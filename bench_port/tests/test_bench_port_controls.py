"""The controls at a size a test run holds: the reference one precision step below the configuration's,
put in the program's place, fails the check (serving: int4 for int8; training: float8 e4m3 for
bfloat16).  On the card ``bench_port/control.py`` reads them at the cells' own sizes."""
import pytest

from bench_port import check, control
from bench_port.tests.small import CPU, small


@pytest.mark.parametrize("cell_name", ["hisfcos20-int8-serve-b64", "fcos20-int8-serve-b64"])
def test_int4_control_fails_serving(cell_name):
    cell, cfg = small(cell_name)
    out = control.serve_control(cell, cfg, 2 ** 31 + 3, CPU, "int4")
    assert not check.passes(out), out


def test_fp8_control_fails_training():
    cell, cfg = small("hisfcos20-train-b64")
    out = control.train_control(cell, cfg, 2 ** 31 + 3, CPU, "fp8")
    assert not check.passes(out), out
