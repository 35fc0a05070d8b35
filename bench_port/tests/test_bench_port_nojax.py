"""Nothing the harness runs loads JAX, Flax or the JAX package, compared by whole top-level names (the
port's own name begins with the JAX package's); and a run prints no result where it cannot measure."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_port import harness

ROOT = harness.ROOT.parent


def test_no_source_of_the_harness_imports_jax():
    found = []
    for path in harness.ROOT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            found += [(path.name, n) for n in names if n.split(".")[0] in harness.FORBIDDEN]
    assert found == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("jaxtyping", "pytorch_object_detection_tpu_torch.ops", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == []
    for name in ("jax.numpy", "pytorch_object_detection_tpu.ops.nms", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == ["flax", "jax.numpy", "pytorch_object_detection_tpu.ops.nms"]


def test_what_a_run_imports_loads_no_jax():
    code = ("import json, sys; sys.path.insert(0, '.');"
            "from bench_port import harness, serve, train, control, check, work;"
            "from pytorch_object_detection_tpu_torch.eval import evaluator;"
            "from pytorch_object_detection_tpu_torch.train import trainer;"
            "from pytorch_object_detection_tpu_torch.parallel import mesh, collectives;"
            "from pytorch_object_detection_tpu_torch.models import registry;"
            "print(json.dumps([harness.forbidden_modules(), 'pytorch_object_detection_tpu_torch' in sys.modules]))")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == [[], True]


def test_without_a_card_a_run_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would measure")
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "hisfcos20-int8-serve-b64", "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA card" in out.stderr


@pytest.mark.cuda
def test_without_the_program_a_run_prints_no_result(card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.ROOT, tmp_path / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "hisfcos20-int8-serve-b64", "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
