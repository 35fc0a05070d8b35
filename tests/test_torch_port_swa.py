"""Stochastic weight averaging and the train CLI's layout flags: the port's train/swa.py and cli/train.py (CPU).

  a. ``swa_update`` (uniform and EMA) and ``swa_lr`` against the JAX
     functions on the same numpy trees (JAX tests/test_aux.py:57-70), and
     ``create_train_state``'s ``swa_lr`` schedule;
  b. ``podt-torch-train --synthetic --swa --swa-every 1 --swa-lr 1e-4``
     (JAX tests/test_cli_features.py:30-64): ``swa: averaged 3 snapshots``,
     and ``<savename>_swa`` restores with the live state's names and shapes
     and holds the mean of the live weights after steps 1, 2 and 3 (runs of
     1, 2 and 3 steps: the CLI is deterministic on the CPU);
  c. ``--model-parallel 2 --layout tp|sp`` in two processes joined by
     ``--coordinator`` (JAX tests/test_cli_features.py:119-136): ``training
     done: step 2``, the ranks' losses identical, one whole checkpoint
     (under tp with ``--swa`` too, averaged on the shards and gathered);
     one process asked for ``--model-parallel 2`` exits 2.
"""
from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu.train import swa as jax_swa
from pytorch_object_detection_tpu_torch.models.registry import build_model
from pytorch_object_detection_tpu_torch.train import checkpoints, swa, trainer
from torch_port_fixtures import FEATURES, REPO, tiny_voc_config
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

STRIDES = (8, 16, 32, 64, 128)
RANGES = [(-1, 32), (32, 96), (96, 192), (192, 384), (384, 9999999)]
TIMEOUT = 300


def test_swa_update_and_lr_match_jax():
    """Three snapshots of a numpy tree through both packages, uniform and
    EMA (0.9), to f32 rounding; the JAX test's own values; ``swa_lr`` on
    both sides of its start."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=5).astype(np.float32)}
    snaps = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in tree.items()} for _ in range(3)]
    for decay in (None, 0.9):
        want = jax_swa.swa_init({k: jnp.asarray(v) for k, v in tree.items()})
        got = swa.swa_init({k: torch.from_numpy(v) for k, v in tree.items()})
        for s in snaps:
            want = jax_swa.swa_update(want, {k: jnp.asarray(v) for k, v in s.items()}, decay)
            got = swa.swa_update(got, {k: torch.from_numpy(v) for k, v in s.items()}, decay)
        assert got.count == int(want.count) == 3
        for k in tree:
            np.testing.assert_allclose(got.params[k].numpy(), np.asarray(want.params[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} decay={decay}")
    s = swa.swa_init({"w": torch.zeros(3)})
    s = swa.swa_update(s, {"w": torch.full((3,), 2.0)})
    s = swa.swa_update(s, {"w": torch.full((3,), 4.0)})
    assert torch.equal(s.params["w"], torch.full((3,), 3.0)) and s.count == 2
    live = torch.zeros(3)
    s = swa.swa_init({"w": live})
    live += 1.0
    assert torch.equal(s.params["w"], torch.zeros(3))  # the average owns its memory
    for base, v, start, steps in ((0.01, 0.001, 100, (0, 50, 99, 100, 150)), (0.05, 1e-4, 3, (0, 2, 3, 4))):
        want, got = jax_swa.swa_lr(base, v, start), swa.swa_lr(base, v, start)
        for step in steps:
            assert got(step) == float(want(step)), (base, v, start, step)


def test_create_train_state_swa_schedule():
    """``create_train_state`` with ``swa_lr``: the base schedule before
    ``swa_start_step``, the constant (in f32) from it on."""
    model = build_model("HISFCOS", 20, FEATURES, device="cpu", generator=torch.Generator().manual_seed(0))
    plain = trainer.create_train_state(model, {"lr": 1e-2, "warmup_steps": 10})
    state = trainer.create_train_state(model, {"lr": 1e-2, "warmup_steps": 10, "swa_lr": 1e-4, "swa_start_step": 5})
    assert [state.schedule(s) for s in range(5)] == [plain.schedule(s) for s in range(5)]
    assert state.schedule(5) == state.schedule(50) == float(np.float32(1e-4))


def cli(tmp_path, *args):
    cmd = [sys.executable, "-m", "pytorch_object_detection_tpu_torch.cli.train", *args]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")  # one torch thread, as in-process
    return subprocess.Popen(cmd, cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(procs):
    """Each process's (exit code, output), none left running."""
    out = []
    try:
        for p in procs:
            out.append((p.communicate(timeout=TIMEOUT)[0], p))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, log) for log, p in out]


def template():
    model = build_model("HISFCOS", 20, FEATURES, frozen_stages=1, device="cpu")
    return trainer.create_train_state(model, {}, freeze_bn=True, frozen_stages=1)


def restore(path):
    return checkpoints.restore_checkpoint(str(path), template())


def test_swa_cli(tmp_path):
    """Runs of 1, 2 and 3 steps with ``--swa --swa-every 1 --swa-lr 1e-4``
    (at once): each prints its count of snapshots; the 3-step run's
    ``_swa`` checkpoint has the live one's names and shapes, differs from
    it where training moved the weights, and is the mean of the three runs'
    live weights (the snapshots after steps 1, 2 and 3) to f32 rounding;
    the BatchNorm running statistics are the live ones."""
    cfg = tiny_voc_config(tmp_path, "HISFCOS", STRIDES, RANGES)
    runs = finish([cli(tmp_path, "--config", cfg, "--device", "cpu", "--synthetic", "--steps", str(n),
                       "--log-every", "1000", "--checkpoint-dir", f"ck{n}", "--swa", "--swa-every", "1",
                       "--swa-lr", "1e-4") for n in (1, 2, 3)])
    for n, (code, log) in zip((1, 2, 3), runs):
        assert code == 0, log[-3000:]
        assert f"swa: averaged {n} snapshots" in log and f"training done: step {n}" in log, log[-2000:]
    live = [restore(tmp_path / f"ck{n}" / "hisfcos").model.state_dict() for n in (1, 2, 3)]
    averaged = restore(tmp_path / "ck3" / "hisfcos_swa")
    saved = torch.load(tmp_path / "ck3" / "hisfcos_swa" / "step_00000003.pt", weights_only=True)
    assert {k: v.shape for k, v in saved["model"].items()} == {k: v.shape for k, v in live[2].items()}
    assert averaged.step == 3
    got = averaged.model.state_dict()
    names = swa.swa_params(averaged.model)
    moved = [k for k in names if not torch.equal(live[0][k], live[2][k])]
    assert len(moved) > 100
    assert any(not torch.equal(got[k], live[2][k]) for k in moved)
    for k in names:
        mean = (live[0][k].double() + live[1][k] + live[2][k]) / 3.0
        np.testing.assert_allclose(got[k].numpy(), mean.numpy(), rtol=1e-6, atol=1e-8, err_msg=k)
    for k in got:
        if "running" in k:
            assert torch.equal(got[k], live[2][k]), k
    for n in (1, 2, 3):  # some 200 MB a checkpoint; the suite's workers share the disk
        shutil.rmtree(tmp_path / f"ck{n}")


@pytest.mark.parametrize("layout", ["tp", "sp"])
def test_model_parallel_cli(tmp_path, layout):
    """``--model-parallel 2 --layout {tp,sp}`` on two gloo processes
    (``--swa --swa-every 1`` under tp): both exit 0 after ``training done:
    step 2`` with identical losses, and rank 0 alone writes the whole
    checkpoint (and ``_swa``), which restores in one process."""
    cfg = tiny_voc_config(tmp_path, "HISFCOS", STRIDES, RANGES)
    with socket.socket() as s:  # a free port for rank 0's store
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    extra = ["--swa", "--swa-every", "1"] if layout == "tp" else []
    runs = finish([cli(tmp_path, "--config", cfg, "--device", "cpu", "--synthetic", "--steps", "2", "--log-every", "1",
                       "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(r),
                       "--model-parallel", "2", "--layout", layout, *extra) for r in range(2)])
    losses = []
    for code, log in runs:
        assert code == 0, log[-3000:]
        assert "training done: step 2" in log and f"{layout} over 2 ranks" in log, log[-2000:]
        losses.append([line.split(" (")[0] for line in log.splitlines() if line.startswith("step ")])
    assert len(losses[0]) == 2 and losses[0] == losses[1]
    assert os.listdir(tmp_path / "checkpoint" / "hisfcos") == ["step_00000002.pt"]
    state = restore(tmp_path / "checkpoint" / "hisfcos")
    assert state.step == 2 and all(torch.isfinite(v).all() for v in state.model.state_dict().values())
    if layout == "tp":
        assert "swa: averaged 2 snapshots" in runs[0][1]
        averaged = restore(tmp_path / "checkpoint" / "hisfcos_swa")
        assert any(not torch.equal(v, state.model.state_dict()[k]) for k, v in averaged.model.state_dict().items())
    shutil.rmtree(tmp_path / "checkpoint")  # some 200 MB a checkpoint; the suite's workers share the disk


def test_model_parallel_needs_its_ranks(tmp_path):
    """One process asked for ``--model-parallel 2`` exits 2 and says what launch it takes."""
    cfg = tiny_voc_config(tmp_path, "HISFCOS", STRIDES, RANGES)
    ((code, log),) = finish([cli(tmp_path, "--config", cfg, "--device", "cpu", "--synthetic", "--steps", "1",
                                 "--model-parallel", "2")])
    assert code == 2 and "data_parallel x 2 processes" in log, log[-2000:]
