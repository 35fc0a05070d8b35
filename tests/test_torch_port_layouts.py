"""Tensor parallelism and spatial partitioning: the port's parallel/tp.py and parallel/sp.py against JAX (CPU, f32).

HISFCOS(20, 64) at 128x128 with weights carried from JAX
(``torch_port_fixtures.perturbed_variables``), a batch of 4 from a numpy
seed, one step of JAX's single-device ``make_train_step`` as the reference:

  a. ``tp_spec`` holds JAX's rule leaf by leaf (``flax_to_torch_name``);
  b. four gloo ranks take the step as dp2 x tp2, dp2 x sp2 and sp4 (where
     the bands reach one row and P6/P7 take the gather): the loss, the
     parameters after it, the frozen ones bit for bit, each rank's state
     bytes against ``tp_spec``'s prediction (JAX tests/test_tp.py:27-110,
     tests/test_sp.py:23-74);
  c. two ranks: every other family of the train CLI (FCOS on ResNet-50 and
     on EfficientNet-B0, MC_FCOS, MNFCOS, RetinaNet's anchor step, SSD300
     at 300x300 with its ceil-mode pools, L2Norm and uneven rows) under tp2
     and sp2 against the port's one-process step (weights from seeds in the
     ranks); HISFCOS with ``remat``;
     ``bn_train`` under sp2 in f64; the halo exchange and the all-gather
     against their adjoints;
  d. the checkpoints: a one-process checkpoint resumed under tp, and the tp
     checkpoint (written whole by rank 0) restored and stepped in one
     process.

The ranks are subprocesses of ``tests/torch_port_dist_worker.py`` (one
torch thread each) on a ``file://`` store under the test's tmp dir, as in
tests/test_torch_port_parallel.py; each case runs on all its ranks at once,
so the ranks are spawned twice.

Tolerances, those of JAX's tests: the loss to rtol 1e-5; the parameters to
rtol 2e-4 with atol 2e-6 under tp and 1e-5 under sp (the halos' and bands'
sums in another order; JAX tests/test_sp.py:71-74).
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu.parallel import tp as jax_tp
from pytorch_object_detection_tpu.train import schedules as jax_schedules
from pytorch_object_detection_tpu.train import trainer as jax_trainer
from pytorch_object_detection_tpu_torch.models.registry import build_model
from pytorch_object_detection_tpu_torch.parallel import tp
from pytorch_object_detection_tpu_torch.train import checkpoints, trainer
from pytorch_object_detection_tpu_torch.train.checkpoints import (flax_to_state_dict, flax_to_torch_name,
                                                                  load_flax_variables)
from torch_port_fixtures import FEATURES, REPO, jax_model, perturbed_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

N_CLASSES = 20
HW = (128, 128)
STRIDES = (8, 16, 32, 64, 128)
SHAPES = [(HW[0] // s, HW[1] // s) for s in STRIDES]
RANGES = [(-1, 32), (32, 96), (96, 192), (192, 384), (384, 9999999)]
OPT = {"lr": 1e-2, "warmup_steps": 10}
LOSS_RTOL = 1e-5
P_RTOL, TP_ATOL, SP_ATOL = 2e-4, 2e-6, 1e-5
WORKER = os.path.join(REPO, "tests", "torch_port_dist_worker.py")
SPAWN_TIMEOUT = 400
FAMILIES = ("FCOS", "FCOS_B0", "MC_FCOS", "MNFCOS", "RETINANET", "SSD300")


def numpy_batch(seed: int, batch: int, hw=HW, max_boxes: int = 8):
    """Normalized-looking images and one to three GT boxes an image (1-based labels), padded with -1."""
    rng = np.random.default_rng(seed)
    images = rng.normal(0.0, 1.0, (batch, *hw, 3)).astype(np.float32)
    boxes = np.full((batch, max_boxes, 4), -1.0, np.float32)
    labels = np.full((batch, max_boxes), -1, np.int32)
    for b in range(batch):
        n = 1 + b % 3
        cxy = rng.uniform(0.25, 0.75, (n, 2)) * np.array(hw[::-1])
        wh = rng.uniform(0.15, 0.6, (n, 2)) * np.array(hw[::-1])
        boxes[b, :n, :2] = np.maximum(cxy - wh / 2, 0)
        boxes[b, :n, 2:] = np.minimum(cxy + wh / 2, np.array(hw[::-1]) - 1)
        labels[b, :n] = rng.integers(1, N_CLASSES + 1, n)
    return images, boxes, labels


def torch_batch(*args, **kw):
    return tuple(torch.from_numpy(a) for a in numpy_batch(*args, **kw))


def port_model(params, stats, **kw):
    model = build_model("HISFCOS", N_CLASSES, FEATURES, device="cpu", frozen_stages=1, **kw)
    load_flax_variables(model, params, stats)
    return model


def launch(case: str, workdir, world: int):
    """Start ``case`` of the worker in ``world`` processes (inputs in ``workdir/inputs.pt``)."""
    url = "file://" + str(workdir / "store")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, WORKER, case, str(r), str(world), url, str(workdir)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]


def collect(case: str, workdir, procs):
    """The ranks' outputs of :func:`launch`, by rank."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {case} failed:\n{log[-4000:]}"
    return [torch.load(workdir / f"{case}_rank{r}.pt", weights_only=False) for r in range(len(procs))]


@pytest.fixture(scope="module")
def weights():
    return perturbed_variables(0, "HISFCOS", N_CLASSES)


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    """The two spawns: ``families`` (two ranks) starts first, then JAX's
    reference step runs here while it works, then ``layouts`` (four ranks,
    held against that step).  Returns (JAX's metrics, the layouts' outputs,
    the families' outputs, their workdir)."""
    fam_dir = tmp_path_factory.mktemp("families")
    bn_params, bn_stats = perturbed_variables(1, "HISFCOS", N_CLASSES, freeze_bn=False)
    bn_model = port_model(bn_params, bn_stats, freeze_bn=False)
    torch.save({"weights": port_model(*weights).state_dict(), "bn_weights": bn_model.state_dict(), "opt": OPT,
                "batch2": torch_batch(2, 2),
                "family_batches": {128: torch_batch(3, 2), 300: torch_batch(4, 2, (300, 300))},
                "workdir": str(fam_dir)}, fam_dir / "inputs.pt")
    fam_procs = launch("families", fam_dir, 2)

    lay_dir = tmp_path_factory.mktemp("layouts")
    want_metrics, want_state, trainable = jax_step(*weights)
    images, boxes, labels = torch_batch(1, 4)
    torch.save({"weights": port_model(*weights).state_dict(), "opt": OPT, "images": images, "boxes": boxes,
                "labels": labels, "want": {k: torch.from_numpy(np.array(v)) for k, v in want_state.items()},
                "trainable": trainable}, lay_dir / "inputs.pt")
    lay = collect("layouts", lay_dir, launch("layouts", lay_dir, 4))
    fam = collect("families", fam_dir, fam_procs)
    for d in (lay_dir, fam_dir):  # the ranks read them at their start; the suite's workers share the disk
        os.remove(d / "inputs.pt")
    return want_metrics, lay, fam, fam_dir


def jax_step(params, stats):
    """JAX's single-device f32 step on :func:`numpy_batch`'s batch of 4:
    (metrics, the state after it in torch names, the trainable names)."""
    model = jax_model("HISFCOS", N_CLASSES, frozen_stages=1)
    tx = jax_trainer.make_optimizer("SGD", jax_schedules.warmup_step_decay(OPT["lr"], OPT["warmup_steps"]), 0.9,
                                    1e-4, params=params, freeze_bn=True, frozen_stages=1)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=p, batch_stats=stats,
                                   opt_state=tx.init(p), tx=tx)
    step = jax_trainer.make_train_step(model, SHAPES, STRIDES, RANGES, "giou", jnp.float32, donate=False)
    new, metrics = step(state, *(jnp.asarray(a) for a in numpy_batch(1, 4)))
    labels = jax_trainer.param_labels(params, freeze_bn=True, frozen_stages=1)
    trainable = {flax_to_torch_name(tuple(k.key for k in path))
                 for path, v in jax.tree_util.tree_flatten_with_path(labels)[0] if v == "train"}
    return ({k: float(v) for k, v in metrics.items()},
            flax_to_state_dict(jax.device_get(new.params), jax.device_get(new.batch_stats)), trainable)


def assert_summary(out, want_metrics, what):
    """A rank's metrics within LOSS_RTOL of ``want_metrics`` and its whole
    state within the step's tolerances (the worker's excesses: <= 0)."""
    for k, v in want_metrics.items():
        np.testing.assert_allclose(out["metrics"][k], v, rtol=LOSS_RTOL, err_msg=f"{what}: {k}")
    worst = max(out["excess"].items(), key=lambda kv: kv[1])
    assert worst[1] <= 0.0, f"{what}: {worst[0]} exceeds the tolerance by {worst[1]:.3g}"


# ---------------------------------------------------------------------------
# a. tp_spec
# ---------------------------------------------------------------------------
def test_tp_spec_matches_jax_rules(weights):
    """Leaf by leaf over HISFCOS's params and statistics, at tp 2 and 4:
    the port shards exactly the leaves JAX shards, along the output
    channels; and the rules of JAX tests/test_tp.py:27-35."""
    params, stats = weights
    port = flax_to_state_dict(params, stats)
    for t in (2, 4):
        n_sharded = 0
        for tree in (params, stats):
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                name = flax_to_torch_name(tuple(k.key for k in path))
                jax_sharded = jax_tp.tp_spec(np.shape(leaf), t) != jax.sharding.PartitionSpec()
                port_dim = tp.tp_spec(port[name].shape, t)
                assert jax_sharded == (port_dim == 0), (t, name, np.shape(leaf))
                n_sharded += jax_sharded
        assert n_sharded > 300
    assert tp.tp_spec((64, 64, 3, 3), 2) == 0 and tp.tp_spec((1, 64, 3, 3), 2) is None
    assert tp.tp_spec((1,), 2) is None and tp.tp_spec((64,), 2) == 0 and tp.tp_spec((64,), 1) is None
    assert tp.tp_spec((64, 1, 3, 3), 2) == 0  # depthwise
    assert tp.tp_spec((20, 64, 3, 3), 2) == 0 and tp.tp_spec((20, 64, 3, 3), 4) == 0  # as JAX: 20 >= 16
    assert tp.tp_spec((4, 64, 3, 3), 2) is None  # the regression predictor stays replicated


# ---------------------------------------------------------------------------
# b. dp x tp, dp x sp and sp4 against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["dp2xtp2", "dp2xsp2", "sp4"])
def test_layout_step_matches_jax(ranks, case):
    """Every rank's loss and whole state after one step of the layout
    against JAX's single-device step; the frozen parameters bit for bit;
    the ranks agree; under sp the deep levels take their gathers (sp4:
    the bands reach one row at P5, P6 and P7 are computed whole), and the
    trunk does not."""
    want_metrics, lay, _, _ = ranks
    for r, out in enumerate(lay):
        assert_summary(out[case], want_metrics, f"{case} rank {r}")
        assert out[case]["frozen_exact"], (case, r)
        assert out[case]["digest"] == lay[0][case]["digest"], (case, r)
    gathers = lay[0][case]["gathers"]
    if case == "dp2xtp2":
        assert gathers == {}
    else:
        assert 1 <= gathers.get("conv2d", 0) + gathers.get("max_pool2d", 0) <= 6, gathers
        assert set(gathers) <= {"conv2d", "max_pool2d"}, gathers  # nothing falls back to a whole gather
    if case == "sp4":
        assert gathers.get("conv2d", 0) >= 2, gathers


def test_tp_state_bytes(ranks, weights):
    """Each rank of dp2 x tp2 holds exactly the bytes of weights, buffers,
    gradients and momenta that ``tp_spec`` predicts from the whole shapes,
    under 0.55 of the whole (JAX tests/test_tp.py:38-70); the head tower's
    conv holds half its output channels, the 1-channel predictor all."""
    _, lay, _, _ = ranks
    whole = sum(v.nbytes for v in flax_to_state_dict(*weights).values())
    for r, out in enumerate(lay):
        local, predicted = out["dp2xtp2"]["bytes"]
        assert local == predicted, (r, local, predicted)
        assert out["dp2xtp2"]["cls_tower0"] == (32, 64, 3, 3)
        assert out["dp2xtp2"]["cnt_pred"] == (1, 64, 3, 3)
    local, _ = lay[0]["dp2xtp2"]["bytes"]
    # weights + buffers, gradients and momenta of the trainable ones: at most 3x the whole weights, halved
    assert local <= 0.55 * 3 * whole


# ---------------------------------------------------------------------------
# c. the other families, remat, bn_train, the collectives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("layout", ["tp", "sp"])
def test_family_layout_matches_one_process(ranks, family, layout):
    """``family``'s step under ``layout`` on two ranks against the port's
    one-process step (loss to rtol 1e-5, parameters to rtol 2e-4 and the
    layout's atol); the ranks agree."""
    _, _, fam, _ = ranks
    for r, out in enumerate(fam):
        got = out[family][layout]
        assert_summary(got, got["want_metrics"], f"{family} {layout} rank {r}")
        assert got["digest"] == fam[0][family][layout]["digest"]
    gathers = fam[0][family][layout]["gathers"]
    if layout == "sp" and family == "SSD300":
        assert gathers.get("max_pool2d", 0) >= 1  # 150 -> 75 rows: the bands stop dividing
    if layout == "sp" and family == "RETINANET":
        assert "reshape" in gathers  # the anchor heads' outputs, flattened whole
    if layout == "sp" and family == "SSD300":
        assert "reshape" not in gathers  # every level is whole from 75 rows down


@pytest.mark.parametrize("case", ["remat_tp", "remat_sp", "bn_train_sp"])
def test_layout_remat_and_bn_train(ranks, case):
    """``remat`` under tp2 and sp2 gives the step without it; a
    ``freeze_bn=False`` HISFCOS with ``bn_train`` under sp2 (f64: trained
    statistics amplify f32 sums' order) gives the one-process step, its
    running statistics included."""
    _, _, fam, _ = ranks
    for r, out in enumerate(fam):
        assert_summary(out[case], out[case]["want_metrics"], f"{case} rank {r}")
    if case == "bn_train_sp":
        assert any("running_var" in k for k in fam[0][case]["excess"])


def test_collectives_adjoint(ranks):
    """The halo exchange (zeros and -inf at the edges) and the all-gather
    along rows and channels: each backward is the adjoint of its forward,
    sum over ranks of <f(x), g> == sum of <x, f^T(g)>."""
    _, _, fam, _ = ranks
    for name, (lhs, rhs) in fam[0]["adjoint"].items():
        assert abs(lhs - rhs) <= 1e-9 * max(1.0, abs(lhs)), (name, lhs, rhs)
    # bands [0..3] and [4..7] with one halo row each way
    assert fam[0]["halo_rows"] == [0.0, 0.0, 1.0, 2.0, 3.0, 4.0]
    assert fam[1]["halo_rows"] == [3.0, 4.0, 5.0, 6.0, 7.0, 0.0]
    assert fam[0]["halo_inf"][0] == fam[1]["halo_inf"][-1] == float("-inf")


# ---------------------------------------------------------------------------
# d. checkpoints
# ---------------------------------------------------------------------------
def test_tp_checkpoints(ranks, weights):
    """A one-process checkpoint resumed under tp2 takes the one-process
    second step; the tp checkpoint, gathered and written by rank 0 alone,
    has a one-process checkpoint's names and shapes, restores in one
    process bit for bit as written, equal to the one-process state after
    two steps (its weights to the step's tolerances, its momenta as said
    below), and takes a third step there."""
    _, _, fam, workdir = ranks
    for r, out in enumerate(fam):
        assert out["resumed_step"] == 1
        assert_summary(out["resumed_tp"], out["resumed_tp"]["want_metrics"], f"resumed under tp, rank {r}")
    assert os.listdir(workdir / "tp_ckpt") == ["step_00000002.pt"]
    saved = torch.load(workdir / "tp_ckpt" / "step_00000002.pt", weights_only=True)
    states = []
    for path in ("tp_ckpt", "one_ckpt2"):
        model = port_model(*weights)
        state = trainer.create_train_state(model, OPT, freeze_bn=True, frozen_stages=1)
        checkpoints.restore_checkpoint(str(workdir / path), state)
        states.append(state)
    tp_state, one_state = states
    assert {k: tuple(v.shape) for k, v in saved["model"].items()} == \
        {k: tuple(v.shape) for k, v in one_state.model.state_dict().items()}
    assert tp_state.step == one_state.step == 2
    for k, v in one_state.model.state_dict().items():
        np.testing.assert_allclose(tp_state.model.state_dict()[k].numpy(), v.numpy(), rtol=P_RTOL, atol=TP_ATOL,
                                   err_msg=k)
    mom = [(tp_state.optimizer.state[p]["momentum_buffer"], one_state.optimizer.state[q]["momentum_buffer"])
           for p, q in zip(tp_state.model.parameters(), one_state.model.parameters()) if p.requires_grad]
    assert len(mom) > 100
    # the momenta are two steps' gradients, not scaled down by the lr: f32 sums in another order move them by up
    # to 1.4e-2 of a tensor's largest value (measured: layer3's conv3 kernels, whose gradients tests/
    # test_torch_port_train.py finds 2.6e-2 off JAX's), so each is held to that file's 5e-2 of its largest
    # gradient and all together to a cosine of 0.99999 (measured 0.9999997)
    for a, b in mom:
        assert float((a - b).abs().max()) <= 5e-2 * float(b.abs().max())
    a, b = (torch.cat([m[i].flatten() for m in mom]).double() for i in (0, 1))
    assert float(a @ b / (a.norm() * b.norm())) >= 0.99999
    assert all(torch.equal(tp_state.model.state_dict()[k], v) for k, v in saved["model"].items())
    # a third step in one process from each: the two states differ by two steps' tolerances already, which
    # move this loss by up to 2.2e-5 (measured), so it is held to 1e-4
    batch = torch_batch(2, 2)
    got = [trainer.make_train_step(s.model, SHAPES, STRIDES, RANGES, "giou", torch.float32)(s, *batch)
           for s in (tp_state, one_state)]
    for k, v in got[1].items():
        np.testing.assert_allclose(float(got[0][k]), float(v), rtol=1e-4, err_msg=k)
    for path in ("tp_ckpt", "one_ckpt", "one_ckpt2"):  # some 200 MB each
        shutil.rmtree(workdir / path)
