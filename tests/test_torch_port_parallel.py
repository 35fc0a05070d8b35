"""Data parallelism: the port's parallel/ package, SyncBatchNorm and the DDP steps against JAX (CPU, f32).

HISFCOS(20, 64) at 128x128 with weights carried from JAX
(``torch_port_fixtures.perturbed_variables``), batches from numpy seeds:

  a. ``nn/layers.BatchNorm`` in training against flax's (``train=True``,
     mutable ``batch_stats``);
  b. one ``make_train_step(bn_train=True)`` step of a ``freeze_bn=False``
     model against JAX's: the trainable set is JAX's ``param_labels``;
  c. two ranks (gloo, each its half of the batch) against one process on
     the whole batch: the DDP step with frozen and with trained BatchNorms
     (global statistics), and RetinaNet's anchor step;
  d. two ranks of ``make_shard_map_train_step(bn_train=True)`` against
     JAX's on a two-device CPU mesh;
  e. the collectives on two ranks;
  f. data-parallel serving on two ranks: the float and the default int8
     pipelines and ``collect_voc_predictions`` over the committed VOC tree,
     with the mesh against without it;
  g. ``parallel/pp.make_two_stage_pipeline`` on ("cpu", "cpu") against
     JAX's on two CPU devices, HISFCOS and FCOS on EfficientNet-B0;
  h. ``podt-torch-train`` in two processes joined by ``--coordinator``.

The ranks are subprocesses (``tests/torch_port_dist_worker.py``, one torch
thread each) joined through a ``file://`` store under ``tmp_path`` (xdist
workers must not share a port), each with its own timeout.

Tolerances: the loss to rtol 1e-5; parameters and BatchNorm statistics
after a step to rtol 2e-4 and atol 2e-6 (those of JAX's
tests/test_tp.py:103-110); parameters nothing updates, bit for bit.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu.nn import layers as jax_layers
from pytorch_object_detection_tpu.parallel import mesh as jax_mesh
from pytorch_object_detection_tpu.train import schedules as jax_schedules
from pytorch_object_detection_tpu.train import trainer as jax_trainer
from pytorch_object_detection_tpu_torch.eval.evaluator import make_eval_pipeline
from pytorch_object_detection_tpu_torch.models.registry import build_model
from pytorch_object_detection_tpu_torch.nn.layers import BatchNorm
from pytorch_object_detection_tpu_torch.parallel import mesh as pmesh
from pytorch_object_detection_tpu_torch.parallel.pp import make_two_stage_pipeline
from pytorch_object_detection_tpu_torch.train import trainer
from pytorch_object_detection_tpu_torch.train.checkpoints import flax_to_state_dict, flax_to_torch_name, load_flax_variables
from torch_port_fixtures import FEATURES, REPO, VOC_TREE, jax_model, perturbed_variables, run_cli
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

N_CLASSES = 20
HW = (128, 128)
STRIDES = (8, 16, 32, 64, 128)
SHAPES = [(HW[0] // s, HW[1] // s) for s in STRIDES]
RANGES = [(-1, 32), (32, 96), (96, 192), (192, 384), (384, 9999999)]
OPT = {"lr": 1e-2, "warmup_steps": 10}
BATCH = 4
LOSS_RTOL = 1e-5
P_RTOL, P_ATOL = 2e-4, 2e-6
WORKER = os.path.join(REPO, "tests", "torch_port_dist_worker.py")
SPAWN_TIMEOUT = 300


def numpy_batch(seed: int = 1, batch: int = BATCH, max_boxes: int = 8):
    """Normalized-looking images and GT boxes (1-based labels) padded with -1,
    one to three boxes an image."""
    rng = np.random.default_rng(seed)
    images = rng.normal(0.0, 1.0, (batch, *HW, 3)).astype(np.float32)
    boxes = np.full((batch, max_boxes, 4), -1.0, np.float32)
    labels = np.full((batch, max_boxes), -1, np.int32)
    for b in range(batch):
        n = 1 + b % 3
        cxy = rng.uniform(0.25, 0.75, (n, 2)) * np.array(HW[::-1])
        wh = rng.uniform(0.15, 0.6, (n, 2)) * np.array(HW[::-1])
        boxes[b, :n, :2] = np.maximum(cxy - wh / 2, 0)
        boxes[b, :n, 2:] = np.minimum(cxy + wh / 2, np.array(HW[::-1]) - 1)
        labels[b, :n] = rng.integers(1, N_CLASSES + 1, n)
    return images, boxes, labels


def port_model(name, params, stats, **kw):
    model = build_model(name, N_CLASSES, FEATURES, device="cpu", **kw)
    load_flax_variables(model, params, stats)
    return model


def assert_state_close(got, want, what):
    """Each tensor of ``want`` (torch names) within the parameters' tolerance."""
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w), rtol=P_RTOL, atol=P_ATOL,
                                   err_msg=f"{what}: {name}")


def assert_losses(got, want, what):
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=LOSS_RTOL, err_msg=f"{what}: {k}")


def spawn_ranks(case: str, workdir, world: int = 2):
    """Run ``case`` of the worker in ``world`` processes; their outputs by rank."""
    url = "file://" + str(workdir / "store")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, case, str(r), str(world), url, str(workdir)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
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
    return [torch.load(workdir / f"{case}_rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# a. BatchNorm in training
# ---------------------------------------------------------------------------
def test_batchnorm_training_matches_flax():
    """Output, running mean and running var against flax's, from perturbed
    statistics and affine.  The mean and the variance to rtol 1e-6; the
    output to rtol 1e-6 plus 1e-6 of its range: it crosses zero, and XLA's
    and torch's f32 ``rsqrt`` differ by an ulp on a fifth of the channels
    (measured: 1.2e-6 at most on outputs up to 5)."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.0, 1.0, (4, 8, 8, 64)).astype(np.float32)
    scale, bias = rng.uniform(0.7, 1.3, 64).astype(np.float32), rng.normal(0.0, 0.1, 64).astype(np.float32)
    mean0, var0 = rng.normal(0.0, 0.1, 64).astype(np.float32), rng.uniform(0.5, 1.5, 64).astype(np.float32)
    variables = {"params": {"bn": {"scale": scale, "bias": bias}}, "batch_stats": {"bn": {"mean": mean0, "var": var0}}}
    want, upd = jax_layers.BatchNorm().apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    want = np.asarray(want)

    bn = BatchNorm(64)
    bn.unfreeze()
    assert sorted(n for n, _ in bn.named_parameters()) == ["bias", "weight"]
    assert sorted(bn.state_dict()) == ["bias", "running_mean", "running_var", "weight"]
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean0), (bn.running_var, var0)):
            t.copy_(torch.from_numpy(v))
    got = bn.train()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()))
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["bn"]["mean"]), rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["bn"]["var"]), rtol=1e-6)
    # eval mode: the running statistics, unchanged by the call; the frozen layer as before
    before = bn.running_mean.clone()
    frozen = BatchNorm(64)
    frozen.load_state_dict(bn.state_dict())
    x_t = torch.from_numpy(x).permute(0, 3, 1, 2)
    assert torch.equal(bn.eval()(x_t), frozen(x_t)) and torch.equal(bn.running_mean, before)


# ---------------------------------------------------------------------------
# b. one bn_train step against JAX's
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    params, stats = perturbed_variables(0, "HISFCOS", N_CLASSES, freeze_bn=False)
    return params, stats


def jax_state(params, stats):
    """A JAX TrainState over f64 copies of the weights, the optimizer of
    ``OPT`` with JAX's freeze set at ``freeze_bn=False, frozen_stages=1``."""
    f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
    p = f64(params)
    tx = jax_trainer.make_optimizer("SGD", jax_schedules.warmup_step_decay(OPT["lr"], OPT["warmup_steps"]), 0.9,
                                    1e-4, params=p, freeze_bn=False, frozen_stages=1)
    return jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=p, batch_stats=f64(stats),
                                  opt_state=tx.init(p), tx=tx)


@pytest.fixture(scope="module")
def jax_bn_step(weights):
    """JAX's make_train_step(bn_train=True) on the whole batch, in f64:
    losses, params and batch_stats after it, and the trainable set."""
    params, stats = weights
    model = jax_model("HISFCOS", N_CLASSES, frozen_stages=1, freeze_bn=False)
    with jax.enable_x64(True):
        step = jax_trainer.make_train_step(model, SHAPES, STRIDES, RANGES, "giou", jnp.float64, bn_train=True,
                                           donate=False)
        new, metrics = step(jax_state(params, stats), *(jnp.asarray(a) for a in f64_batch()))
        got = ({k: float(v) for k, v in metrics.items()},
               flax_to_state_dict(jax.device_get(new.params), jax.device_get(new.batch_stats)))
    labels = jax_trainer.param_labels(params, freeze_bn=False, frozen_stages=1)
    trainable = {flax_to_torch_name(tuple(k.key for k in path))
                 for path, v in jax.tree_util.tree_flatten_with_path(labels)[0] if v == "train"}
    return (*got, trainable)


def f64_batch():
    """:func:`numpy_batch` with the images in f64."""
    images, boxes, labels = numpy_batch()
    return images.astype(np.float64), boxes, labels


def port_step(weights, freeze_bn: bool, bn_train: bool, batch, dtype=torch.float32):
    """One port step on one process, the model in ``dtype`` (the losses in
    f32 either way, as in JAX): (metrics, state_dict after, state)."""
    model = port_model("HISFCOS", *weights, frozen_stages=1, freeze_bn=freeze_bn).to(dtype)
    state = trainer.create_train_state(model, OPT, freeze_bn=freeze_bn, frozen_stages=1)
    step = trainer.make_train_step(model, SHAPES, STRIDES, RANGES, "giou", torch.float32, bn_train=bn_train)
    metrics = step(state, *batch)
    return metrics, {k: v.detach().clone() for k, v in model.state_dict().items()}, state


@pytest.fixture(scope="module")
def single(weights):
    """The one-process port steps on the whole batch: frozen BatchNorms in
    f32, and bn_train in f64 (see :func:`test_bn_train_step_matches_jax`)."""
    return {"frozen": port_step(weights, True, False, tuple(torch.from_numpy(a) for a in numpy_batch())),
            "bn_train": port_step(weights, False, True, tuple(torch.from_numpy(a) for a in f64_batch()),
                                  torch.float64)}


def test_bn_train_step_matches_jax(weights, single, jax_bn_step):
    """Both sides in f64 (the losses in f32, as the JAX step casts them).
    With batch statistics, f32 sums in another order drift with depth: the
    statistics of a 4x4 layer4 map or a 1x1 P7 map over a batch of 4
    amplify them (measured against the port in f64: JAX's f32 step 1.5e-4
    off on the loss and 5e-4 of the range on his7's statistics, the port's
    f32 step 6 to 10 times closer, and the port's f32 step on two ranks
    2.2e-4 off a backbone weight after one update), which the tolerances
    here would not admit.  The frozen step keeps f32 (test c)."""
    want_losses, want_state, want_trainable = jax_bn_step
    metrics, got_state, state = single["bn_train"]
    assert set(state.trainable_names()) == want_trainable
    assert any(".bn" in n for n in want_trainable)  # the BatchNorm affines train
    assert not any(m.training for m in state.model.modules())  # the step leaves the model in eval mode
    assert_losses(metrics, want_losses, "bn_train step")
    assert sorted(got_state) == sorted(want_state)
    assert_state_close(got_state, want_state, "bn_train step")
    before = flax_to_state_dict({}, weights[1])
    assert all(not np.array_equal(got_state[k].numpy(), v) for k, v in before.items())  # every statistic moved


def test_bn_train_validation(weights):
    """A trained-statistics model needs bn_train; a frozen model's
    statistics stay with it; freeze_bn=False on the state trains every
    parameter at frozen_stages=0 (JAX applies no mask then)."""
    model = port_model("HISFCOS", *weights, freeze_bn=False)
    state = trainer.create_train_state(model, OPT, freeze_bn=False, frozen_stages=0)
    assert state.trainable_names() == [n for n, _ in model.named_parameters()]
    with pytest.raises(ValueError, match="bn_train=True"):
        trainer.make_train_step(model, SHAPES, STRIDES, RANGES, "giou", torch.float32)
    frozen = port_model("HISFCOS", *weights)
    state = trainer.create_train_state(frozen, OPT, freeze_bn=False, frozen_stages=1)
    before = {k: v.clone() for k, v in frozen.state_dict().items() if "running" in k}
    step = trainer.make_train_step(frozen, SHAPES, STRIDES, RANGES, "giou", torch.float32, bn_train=True)
    step(state, *(torch.from_numpy(a[:2]) for a in numpy_batch()))
    assert all(torch.equal(v, frozen.state_dict()[k]) for k, v in before.items())
    assert frozen.backbone.layer2_0.bn1.weight.grad is not None  # the affine trains on frozen statistics
    with pytest.raises(RuntimeError, match="process group"):  # a (data, model) mesh takes its ranks' group
        pmesh.create_mesh(model_parallel=2)


def test_bn_train_remat_updates_statistics_once(weights):
    """With ``remat`` the forward runs again in the backward: the running
    statistics are updated by the first run only, and the step equals the
    one without remat."""
    batch = tuple(torch.from_numpy(a[:2]) for a in numpy_batch())
    out = []
    for remat in (False, True):
        model = port_model("HISFCOS", *weights, frozen_stages=1, freeze_bn=False)
        state = trainer.create_train_state(model, OPT, freeze_bn=False, frozen_stages=1)
        step = trainer.make_train_step(model, SHAPES, STRIDES, RANGES, "giou", torch.float32, bn_train=True,
                                       remat=remat)
        out.append((step(state, *batch), model.state_dict()))
    (m0, s0), (m1, s1) = out
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for k, v in s0.items():
        torch.testing.assert_close(s1[k], v, rtol=P_RTOL, atol=P_ATOL, msg=lambda m: f"{k}: {m}")
        if "running" in k:
            assert torch.equal(s1[k], v), k


# ---------------------------------------------------------------------------
# c, d. two ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def train_ranks(weights, tmp_path_factory):
    work = tmp_path_factory.mktemp("train_ranks")
    images, boxes, labels = (torch.from_numpy(a) for a in numpy_batch())
    retina = port_model("RETINANET", *perturbed_variables(0, "RETINANET", N_CLASSES))
    hisfcos = port_model("HISFCOS", *weights, freeze_bn=False)
    torch.save({"weights": hisfcos.state_dict(), "retina_weights": retina.state_dict(), "opt": OPT,
                "images": images, "boxes": boxes, "labels": labels}, work / "inputs.pt")
    return spawn_ranks("train", work), retina


def test_ddp_step_matches_one_process(single, train_ranks):
    """Two ranks at B=2 against one process at B=4: frozen BatchNorms (f32),
    and bn_train with the statistics of the whole batch (f64, as test b)."""
    ranks, _ = train_ranks
    for case in ("frozen", "bn_train"):
        metrics, want_state, state = single[case]
        trainable = set(state.trainable_names())
        for r, out in enumerate(ranks):
            got = out[case]
            assert_losses(got["metrics"], metrics, f"{case} rank {r}")
            assert_state_close(got["state"], {k: v.numpy() for k, v in want_state.items()}, f"{case} rank {r}")
            for k, v in want_state.items():
                if k not in trainable and "running" not in k:
                    assert torch.equal(got["state"][k], v), (case, r, k)  # frozen: bit for bit
                if case == "frozen" and "running" in k:
                    assert torch.equal(got["state"][k], v), (case, r, k)
            assert got["step"] == 1
        # the ranks hold the same metrics and weights
        assert all(torch.equal(ranks[0][case]["metrics"][k], ranks[1][case]["metrics"][k]) for k in metrics)
        assert all(torch.equal(v, ranks[1][case]["state"][k]) for k, v in ranks[0][case]["state"].items())


def test_ddp_anchor_step_matches_one_process(train_ranks):
    """RetinaNet's make_anchor_train_step (focal loss) on two ranks against one process."""
    ranks, retina = train_ranks
    from pytorch_object_detection_tpu_torch.ops.anchors import generate_anchors

    state = trainer.create_train_state(retina, OPT, freeze_bn=True, frozen_stages=0)
    anchors = generate_anchors(retina.level_shapes(HW), STRIDES, device="cpu")
    step = trainer.make_anchor_train_step(retina, anchors, N_CLASSES, torch.float32)
    metrics = step(state, *(torch.from_numpy(a) for a in numpy_batch()))
    want = {k: v.numpy() for k, v in retina.state_dict().items()}
    for r, out in enumerate(ranks):
        assert_losses(out["retinanet"]["metrics"], metrics, f"retinanet rank {r}")
        assert_state_close(out["retinanet"]["state"], want, f"retinanet rank {r}")


def test_shard_map_step_matches_jax(weights, train_ranks):
    """make_shard_map_train_step(bn_train=True): local statistics, the
    gradients, metrics and updated statistics averaged; against JAX's on a
    two-device mesh (both in f64, as test b); the statistics identical on
    both ranks."""
    ranks, _ = train_ranks
    model = jax_model("HISFCOS", N_CLASSES, frozen_stages=1, freeze_bn=False)
    mesh = jax_mesh.create_mesh(jax.devices()[:2])
    with jax.enable_x64(True), mesh:  # f64, as test b
        step = jax_trainer.make_shard_map_train_step(model, SHAPES, STRIDES, RANGES, mesh, "giou", jnp.float64,
                                                     bn_train=True)
        state = jax_mesh.replicate_state(mesh, jax_state(*weights))
        new, metrics = step(state, *jax_mesh.shard_batch(mesh, tuple(jnp.asarray(a) for a in f64_batch())))
        want = flax_to_state_dict(jax.device_get(new.params), jax.device_get(new.batch_stats))
        metrics = {k: float(v) for k, v in metrics.items()}
    for r, out in enumerate(ranks):
        got = out["shard_map"]
        assert_losses(got["metrics"], metrics, f"shard_map rank {r}")
        assert_state_close(got["state"], want, f"shard_map rank {r}")
    stat_keys = [k for k in want if "running" in k]
    assert stat_keys and all(torch.equal(ranks[0]["shard_map"]["state"][k], ranks[1]["shard_map"]["state"][k])
                             for k in stat_keys)


# ---------------------------------------------------------------------------
# e, f. the collectives and data-parallel serving
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def serve_ranks(weights, tmp_path_factory):
    work = tmp_path_factory.mktemp("serve_ranks")
    params, stats = perturbed_variables(3, "HISFCOS", N_CLASSES)
    model = port_model("HISFCOS", params, stats)
    rng = np.random.default_rng(7)
    frames = torch.from_numpy(rng.integers(0, 256, (BATCH, *HW, 3), dtype=np.uint8))
    calib = torch.from_numpy(rng.normal(0.0, 1.0, (2, *HW, 3)).astype(np.float32))
    torch.save({"weights": model.state_dict(), "frames": frames, "calib": calib, "voc_root": VOC_TREE},
               work / "inputs.pt")
    return spawn_ranks("serve", work)


def test_collectives_two_ranks(serve_ranks):
    x = [torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10.0 * r for r in range(2)]
    for r, out in enumerate(serve_ranks):
        assert torch.equal(out["psum"]["a"], x[0] + x[1]) and torch.equal(out["psum"]["b"], torch.full((4,), 3.0))
        assert torch.equal(out["pmean"][0], (x[0] + x[1]) / 2) and torch.equal(out["pmean"][1], torch.full((4,), 1.5))
        assert float(out["metrics"]["total"]) == 1.5 and float(out["metrics"]["cls"]) == 2.0
        mean, var = out["sync_stats"]
        assert torch.equal(mean, (x[0][0] + x[1][0]) / 2) and torch.equal(var, (x[0][1] + 2 * x[1][1]) / 2)
        assert torch.equal(out["gather"], torch.cat(x))
        assert torch.equal(out["gather_bool"], torch.cat(x) > 12.0)
    # replicate_state: rank 1's seed-1 weights became rank 0's seed-0 weights
    want = build_model("HISFCOS", N_CLASSES, FEATURES, device="cpu", generator=torch.Generator().manual_seed(0))
    for out in serve_ranks:
        assert all(torch.equal(v, out["replicated"][k]) for k, v in want.state_dict().items())


def assert_same_detections(got, want, exact: bool, what: str):
    for name, g, w in zip(want._fields, got, want):
        if exact or g.dtype in (torch.bool, torch.int32):
            assert torch.equal(g, w), (what, name)
        else:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=lambda m: f"{what} {name}: {m}")


def test_data_parallel_serving_two_ranks(serve_ranks):
    """Every rank returns what the pipeline alone returns: the default int8
    pipeline exactly, the float one within 1e-5; collect_voc_predictions
    over the VOC tree at B=4 on two ranks exactly the rows of one process
    at B=2, the batch each rank serves (against one process at B=4 one
    score of the 64 moved by an ulp: PyTorch's CPU kernels round a value
    by where the batch puts it in a vector); a batch of 3 on 2 ranks
    raises."""
    for r, out in enumerate(serve_ranks):
        assert_same_detections(out["float"][1], out["float"][0], False, f"float rank {r}")
        assert_same_detections(out["int8"][1], out["int8"][0], True, f"int8 rank {r}")
        assert int(out["int8"][0].valid.sum()) > 0
        alone, meshed = out["voc"]
        assert len(alone[0]) == len(meshed[0]) == 8
        for col_a, col_m in zip(alone, meshed):
            for a, m in zip(col_a, col_m):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(m))
        assert "does not divide" in out["odd_batch_raised"]
    for field in range(4):  # the ranks agree with each other
        assert torch.equal(serve_ranks[0]["int8"][1][field], serve_ranks[1]["int8"][1][field])


# ---------------------------------------------------------------------------
# g. the two-stage pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kw", [("HISFCOS", {}), ("FCOS", {"backbone": "efficientnet-b0"})],
                         ids=["hisfcos", "fcos-efficientnet-b0"])
def test_two_stage_pipeline_matches_jax(name, kw):
    """Three microbatches of 2 through the port's two stages on ("cpu",
    "cpu") against JAX's on two CPU devices at the JAX test's tolerances
    (tests/test_pp.py:44-52), both in f64 (as test b: at f32 the two
    frameworks' forwards sit 2e-5 apart on the scores at this size); and in
    f32 against the port's one-stage pipeline, as the JAX test holds its
    own."""
    from pytorch_object_detection_tpu.parallel.pp import make_two_stage_pipeline as jax_two_stage

    params, stats = perturbed_variables(5, name, N_CLASSES, **kw)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 255, (2, *HW, 3), np.uint8) for _ in range(3)]
    with jax.enable_x64(True):
        jrun = jax_two_stage(jax_model(name, N_CLASSES, **kw), {"params": params, "batch_stats": stats}, STRIDES,
                             HW, devices=jax.devices()[:2], max_detections=64, compute_dtype=jnp.float64)
        want = [[np.asarray(t) for t in det] for det in jrun(batches)]

    model = port_model(name, params, stats, **kw)
    run = make_two_stage_pipeline(model, STRIDES, HW, devices=("cpu", "cpu"), max_detections=64,
                                  compute_dtype=torch.float64)
    assert run.devices == (torch.device("cpu"), torch.device("cpu"))
    assert all(p.device.type == "cpu" and p.dtype == torch.float64
               for m in (run.stage_params[0], *run.stage_params[1]) for p in m.parameters())
    for b, (got, (scores, classes, boxes, valid)) in enumerate(zip(run(batches), want)):
        assert got.scores.device.type == "cpu"
        np.testing.assert_array_equal(got.valid.numpy(), valid, err_msg=f"microbatch {b}")
        np.testing.assert_array_equal(got.classes.numpy(), classes, err_msg=f"microbatch {b}")
        np.testing.assert_allclose(got.scores.numpy(), scores, rtol=1e-5, atol=1e-6, err_msg=f"microbatch {b}")
        np.testing.assert_allclose(got.boxes.numpy(), boxes, rtol=1e-5, atol=1e-4, err_msg=f"microbatch {b}")
    assert sum(int(v.sum()) for *_, v in want) > 0
    run32 = make_two_stage_pipeline(model, STRIDES, HW, devices=("cpu", "cpu"), max_detections=64,
                                    compute_dtype=torch.float32)
    one = make_eval_pipeline(model, STRIDES, HW, max_detections=64, compute_dtype=torch.float32)
    for b, got in enumerate(run32(batches)):
        assert_same_detections(got, one(batches[b]), False, f"one-stage microbatch {b}")


# ---------------------------------------------------------------------------
# h. the train CLI in two processes
# ---------------------------------------------------------------------------
def test_two_process_train_cli(tmp_path):
    """Two ``podt-torch-train --synthetic --steps 2`` processes joined by
    --coordinator/--num-processes/--process-id (JAX's
    tests/test_multiprocess.py:115-154): both exit 0 with the same losses,
    rank 0 alone writes the checkpoint, and one process resumes from it."""
    from torch_port_fixtures import tiny_voc_config

    cfg = tiny_voc_config(tmp_path, "HISFCOS", STRIDES, RANGES)
    with socket.socket() as s:  # a free port for rank 0's store
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "pytorch_object_detection_tpu_torch.cli.train", "--config", cfg, "--device", "cpu",
           "--synthetic", "--steps", "2", "--log-every", "1", "--coordinator", f"127.0.0.1:{port}",
           "--num-processes", "2"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
        assert "training done: step 2" in log, log[-2000:]
        assert "backend gloo" in log
    steps = [[line for line in log.splitlines() if line.startswith("step ")] for log in logs]
    assert len(steps[0]) == 2 and [s.split(" (")[0] for s in steps[0]] == [s.split(" (")[0] for s in steps[1]]
    assert "checkpoint " in logs[0] and "checkpoint " not in logs[1]
    ckpt_dir = tmp_path / "checkpoint" / "hisfcos"
    assert [f.name for f in ckpt_dir.iterdir()] == ["step_00000002.pt"]
    run = run_cli(tmp_path, "train", "--config", cfg, "--device", "cpu", "--synthetic", "--steps", "3",
                  "--log-every", "1000", "--resume", str(ckpt_dir))
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    assert "resumed from" in run.stdout and "at step 2" in run.stdout and "training done: step 3" in run.stdout
