"""One rank of the data-parallel CPU tests (tests/test_torch_port_parallel.py).

    python torch_port_dist_worker.py <case> <rank> <world> <init_url> <dir>

joins a gloo group of ``world`` ranks at ``init_url`` (a ``file://`` store:
parallel test workers must not share a port), reads ``<dir>/inputs.pt``
(written by the test: weights and batches), runs ``case`` and writes
``<dir>/<case>_rank<rank>.pt``.  Cases:

  * ``train``: one step each of the DDP ``make_train_step`` (frozen
    BatchNorms in f32; ``freeze_bn=False`` with ``bn_train`` in f64),
    RetinaNet's ``make_anchor_train_step`` (f32) and
    ``make_shard_map_train_step(bn_train=True)`` (f64) on this rank's shard
    of the batch: the metrics, and the parameters and buffers after the
    step;
  * ``serve``: the collectives on known values, ``replicate_state``, the
    float and the default int8 pipelines with and without the mesh,
    ``collect_voc_predictions`` with and without it over the committed VOC
    tree, and whether a batch that does not divide raises;
  * ``layouts`` (four ranks, tests/test_torch_port_layouts.py): one step
    of HISFCOS(20, 64) from JAX's weights on dp2 x tp2, dp2 x sp2 and sp4
    meshes, each rank's whole state after it held against JAX's step
    (``want``) and its state bytes against ``tp_spec``'s prediction;
  * ``families`` (two ranks): every other family of the train CLI under
    tp2 and sp2 against the one-process step, HISFCOS with ``remat``,
    ``bn_train`` under sp2 in f64, and the tp checkpoints.

Imports no JAX.
"""
from __future__ import annotations

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from pytorch_object_detection_tpu_torch.models.registry import build_model  # noqa: E402
from pytorch_object_detection_tpu_torch.parallel import collectives, mesh as pmesh, sp, tp  # noqa: E402
from pytorch_object_detection_tpu_torch.train import checkpoints, trainer  # noqa: E402

FEATURES = 64
HW = (128, 128)
STRIDES = (8, 16, 32, 64, 128)
SHAPES = [(HW[0] // s, HW[1] // s) for s in STRIDES]
RANGES = [(-1, 32), (32, 96), (96, 192), (192, 384), (384, 9999999)]


def model_from(name: str, weights, freeze_bn: bool = True, frozen_stages: int = 0, dtype=torch.float32):
    model = build_model(name, 20, FEATURES, frozen_stages=frozen_stages, freeze_bn=freeze_bn, device="cpu")
    model.load_state_dict(weights)
    return model.to(dtype)


def after(state, metrics):
    return {"metrics": {k: v.clone() for k, v in metrics.items()},
            "state": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "step": state.step}


def run_train(inp, mesh, rank, world):
    rows = slice(rank * inp["images"].shape[0] // world, (rank + 1) * inp["images"].shape[0] // world)
    batch = pmesh.shard_batch(mesh, (inp["images"][rows], inp["boxes"][rows], inp["labels"][rows]))
    batch64 = (batch[0].double(), *batch[1:])
    out = {}
    # trained statistics in f64, as the test's references (its docstring)
    for case, freeze_bn, dtype in (("frozen", True, torch.float32), ("bn_train", False, torch.float64)):
        model = model_from("HISFCOS", inp["weights"], freeze_bn, 1, dtype)
        state = trainer.create_train_state(model, inp["opt"], freeze_bn=freeze_bn, frozen_stages=1)
        step = trainer.make_train_step(model, SHAPES, STRIDES, RANGES, "giou", torch.float32,
                                       bn_train=not freeze_bn)
        out[case] = after(state, step(state, *(batch if dtype == torch.float32 else batch64)))
    model = model_from("HISFCOS", inp["weights"], False, 1, torch.float64)
    state = trainer.create_train_state(model, inp["opt"], freeze_bn=False, frozen_stages=1)
    step = trainer.make_shard_map_train_step(model, SHAPES, STRIDES, RANGES, mesh, "giou", torch.float32,
                                             bn_train=True)
    out["shard_map"] = after(state, step(state, *batch64))
    from pytorch_object_detection_tpu_torch.ops.anchors import generate_anchors

    model = model_from("RETINANET", inp["retina_weights"])
    state = trainer.create_train_state(model, inp["opt"], freeze_bn=True, frozen_stages=0)
    anchors = generate_anchors(model.level_shapes(HW), STRIDES, device="cpu")
    step = trainer.make_anchor_train_step(model, anchors, 20, torch.float32)
    out["retinanet"] = after(state, step(state, *batch))
    return out


def run_serve(inp, mesh, rank, world):
    from pytorch_object_detection_tpu_torch.data.voc import VOCDataset
    from pytorch_object_detection_tpu_torch.eval.evaluator import (
        DataParallelPipeline,
        collect_voc_predictions,
        make_eval_pipeline,
        make_eval_pipeline_int8,
    )

    out = {}
    # the collectives on values that differ by rank
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10.0 * rank
    grads = {"a": x.clone(), "b": torch.full((4,), float(rank + 1))}
    out["psum"] = {k: v.clone() for k, v in collectives.psum_grads({k: v.clone() for k, v in grads.items()},
                                                                   mesh).items()}
    out["pmean"] = [t.clone() for t in collectives.pmean_grads([t.clone() for t in grads.values()], mesh)]
    out["metrics"] = collectives.pmean_metrics({"total": torch.tensor(float(rank + 1)), "cls": torch.tensor(2.0)},
                                               mesh)
    out["sync_stats"] = collectives.sync_batch_stats(x[0], x[1] * (rank + 1), mesh)
    out["gather"] = collectives.all_gather_rows(x, mesh)
    out["gather_bool"] = collectives.all_gather_rows(x > 12.0, mesh)
    model = build_model("HISFCOS", 20, FEATURES, device="cpu", generator=torch.Generator().manual_seed(rank))
    pmesh.replicate_state(mesh, model)
    out["replicated"] = {k: v.clone() for k, v in model.state_dict().items()}

    # the pipelines, with and without the mesh
    model = model_from("HISFCOS", inp["weights"])
    frames = inp["frames"]
    pipe = make_eval_pipeline(model, STRIDES, HW, max_detections=64, compute_dtype=torch.float32)
    out["float"] = (pipe(frames), DataParallelPipeline(pipe, mesh)(frames))
    ipipe = make_eval_pipeline_int8(model, inp["calib"], STRIDES, HW, max_detections=64, compute_dtype=torch.float32)
    mpipe = make_eval_pipeline_int8(model, inp["calib"], STRIDES, HW, max_detections=64, compute_dtype=torch.float32,
                                    mesh=mesh)
    out["int8"] = (ipipe(frames), mpipe(frames))
    try:
        mpipe(frames[:world + 1])
        out["odd_batch_raised"] = ""
    except ValueError as e:
        out["odd_batch_raised"] = str(e)
    voc = VOCDataset(inp["voc_root"], "test", HW)
    # the reference: one process's whole dataset (without the mesh each rank would load its own half), at
    # the batch each rank serves under the mesh (see the test)
    out["voc"] = (collect_voc_predictions(ipipe, voc, batch_size=2, num_workers=1, process_count=1, process_index=0),
                  collect_voc_predictions(ipipe, voc, batch_size=2 * world, num_workers=1, mesh=mesh))
    return out


def excess(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """max(|got - want| - (atol + rtol |want|)): <= 0 where within; NaN counts as +inf."""
    d = (got.double() - want.double()).abs() - (atol + rtol * want.double().abs())
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    return float(d.max()) if d.numel() else -1.0


def held(whole, want, rtol, atol):
    """{name: excess} of a whole state dict against ``want``."""
    return {k: excess(whole[k], torch.as_tensor(w), rtol, atol) for k, w in want.items() if w.is_floating_point()}


def state_bytes(state, whole_shapes, tp_size):
    """(this rank's bytes of weights and buffers, gradients and optimizer
    state; what ``tp_spec`` predicts for them from the whole shapes)."""
    names = dict(state.model.named_parameters())
    tensors = [(k, v) for k, v in state.model.state_dict().items()]
    tensors += [(n, p.grad) for n, p in names.items() if p.grad is not None]
    by_id = {id(p): n for n, p in names.items()}
    tensors += [(by_id[id(p)], v) for p, st in state.optimizer.state.items() for v in st.values()
                if torch.is_tensor(v) and v.dim()]
    local = sum(v.numel() * v.element_size() for _, v in tensors)
    predicted = 0
    for name, v in tensors:
        whole = whole_shapes[name]
        n = int(torch.Size(whole).numel()) * v.element_size()
        predicted += n // tp_size if tp.tp_spec(whole, tp_size) is not None else n
    return local, predicted


def layout_step(name, weights, opt, batch, mesh, layout, frozen_stages=1, freeze_bn=True, dtype=torch.float32,
                remat=False, step_kw=None):
    """One step of ``name`` from ``weights`` on ``batch`` (this rank's data
    shard, whole rows) under ``layout`` ("tp", "sp" or None: the
    one-process step) over ``mesh``: (metrics, state)."""
    model = model_from(name, weights, freeze_bn, frozen_stages, dtype)
    state = trainer.create_train_state(model, opt, freeze_bn=freeze_bn, frozen_stages=frozen_stages)
    images, boxes, labels = batch
    images, size = images.to(dtype), images.shape[1]
    if layout == "tp":
        tp.shard_state_tp(mesh, state)
    elif layout == "sp":
        images, boxes, labels = sp.shard_batch_spatial(mesh, images, boxes, labels)
    step = make_step(name, model, size, not freeze_bn, remat, mesh if layout else None, **(step_kw or {}))
    return step(state, images, boxes, labels), state


def make_step(name, model, size, bn_train=False, remat=False, mesh=None, strides=STRIDES, ranges=RANGES):
    """The train CLI's step for ``name`` at a square canvas of ``size``."""
    if name in ("RETINANET", "SSD300"):
        if name == "SSD300":
            from pytorch_object_detection_tpu_torch.models.ssd import default_boxes

            return trainer.make_anchor_train_step(model, default_boxes(size, "cpu"), 20, torch.float32, 0.5, 0.5,
                                                  "multibox", bn_train, mesh=mesh)
        from pytorch_object_detection_tpu_torch.ops.anchors import generate_anchors

        anchors = generate_anchors(model.level_shapes((size, size)), STRIDES, device="cpu")
        return trainer.make_anchor_train_step(model, anchors, 20, torch.float32, bn_train=bn_train, mesh=mesh)
    shapes = [(-(-size // s), -(-size // s)) for s in strides]
    return trainer.make_train_step(model, shapes, strides, ranges, "giou", torch.float32, bn_train, remat,
                                   mesh=mesh)


def summary(metrics, state, want_metrics=None, want_state=None, rtol=2e-4, atol=2e-6, frozen=None):
    """What a rank reports of a step: its metrics, the whole state's excess
    over ``want_state``, a digest of the whole state (the ranks agree), and
    whether the tensors of ``frozen`` are still theirs, bit for bit."""
    whole = state.state_dict()["model"]
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "digest": float(sum(v.double().sum() for v in whole.values() if v.is_floating_point()))}
    if frozen is not None:
        out["frozen_exact"] = all(torch.equal(whole[k], v) for k, v in frozen.items())
    if want_state is not None:
        out["excess"] = held(whole, want_state, rtol, atol)
    if want_metrics is not None:
        out["want_metrics"] = {k: float(v) for k, v in want_metrics.items()}
    return out


def run_layouts(inp, mesh, rank, world):
    """dp2 x tp2, dp2 x sp2 and sp4 steps of HISFCOS(20, 64) at 128x128."""
    images, boxes, labels = inp["images"], inp["boxes"], inp["labels"]
    whole_shapes = {k: tuple(v.shape) for k, v in inp["weights"].items()}
    out = {}
    for case, dp, mp, layout, atol in (("dp2xtp2", 2, 2, "tp", 2e-6), ("dp2xsp2", 2, 2, "sp", 1e-5),
                                       ("sp4", 1, 4, "sp", 1e-5)):
        m = pmesh.create_mesh(data_parallel=dp, model_parallel=mp, device_type="cpu")
        d, b = rank // mp, images.shape[0]
        rows = slice(d * b // dp, (d + 1) * b // dp)
        sp.Band.gathers.clear()
        metrics, state = layout_step("HISFCOS", inp["weights"], inp["opt"], (images[rows], boxes[rows], labels[rows]),
                                     m, layout)
        entry = summary(metrics, state, want_state=inp["want"], atol=atol,
                        frozen={k: v for k, v in inp["weights"].items() if k not in inp["trainable"]})
        entry["gathers"] = dict(sp.Band.gathers)
        if layout == "tp":
            entry["bytes"] = state_bytes(state, whole_shapes, mp)
            entry["cls_tower0"] = tuple(state.model.head.cls_tower0.weight.shape)
            entry["cnt_pred"] = tuple(state.model.head.cnt_pred.weight.shape)
        out[case] = entry
    return out


FAMILIES = {  # name, build kwargs, weights' seed, canvas, strides, ranges
    "FCOS": ("FCOS", {}, 10, 128, STRIDES, RANGES),
    "FCOS_B0": ("FCOS", {"backbone": "efficientnet-b0"}, 11, 128, STRIDES, RANGES),
    "MC_FCOS": ("MC_FCOS", {}, 12, 128, (8, 16, 32, 64), [(-1, 64), (64, 128), (128, 256), (256, 99999999)]),
    "MNFCOS": ("MNFCOS", {}, 13, 128, STRIDES, RANGES),
    "RETINANET": ("RETINANET", {}, 14, 128, STRIDES, RANGES),
    "SSD300": ("SSD300", {}, 15, 300, STRIDES, RANGES),
}


def family_step(key, inp, mesh, layout):
    """One step of the family ``key`` (64 features; SSD300 has no width)
    from its seeded weights, under ``layout`` or (None) one process."""
    name, kw, seed, size, strides, ranges = FAMILIES[key]
    model = build_model(name, 20, FEATURES, device="cpu", generator=torch.Generator().manual_seed(seed), **kw)
    state = trainer.create_train_state(model, inp["opt"], freeze_bn=True, frozen_stages=0)
    images, boxes, labels = inp["family_batches"][size]
    if layout == "tp":
        tp.shard_state_tp(mesh, state)
    elif layout == "sp":
        images, boxes, labels = sp.shard_batch_spatial(mesh, images, boxes, labels)
    step = make_step(name, model, size, mesh=mesh if layout else None, strides=strides, ranges=ranges)
    return step(state, images, boxes, labels), state


def adjoint_checks(group, rank):
    """{name: (sum over ranks of <f(x), g>, of <x, f^T(g)>)} for the halo
    exchange and the all-gathers, f^T being autograd's backward, in f64."""
    gen = torch.Generator().manual_seed(100 + rank)
    cases = {"halo_2_1_rows": lambda t: collectives.halo_exchange(t, 2, 1, 2, group),
             "halo_0_3_rows": lambda t: collectives.halo_exchange(t, 0, 3, 2, group),
             "halo_1_1_dim1": lambda t: collectives.halo_exchange(t, 1, 1, 1, group),
             "gather_rows": lambda t: collectives.all_gather_autograd(t, 2, group),
             "gather_channels": lambda t: collectives.all_gather_autograd(t, 1, group)}
    out = {}
    for name, fn in cases.items():
        x = torch.randn(2, 3, 4, 5, dtype=torch.float64, generator=gen, requires_grad=True)
        y = fn(x)
        gy = torch.randn(y.shape, dtype=torch.float64, generator=gen)
        (gx,) = torch.autograd.grad(y, x, gy)
        sums = torch.stack([(y * gy).sum(), (x * gx).sum()]).detach()
        torch.distributed.all_reduce(sums, group=group)
        out[name] = tuple(sums.tolist())
    return out


def run_families(inp, mesh, rank, world):
    """Each family under tp2 and sp2 against the one-process step (in this
    group of two ranks with the same batch: the mean of two equal
    gradients is the one-process gradient, bit for bit), HISFCOS with
    ``remat`` under both, ``bn_train`` under sp2 in f64, the tp checkpoints."""
    m = pmesh.create_mesh(data_parallel=1, model_parallel=world, device_type="cpu")
    out = {"adjoint": adjoint_checks(pmesh.model_group(m), rank)}
    band = torch.arange(4, dtype=torch.float32) + 4 * rank
    out["halo_rows"] = collectives.halo_exchange(band, 1, 1, 0, pmesh.model_group(m)).tolist()
    out["halo_inf"] = collectives.halo_exchange(band, 1, 1, 0, pmesh.model_group(m), float("-inf")).tolist()
    for key in FAMILIES:
        sp.Band.gathers.clear()
        metrics, state = family_step(key, inp, m, None)
        want = state.state_dict()["model"]
        out[key] = {"one": summary(metrics, state)}
        for layout, atol in (("tp", 2e-6), ("sp", 1e-5)):
            sp.Band.gathers.clear()
            metrics_l, state_l = family_step(key, inp, m, layout)
            out[key][layout] = summary(metrics_l, state_l, metrics, want, atol=atol)
            out[key][layout]["gathers"] = dict(sp.Band.gathers)
    batch = inp["batch2"]
    # remat under both layouts: the same step as without it
    for layout in ("tp", "sp"):
        got = [layout_step("HISFCOS", inp["weights"], inp["opt"], batch, m, layout, remat=remat) for remat in
               (False, True)]
        out[f"remat_{layout}"] = summary(*got[1], got[0][0], got[0][1].state_dict()["model"], atol=1e-5)
    # bn_train under sp2, in f64 (the trained statistics amplify f32 sums' order)
    metrics, state = layout_step("HISFCOS", inp["bn_weights"], inp["opt"], batch, m, None, freeze_bn=False,
                                 dtype=torch.float64)
    metrics_l, state_l = layout_step("HISFCOS", inp["bn_weights"], inp["opt"], batch, m, "sp", freeze_bn=False,
                                     dtype=torch.float64)
    out["bn_train_sp"] = summary(metrics_l, state_l, metrics, state.state_dict()["model"])
    # the checkpoints: a one-process one resumed under tp; the tp one written whole, for the test
    workdir = inp["workdir"]
    _, one = layout_step("HISFCOS", inp["weights"], inp["opt"], batch, m, None)
    if rank == 0:
        checkpoints.save_checkpoint(os.path.join(workdir, "one_ckpt"), one)
    torch.distributed.barrier()
    metrics2 = make_step("HISFCOS", one.model, HW[0])(one, *batch)
    if rank == 0:
        checkpoints.save_checkpoint(os.path.join(workdir, "one_ckpt2"), one)
    model = model_from("HISFCOS", inp["weights"], True, 1)
    resumed = tp.shard_state_tp(m, trainer.create_train_state(model, inp["opt"], freeze_bn=True, frozen_stages=1))
    checkpoints.restore_checkpoint(os.path.join(workdir, "one_ckpt"), resumed)
    out["resumed_step"] = resumed.step
    metrics = make_step("HISFCOS", model, HW[0], mesh=m)(resumed, *batch)
    out["resumed_tp"] = summary(metrics, resumed, metrics2, one.state_dict()["model"])
    checkpoints.save_checkpoint(os.path.join(workdir, "tp_ckpt"), resumed)  # every rank: the shards are gathered
    return out


def main(case: str, rank: int, world: int, init_url: str, workdir: str) -> None:
    torch.set_num_threads(1)
    pmesh.initialize_distributed(init_url, world, rank, device="cpu")
    try:
        mesh = pmesh.create_mesh(device_type="cpu")
        inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
        out = {"train": run_train, "serve": run_serve, "layouts": run_layouts,
               "families": run_families}[case](inp, mesh, rank, world)
        torch.save(out, os.path.join(workdir, f"{case}_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
