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
    tree, and whether a batch that does not divide raises.

Imports no JAX.
"""
from __future__ import annotations

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from pytorch_object_detection_tpu_torch.models.registry import build_model  # noqa: E402
from pytorch_object_detection_tpu_torch.parallel import collectives, mesh as pmesh  # noqa: E402
from pytorch_object_detection_tpu_torch.train import trainer  # noqa: E402

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


def main(case: str, rank: int, world: int, init_url: str, workdir: str) -> None:
    torch.set_num_threads(1)
    pmesh.initialize_distributed(init_url, world, rank, device="cpu")
    try:
        mesh = pmesh.create_mesh(device_type="cpu")
        inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
        out = {"train": run_train, "serve": run_serve}[case](inp, mesh, rank, world)
        torch.save(out, os.path.join(workdir, f"{case}_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
