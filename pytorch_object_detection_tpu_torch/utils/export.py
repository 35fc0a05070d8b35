"""Serving export: the detection pipeline as a ``torch.export`` program.

Counterpart of ``pytorch_object_detection_tpu/utils/export.py``.  Where the
JAX package freezes the jitted normalize -> forward -> decode -> NMS program
into a serialized StableHLO artifact, the port traces its serving pipeline
(``eval/evaluator.make_eval_pipeline`` or ``make_eval_pipeline_int8``) with
``torch.export`` into an ``ExportedProgram``: an ATen graph that runs without
the Python model code.  Every kernel the pipeline launches is a
``torch.library`` op of ``ops/library.py`` (``podt::*``) and one node of the
graph, so the loaded program launches the same hand-written kernels, with
the same launch counters, as the eager pipeline; on the CPU the same nodes
run the plain versions.

A program takes ``[B, H, W, 3]`` uint8 frames on the pipeline's device and
returns ``(scores, classes, boxes, valid)``.  It is tied to the batch, the
canvas and the device of its export, and to the card: the kernels' tiles are
chosen on the host when the graph is traced and recorded in it, as the JAX
artifact is tied to its platform.  Run a program with
``program.module()(frames)``, under ``torch.inference_mode()`` as the eager
pipelines run.  The trace runs under ``torch.no_grad()`` rather than
switching grad mode inside the graph: a grad-mode region becomes a
higher-order op whose body ran every Python frame of the kernels' launches
several times slower on the card (PERF.md §6).
"""
from __future__ import annotations

import copy
from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from pytorch_object_detection_tpu_torch.ops import library

STRIDES = (8, 16, 32, 64, 128)


class _Serving(nn.Module):
    """``forward(frames) -> (scores, classes, boxes, valid)``: the pipeline's
    normalize, forward, f32 cast and decode; a float pipeline's model is a
    submodule, so its weights are the program's state."""

    def __init__(self, pipeline):
        super().__init__()
        if getattr(pipeline, "model", None) is not None:
            # the program's own weights, which need no gradient (kernel B refuses a call autograd would record)
            if any(p.requires_grad for p in pipeline.model.parameters()):
                pipeline = copy.copy(pipeline)
                pipeline.model = copy.deepcopy(pipeline.model).requires_grad_(False)
            self.model = pipeline.model
        self.pipeline = pipeline

    def forward(self, images: torch.Tensor):
        return tuple(self.pipeline._decode(self.pipeline._levels(images)))


class _ServingWeights(nn.Module):
    """``forward(weights, frames)``: the float pipeline with the weights as an
    input, a dict under the model's ``state_dict`` names, cast to the
    compute dtype on each call (the JAX program's ``(params, batch_stats,
    images)``)."""

    def __init__(self, pipeline):
        super().__init__()
        self.pipeline = pipeline

    def forward(self, weights: Dict[str, torch.Tensor], images: torch.Tensor):
        p = self.pipeline
        dtype = p.compute_dtype
        cast = {k: v.to(dtype) if v.is_floating_point() else v for k, v in weights.items()}
        x = p._input(images).to(dtype)
        levels = torch.func.functional_call(p.model, cast, (x,), {"plain": p.plain})
        return tuple(p._decode(tuple([t.float() for t in branch] for branch in levels)))


def export_pipeline(pipeline, batch_size: int) -> torch.export.ExportedProgram:
    """Export a pipeline that ``make_eval_pipeline`` or
    ``make_eval_pipeline_int8`` made (not a device-resize or data-parallel
    one) for ``[batch_size, H, W, 3]`` uint8 frames on its canvas and
    device, its weights and qtree baked in: the same weights as the eager
    pipeline, where a new int8 pipeline would calibrate anew."""
    if getattr(pipeline, "resize", None) is not None or not hasattr(pipeline, "_levels"):
        raise ValueError("an exported program serves one device's canvas frames: no mesh, no device resize")
    frames = torch.zeros((batch_size, *pipeline.canvas_hw, 3), dtype=torch.uint8, device=pipeline.device)
    return _export(_Serving(pipeline), (frames,))


def _export(module: nn.Module, args) -> torch.export.ExportedProgram:
    with torch.no_grad():  # the eager pipelines' inference mode, which a trace does not take
        return torch.export.export(module, args, strict=False)


def export_eval_pipeline(
    model: nn.Module,
    batch_size: int,
    canvas_hw: Tuple[int, int],
    strides: Sequence[int] = STRIDES,
    score_threshold: float = 0.05,
    nms_iou: float = 0.6,
    max_detections: int = 1000,
    bake_weights: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.export.ExportedProgram:
    """Export the float serving pipeline (``make_eval_pipeline``) for
    ``[batch_size, H, W, 3]`` uint8 frames on the model's device.

    With ``bake_weights`` the weights (in ``compute_dtype``) are the
    program's own state and the program takes the frames alone; otherwise
    it takes ``(weights, frames)``, ``weights`` a dict under the model's
    ``state_dict`` names (f32, cast on each call).  The model carries its
    weights, so there is no ``params`` or ``batch_stats`` argument.
    """
    from pytorch_object_detection_tpu_torch.eval.evaluator import make_eval_pipeline

    pipeline = make_eval_pipeline(model, strides, canvas_hw, score_threshold, nms_iou, max_detections,
                                  compute_dtype)
    if bake_weights:
        return export_pipeline(pipeline, batch_size)
    weights = {k: v.detach() for k, v in model.state_dict().items()}
    frames = torch.zeros((batch_size, *canvas_hw, 3), dtype=torch.uint8, device=pipeline.device)
    return _export(_ServingWeights(pipeline), (weights, frames))


def export_eval_pipeline_int8(
    model: nn.Module,
    calib_images: torch.Tensor,
    batch_size: int,
    canvas_hw: Tuple[int, int],
    strides: Sequence[int] = STRIDES,
    score_threshold: float = 0.05,
    nms_iou: float = 0.6,
    max_detections: int = 1000,
    backend: str = "pallas_block",
    nms_impl: str = "auto",
    **options,
) -> torch.export.ExportedProgram:
    """Export the int8-PTQ serving pipeline (``make_eval_pipeline_int8``;
    by default raw uint8 frames through K1, kernel C, K4, K5, K6, K7 (K9 on
    levels of more than 64x64 pixels) and kernel A) for ``[batch_size, H, W,
    3]`` uint8 frames on the model's device.

    The quantized weights are calibrated on ``calib_images`` (NORMALIZED NHWC
    float frames on the model's device) and baked into the program as
    constants: the program is the complete serving binary.  ``options`` go
    to ``make_eval_pipeline_int8`` (``int8_fpn``, ``int8_head``,
    ``fuse_strided``, ``direct_stem``, ``chain_segments``, ``fused_head``,
    ``compute_dtype``); ``mesh`` and ``device_resize`` are not taken.
    """
    from pytorch_object_detection_tpu_torch.eval.evaluator import make_eval_pipeline_int8

    if "mesh" in options or "device_resize" in options:
        raise ValueError("an exported program serves one device's canvas frames: no mesh, no device resize")
    pipeline = make_eval_pipeline_int8(model, calib_images, strides, canvas_hw, score_threshold, nms_iou,
                                       max_detections, backend=backend, nms_impl=nms_impl, **options)
    return export_pipeline(pipeline, batch_size)


def save_exported(exported: torch.export.ExportedProgram, path: str) -> None:
    """Write the program (graph, weights and constants) to ``path``."""
    torch.export.save(exported, path)


def load_exported(path: str) -> torch.export.ExportedProgram:
    """Read a program that :func:`save_exported` wrote; the port's ops are
    defined first, so its ``podt::*`` nodes resolve."""
    library.load_ops()
    return torch.export.load(path)


def op_counts(exported: torch.export.ExportedProgram) -> Dict[str, int]:
    """How many nodes of the program's graphs (its own and any subgraph's) call each ``podt`` op."""
    counts: Dict[str, int] = {}
    for gm in exported.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            if node.op == "call_function" and str(node.target).startswith(f"{library.NAMESPACE}."):
                name = str(node.target).split(".")[1]
                counts[name] = counts.get(name, 0) + 1
    return counts
