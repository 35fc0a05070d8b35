"""Fixed-shape greedy NMS, plain PyTorch version.

Counterpart of ``pytorch_object_detection_tpu/ops/nms.py``: the keep mask is
the fixpoint of ``keep[j] = valid[j] and no kept i < j has IoU(i, j) > t``
over score-sorted boxes, class-aware through one coordinate offset per
class.  This is the plain version of kernel A (``ops/cuda_nms.py``): the CPU
path, and the reference the kernel is held to on the card.  The fixpoint
stops on a data-dependent test, which a tracer cannot follow, so while one
runs :func:`nms_keep_mask` goes through the op ``podt::nms_fixpoint``, the
same loop on the CPU and on the card (``ops/library.py``).
"""
from __future__ import annotations

import torch

from pytorch_object_detection_tpu_torch.ops import library
from pytorch_object_detection_tpu_torch.ops.boxes import pairwise_iou


def nms_keep_mask(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep mask by fixpoint iteration (:func:`fixpoint_keep_mask`;
    ``podt::nms_fixpoint`` while a tracer runs)."""
    if library.tracing(boxes):
        return nms_fixpoint_op(boxes, valid, float(iou_threshold))
    return fixpoint_keep_mask(boxes, valid, iou_threshold)


def fixpoint_keep_mask(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep mask by fixpoint iteration.

    boxes ``[..., K, 4]`` sorted by descending score; valid ``[..., K]``
    bool.  Invalid boxes are never kept and so never suppress.  The keep
    prefix stabilises monotonically (position j depends only on positions
    < j), so at most K iterations reach the exact greedy result.
    """
    k = boxes.shape[-2]
    iou = pairwise_iou(boxes, boxes)
    idx = torch.arange(k, device=boxes.device)
    overlaps = (iou > iou_threshold) & (idx[:, None] < idx[None, :])  # i suppresses j
    keep = valid
    for _ in range(k):
        suppressed = (keep[..., :, None] & overlaps).any(dim=-2)
        new_keep = valid & ~suppressed
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    return keep


nms_fixpoint_op = library.define(
    "nms_fixpoint", "(Tensor boxes, Tensor valid, float iou_threshold) -> Tensor",
    cpu=fixpoint_keep_mask, cuda=None,
    fake=lambda boxes, valid, iou_threshold: library.empty_like_shape(valid, valid.shape, torch.bool))


def class_offset_boxes(boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Shift each box by ``class * (max_coord + 1)`` so that boxes of
    different classes never overlap.  ``max_coord`` is the largest
    coordinate of any valid box in the WHOLE batch, as in the JAX package."""
    max_coord = torch.where(valid[..., None], boxes, torch.zeros_like(boxes)).max()
    offsets = classes.to(boxes.dtype) * (max_coord + 1.0)
    return boxes + offsets[..., None]


def batched_class_nms(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                      valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Class-aware NMS keep mask ``[..., K]`` (plain fixpoint).  ``scores``
    is unused, as in the JAX package: the boxes arrive sorted by it."""
    del scores
    return nms_keep_mask(class_offset_boxes(boxes, classes, valid), valid, iou_threshold)
