"""FCOS detection decode: scores, classes, boxes, top-k, NMS (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/ops/postprocess.py`` on its
sort-carried branch.  Outputs have a fixed shape ``[B, K]`` with a validity
mask.  ``score = sqrt(sigmoid(max cls) * sigmoid(cnt))``; class = first
argmax + 1; the top-k is a stable sort of ``-score^2`` (ties: smallest flat
index first); boxes are rebuilt from the flat index.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from pytorch_object_detection_tpu_torch.ops.boxes import clip_boxes, ltrb_to_boxes
from pytorch_object_detection_tpu_torch.ops.cuda_nms import cuda_batched_class_nms
from pytorch_object_detection_tpu_torch.ops.nms import batched_class_nms


NMS_IMPLS = ("auto", "pallas", "fixpoint")


def resolve_nms_impl(nms_impl: str, device: torch.device) -> str:
    """The NMS that ``nms_impl`` names on ``device``: ``"pallas"`` (kernel A,
    ``ops/cuda_nms.py``) or ``"fixpoint"`` (the plain greedy NMS,
    ``ops/nms.py``).  ``"auto"`` is kernel A on CUDA and the plain NMS on the
    CPU; ``"pallas"`` on the CPU raises ``ValueError``.  The argument is the
    switch: the JAX function's environment override ``PODT_NMS`` is not
    read, as the port reads no ``PODT_*`` switch."""
    if nms_impl not in NMS_IMPLS:
        raise ValueError(f"nms_impl must be one of {NMS_IMPLS}; got {nms_impl!r}")
    if nms_impl == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "fixpoint"
    if nms_impl == "pallas" and torch.device(device).type != "cuda":
        raise ValueError(f"nms_impl='pallas' is kernel A, a CUDA kernel: it does not run on {device}")
    return nms_impl


class Detections(NamedTuple):
    """Fixed-size batched detections, sorted by descending score.

    scores ``[B, K]``, classes ``[B, K]`` int32 (1-based), boxes
    ``[B, K, 4]`` xyxy, valid ``[B, K]`` bool (survived threshold + NMS).
    """

    scores: torch.Tensor
    classes: torch.Tensor
    boxes: torch.Tensor
    valid: torch.Tensor


def flatten_level_preds(preds: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concat per-level NHWC predictions to ``[B, sum(H*W), C]`` (row-major:
    y outer, x inner, as the grid coordinates)."""
    b = preds[0].shape[0]
    c = preds[0].shape[-1]
    return torch.cat([p.reshape(b, -1, c) for p in preds], dim=1)


def decode_detections(
    cls_levels: Sequence[torch.Tensor],
    cnt_levels: Sequence[torch.Tensor],
    reg_levels: Sequence[torch.Tensor],
    strides: Sequence[int],
    score_threshold: float = 0.05,
    nms_iou: float = 0.6,
    max_detections: int = 1000,
    image_hw: Optional[Tuple[int, int]] = None,
    plain: bool = False,
) -> Detections:
    """Decode per-level NHWC head outputs into final detections.

    cls_levels[i] ``[B, H_i, W_i, C]`` logits; cnt ``[..., 1]``; reg
    ``[..., 4]`` ltrb distances.  ``image_hw`` clips boxes to the image.
    NMS runs kernel A on CUDA tensors (its plain version on the CPU);
    ``plain=True`` runs the plain version on any device and exists only to
    compare the two.
    """
    level_shapes = [tuple(p.shape[1:3]) for p in cls_levels]
    cls_logits = flatten_level_preds(cls_levels)  # [B, N, C]
    cnt_logits = flatten_level_preds(cnt_levels)  # [B, N, 1]
    reg_preds = flatten_level_preds(reg_levels)  # [B, N, 4]

    # sigmoid is monotone: max/argmax commute with it
    cls_score = torch.sigmoid(cls_logits.max(dim=-1).values)  # [B, N]
    cls_class = torch.argmax(cls_logits, dim=-1).to(torch.int32) + 1  # first index, 1-based
    score_sq = cls_score * torch.sigmoid(cnt_logits[..., 0])

    k = min(max_detections, score_sq.shape[-1])
    # stable sort of -score^2 == the JAX package's lax.sort(is_stable=True):
    # ties keep the smallest flat index first (torch.topk promises no order)
    neg_sq, order = torch.sort(-score_sq, dim=1, stable=True)
    top_idx = order[:, :k]
    top_scores = torch.sqrt(-neg_sq[:, :k])
    top_classes = torch.gather(cls_class, 1, top_idx)
    top_reg = torch.gather(reg_preds, 1, top_idx[..., None].expand(-1, -1, 4))
    # grid-centre coords from the flat index (exact in f32)
    cx = torch.zeros_like(top_scores)
    cy = torch.zeros_like(top_scores)
    start = 0
    for (h, w), s in zip(level_shapes, strides):
        j = top_idx - start
        in_level = (top_idx >= start) & (j < h * w)
        cx = torch.where(in_level, (j % w).to(torch.float32) * s + s // 2, cx)
        cy = torch.where(in_level, torch.div(j, w, rounding_mode="floor").to(torch.float32) * s + s // 2, cy)
        start += h * w
    top_boxes = ltrb_to_boxes(torch.stack([cx, cy], dim=-1), top_reg)
    if image_hw is not None:
        top_boxes = clip_boxes(top_boxes, image_hw[0], image_hw[1])

    valid = top_scores >= score_threshold
    nms = batched_class_nms if plain else cuda_batched_class_nms
    keep = nms(top_boxes, top_scores, top_classes, valid, nms_iou) & valid
    return Detections(top_scores, top_classes, top_boxes, keep)
