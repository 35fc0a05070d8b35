"""Anchor generation and the box codec of the anchor detectors (RetinaNet, SSD300), in PyTorch.

Counterpart of ``pytorch_object_detection_tpu/ops/anchors.py``, operation
for operation: :func:`anchor_shapes` and :func:`generate_anchors` (numpy on
the host, as in JAX, then one move to the caller's device),
:func:`encode_targets` (0.5/0.4 matching, the ignore band at -1, the best
GT by the first argmax over the GT axis), :func:`decode_boxes`,
:func:`decode_anchor_detections` (``"sigmoid"`` or ``"softmax_bg0"``,
applied before the max; the top-k by a stable sort, ties to the lower
index; class-aware NMS on kernel A for CUDA tensors), and the losses
:func:`smooth_l1`, :func:`retinanet_loss` (focal + smooth-L1) and
:func:`multibox_loss` (softmax CE with 3:1 hard-negative mining by the
double argsort, the first one stable).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_object_detection_tpu_torch.ops.boxes import clip_boxes, pairwise_iou
from pytorch_object_detection_tpu_torch.ops.cuda_nms import cuda_batched_class_nms
from pytorch_object_detection_tpu_torch.ops.losses import sigmoid_focal_loss
from pytorch_object_detection_tpu_torch.ops.nms import batched_class_nms
from pytorch_object_detection_tpu_torch.ops.postprocess import Detections

ACTIVATIONS = ("sigmoid", "softmax_bg0")


def anchor_shapes(base_size: float, ratios: Sequence[float] = (0.5, 1.0, 2.0),
                  scales: Sequence[float] = (1.0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0))) -> np.ndarray:
    """``[A, 2]`` (w, h) anchor extents of one level: area ``(base * scale)^2``,
    ``h = sqrt(area / ratio)``, ``w = ratio * h``."""
    out = []
    for r in ratios:
        for s in scales:
            area = (base_size * s) ** 2
            h = np.sqrt(area / r)
            out.append((r * h, h))
    return np.asarray(out, np.float32)


def generate_anchors(level_shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                     sizes: Optional[Sequence[float]] = None, ratios: Sequence[float] = (0.5, 1.0, 2.0),
                     scales: Sequence[float] = (1.0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0)),
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """All levels' anchors ``[sum(H * W * A), 4]`` xyxy f32 on ``device``:
    position first (row-major), then anchor.  Sizes default to ``4 *
    stride`` (RetinaNet's ``2^(l + 2)``); cell centres at ``(i + 0.5) *
    stride``."""
    if sizes is None:
        sizes = [4 * s for s in strides]
    boxes = []
    for (h, w), stride, size in zip(level_shapes, strides, sizes):
        wh = anchor_shapes(size, ratios, scales)
        cx = (np.arange(w, dtype=np.float32) + 0.5) * stride
        cy = (np.arange(h, dtype=np.float32) + 0.5) * stride
        cyy, cxx = np.meshgrid(cy, cx, indexing="ij")
        centers = np.stack([cxx.reshape(-1), cyy.reshape(-1)], -1)
        half = wh / 2.0
        lo = centers[:, None, :] - half[None, :, :]
        hi = centers[:, None, :] + half[None, :, :]
        boxes.append(np.concatenate([lo, hi], -1).reshape(-1, 4))
    return torch.from_numpy(np.concatenate(boxes, axis=0)).to(device)


def _xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    wh = b[..., 2:] - b[..., :2]
    return torch.cat([b[..., :2] + wh / 2.0, wh], dim=-1)


def encode_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_labels: torch.Tensor, pos_iou: float = 0.5,
                   neg_iou: float = 0.4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor targets: anchors ``[N, 4]``, gt_boxes ``[B, M, 4]`` and
    gt_labels ``[B, M]`` (1-based, -1 padded) -> loc targets ``[B, N, 4]``
    (``(dx, dy) / anchor wh``, ``log(wh / anchor wh)``) and cls targets
    ``[B, N]`` int32: the matched label at IoU >= ``pos_iou``, -1 in
    ``[neg_iou, pos_iou)``, 0 below.  Each anchor's GT is the first of its
    largest IoUs."""
    valid_gt = gt_labels > 0
    safe_gt = torch.where(valid_gt[..., None], gt_boxes, torch.zeros_like(gt_boxes))
    iou = pairwise_iou(anchors[None], safe_gt)
    iou = torch.where(valid_gt[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou = iou.amax(dim=-1)
    best_gt = torch.argmax(iou, dim=-1)  # the first maximum, as jnp.argmax

    matched_box = torch.gather(safe_gt, 1, best_gt[..., None].expand(-1, -1, 4))
    a = _xyxy_to_cxcywh(anchors)
    g = _xyxy_to_cxcywh(matched_box)
    a_wh = a[..., 2:].clamp(min=1e-6)
    loc_xy = (g[..., :2] - a[..., :2]) / a_wh
    loc_wh = torch.log(g[..., 2:].clamp(min=1e-6) / a_wh)
    loc = torch.cat([loc_xy, loc_wh], dim=-1)

    matched_label = torch.gather(gt_labels, 1, best_gt)
    cls = torch.where(best_iou >= pos_iou, matched_label, torch.zeros_like(matched_label))
    cls = torch.where((best_iou >= neg_iou) & (best_iou < pos_iou), torch.full_like(cls, -1), cls)
    return loc, cls.to(torch.int32)


def decode_boxes(anchors: torch.Tensor, loc_preds: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`encode_targets`: xyxy boxes."""
    a = _xyxy_to_cxcywh(anchors)
    xy = loc_preds[..., :2] * a[..., 2:] + a[..., :2]
    wh = torch.exp(loc_preds[..., 2:]) * a[..., 2:]
    return torch.cat([xy - wh / 2.0, xy + wh / 2.0], dim=-1)


def decode_anchor_detections(anchors: torch.Tensor, loc_preds: torch.Tensor, cls_logits: torch.Tensor,
                             activation: str = "sigmoid", score_threshold: float = 0.05, nms_iou: float = 0.5,
                             max_detections: int = 300, image_hw: Optional[Tuple[int, int]] = None,
                             plain: bool = False) -> Detections:
    """Batched decode of an anchor detector: loc_preds ``[B, N, 4]``,
    cls_logits ``[B, N, C]``.  ``"sigmoid"`` (RetinaNet: C foreground
    classes) or ``"softmax_bg0"`` (SSD: class 0 is the background, dropped)
    turns the logits into probabilities BEFORE the max and the first argmax
    (where sigmoid saturates, two logits give one probability and the first
    class wins, as in JAX).  The top ``min(max_detections, N)`` by a stable
    sort (``jax.lax.top_k``'s order: ties keep the lower index first),
    boxes decoded and clipped to ``image_hw``, then class-aware NMS: kernel
    A on CUDA tensors (its plain version on the CPU, or with
    ``plain=True``)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}; got {activation!r}")
    if activation == "softmax_bg0":
        probs = torch.softmax(cls_logits, dim=-1)[..., 1:]
    else:
        probs = torch.sigmoid(cls_logits)
    score = probs.max(dim=-1).values
    classes = torch.argmax(probs, dim=-1).to(torch.int32) + 1

    boxes = decode_boxes(anchors, loc_preds)
    k = min(max_detections, score.shape[-1])
    neg, order = torch.sort(-score, dim=1, stable=True)
    top_idx = order[:, :k]
    top_scores = -neg[:, :k]
    top_classes = torch.gather(classes, 1, top_idx)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    if image_hw is not None:
        top_boxes = clip_boxes(top_boxes, image_hw[0], image_hw[1])
    valid = top_scores >= score_threshold
    nms = batched_class_nms if plain else cuda_batched_class_nms
    keep = nms(top_boxes, top_scores, top_classes, valid, nms_iou)
    return Detections(top_scores, top_classes, top_boxes, keep)


def smooth_l1(x: torch.Tensor, beta: float = 1.0 / 9.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def retinanet_loss(cls_logits: torch.Tensor, loc_preds: torch.Tensor, cls_targets: torch.Tensor,
                   loc_targets: torch.Tensor, num_classes: int, gamma: float = 2.0,
                   alpha: float = 0.25) -> Dict[str, torch.Tensor]:
    """Focal classification over the anchors outside the ignore band and
    smooth-L1 (beta 1/9) on the positives, each a per-image sum over the
    positive count (at least 1), then the batch mean."""
    pos = cls_targets > 0
    considered = cls_targets >= 0
    num_pos = pos.sum(dim=1).clamp(min=1).float()
    classes = torch.arange(1, num_classes + 1, dtype=cls_targets.dtype, device=cls_targets.device)
    onehot = (classes[None, None, :] == cls_targets[..., None]).float()
    focal = sigmoid_focal_loss(cls_logits, onehot, gamma, alpha)
    zero = torch.zeros((), device=cls_logits.device)
    cls_loss = (torch.where(considered[..., None], focal, zero).sum(dim=(1, 2)) / num_pos).mean()
    reg_elem = smooth_l1(loc_preds - loc_targets).sum(dim=-1)
    reg_loss = (torch.where(pos, reg_elem, zero).sum(dim=1) / num_pos).mean()
    return {"cls": cls_loss, "reg": reg_loss, "total": cls_loss + reg_loss}


def multibox_loss(cls_logits: torch.Tensor, loc_preds: torch.Tensor, cls_targets: torch.Tensor,
                  loc_targets: torch.Tensor, neg_pos_ratio: float = 3.0) -> Dict[str, torch.Tensor]:
    """SSD's MultiBox loss: softmax CE (class 0 the background) on the
    positives and the hardest ``neg_pos_ratio * num_pos`` negatives of each
    image, smooth-L1 (beta 1) on the positives, both over the positive
    count (at least 1), then the batch mean.  The negatives are ranked by a
    stable sort of their CE, descending (JAX's ``argsort`` of ``-ce``: among
    equal CE the lower index ranks first), so the gradient reaches the same
    anchors."""
    pos = cls_targets > 0
    neg = cls_targets == 0
    num_pos = pos.sum(dim=1)
    denom = num_pos.clamp(min=1).float()

    logp = F.log_softmax(cls_logits, dim=-1)
    tgt = cls_targets.clamp(0, cls_logits.shape[-1] - 1).long()
    ce = -torch.gather(logp, -1, tgt[..., None])[..., 0]

    neg_ce = torch.where(neg, ce.detach(), torch.full_like(ce, -float("inf")))
    order = torch.sort(-neg_ce, dim=1, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(order.shape[1], device=order.device).expand_as(order).contiguous())
    num_neg = torch.minimum((neg_pos_ratio * num_pos.float()).to(torch.int32), neg.sum(dim=1).to(torch.int32))
    keep_neg = neg & (rank < num_neg[:, None])

    zero = torch.zeros((), device=cls_logits.device)
    cls_loss = (torch.where(pos | keep_neg, ce, zero).sum(dim=1) / denom).mean()
    reg_elem = smooth_l1(loc_preds - loc_targets, beta=1.0).sum(dim=-1)
    reg_loss = (torch.where(pos, reg_elem, zero).sum(dim=1) / denom).mean()
    return {"cls": cls_loss, "reg": reg_loss, "total": cls_loss + reg_loss}
