"""Box and coordinate math for FCOS-style dense detection (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/ops/boxes.py``, operation for
operation, so that the port's decode and NMS round exactly as the JAX ones.

``ltrb_iou`` and ``ltrb_giou`` are the regression loss's overlaps in ltrb-offset
space.

Conventions: boxes are ``(x1, y1, x2, y2)`` in image pixels, float32; grid
coords are ``(x, y)`` cell centres; per-level maps are flattened NHWC
row-major (y outer, x inner).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def level_coords(h: int, w: int, stride: int, device: Optional[torch.device] = None) -> torch.Tensor:
    """Grid-cell centres for one level, ``[h*w, 2]`` as (x, y), row-major:
    ``x = arange(w) * stride + stride // 2``."""
    xs = torch.arange(w, dtype=torch.float32, device=device) * stride + stride // 2
    ys = torch.arange(h, dtype=torch.float32, device=device) * stride + stride // 2
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


def all_level_coords(level_shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """Concatenated grid coords over all levels, ``[sum(h*w), 2]``."""
    return torch.cat(
        [level_coords(h, w, s, device) for (h, w), s in zip(level_shapes, strides)], dim=0)


def clip_boxes(boxes: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Clamp xyxy boxes into ``[0, w-1] x [0, h-1]``."""
    x1 = boxes[..., 0].clamp(0.0, width - 1)
    y1 = boxes[..., 1].clamp(0.0, height - 1)
    x2 = boxes[..., 2].clamp(0.0, width - 1)
    y2 = boxes[..., 3].clamp(0.0, height - 1)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes, ``[..., N, 4] x [..., M, 4] -> [..., N, M]``.

    Raw coordinates, no +1 pixel; areas unclamped; ``inter / union`` with a
    non-positive union replaced by 1.  Kernel A (csrc/nms.cu) repeats these
    operations in this order.
    """
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    overlap = wh[..., 0] * wh[..., 1]
    area_a = (boxes_a[..., 2] - boxes_a[..., 0]) * (boxes_a[..., 3] - boxes_a[..., 1])
    area_b = (boxes_b[..., 2] - boxes_b[..., 0]) * (boxes_b[..., 3] - boxes_b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - overlap
    return overlap / torch.where(union > 0, union, torch.ones_like(union))


def ltrb_iou(preds: torch.Tensor, targets: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """IoU of two ltrb offset sets measured from the same grid point,
    elementwise over the last axis (``[..., 4]`` -> ``[...]``); a zero union
    is replaced by ``eps``."""
    lt = torch.minimum(preds[..., :2], targets[..., :2])
    rb = torch.minimum(preds[..., 2:], targets[..., 2:])
    wh = (lt + rb).clamp(min=0.0)
    overlap = wh[..., 0] * wh[..., 1]
    area_p = (preds[..., 0] + preds[..., 2]) * (preds[..., 1] + preds[..., 3])
    area_t = (targets[..., 0] + targets[..., 2]) * (targets[..., 1] + targets[..., 3])
    union = area_p + area_t - overlap
    return overlap / torch.where(union != 0, union, torch.full_like(union, eps))


def ltrb_giou(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """GIoU of two ltrb offset sets, elementwise; a zero union is replaced
    by 1e-10 and the enclosing area floored at 1e-10."""
    lt_min = torch.minimum(preds[..., :2], targets[..., :2])
    rb_min = torch.minimum(preds[..., 2:], targets[..., 2:])
    wh_min = (lt_min + rb_min).clamp(min=0.0)
    overlap = wh_min[..., 0] * wh_min[..., 1]
    area_p = (preds[..., 0] + preds[..., 2]) * (preds[..., 1] + preds[..., 3])
    area_t = (targets[..., 0] + targets[..., 2]) * (targets[..., 1] + targets[..., 3])
    union = area_p + area_t - overlap
    iou = overlap / torch.where(union != 0, union, torch.full_like(union, 1e-10))
    lt_max = torch.maximum(preds[..., :2], targets[..., :2])
    rb_max = torch.maximum(preds[..., 2:], targets[..., 2:])
    wh_max = (lt_max + rb_max).clamp(min=0.0)
    g_area = wh_max[..., 0] * wh_max[..., 1]
    return iou - (g_area - union) / g_area.clamp(min=1e-10)
