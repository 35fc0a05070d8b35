"""FCOS training-target assignment (PyTorch), on the boxes' device.

Counterpart of ``pytorch_object_detection_tpu/ops/targets.py``, operation
for operation:

  * positives are locations whose ltrb offsets to a GT are all > 0 (inside
    the box), whose largest offset falls in the level's limit range, and
    whose Chebyshev distance to the GT centre is below ``stride * radius``
    (centre sampling);
  * a location inside several GTs takes the one of least area
    (``argmin``, ties to the first GT);
  * centerness is ``sqrt(min(l, r) * min(t, b) / (max(l, r) * max(t, b)))``;
  * negatives get class 0 and ``-1`` for centerness and regression (the
    loss masks on ``cnt > -1``).

GT boxes and labels arrive padded to a fixed count with ``-1``; a padded GT
never assigns, since its ``r = x2 - x`` offset is negative.  Shapes are
fixed by the level shapes, so the targets run inside the train step with
no host round trip.  The ``[B, HW, M, 4]`` offsets are the largest tensor:
about 67 MB at P3 of a 512x512 canvas, B=16, M=64.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from pytorch_object_detection_tpu_torch.ops.boxes import level_coords

_INF_AREA = 99999999.0


class FCOSTargets(NamedTuple):
    """Targets concatenated over levels.

    cls: ``[B, N, 1]`` class index (1-based; 0 = background), the labels' dtype
    cnt: ``[B, N, 1]`` float32 centerness in [0, 1], ``-1`` for negatives
    reg: ``[B, N, 4]`` float32 ltrb offsets, ``-1`` for negatives
    """

    cls: torch.Tensor
    cnt: torch.Tensor
    reg: torch.Tensor


def generate_level_targets(hw: Tuple[int, int], stride: int, limit_range: Tuple[float, float],
                           gt_boxes: torch.Tensor, gt_labels: torch.Tensor, radius: float = 1.5) -> FCOSTargets:
    """Targets for one pyramid level; ``gt_boxes [B, M, 4]`` xyxy and
    ``gt_labels [B, M]`` (1-based), both padded with -1."""
    h, w = hw
    coords = level_coords(h, w, stride, gt_boxes.device)  # [HW, 2]
    x = coords[:, 0][None, :, None]  # [1, HW, 1]
    y = coords[:, 1][None, :, None]
    x1 = gt_boxes[..., 0][:, None, :]  # [B, 1, M]
    y1 = gt_boxes[..., 1][:, None, :]
    x2 = gt_boxes[..., 2][:, None, :]
    y2 = gt_boxes[..., 3][:, None, :]

    left = x - x1  # [B, HW, M]
    top = y - y1
    right = x2 - x
    bottom = y2 - y
    offsets = torch.stack([left, top, right, bottom], dim=-1)  # [B, HW, M, 4]

    area = (left + right) * (top + bottom)
    off_min = offsets.amin(dim=-1)
    off_max = offsets.amax(dim=-1)
    mask_in_box = off_min > 0
    mask_level = (off_max > limit_range[0]) & (off_max <= limit_range[1])
    cx = (x1 + x2) / 2.0
    cy = (y1 + y2) / 2.0
    c_off_max = torch.maximum((x - cx).abs(), (y - cy).abs()).clamp(min=0.0)
    mask_center = c_off_max < stride * radius
    mask_pos = mask_in_box & mask_level & mask_center  # [B, HW, M]

    area_masked = torch.where(mask_pos, area, torch.full_like(area, _INF_AREA))
    assign = area_masked.argmin(dim=-1)  # [B, HW], ties to the first GT
    reg = offsets.gather(2, assign[..., None, None].expand(-1, -1, 1, 4))[:, :, 0, :]
    cls = gt_labels.gather(1, assign)  # [B, HW]

    lr_min = torch.minimum(reg[..., 0], reg[..., 2])
    lr_max = torch.maximum(reg[..., 0], reg[..., 2])
    tb_min = torch.minimum(reg[..., 1], reg[..., 3])
    tb_max = torch.maximum(reg[..., 1], reg[..., 3])
    cnt = torch.sqrt((lr_min * tb_min).clamp(min=0.0) / (lr_max * tb_max + 1e-10))

    has_pos = mask_pos.any(dim=-1)  # [B, HW]
    cls = torch.where(has_pos, cls, torch.zeros_like(cls))
    cnt = torch.where(has_pos, cnt, torch.full_like(cnt, -1.0))
    reg = torch.where(has_pos[..., None], reg, torch.full_like(reg, -1.0))
    return FCOSTargets(cls[..., None], cnt[..., None].float(), reg)


def generate_targets(level_shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                     limit_ranges: Sequence[Tuple[float, float]], gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                     radius: float = 1.5) -> FCOSTargets:
    """Targets concatenated over all pyramid levels, in level order."""
    if not len(level_shapes) == len(strides) == len(limit_ranges):
        raise ValueError(f"{len(level_shapes)} level shapes, {len(strides)} strides, {len(limit_ranges)} ranges")
    per_level = [generate_level_targets(hw, s, r, gt_boxes, gt_labels, radius)
                 for hw, s, r in zip(level_shapes, strides, limit_ranges)]
    return FCOSTargets(*(torch.cat([getattr(t, f) for t in per_level], dim=1) for f in FCOSTargets._fields))
