"""Plain FCOS decode and class-aware greedy NMS.

The decode follows the FCOS paper's test procedure as the served pipeline
states it: ``score = sqrt(sigmoid(max cls) * sigmoid(cnt))``, the class
the first arg-max (1-based), the ``max_detections`` best locations by a
stable sort, the box ``centre -/+ ltrb`` clipped to the canvas, valid where
the score reaches the threshold.  NMS is the textbook greedy loop, one
image and one class at a time, on the host in float64.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def decode(cls_l: Sequence[torch.Tensor], cnt_l: Sequence[torch.Tensor], reg_l: Sequence[torch.Tensor],
           strides: Sequence[int], score_threshold: float, max_detections: int,
           canvas_hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
    """Per-level NHWC maps -> the ``max_detections`` best locations an
    image: ``scores``, ``classes``, ``boxes``, ``valid`` (before NMS)."""
    b = cls_l[0].shape[0]
    coords = []
    for t, s in zip(cls_l, strides):
        h, w = t.shape[1:3]
        ys, xs = torch.meshgrid(torch.arange(h, device=t.device), torch.arange(w, device=t.device), indexing="ij")
        coords.append(torch.stack([xs.reshape(-1) * s + s // 2, ys.reshape(-1) * s + s // 2], -1).float())
    coords = torch.cat(coords)
    cls = torch.cat([t.reshape(b, -1, t.shape[-1]) for t in cls_l], 1)
    cnt = torch.cat([t.reshape(b, -1) for t in cnt_l], 1)
    reg = torch.cat([t.reshape(b, -1, 4) for t in reg_l], 1)
    best, arg = cls.max(-1)
    score_sq = torch.sigmoid(best) * torch.sigmoid(cnt)
    k = min(max_detections, score_sq.shape[1])
    order = torch.sort(-score_sq, dim=1, stable=True).indices[:, :k]
    scores = torch.sqrt(torch.gather(score_sq, 1, order))
    classes = torch.gather(arg, 1, order).to(torch.int32) + 1
    ltrb = torch.gather(reg, 1, order[..., None].expand(-1, -1, 4))
    c = coords[order]
    boxes = torch.cat([c - ltrb[..., :2], c + ltrb[..., 2:]], -1)
    h, w = canvas_hw
    boxes = torch.stack([boxes[..., 0].clamp(0, w - 1), boxes[..., 1].clamp(0, h - 1),
                         boxes[..., 2].clamp(0, w - 1), boxes[..., 3].clamp(0, h - 1)], -1)
    return {"scores": scores, "classes": classes, "boxes": boxes, "valid": scores >= score_threshold}


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of xyxy boxes ``[N, 4] x [M, 4] -> [N, M]`` (no +1 pixel)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.where(union > 0, union, 1.0)


def greedy_nms(boxes: np.ndarray, classes: np.ndarray, valid: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Keep mask of one image's score-sorted detections: a valid box is kept
    unless a kept box of its class earlier in the order overlaps it by more
    than ``iou_threshold``."""
    keep = np.zeros(len(boxes), bool)
    boxes = boxes.astype(np.float64)
    for c in np.unique(classes[valid]):
        idx = np.nonzero(valid & (classes == c))[0]
        iou = iou_matrix(boxes[idx], boxes[idx])
        alive = np.ones(len(idx), bool)
        for i in range(len(idx)):
            if alive[i]:
                keep[idx[i]] = True
                alive[i + 1:] &= iou[i, i + 1:] <= iou_threshold
    return keep


def detections(maps, strides: Sequence[int], score_threshold: float, nms_iou: float, max_detections: int,
               canvas_hw: Tuple[int, int]) -> List[Dict[str, np.ndarray]]:
    """Per-level maps -> one dict of host arrays an image: the kept
    detections' ``scores``, ``classes``, ``boxes``, best first."""
    d = {k: v.cpu().numpy() for k, v in decode(*maps, strides, score_threshold, max_detections, canvas_hw).items()}
    out = []
    for i in range(len(d["scores"])):
        keep = greedy_nms(d["boxes"][i], d["classes"][i], d["valid"][i], nms_iou)
        out.append({k: d[k][i][keep] for k in ("scores", "classes", "boxes")})
    return out
