"""The traffic generator: seeded frames and boxes, made on the device.

Every cell's frames come from one description in its workload file
(``frames``): a smooth background (uniform noise at ``1/bg_cell`` of the
canvas, upsampled bilinearly), ``rects`` filled rectangles a frame whose
sides are log-uniform in ``rect_px``, and pixel noise of
``pixel_noise`` grey levels.  The rectangles are the training boxes, each
with a class drawn uniformly; a frame's box list is padded with ``-1`` to
``max_boxes``.  Every seed draws the same number of frames, rectangles
and boxes: only their places, sizes and colours change.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)  # ImageNet statistics, the configurations' input normalization
STD = (0.229, 0.224, 0.225)


def frames(g: torch.Generator, n: int, canvas_hw: Tuple[int, int], spec: dict, num_classes: int,
           device: torch.device):
    """``n`` uint8 frames ``[n, H, W, 3]``, their boxes ``[n, max_boxes, 4]``
    (xyxy, float32) and labels ``[n, max_boxes]`` (int64, 1-based; ``-1``
    pads)."""
    h, w = canvas_hw
    cell = spec["bg_cell"]
    bg = torch.rand(n, 3, max(h // cell, 1), max(w // cell, 1), generator=g, device=device)
    img = F.interpolate(bg, size=(h, w), mode="bilinear", align_corners=False) * 255.0
    k = spec["rects"]
    lo, hi = (float(v) for v in spec["rect_px"])
    log_lo, log_hi = torch.log(torch.tensor(lo)), torch.log(torch.tensor(hi))
    u = torch.rand(n, k, 5, generator=g, device=device)
    bw = torch.exp(log_lo + (log_hi - log_lo) * u[..., 0]).clamp(max=w - 2)
    bh = torch.exp(log_lo + (log_hi - log_lo) * u[..., 1]).clamp(max=h - 2)
    x1 = torch.floor(u[..., 2] * (w - 1 - bw))
    y1 = torch.floor(u[..., 3] * (h - 1 - bh))
    boxes = torch.stack([x1, y1, x1 + torch.ceil(bw), y1 + torch.ceil(bh)], -1)
    colour = torch.rand(n, k, 3, generator=g, device=device) * 255.0
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    for j in range(k):  # later rectangles cover earlier ones
        b = boxes[:, j]
        inside = ((xs >= b[:, 0, None, None]) & (xs < b[:, 2, None, None]) & (ys >= b[:, 1, None, None])
                  & (ys < b[:, 3, None, None]))
        img = torch.where(inside[:, None], colour[:, j, :, None, None], img)
    img = img + torch.randn(img.shape, generator=g, device=device) * spec["pixel_noise"]
    u8 = img.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    labels = torch.randint(1, num_classes + 1, (n, k), generator=g, device=device)
    pad = spec["max_boxes"] - k
    boxes = torch.cat([boxes, torch.full((n, pad, 4), -1.0, device=device)], 1)
    labels = torch.cat([labels, torch.full((n, pad), -1, device=device, dtype=labels.dtype)], 1)
    return u8, boxes, labels


def normalize(u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> ``(x / 255 - mean) / std`` in float32."""
    mean = torch.tensor(MEAN, device=u8.device)
    std = torch.tensor(STD, device=u8.device)
    return (u8.float() / 255.0 - mean) / std
