"""Synthetic detection batches (the port's ``data/synthetic.py``).

The JAX ``synthetic_batch``'s layout and distributions, drawn from a
``torch.Generator`` on the generator's device: NHWC float images in [0, 1),
GT boxes padded to ``max_boxes`` with ``-1``, 1-based int32 labels padded
with ``-1``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def synthetic_batch(generator: torch.Generator, batch_size: int = 8, hw: Tuple[int, int] = (512, 512),
                    num_classes: int = 20, max_boxes: int = 32,
                    mean_boxes: int = 6) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(images [B, H, W, 3] f32, boxes [B, max_boxes, 4] f32, labels [B,
    max_boxes] int32)`` on ``generator.device``: between 1 and ``min(2 *
    mean_boxes, max_boxes)`` boxes an image, centres in the middle 80 % of
    the canvas, sides 5-50 % of it, clipped to the canvas."""
    h, w = hw
    g, dev = generator, generator.device
    images = torch.rand((batch_size, h, w, 3), generator=g, device=dev)
    n_boxes = torch.randint(1, min(mean_boxes * 2, max_boxes) + 1, (batch_size,), generator=g, device=dev)
    size = torch.tensor([w, h], dtype=torch.float32, device=dev)
    cx = torch.rand((batch_size, max_boxes, 2), generator=g, device=dev) * size * 0.8 + size * 0.1
    bwh = (torch.rand((batch_size, max_boxes, 2), generator=g, device=dev) * 0.45 + 0.05) * size
    x1y1 = (cx - bwh / 2).clamp(min=0.0)
    x2y2 = torch.minimum(cx + bwh / 2, size - 1.0)
    boxes = torch.cat([x1y1, x2y2], dim=-1)
    labels = torch.randint(1, num_classes + 1, (batch_size, max_boxes), generator=g, device=dev, dtype=torch.int32)
    valid = torch.arange(max_boxes, device=dev)[None, :] < n_boxes[:, None]
    boxes = torch.where(valid[..., None], boxes, torch.full_like(boxes, -1.0))
    labels = torch.where(valid, labels, torch.full_like(labels, -1))
    return images, boxes, labels
