"""SSD300 (VGG-16, multibox) in PyTorch.

Counterpart of ``pytorch_object_detection_tpu/models/ssd.py``: the VGG-16
backbone (``nn/vgg.py``), :class:`L2Norm` on conv4_3 (a learnable
per-channel ``scale``, init 20), four :class:`ExtraLayer` s, and per level
a loc and a conf 3x3 conv with (4, 6, 6, 6, 4, 4) default boxes a cell;
:func:`default_boxes` gives the 8,732 boxes in the same order (level, then
row-major position, then box).  The forward takes NHWC normalized float
images at 300x300 and returns ``loc [B, 8732, 4]`` and ``conf [B, 8732,
C]`` logits, class 0 the background; inside, everything runs NCHW.  Names
follow the flax scopes (``backbone``, ``l2norm``, ``extra1..4``,
``loc0..5``, ``conf0..5``).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from pytorch_object_detection_tpu_torch.nn.layers import Conv, relu
from pytorch_object_detection_tpu_torch.nn.vgg import VGG16
from pytorch_object_detection_tpu_torch.parallel import tp

FEATURE_SIZES = (38, 19, 10, 5, 3, 1)
STEPS = (8, 16, 32, 64, 100, 300)
MIN_SIZES = (30, 60, 111, 162, 213, 264)
MAX_SIZES = (60, 111, 162, 213, 264, 315)
ASPECT_RATIOS = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,))
NUM_ANCHORS = (4, 6, 6, 6, 4, 4)
# (in, mid, out, stride, pad) of extra1..4: the stride-2 layers pad 1, the stride-1 ones are VALID (5 -> 3 -> 1)
EXTRAS = ((1024, 256, 512, 2, 1), (512, 128, 256, 2, 1), (256, 128, 256, 1, 0), (256, 128, 256, 1, 0))
LEVEL_CHANNELS = (512, 1024, 512, 256, 256, 256)


def default_boxes(img_size: int = 300, device: torch.device | str = "cpu") -> torch.Tensor:
    """SSD's default boxes ``[8732, 4]`` xyxy in pixels, clipped to the image,
    built in numpy as in JAX and moved to ``device``: per cell the s_k
    square, the sqrt(s_k * s_k+1) square, and (s_k * sqrt(ar), s_k /
    sqrt(ar)) pairs."""
    boxes: List[Tuple[float, float, float, float]] = []
    for k, f in enumerate(FEATURE_SIZES):
        f_k = img_size / STEPS[k]
        s_k = MIN_SIZES[k] / img_size
        s_k_prime = math.sqrt(s_k * (MAX_SIZES[k] / img_size))
        for i in range(f):
            for j in range(f):
                cx = (j + 0.5) / f_k
                cy = (i + 0.5) / f_k
                boxes.append((cx, cy, s_k, s_k))
                boxes.append((cx, cy, s_k_prime, s_k_prime))
                for ar in ASPECT_RATIOS[k]:
                    r = math.sqrt(ar)
                    boxes.append((cx, cy, s_k * r, s_k / r))
                    boxes.append((cx, cy, s_k / r, s_k * r))
    arr = np.clip(np.asarray(boxes, np.float32), 0.0, 1.0)
    cx, cy, w, h = arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]
    xyxy = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1) * img_size
    return torch.from_numpy(np.clip(xyxy, 0.0, img_size)).to(device)


class L2Norm(nn.Module):
    """Channelwise L2 normalization with a learnable scale (init 20): ``x /
    (||x|| + 1e-10) * scale`` over the channels of NCHW ``x``."""

    def __init__(self, ch: int, scale_init: float = 20.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((ch,), scale_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt((x * x).sum(dim=1, keepdim=True)) + 1e-10
        (scale,) = tp.full((self.scale,), x.shape[1])  # whole, where a tensor-parallel shard (parallel/tp.py)
        return x / norm * scale[:, None, None]


class ExtraLayer(nn.Module):
    """1x1 squeeze + ReLU, then a 3x3 conv + ReLU at ``stride`` with
    ``pad`` (1 on the stride-2 layers, 0: VALID on the others).  ``conv2``
    is a bare flax ``nn.Conv`` in JAX: its default (lecun) init and no inner
    scope."""

    def __init__(self, in_ch: int, mid: int, out: int, stride: int = 1, pad: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = Conv(in_ch, mid, 1, generator=generator)
        self.conv2 = Conv(mid, out, 3, stride=stride, padding=pad, winit="lecun", generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu(self.conv2(relu(self.conv1(x))))


class SSD300(nn.Module):
    """SSD300 with ``num_classes`` logits a box, the background among them
    (``models/registry.build_model`` adds it to the dataset's count).
    Weights are drawn on the CPU from ``generator`` and moved to ``device``:
    the card by default; pass ``device="cpu"`` for the CPU.  ``features``
    is taken and unused, as the JAX registry drops it."""

    def __init__(self, num_classes: int = 21, features: int = 256, *, device: torch.device | str = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        del features
        g = generator
        self.num_classes = num_classes
        self.backbone = VGG16(generator=g)
        self.l2norm = L2Norm(512)
        for i, (cin, mid, out, stride, pad) in enumerate(EXTRAS):
            self.add_module(f"extra{i + 1}", ExtraLayer(cin, mid, out, stride, pad, generator=g))
        for i, (ch, na) in enumerate(zip(LEVEL_CHANNELS, NUM_ANCHORS)):
            self.add_module(f"loc{i}", Conv(ch, na * 4, 3, generator=g))
            self.add_module(f"conf{i}", Conv(ch, na * num_classes, 3, generator=g))
        self.eval()
        self.to(device)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images ``[B, 300, 300, 3]`` -> (loc ``[B, 8732, 4]``, conf ``[B,
        8732, num_classes]``); each level's NHWC map is flattened position
        first, then box, the order of :func:`default_boxes`."""
        c4_3, c7 = self.backbone(images.permute(0, 3, 1, 2))
        feats = [self.l2norm(c4_3), c7]
        for i in range(len(EXTRAS)):
            feats.append(getattr(self, f"extra{i + 1}")(feats[-1]))
        b = images.shape[0]
        locs, confs = [], []
        for i, feat in enumerate(feats):
            locs.append(getattr(self, f"loc{i}")(feat).permute(0, 2, 3, 1).reshape(b, -1, 4))
            confs.append(getattr(self, f"conf{i}")(feat).permute(0, 2, 3, 1).reshape(b, -1, self.num_classes))
        return torch.cat(locs, dim=1), torch.cat(confs, dim=1)
