"""ResNet-50 backbone (PyTorch, NCHW).

Counterpart of ``pytorch_object_detection_tpu/nn/resnet.py``: the 7x7/2
stem conv (``stem_mode="conv7"``) or its space-to-depth form (``"s2d"``),
then BN + ReLU + 3x3/2 max pool, bottleneck stages [3,4,6,3]
of widths [64,128,256,512] (x4 expansion), projection on the first block of
each stage.  Returns (C3, C4, C5) = (512 ch /8, 1024 ch /16, 2048 ch /32).
Module names follow the flax scopes (``conv1``, ``bn1``, ``layer{s}_{b}``).
``grad_barrier_stages=k`` detaches the map after stage k: with the stem and
``layer1..k`` frozen for training, their backward is never computed (the
JAX package's ``stop_gradient``; the same gradients for every trainable
parameter).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_object_detection_tpu_torch.nn.layers import BatchNorm, Conv, relu


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NHWC ``[B, H, W, C]`` -> ``[B, H/b, W/b, b*b*C]``, channels in (dy, dx, c)
    order (the JAX package's ``nn/resnet.space_to_depth``)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, block * block * c)


def s2d_stem_kernel(conv7: torch.Tensor) -> torch.Tensor:
    """A ``[7, 7, C, O]`` (HWIO) stride-2 stem kernel rewritten exactly as the
    space-to-depth ``[4, 4, 4C, O]`` stride-1 kernel: a leading zero row and
    column, then each 2x2 group of taps becomes one tap over 4C channels."""
    k = F.pad(conv7, (0, 0, 0, 0, 1, 0, 1, 0))
    kh, kw, cin, cout = k.shape
    k = k.reshape(kh // 2, 2, kw // 2, 2, cin, cout).permute(0, 2, 1, 3, 4, 5)
    return k.reshape(kh // 2, kw // 2, 4 * cin, cout)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4) with a projection shortcut when the
    stride or the width changes."""

    def __init__(self, in_ch: int, width: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out_ch = width * 4
        g = generator
        self.conv1 = Conv(in_ch, width, 1, bias=False, winit="resnet", generator=g)
        self.bn1 = BatchNorm(width)
        self.conv2 = Conv(width, width, 3, stride=stride, bias=False, winit="resnet", generator=g)
        self.bn2 = BatchNorm(width)
        self.conv3 = Conv(width, out_ch, 1, bias=False, winit="resnet", generator=g)
        self.bn3 = BatchNorm(out_ch)
        self.has_projection = stride != 1 or in_ch != out_ch
        if self.has_projection:
            self.downsample_conv = Conv(in_ch, out_ch, 1, stride=stride, bias=False, winit="resnet",
                                        generator=g)
            self.downsample_bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = relu(self.bn1(self.conv1(x)))
        y = relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.has_projection:
            x = self.downsample_bn(self.downsample_conv(x))
        return relu(x + y)


class ResNet50(nn.Module):
    """ResNet-50 returning the stage taps (C3, C4, C5)."""

    def __init__(self, stem_mode: str = "conv7", grad_barrier_stages: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.grad_barrier_stages = grad_barrier_stages
        if stem_mode not in ("conv7", "s2d"):
            raise ValueError(f"stem_mode must be 'conv7' or 's2d'; got {stem_mode!r}")
        self.stem_mode = stem_mode
        if stem_mode == "s2d":
            # the JAX model's own conv1_s2d parameter ([4, 4, 12, 64] HWIO, fan-out
            # He normal): a 4x4/1 conv on the 2x2 space-to-depth input with
            # asymmetric (2, 1) padding, applied in stem_conv
            self.conv1_s2d = Conv(12, 64, 4, bias=False, winit="resnet", generator=generator)
        else:
            self.conv1 = Conv(3, 64, 7, stride=2, bias=False, winit="resnet", generator=generator)
        self.bn1 = BatchNorm(64)
        self.stages = []
        in_ch = 64
        for stage, (blocks, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            names = []
            for block in range(blocks):
                stride = 2 if (block == 0 and stage > 0) else 1
                name = f"layer{stage + 1}_{block}"
                self.add_module(name, Bottleneck(in_ch, width, stride, generator=generator))
                in_ch = width * 4
                names.append(name)
            self.stages.append(names)

    def stem_conv(self, x: torch.Tensor) -> torch.Tensor:
        """The stem conv alone, NCHW in and out, in ``x``'s dtype: the 7x7/2
        conv, or space-to-depth and the 4x4/1 conv over pad (2, 1)."""
        if self.stem_mode == "conv7":
            return F.conv2d(x, self.conv1.weight.to(x.dtype), None, 2, 3)
        s2d = space_to_depth(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return F.conv2d(F.pad(s2d, (2, 1, 2, 1)), self.conv1_s2d.weight.to(x.dtype))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = relu(self.bn1(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        outputs = []
        for stage, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if stage + 1 == self.grad_barrier_stages:
                x = x.detach()
            outputs.append(x)
        return tuple(outputs[-3:])
