"""MobileNetV2 backbone (PyTorch, NCHW).

Counterpart of ``pytorch_object_detection_tpu/nn/mobilenet.py``: the 3x3/2
stem conv + BN + ReLU6, then inverted residual blocks (1x1 expand + BN +
ReLU6 where the expand ratio is not 1, 3x3 depthwise at its stride + BN +
ReLU6, 1x1 project + BN, a linear bottleneck; the residual at stride 1 with
equal widths).  Returns (C3, C4, C5) at strides 8, 16, 32 with 32, 96 and
320 channels: the maps before the last two stride-2 blocks, and the last
map.  No detector of the JAX package uses it, so no pipeline serves it
here either.  Module names follow the flax scopes (``stem``, ``stem_bn``,
``block{i}`` with ``expand``, ``bn0``, ``dw``, ``bn1``, ``project``,
``bn2``); ``train/checkpoints.load_flax_variables`` takes the JAX tree.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from pytorch_object_detection_tpu_torch.nn.layers import BatchNorm, Conv, DepthwiseConv

# (expand, channels, repeats, stride)
_V2_BLOCKS = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


class InvertedResidual(nn.Module):
    """expand 1x1 -> depthwise 3x3 (stride) -> project 1x1 (+ residual)."""

    def __init__(self, in_ch: int, features: int, expand: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        mid = in_ch * expand
        if expand != 1:
            self.expand = Conv(in_ch, mid, 1, bias=False, generator=g)
            self.bn0 = BatchNorm(mid)
        self.dw = DepthwiseConv(mid, 3, stride=stride, generator=g)
        self.bn1 = BatchNorm(mid)
        self.project = Conv(mid, features, 1, bias=False, generator=g)
        self.bn2 = BatchNorm(features)
        self.has_residual = stride == 1 and in_ch == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = relu6(self.bn0(self.expand(x))) if hasattr(self, "expand") else x
        y = relu6(self.bn1(self.dw(y)))
        y = self.bn2(self.project(y))
        return x + y if self.has_residual else y


class MobileNetV2(nn.Module):
    """MobileNetV2 returning (C3, C4, C5)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stem = Conv(3, 32, 3, stride=2, bias=False, generator=generator)
        self.stem_bn = BatchNorm(32)
        self.strides = []
        in_ch = 32
        for expand, ch, repeats, stride in _V2_BLOCKS:
            for r in range(repeats):
                s = stride if r == 0 else 1
                self.add_module(f"block{len(self.strides)}", InvertedResidual(in_ch, ch, expand, s, generator))
                self.strides.append(s)
                in_ch = ch

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = relu6(self.stem_bn(self.stem(x)))
        taps = []
        for i, s in enumerate(self.strides):
            if s == 2:
                taps.append(x)  # the last map before each downsample
            x = getattr(self, f"block{i}")(x)
        taps.append(x)
        return tuple(taps[-3:])
