"""EfficientNet-V1 backbone B0..B7 (PyTorch, NCHW).

Counterpart of ``pytorch_object_detection_tpu/nn/efficientnet.py``: the
3x3/2 stem conv + BN + SiLU, then the MBConv blocks (1x1 expand + BN + SiLU
where the expand ratio is not 1, the kxk depthwise at its stride + BN +
SiLU, squeeze-and-excitation, 1x1 project + BN, the residual at stride 1
with equal widths; no stochastic depth, as in JAX), their widths and depths
compound-scaled per variant.  Returns the five endpoints (strides 2, 4, 8,
16, 32): the map before each stride-2 block, then the last map; the
detectors take the last three (C3, C4, C5: 40, 112, 320 channels at B0).

Module names follow the flax scopes (``stem_conv``, ``stem_bn``,
``block{i}`` with ``expand``, ``bn0``, ``dw``, ``bn1``, ``se``, ``project``,
``bn2``), so ``train/checkpoints.load_flax_variables`` takes the JAX tree.
The port keeps its own copies of the block table, the scaling table and the
rounding helpers.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from pytorch_object_detection_tpu_torch.nn.layers import BatchNorm, Conv, DepthwiseConv, SEBlock, silu

# (expand_ratio, channels, num_blocks, stride, kernel)
_B0_BLOCKS = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]
# (width_mult, depth_mult) per variant
_SCALING = {
    "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
    "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1),
}


def _round_filters(c: float, width_mult: float, divisor: int = 8) -> int:
    c *= width_mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return new_c


def _round_repeats(r: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * r))


def se_reduction(in_ch: int, expand_ratio: int, se_ratio: float = 0.25) -> int:
    """The SE block's reduction of the expanded width, relative to the block
    INPUT width, with Python's ``round`` (half to even), as JAX computes it."""
    return max(1, int(round((in_ch * expand_ratio) / max(1, int(in_ch * se_ratio)))))


def block_specs(width_mult: float = 1.0, depth_mult: float = 1.0) -> List[Tuple[int, int, int, int, int]]:
    """(in_ch, features, expand, kernel, stride) of every MBConv, in order."""
    specs, in_ch = [], _round_filters(32, width_mult)
    for expand, ch, repeats, stride, kernel in _B0_BLOCKS:
        ch = _round_filters(ch, width_mult)
        for r in range(_round_repeats(repeats, depth_mult)):
            specs.append((in_ch, ch, expand, kernel, stride if r == 0 else 1))
            in_ch = ch
    return specs


class MBConv(nn.Module):
    """expand 1x1 -> depthwise kxk (stride) -> SE -> project 1x1 (+ residual)."""

    def __init__(self, in_ch: int, features: int, expand_ratio: int, kernel: int, stride: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        mid = in_ch * expand_ratio
        if expand_ratio != 1:
            self.expand = Conv(in_ch, mid, 1, bias=False, generator=g)
            self.bn0 = BatchNorm(mid)
        self.dw = DepthwiseConv(mid, kernel, stride=stride, generator=g)
        self.bn1 = BatchNorm(mid)
        self.se = SEBlock(mid, se_reduction(in_ch, expand_ratio), generator=g)
        self.project = Conv(mid, features, 1, bias=False, generator=g)
        self.bn2 = BatchNorm(features)
        self.has_residual = stride == 1 and in_ch == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = silu(self.bn0(self.expand(x))) if hasattr(self, "expand") else x
        y = self.se(silu(self.bn1(self.dw(y))))
        y = self.bn2(self.project(y))
        return x + y if self.has_residual else y


class EfficientNet(nn.Module):
    """EfficientNet at ``width_mult`` x ``depth_mult``, returning its five endpoints."""

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.width_mult, self.depth_mult = width_mult, depth_mult
        stem = _round_filters(32, width_mult)
        self.stem_conv = Conv(3, stem, 3, stride=2, bias=False, generator=generator)
        self.stem_bn = BatchNorm(stem)
        self.specs = block_specs(width_mult, depth_mult)
        for i, spec in enumerate(self.specs):
            self.add_module(f"block{i}", MBConv(*spec, generator=generator))

    @classmethod
    def b0(cls, generator: Optional[torch.Generator] = None) -> "EfficientNet":
        return cls(1.0, 1.0, generator=generator)

    @classmethod
    def variant(cls, v: str, generator: Optional[torch.Generator] = None) -> "EfficientNet":
        w, d = _SCALING[v.lower()]
        return cls(w, d, generator=generator)

    def endpoint_channels(self) -> Tuple[int, ...]:
        """The widths of the five endpoints."""
        return tuple(s[0] for s in self.specs if s[4] == 2) + (self.specs[-1][1],)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = silu(self.stem_bn(self.stem_conv(x)))
        endpoints = []
        for i, spec in enumerate(self.specs):
            if spec[4] == 2:
                endpoints.append(x)  # the last map before each downsample
            x = getattr(self, f"block{i}")(x)
        endpoints.append(x)
        return tuple(endpoints)
