"""Feature pyramids (PyTorch, NCHW): the classic FPN, the half-inverted-stage HisFPN and the MNFCOS LightweightFPN.

Counterparts of ``pytorch_object_detection_tpu/nn/fpn.py``'s ``FPN``,
``HisFPN`` and ``LightweightFPN``: each takes (C3, C4, C5) and returns
(P3..P7) at strides (8, 16, 32, 64, 128).  The classic FPN's P6 and P7 are
stride-2 3x3 convs of P5 and of ReLU(P6).  As in the JAX package, the HisFPN's C4 and C3
laterals share ONE BatchNorm (``bn_lat_shared``), and its two extra levels
are seeded by max pools of the transformed C5; the LightweightFPN's P6 and
P7 are 2x2 max pools of P5 and P6, each through an MNBlock.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from pytorch_object_detection_tpu_torch.nn.layers import (
    BatchNorm,
    Conv,
    HisBlock,
    MNBlock,
    maxpool2x2,
    relu,
    upsample2x,
)


class FPN(nn.Module):
    """The classic FCOS pyramid: 1x1 laterals, top-down nearest upsample and
    add, 3x3 smoothing, stride-2 ``down6`` on P5 and ``down7`` on ReLU(P6);
    every conv with a bias and the kaiming-uniform(a=1) init."""

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048), features: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c3, c4, c5 = in_channels
        f, g = features, generator
        self.lateral5 = Conv(c5, f, 1, winit="fpn", generator=g)
        self.lateral4 = Conv(c4, f, 1, winit="fpn", generator=g)
        self.smooth4 = Conv(f, f, 3, winit="fpn", generator=g)
        self.lateral3 = Conv(c3, f, 1, winit="fpn", generator=g)
        self.smooth3 = Conv(f, f, 3, winit="fpn", generator=g)
        self.smooth5 = Conv(f, f, 3, winit="fpn", generator=g)
        self.down6 = Conv(f, f, 3, stride=2, winit="fpn", generator=g)
        self.down7 = Conv(f, f, 3, stride=2, winit="fpn", generator=g)

    def forward(self, feats: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]):
        c3, c4, c5 = feats
        p5 = self.lateral5(c5)
        p4 = self.smooth4(upsample2x(p5) + self.lateral4(c4))
        p3 = self.smooth3(upsample2x(p4) + self.lateral3(c3))
        p5 = self.smooth5(p5)
        p6 = self.down6(p5)
        p7 = self.down7(relu(p6))
        return p3, p4, p5, p6, p7


class HisFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048), features: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c3, c4, c5 = in_channels
        f, g = features, generator
        self.bn_lat_shared = BatchNorm(f)  # one module for the t4 AND the t3 lateral
        self.tf1 = Conv(c5, f, 1, bias=False, generator=g)
        self.bn_tf1 = BatchNorm(f)
        self.tf2 = Conv(c4, f, 1, bias=False, generator=g)
        self.tf3 = Conv(c3, f, 1, bias=False, generator=g)
        for i in range(1, 8):
            self.add_module(f"his{i}", HisBlock(f, f, generator=g))

    def forward(self, feats: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]):
        c3, c4, c5 = feats
        t5 = relu(self.bn_tf1(self.tf1(c5)))
        seed6 = maxpool2x2(t5)  # /64
        seed7 = maxpool2x2(seed6)  # /128
        d5 = self.his1(t5)  # /32
        t4 = relu(self.bn_lat_shared(self.tf2(c4)))
        d4 = self.his2(upsample2x(d5) + t4)  # /16
        t3 = relu(self.bn_lat_shared(self.tf3(c3)))
        p3 = self.his3(upsample2x(d4) + t3)  # /8
        p4 = self.his4(maxpool2x2(p3) + d4)
        p5 = self.his5(maxpool2x2(p4) + d5)
        p6 = self.his6(maxpool2x2(p5) + seed6)
        p7 = self.his7(maxpool2x2(p6) + seed7)
        return p3, p4, p5, p6, p7


class LightweightFPN(nn.Module):
    """The MNFCOS pyramid: 1x1 laterals, then MNBlocks (alpha 2) -- P5 first
    (k5 d2), top-down adds to P4 (k3 d2) and P3 (k3 d1), max-pool descents
    to P6 (k5 d1) and P7 (k7 d1)."""

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048), features: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c3, c4, c5 = in_channels
        f, g = features, generator
        self.lateral5 = Conv(c5, f, 1, generator=g)
        self.lateral4 = Conv(c4, f, 1, generator=g)
        self.lateral3 = Conv(c3, f, 1, generator=g)
        for name, kernel, dilation in (("mnb5", 5, 2), ("mnb4", 3, 2), ("mnb3", 3, 1), ("mnb6", 5, 1),
                                       ("mnb7", 7, 1)):
            self.add_module(name, MNBlock(f, kernel, dilation, alpha=2, generator=g))

    def forward(self, feats: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]):
        c3, c4, c5 = feats
        p5 = self.mnb5(self.lateral5(c5))
        p4 = self.mnb4(upsample2x(p5) + self.lateral4(c4))
        p3 = self.mnb3(upsample2x(p4) + self.lateral3(c3))
        p6 = self.mnb6(maxpool2x2(p5))
        p7 = self.mnb7(maxpool2x2(p6))
        return p3, p4, p5, p6, p7
