"""MC-FCOS: the 4-level CSP/MBConv FCOS variant (PyTorch, NCHW).

Counterpart of ``pytorch_object_detection_tpu/models/mcfcos.py``:
ResNet-50, a CSP-style half-split MBConv block (:class:`MCBlock`, SE with
reduction 6), the top-down FeatureFusion (concat + 1x1), an MBConv FPN, a
FeatureRefine stage giving 4 levels at strides (8, 16, 32, 64), and a
4-conv head with BatchNorm + SiLU and bias-free predictions, WITHOUT
ScaleExp (the regression output is the raw conv).  Every conv has its own
BatchNorm, as in the JAX package; every BatchNorm is frozen unless the model
is built with ``freeze_bn=False`` (as :class:`~.fcos.HISFCOS`).  The head has
no GroupNorm, so the float forward launches no kernel B.

The forward takes NHWC float images (normalized) and returns per-level
NHWC (cls, cnt, reg) lists; the module names are the flax scopes
(``train/checkpoints.load_flax_variables``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pytorch_object_detection_tpu_torch.models.heads import LevelOutputs
from pytorch_object_detection_tpu_torch.nn.layers import (
    BatchNorm,
    Conv,
    DepthwiseConv,
    SEBlock,
    maxpool2x2,
    silu,
    unfreeze_batchnorms,
    upsample2x,
)
from pytorch_object_detection_tpu_torch.nn.resnet import ResNet50

STRIDES = (8, 16, 32, 64)
MC_TOWER = 4  # conv-BN-SiLU stages of MCHead's shared tower


class MCBlock(nn.Module):
    """CSP half-split MBConv: pw1 (C -> C/2) -> BN -> SiLU = a1; a1 -> DW3x3
    -> BN -> SiLU -> SE(6) -> pw3 -> BN -> SiLU; a1 -> pw4 -> BN -> SiLU;
    concat -> pw5 (-> ``features``) -> BN -> SiLU."""

    def __init__(self, in_ch: int, features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        half, g = in_ch // 2, generator
        self.pw1 = Conv(in_ch, half, 1, generator=g)
        self.bn1 = BatchNorm(half)
        self.dw = DepthwiseConv(half, generator=g)
        self.bn2 = BatchNorm(half)
        self.se = SEBlock(half, 6, generator=g)
        self.pw3 = Conv(half, half, 1, generator=g)
        self.bn3 = BatchNorm(half)
        self.pw4 = Conv(half, half, 1, generator=g)
        self.bn4 = BatchNorm(half)
        self.pw5 = Conv(2 * half, features, 1, generator=g)
        self.bn5 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a1 = silu(self.bn1(self.pw1(x)))
        y = self.se(silu(self.bn2(self.dw(a1))))
        y = silu(self.bn3(self.pw3(y)))
        skip = silu(self.bn4(self.pw4(a1)))
        return silu(self.bn5(self.pw5(torch.cat([y, skip], dim=1))))


class MCHead(nn.Module):
    """4 x (conv3x3 -> BN -> SiLU), then bias-free 3x3 cls, cnt and reg
    convs; shared across the levels."""

    def __init__(self, num_classes: int, features: int = 256, generator: Optional[torch.Generator] = None):
        super().__init__()
        f, g = features, generator
        for i in range(MC_TOWER):
            self.add_module(f"conv{i}", Conv(f, f, 3, bias=False, generator=g))
            self.add_module(f"bn{i}", BatchNorm(f))
        self.cls = Conv(f, num_classes, 3, bias=False, generator=g)
        self.cnt = Conv(f, 1, 3, bias=False, generator=g)
        self.reg = Conv(f, 4, 3, bias=False, generator=g)

    def forward(self, levels: Sequence[torch.Tensor], plain: bool = False) -> LevelOutputs:
        """Per-level NCHW (cls, cnt, reg); ``plain`` is accepted for the
        detectors' common signature (the head runs no kernel)."""
        del plain
        cls_out, cnt_out, reg_out = [], [], []
        for x in levels:
            for i in range(MC_TOWER):
                x = silu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
            cls_out.append(self.cls(x))
            cnt_out.append(self.cnt(x))
            reg_out.append(self.reg(x))
        return cls_out, cnt_out, reg_out


class MC_FCOS(nn.Module):
    """MC-FCOS on ResNet-50; weights drawn on the CPU from ``generator`` and
    moved to ``device`` (the card by default), as the other detectors.
    ``frozen_stages=k`` puts the backbone's gradient barrier after
    ``layer{k}`` (the JAX model has no such field: the trainer's freeze set
    alone keeps those parameters, and the barrier changes no update)."""

    def __init__(self, num_classes: int = 20, features: int = 256, *, frozen_stages: int = 0,
                 freeze_bn: bool = True, device: torch.device | str = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f, g = features, generator
        self.num_classes = num_classes
        self.backbone = ResNet50(grad_barrier_stages=frozen_stages, generator=g)
        self.mb_top = MCBlock(2048, f, generator=g)
        self.ffm_pw1 = Conv(1024 + 2048, f, 1, generator=g)
        self.ffm_mb1 = MCBlock(f, f, generator=g)
        self.ffm_pw2 = Conv(512 + 1024, f, 1, generator=g)
        self.ffm_mb2 = MCBlock(f, f, generator=g)
        self.tf1_conv = Conv(2048, f, 1, bias=False, generator=g)
        self.tf1_bn = BatchNorm(f)
        for i in (1, 2, 3):
            self.add_module(f"fpn_mb{i}", MCBlock(f, f, generator=g))
        self.refine_mb1 = MCBlock(2 * f, f, generator=g)
        self.refine_mb2 = MCBlock(2 * f, f, generator=g)
        self.refine_conv = Conv(f, f, 3, bias=False, generator=g)
        self.head = MCHead(num_classes, f, generator=g)
        self.freeze_bn = freeze_bn
        if not freeze_bn:
            unfreeze_batchnorms(self)
        self.eval()
        self.to(device)

    def neck(self, feats) -> Sequence[torch.Tensor]:
        """(C3, C4, C5) NCHW -> the four head inputs at strides 8, 16, 32, 64."""
        c3, c4, c5 = feats
        x4 = self.mb_top(maxpool2x2(c5))  # /64
        x2 = self.ffm_mb1(self.ffm_pw1(torch.cat([c4, upsample2x(c5)], dim=1)))  # /16
        x1 = self.ffm_mb2(self.ffm_pw2(torch.cat([c3, upsample2x(c4)], dim=1)))  # /8
        x3 = silu(self.tf1_bn(self.tf1_conv(c5)))  # /32
        p1 = self.fpn_mb1(x3)
        p2 = self.fpn_mb2(upsample2x(p1) + x2)
        p3 = self.fpn_mb3(upsample2x(p2) + x1)
        c1 = self.refine_mb1(torch.cat([upsample2x(p1), p2], dim=1))  # /16
        c1 = self.refine_mb2(torch.cat([c1, maxpool2x2(p3)], dim=1))
        d = maxpool2x2(c1)
        return upsample2x(c1) + p3, self.refine_conv(c1) + p2, d + p1, maxpool2x2(d) + x4

    def forward(self, images: torch.Tensor, plain: bool = False) -> LevelOutputs:
        """images ``[B, H, W, 3]`` float -> per-level ``[B, H_i, W_i, C]``
        (cls, cnt, reg) at strides 8, 16, 32, 64; ``plain`` as the other
        detectors' (no kernel runs here)."""
        x = images.permute(0, 3, 1, 2).contiguous()
        outs = self.head(self.neck(self.backbone(x)), plain)
        return tuple([o.permute(0, 2, 3, 1) for o in branch] for branch in outs)
