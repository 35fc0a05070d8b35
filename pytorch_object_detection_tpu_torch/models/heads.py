"""FCOSHead, HISHead and MNHead: the detection heads shared across pyramid levels (PyTorch, NCHW).

Counterparts of ``pytorch_object_detection_tpu/models/heads.py``:

  * ``FCOSHead`` (the classic FCOS): 4+4 towers of conv3x3 -> GN32+ReLU,
    3x3 predictions, the normal(0.01) init with the cls prior bias, and
    ``ScaleExp(1.0)``.  Eight GroupNorms per level, so 40 launches of
    kernel B per forward over five levels.
  * ``HISHead``: a shared inverted-bottleneck stem (PW-up 2f -> GN+ReLU ->
    DW3x3 -> GN+SiLU -> PW-down f, residual), then one conv-GN-ReLU per
    tower, 3x3 predictions, and ``ScaleExp(1.2)`` on the regression branch.
    Four GroupNorms per level, so 20 launches of kernel B per forward over
    five levels.
  * ``MNHead`` (MNFCOS): two shared MNBlocks (k3, dilation 2, alpha 2), then
    one conv-GN-SiLU per tower, 1x1 predictions, and ``ScaleExp(1.0)``.  Two
    GroupNorms per level, so 10 launches of kernel B per forward.

Every parameter is shared across levels except ``scale{i}``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from pytorch_object_detection_tpu_torch.nn.layers import (
    Conv,
    DepthwiseConv,
    GroupNorm32,
    MNBlock,
    ScaleExp,
)

LevelOutputs = Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]
FCOS_TOWER = 4  # conv-GN-ReLU stages in each of FCOSHead's two towers


def prior_bias(prior: float = 0.01) -> float:
    """Focal-loss classification bias init: ``-log((1-p)/p)`` (-log 99 at p=0.01)."""
    return -math.log((1.0 - prior) / prior)


class FCOSHead(nn.Module):
    def __init__(self, num_classes: int, features: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f, g = features, generator
        for i in range(FCOS_TOWER):
            self.add_module(f"cls_tower{i}", Conv(f, f, 3, bias=False, winit="head", generator=g))
            self.add_module(f"cls_gn{i}", GroupNorm32(f, act="relu"))
        for i in range(FCOS_TOWER):
            self.add_module(f"reg_tower{i}", Conv(f, f, 3, bias=False, winit="head", generator=g))
            self.add_module(f"reg_gn{i}", GroupNorm32(f, act="relu"))
        self.cls_pred = Conv(f, num_classes, 3, winit="head", bias_const=prior_bias(), generator=g)
        self.cnt_pred = Conv(f, 1, 3, winit="head", generator=g)
        self.reg_pred = Conv(f, 4, 3, winit="head", generator=g)
        for i in range(5):  # one ScaleExp per pyramid level
            self.add_module(f"scale{i}", ScaleExp(1.0))

    def forward(self, levels: Sequence[torch.Tensor], plain: bool = False) -> LevelOutputs:
        """Per-level NCHW (cls, cnt, reg) lists.  ``plain=True`` runs the
        GroupNorms' plain version, for comparing kernel B only."""
        cls_out, cnt_out, reg_out = [], [], []
        for i, x in enumerate(levels):
            c = r = x
            for j in range(FCOS_TOWER):
                c = getattr(self, f"cls_gn{j}")(getattr(self, f"cls_tower{j}")(c), plain)
            for j in range(FCOS_TOWER):
                r = getattr(self, f"reg_gn{j}")(getattr(self, f"reg_tower{j}")(r), plain)
            cls_out.append(self.cls_pred(c))
            cnt_out.append(self.cnt_pred(r))
            reg_out.append(getattr(self, f"scale{i}")(self.reg_pred(r)))
        return cls_out, cnt_out, reg_out


class HISHead(nn.Module):
    def __init__(self, num_classes: int, features: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f, g = features, generator
        self.stem_pw1 = Conv(f, 2 * f, 1, bias=False, generator=g)
        self.stem_gn1 = GroupNorm32(2 * f, act="relu")
        self.stem_dw = DepthwiseConv(2 * f, generator=g)
        self.stem_gn2 = GroupNorm32(2 * f, act="silu")
        self.stem_pw2 = Conv(2 * f, f, 1, bias=True, generator=g)
        self.cls_tower0 = Conv(f, f, 3, bias=False, generator=g)
        self.cls_gn0 = GroupNorm32(f, act="relu")
        self.reg_tower0 = Conv(f, f, 3, bias=False, generator=g)
        self.reg_gn0 = GroupNorm32(f, act="relu")
        self.cls_pred = Conv(f, num_classes, 3, bias_const=prior_bias(), generator=g)
        self.cnt_pred = Conv(f, 1, 3, generator=g)
        self.reg_pred = Conv(f, 4, 3, generator=g)
        for i in range(5):  # one ScaleExp per pyramid level
            self.add_module(f"scale{i}", ScaleExp())

    def forward(self, levels: Sequence[torch.Tensor], plain: bool = False) -> LevelOutputs:
        """Per-level NCHW (cls, cnt, reg) lists.  ``plain=True`` runs the
        GroupNorms' plain version, for comparing kernel B only."""
        cls_out, cnt_out, reg_out = [], [], []
        for i, x in enumerate(levels):
            y = self.stem_gn1(self.stem_pw1(x), plain)
            y = self.stem_gn2(self.stem_dw(y), plain)
            y = self.stem_pw2(y) + x  # inverted-bottleneck stem, residual
            c = self.cls_gn0(self.cls_tower0(y), plain)
            r = self.reg_gn0(self.reg_tower0(y), plain)
            cls_out.append(self.cls_pred(c))
            cnt_out.append(self.cnt_pred(r))
            reg_out.append(getattr(self, f"scale{i}")(self.reg_pred(r)))
        return cls_out, cnt_out, reg_out


class MNHead(nn.Module):
    def __init__(self, num_classes: int, features: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f, g = features, generator
        self.block1 = MNBlock(f, 3, 2, 2, generator=g)
        self.block2 = MNBlock(f, 3, 2, 2, generator=g)
        self.cls_tower0 = Conv(f, f, 3, bias=False, generator=g)
        self.cls_gn0 = GroupNorm32(f, act="silu")
        self.reg_tower0 = Conv(f, f, 3, bias=False, generator=g)
        self.reg_gn0 = GroupNorm32(f, act="silu")
        self.cls_pred = Conv(f, num_classes, 1, bias_const=prior_bias(), generator=g)
        self.cnt_pred = Conv(f, 1, 1, generator=g)
        self.reg_pred = Conv(f, 4, 1, generator=g)
        for i in range(5):  # one ScaleExp per pyramid level
            self.add_module(f"scale{i}", ScaleExp(1.0))

    def forward(self, levels: Sequence[torch.Tensor], plain: bool = False) -> LevelOutputs:
        """Per-level NCHW (cls, cnt, reg) lists.  ``plain=True`` runs the
        GroupNorms' plain version, for comparing kernel B only."""
        cls_out, cnt_out, reg_out = [], [], []
        for i, x in enumerate(levels):
            y = self.block2(self.block1(x))
            c = self.cls_gn0(self.cls_tower0(y), plain)
            r = self.reg_gn0(self.reg_tower0(y), plain)
            cls_out.append(self.cls_pred(c))
            cnt_out.append(self.cnt_pred(r))
            reg_out.append(getattr(self, f"scale{i}")(self.reg_pred(r)))
        return cls_out, cnt_out, reg_out
