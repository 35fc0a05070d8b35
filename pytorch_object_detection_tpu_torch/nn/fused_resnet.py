"""BatchNorm folding helpers (PyTorch, NCHW).

Counterpart of ``pytorch_object_detection_tpu/nn/fused_resnet.py:_fold_bn``
and ``_conv_bn_act``: a frozen BatchNorm becomes a per-channel f32
``(mult, shift)`` with ``mult = scale * rsqrt(var + eps)`` and
``shift = bias - mean * mult`` (eps 1e-5), applied after the conv in the
conv's dtype.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_object_detection_tpu_torch.nn.layers import BatchNorm

BN_EPS = 1e-5


def fold_bn_params(scale, bias, mean, var, eps: float = BN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mult, shift) f32 from a frozen BatchNorm's four vectors."""
    mult = scale.float() * torch.rsqrt(var.float() + eps)
    return mult, bias.float() - mean.float() * mult


def fold_bn(bn: BatchNorm, eps: float = BN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mult, shift) f32 of a frozen BatchNorm module."""
    return fold_bn_params(bn.weight, bn.bias, bn.running_mean, bn.running_var, eps)


def conv_bn_act(x: torch.Tensor, conv: nn.Conv2d, mult: torch.Tensor, shift: torch.Tensor,
                act: bool = True) -> torch.Tensor:
    """conv (the module's kernel cast to ``x``'s dtype, its stride and
    padding) -> ``y * mult + shift`` in ``x``'s dtype -> optional ReLU."""
    y = F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding, conv.dilation, conv.groups)
    y = y * mult.to(y.dtype)[:, None, None] + shift.to(y.dtype)[:, None, None]
    return torch.relu(y) if act else y
