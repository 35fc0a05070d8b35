"""Shared NN primitives (PyTorch, NCHW).

Counterpart of ``pytorch_object_detection_tpu/nn/layers.py``.  Modules run
NCHW, PyTorch's native layout; the detector converts from and to the JAX
package's NHWC at its public boundary.  Initialisation draws the JAX
package's distributions from an explicit ``torch.Generator``:

  * ``winit='torch'``: kaiming-uniform(a=sqrt 5) kernel, uniform(+-1/sqrt
    fan_in) bias (torch's Conv2d default);
  * ``winit='resnet'``: normal(0, sqrt(2 / fan_out)) kernel, zero bias;
  * ``bias_const`` overrides the bias (the cls prior).

Each JAX wrapper (``Conv``, ``DepthwiseConv``, ``BatchNorm``,
``GroupNorm32``) adds one inner flax scope (``conv``, ``dw``, ``bn``,
``gn``); the port's module IS the wrapped layer, so its parameter names are
the flax path without those scopes (``train/checkpoints.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_object_detection_tpu_torch.ops.gn import groupnorm_act, groupnorm_act_autograd


def _uniform(shape, bound: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


class Conv(nn.Conv2d):
    """2D conv with symmetric padding ``d*(k-1)//2`` and the JAX package's init."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, groups: int = 1, bias: bool = True, winit: str = "torch",
                 bias_const: Optional[float] = None, generator: Optional[torch.Generator] = None):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=dilation * (kernel - 1) // 2,
                         dilation=dilation, groups=groups, bias=bias)
        shape = self.weight.shape
        fan_in = (in_ch // groups) * kernel * kernel
        with torch.no_grad():
            if winit == "torch":
                a = math.sqrt(5.0)
                bound = math.sqrt(2.0 / (1.0 + a * a)) * math.sqrt(3.0 / fan_in)
                self.weight.copy_(_uniform(shape, bound, generator))
                if bias:
                    self.bias.copy_(_uniform(out_ch, 1.0 / math.sqrt(fan_in), generator))
            elif winit == "resnet":
                std = math.sqrt(2.0 / (out_ch * kernel * kernel))
                self.weight.copy_(torch.empty(shape).normal_(0.0, std, generator=generator))
                if bias:
                    self.bias.zero_()
            else:
                raise ValueError(f"winit must be 'torch' or 'resnet'; got {winit!r}")
            if bias and bias_const is not None:
                self.bias.fill_(bias_const)

    def reset_parameters(self) -> None:
        """No-op: ``__init__`` draws the weights from the caller's generator
        (``nn.Conv2d.__init__`` would otherwise draw from the global RNG)."""


class DepthwiseConv(Conv):
    """Per-channel ``kernel`` x ``kernel`` conv (groups == channels), dilation
    ``dilation``, same padding, no bias; 3x3, dilation 1 by default (the HISHead's)."""

    def __init__(self, ch: int, kernel: int = 3, dilation: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__(ch, ch, kernel, dilation=dilation, groups=ch, bias=False, generator=generator)


class BatchNorm(nn.Module):
    """Frozen BatchNorm: running statistics only, eps 1e-5 (the reference
    freezes every BN; the JAX package runs them with
    ``use_running_average=True``)."""

    def __init__(self, ch: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(ch))
        self.register_buffer("bias", torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, momentum=0.0, eps=1e-5)


class GroupNorm32(nn.Module):
    """GroupNorm with 32 groups and the following activation folded in
    (``act``: 'none', 'relu', 'silu').

    The path is chosen by whether autograd records, not by
    ``self.training``: where ``torch.is_grad_enabled()`` and the input or
    the affine requires grad (a train step), ``F.group_norm`` + act
    (``ops/gn.groupnorm_act_autograd``; kernel B has no backward, and the
    JAX training path's ``nn.GroupNorm`` runs no Pallas kernel either);
    otherwise kernel B on CUDA tensors (``ops/gn.py``), whatever the
    module's mode.  ``plain=True`` runs kernel B's plain version instead,
    for the comparison only."""

    def __init__(self, ch: int, act: str = "none"):
        super().__init__()
        self.act = act
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        if torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad or self.bias.requires_grad):
            return groupnorm_act_autograd(x, self.weight, self.bias, groups=32, eps=1e-5, act=self.act)
        return groupnorm_act(x, self.weight, self.bias, groups=32, eps=1e-5, act=self.act, plain=plain)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool, floor mode."""
    return F.max_pool2d(x, 2, 2)


relu = F.relu
silu = F.silu


class SEBlock(nn.Module):
    """Squeeze-and-excitation: GAP -> 1x1 (C/4) -> SiLU -> 1x1 -> sigmoid -> scale."""

    def __init__(self, ch: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = Conv(ch, ch // 4, 1, generator=generator)
        self.fc2 = Conv(ch // 4, ch, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(dim=(2, 3), keepdim=True)
        y = self.fc2(silu(self.fc1(y)))
        return x * torch.sigmoid(y)


class ScaleExp(nn.Module):
    """Learnable per-level regression scale: ``exp(x * s)``, s from
    ``init_value`` (the HISHead's 1.2 by default; the MNHead's is 1.0)."""

    def __init__(self, init_value: float = 1.2):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor([init_value], dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(x * self.scale)


class HisBlock(nn.Module):
    """Half-inverted-stage block.

    x1 = 1x1 -> BN -> SiLU; branch a = DW3x3 -> BN -> ReLU, branch b =
    SE(x1); concat -> 3x3 -> BN -> ReLU; concat with the passthrough 1x1(x)
    -> dilated 3x3 -> BN -> SiLU.
    """

    def __init__(self, in_ch: int, features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        half = features // 2
        g = generator
        self.conv1 = Conv(in_ch, half, 1, generator=g)
        self.bn1 = BatchNorm(half)
        self.conv2 = Conv(in_ch, half, 1, generator=g)  # passthrough, no norm/act
        self.dwconv = DepthwiseConv(half, generator=g)
        self.bn2 = BatchNorm(half)
        self.se = SEBlock(half, generator=g)
        self.conv3 = Conv(2 * half, half, 3, bias=False, generator=g)
        self.bn3 = BatchNorm(half)
        self.conv4 = Conv(2 * half, features, 3, dilation=2, bias=False, generator=g)
        self.bn4 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = silu(self.bn1(self.conv1(x)))
        x2 = self.conv2(x)
        a = relu(self.bn2(self.dwconv(x1)))
        b = self.se(x1)
        m = relu(self.bn3(self.conv3(torch.cat([a, b], dim=1))))
        y = self.conv4(torch.cat([m, x2], dim=1))
        return silu(self.bn4(y))


class MNBlock(nn.Module):
    """Dilated depthwise ``kernel`` x ``kernel`` -> BN -> 1x1 up to ``alpha``
    x C -> SiLU -> 1x1 down to ``features`` -> + residual (the MNFCOS block;
    same padding, as the JAX package fixes the reference's k=5/7 blocks)."""

    def __init__(self, features: int, kernel: int = 3, dilation: int = 1, alpha: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.ddw = DepthwiseConv(features, kernel, dilation, generator=g)
        self.bn1 = BatchNorm(features)
        self.pw1 = Conv(features, features * alpha, 1, generator=g)
        self.pw2 = Conv(features * alpha, features, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pw2(silu(self.pw1(self.bn1(self.ddw(x)))))
