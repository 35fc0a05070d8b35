"""Shared NN primitives (PyTorch, NCHW).

Counterpart of ``pytorch_object_detection_tpu/nn/layers.py``.  Modules run
NCHW, PyTorch's native layout; the detector converts from and to the JAX
package's NHWC at its public boundary.  Initialisation draws the JAX
package's distributions from an explicit ``torch.Generator``:

  * ``winit='torch'``: kaiming-uniform(a=sqrt 5) kernel, uniform(+-1/sqrt
    fan_in) bias (torch's Conv2d default);
  * ``winit='resnet'``: normal(0, sqrt(2 / fan_out)) kernel, zero bias;
  * ``winit='head'``: normal(0, 0.01) kernel, zero bias (the detection heads);
  * ``winit='fpn'``: kaiming-uniform(a=1) kernel, zero bias (the classic FPN);
  * ``winit='lecun'``: truncated-normal(fan_in) kernel, zero bias (a bare
    flax ``nn.Conv``'s default: SSD's ``ExtraLayer.conv2``);
  * ``bias_const`` overrides the bias (the cls prior).

Each JAX wrapper (``Conv``, ``DepthwiseConv``, ``BatchNorm``,
``GroupNorm32``) adds one inner flax scope (``conv``, ``dw``, ``bn``,
``gn``); the port's module IS the wrapped layer, so its parameter names are
the flax path without those scopes (``train/checkpoints.py``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_object_detection_tpu_torch.ops.gn import groupnorm_act, groupnorm_act_autograd
from pytorch_object_detection_tpu_torch.parallel import sp, tp
from pytorch_object_detection_tpu_torch.parallel.collectives import all_reduce_autograd


def _uniform(shape, bound: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


class Conv(nn.Conv2d):
    """2D conv with symmetric padding ``d*(k-1)//2`` (or ``padding``) and the JAX package's init."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, groups: int = 1, bias: bool = True, winit: str = "torch",
                 bias_const: Optional[float] = None, generator: Optional[torch.Generator] = None,
                 padding: Optional[int] = None):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=dilation * (kernel - 1) // 2 if padding is None else padding,
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
            elif winit in ("resnet", "head"):
                std = math.sqrt(2.0 / (out_ch * kernel * kernel)) if winit == "resnet" else 0.01
                self.weight.copy_(torch.empty(shape).normal_(0.0, std, generator=generator))
                if bias:
                    self.bias.zero_()
            elif winit == "fpn":
                self.weight.copy_(_uniform(shape, math.sqrt(3.0 / fan_in), generator))  # gain 1 at a=1
                if bias:
                    self.bias.zero_()
            elif winit == "lecun":
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # unit variance after the cut at 2 std
                self.weight.copy_(nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2.0 * std, 2.0 * std,
                                                        generator=generator))
                if bias:
                    self.bias.zero_()
            else:
                raise ValueError(f"winit must be 'torch', 'resnet', 'head', 'fpn' or 'lecun'; got {winit!r}")
            if bias and bias_const is not None:
                self.bias.fill_(bias_const)

    def reset_parameters(self) -> None:
        """No-op: ``__init__`` draws the weights from the caller's generator
        (``nn.Conv2d.__init__`` would otherwise draw from the global RNG)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.shape[0] != self.out_channels:  # a tensor-parallel shard (parallel/tp.py)
            return tp.sharded_conv2d(x, self.weight, self.bias, self.stride, self.padding, self.dilation,
                                     self.groups, self.out_channels)
        return super().forward(x)


class DepthwiseConv(Conv):
    """Per-channel ``kernel`` x ``kernel`` conv (groups == channels), dilation
    ``dilation``, stride ``stride``, symmetric padding ``dilation * (kernel -
    1) // 2`` (the JAX ``Conv``'s, never "SAME"), no bias; 3x3, dilation 1,
    stride 1 by default (the HISHead's)."""

    def __init__(self, ch: int, kernel: int = 3, dilation: int = 1, generator: Optional[torch.Generator] = None,
                 stride: int = 1):
        super().__init__(ch, ch, kernel, stride=stride, dilation=dilation, groups=ch, bias=False,
                         generator=generator)


class BatchNorm(nn.Module):
    """BatchNorm over NCHW channels, eps 1e-5, frozen by default.

    Frozen (the reference's only trained configuration; the JAX package's
    ``use_running_average=True``): the running statistics normalize, and
    the affine and the statistics are buffers.  :func:`unfreeze_batchnorms`
    (a detector built with ``freeze_bn=False``) makes ``weight`` and
    ``bias`` parameters under the same ``state_dict`` names and sets
    ``batch_stats``: then, in training mode, the layer normalizes with the
    batch's statistics in f32 (or the input's wider type) and updates the
    running ones as flax's ``nn.BatchNorm`` (momentum 0.9) does: the biased variance
    ``E[x^2] - E[x]^2``, clipped at 0, normalizes and goes into
    ``running_var`` (``F.batch_norm`` would store the unbiased one).
    ``sync_group``, where set (:func:`batch_statistics`), makes the
    statistics those of the whole data-parallel batch: one all-reduce of
    the per-channel count, sum and sum of squares, through which autograd
    runs.  ``update_stats=False`` (:func:`frozen_running_stats`) leaves the
    running statistics alone: a recomputed forward must not update them a
    second time."""

    def __init__(self, ch: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(ch))
        self.register_buffer("bias", torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.batch_stats = False
        self.sync_group = None
        self.update_stats = True

    def affine_parameters(self) -> None:
        """``weight`` and ``bias`` as parameters (a trainer's ``freeze_bn=False``)."""
        for name in ("weight", "bias"):
            if name in self._buffers:
                self.register_parameter(name, nn.Parameter(self._buffers.pop(name)))

    def unfreeze(self) -> None:
        """The affine as parameters, the batch statistics in training mode."""
        self.affine_parameters()
        self.batch_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # tensor parallelism: the affine and statistics whole, gathered from this rank's slices
        weight, bias, running_mean, running_var = tp.full(
            (self.weight, self.bias, self.running_mean, self.running_var), x.shape[1])
        if not (self.training and self.batch_stats):
            return F.batch_norm(x, running_mean, running_var, weight, bias, training=False, momentum=0.0, eps=1e-5)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # at least f32, as flax computes
        if self.sync_group is None:  # a row band's sums span its whole image (parallel/sp.py)
            mean, mean2 = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
        else:
            c = xf.shape[1]
            count = torch.full((1,), sp.global_numel(xf) // c, dtype=xf.dtype, device=xf.device)
            sums = all_reduce_autograd(torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)), count]),
                                       self.sync_group)
            mean, mean2 = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.copy_(0.9 * self.running_mean + (1.0 - 0.9) * tp.local(mean.detach(),
                                                                                          self.running_mean))
                self.running_var.copy_(0.9 * self.running_var + (1.0 - 0.9) * tp.local(var.detach(),
                                                                                        self.running_var))
        mul = torch.rsqrt(var + 1e-5) * weight.to(xf.dtype)
        y = (xf - mean[:, None, None]) * mul[:, None, None] + bias.to(xf.dtype)[:, None, None]
        return y.to(x.dtype)


def batchnorms(module: nn.Module):
    """The :class:`BatchNorm` layers of ``module``."""
    return [m for m in module.modules() if isinstance(m, BatchNorm)]


def unfreeze_batchnorms(module: nn.Module) -> None:
    """Every BatchNorm of ``module`` trainable (a detector's ``freeze_bn=False``)."""
    for bn in batchnorms(module):
        bn.unfreeze()


@contextlib.contextmanager
def batch_statistics(bns, group=None):
    """Within the block, those of the BatchNorms ``bns`` that train their
    statistics run in training mode (the batch's statistics, the running
    ones updated), over the whole batch of ``group``'s ranks where given
    (SyncBatchNorm); the rest of the model keeps its mode."""
    bns = [bn for bn in bns if bn.batch_stats]
    modes = [bn.training for bn in bns]
    for bn in bns:
        bn.training, bn.sync_group = True, group
    try:
        yield
    finally:
        for bn, mode in zip(bns, modes):
            bn.training, bn.sync_group = mode, None


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Within the block, ``module``'s BatchNorms leave their running statistics as they are."""
    bns = batchnorms(module)
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn in bns:
            bn.update_stats = True


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
        weight, bias = tp.full((self.weight, self.bias), x.shape[1])  # whole, where tensor-parallel shards
        if sp.is_band(x) or (torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                                          or bias.requires_grad)):
            return groupnorm_act_autograd(x, weight, bias, groups=32, eps=1e-5, act=self.act)
        return groupnorm_act(x, weight, bias, groups=32, eps=1e-5, act=self.act, plain=plain)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool, floor mode."""
    return F.max_pool2d(x, 2, 2)


relu = F.relu
silu = F.silu


class SEBlock(nn.Module):
    """Squeeze-and-excitation: GAP -> 1x1 (C/reduction) -> SiLU -> 1x1 -> sigmoid -> scale
    (reduction 4, the HisBlock's; the MCBlock's is 6)."""

    def __init__(self, ch: int, reduction: int = 4, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = Conv(ch, ch // reduction, 1, generator=generator)
        self.fc2 = Conv(ch // reduction, ch, 1, generator=generator)

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


class ConvBnAct(nn.Module):
    """conv -> BN -> ReLU (``act='SiLU'``: SiLU); ``mode='DWconv'`` makes the
    conv depthwise (its output keeps ``in_ch`` channels).  The conv has no
    bias and is named as flax names an unnamed submodule (``Conv_0``,
    ``DepthwiseConv_0``), so a JAX ``ConvBnAct``'s variables load by
    ``train/checkpoints.load_flax_variables``."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 1, dilation: int = 1,
                 act: str = "relu", mode: str = "conv", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = act
        if mode == "DWconv":
            self.DepthwiseConv_0 = DepthwiseConv(in_ch, kernel, dilation, generator=generator, stride=stride)
            out_ch = in_ch
        else:
            self.Conv_0 = Conv(in_ch, features, kernel, stride, dilation, bias=False, generator=generator)
            out_ch = features
        self.bn1 = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.DepthwiseConv_0 if hasattr(self, "DepthwiseConv_0") else self.Conv_0
        x = self.bn1(conv(x))
        return silu(x) if self.act == "SiLU" else relu(x)


class SeparableConv(nn.Module):
    """Depthwise ``kernel`` x ``kernel`` -> BN -> ReLU, then 1x1 to ``features``
    -> BN -> ReLU (both convs with bias)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dw = Conv(in_ch, in_ch, kernel, groups=in_ch, generator=generator)
        self.bn1 = BatchNorm(in_ch)
        self.pw = Conv(in_ch, features, 1, generator=generator)
        self.bn2 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = relu(self.bn1(self.dw(x)))
        return relu(self.bn2(self.pw(x)))


class MCBottle(nn.Module):
    """Inverted bottleneck: 1x1 up to ``beta`` x C -> BN -> SiLU, depthwise
    ``kernel`` x ``kernel`` -> BN -> SiLU, SE (reduction ``alpha``), 1x1 down
    to ``features`` -> BN -> SiLU, + residual (so ``features`` == ``in_ch``)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, beta: int = 4, alpha: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, mid = generator, in_ch * beta
        self.pw1 = Conv(in_ch, mid, 1, bias=False, generator=g)
        self.bn1 = BatchNorm(mid)
        self.dw = DepthwiseConv(mid, kernel, generator=g)
        self.bn2 = BatchNorm(mid)
        self.se = SEBlock(mid, alpha, generator=g)
        self.pw2 = Conv(mid, features, 1, bias=False, generator=g)
        self.bn3 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = silu(self.bn1(self.pw1(x)))
        y = self.se(silu(self.bn2(self.dw(y))))
        return x + silu(self.bn3(self.pw2(y)))


class ICSPBlock(nn.Module):
    """CSP-style split: two :class:`MCBottle` s (``beta`` 2) then a 1x1 to
    C/2, beside a 1x1 to C/2 of the input; concat -> BN -> ReLU -> 3x3 to
    ``features`` -> BN -> ReLU."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, beta: int = 2, alpha: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, half = generator, in_ch // 2
        self.bottle1 = MCBottle(in_ch, in_ch, kernel, beta, alpha, generator=g)
        self.bottle2 = MCBottle(in_ch, in_ch, kernel, beta, alpha, generator=g)
        self.pw3 = Conv(in_ch, half, 1, generator=g)
        self.pw4 = Conv(in_ch, half, 1, generator=g)
        self.bn3 = BatchNorm(2 * half)
        self.conv5 = Conv(2 * half, features, 3, bias=False, generator=g)
        self.bn4 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bottle2(self.bottle1(x))
        z = relu(self.bn3(torch.cat([self.pw3(y), self.pw4(x)], dim=1)))
        return relu(self.bn4(self.conv5(z)))
