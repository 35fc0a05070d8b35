"""BatchNorm folding and the inference-fused ResNet-50 forward (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/nn/fused_resnet.py``:

* ``fold_bn_params`` / ``fold_bn`` (``_fold_bn``): a frozen BatchNorm
  becomes a per-channel f32 ``(mult, shift)`` with ``mult = scale *
  rsqrt(var + eps)`` and ``shift = bias - mean * mult`` (eps 1e-5);
* ``conv_bn_act`` (``_conv_bn_act``): conv, then ``y * mult + shift`` in
  the conv's dtype, then optional ReLU (NCHW);
* ``resnet50_fused_forward``: (C3, C4, C5) with every bottleneck's 1x1
  conv1 and conv3 on K16 (``ops/fused.py``: the BN, the residual add and
  the ReLU in the GEMM's epilogue) and conv2, the projection shortcut and
  the stem as cuDNN convs with the BN folded in.  The activations stay NHWC
  from the stem on: an NHWC map is K16's ``[M, K]`` with no copy, and the
  3x3 convs take its channels-last NCHW view, so no layout transpose runs.
  ``fold_resnet50`` folds the BNs once; the JAX function folds at each
  call, with the same numbers.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_object_detection_tpu_torch.nn.layers import BatchNorm
from pytorch_object_detection_tpu_torch.ops.fused import conv1x1_bn_act

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


def fold_resnet50(backbone: nn.Module, compute_dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The folded weights :func:`resnet50_fused_forward` uses, computed once
    from ``backbone``'s f32 weights: K16's ``[N, K]`` kernels in
    ``compute_dtype`` with f32 ``(mult, shift)``; the cuDNN convs' kernels
    with ``(mult, shift)`` cast to ``compute_dtype``, as the JAX
    ``_conv_bn_act`` applies them.  Later changes to ``backbone`` are not
    seen."""
    def cast(conv, bn):
        mult, shift = fold_bn(bn)
        return conv.weight.detach().to(compute_dtype), mult.to(compute_dtype), shift.to(compute_dtype)

    def gemm(conv, bn):
        w = conv.weight.detach()
        return (w.reshape(w.shape[0], -1).to(compute_dtype).contiguous(), *fold_bn(bn))

    mult, shift = fold_bn(backbone.bn1)
    out = {"stem": (mult.to(compute_dtype), shift.to(compute_dtype)), "blocks": []}
    for names in backbone.stages:
        for name in names:
            blk = getattr(backbone, name)
            out["blocks"].append({
                "stride": blk.conv2.stride[0],
                "conv1": gemm(blk.conv1, blk.bn1),
                "conv2": cast(blk.conv2, blk.bn2),
                "conv3": gemm(blk.conv3, blk.bn3),
                "shortcut": cast(blk.downsample_conv, blk.downsample_bn) if blk.has_projection else None,
            })
    return out


def _nchw_conv_bn(x_nhwc: torch.Tensor, w: torch.Tensor, mult: torch.Tensor, shift: torch.Tensor, stride: int,
                  act: bool) -> torch.Tensor:
    """cuDNN conv (SAME for 3x3, none for 1x1) on the channels-last NCHW view
    of an NHWC map, then the BN in the map's dtype and the optional ReLU;
    back as an NHWC tensor."""
    y = F.conv2d(x_nhwc.permute(0, 3, 1, 2), w, None, stride, w.shape[-1] // 2)
    y = y * mult[:, None, None] + shift[:, None, None]
    y = torch.relu(y) if act else y
    return y.permute(0, 2, 3, 1).contiguous()  # no copy when cuDNN kept channels-last


@torch.no_grad()
def resnet50_fused_forward(backbone: nn.Module, x_nhwc: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16,
                           folded: Optional[Dict] = None) -> Tuple[torch.Tensor, ...]:
    """(C3, C4, C5) NHWC in ``compute_dtype`` from normalized NHWC images,
    as ``resnet50_fused_forward`` of the JAX package (module docstring).
    ``folded`` is :func:`fold_resnet50`'s result (made here when None)."""
    folded = fold_resnet50(backbone, compute_dtype) if folded is None else folded
    x = x_nhwc.to(compute_dtype).permute(0, 3, 1, 2)  # the NCHW view of the NHWC frames
    mult, shift = folded["stem"]
    x = torch.relu(backbone.stem_conv(x) * mult[:, None, None] + shift[:, None, None])
    x = F.max_pool2d(x, 3, 2, padding=1).permute(0, 2, 3, 1).contiguous()
    outputs, i = [], 0
    for names in backbone.stages:
        for _ in names:
            blk = folded["blocks"][i]
            i += 1
            y = conv1x1_bn_act(x, *blk["conv1"], act=True)
            y = _nchw_conv_bn(y, *blk["conv2"], blk["stride"], act=True)
            shortcut = x if blk["shortcut"] is None else _nchw_conv_bn(x, *blk["shortcut"], blk["stride"], act=False)
            x = conv1x1_bn_act(y, *blk["conv3"], residual=shortcut, act=True)
        outputs.append(x)
    return tuple(outputs[-3:])
