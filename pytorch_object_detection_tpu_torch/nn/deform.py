"""Deformable convolution v2 (DCNv2) by bilinear gathers (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/nn/deform.py``: an offset
conv and a modulator conv predict, per output pixel, ``k*k`` fractional
sampling offsets (interleaved (dy, dx) per tap) and masks (``2 *
sigmoid``); the input is sampled bilinearly at the offset taps, each of the
four corners masked to zero on its own where it falls outside the map, the
taps scaled by the masks and contracted over (tap, channel) with a ``[k*k,
C, F]`` kernel.  Both predicting convs start at zero, so the module equals
a regular conv at init.

The gathers are PyTorch advanced indexing over the flattened map (no
kernel: the JAX version is an XLA gather and ``dot_general``), so the
module trains through autograd, its gradients reaching the input, the
kernel and both predicting convs.  torchvision's ``deform_conv2d`` would
not be this function: it masks the corners otherwise.

``_bilinear_gather`` and ``deform_sample`` take NHWC tensors, as the JAX
functions do; :class:`DeformableConv` runs NCHW in and out, as the port's
modules do.  Parameter names follow the flax scopes (``offset_conv``,
``modulator_conv``, ``weight`` for the flax ``kernel``, ``bias``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from pytorch_object_detection_tpu_torch.nn.layers import Conv


def _bilinear_gather(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """img ``[B, H, W, C]``; y, x ``[B, ..., T]`` fractional coordinates ->
    ``[B, ..., T, C]``.  A corner outside the map contributes zero."""
    b, h, w, c = img.shape
    flat = img.reshape(b, h * w, c)
    rows = torch.arange(b, device=img.device).reshape(b, *([1] * (y.dim() - 1)))
    y0, x0 = torch.floor(y), torch.floor(x)
    wy, wx = (y - y0)[..., None], (x - x0)[..., None]

    def tap(yy, xx):
        inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        yc = torch.clamp(yy, 0, h - 1).long()
        xc = torch.clamp(xx, 0, w - 1).long()
        vals = flat[rows, yc * w + xc]  # advanced indexing: a gather, [B, ..., T, C]
        return torch.where(inside[..., None], vals, torch.zeros((), dtype=vals.dtype, device=vals.device))

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    return v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx + v10 * wy * (1 - wx) + v11 * wy * wx


def deform_sample(images: torch.Tensor, offsets: torch.Tensor, kernel: int, stride: int = 1) -> torch.Tensor:
    """images ``[B, H, W, C]``; offsets ``[B, Ho, Wo, 2*k*k]`` ((dy, dx)
    interleaved per tap) -> the sampled taps ``[B, Ho, Wo, k*k, C]``."""
    b = images.shape[0]
    ho, wo = offsets.shape[1:3]
    k, pad, dev = kernel, kernel // 2, images.device
    ky, kx = torch.meshgrid(torch.arange(k, device=dev) - pad, torch.arange(k, device=dev) - pad, indexing="ij")
    taps_y = (torch.arange(ho, device=dev) * stride)[:, None, None] + ky.reshape(-1)[None, None, :]  # [Ho, 1, T]
    taps_x = (torch.arange(wo, device=dev) * stride)[None, :, None] + kx.reshape(-1)[None, None, :]  # [1, Wo, T]
    off = offsets.reshape(b, ho, wo, k * k, 2)
    y = taps_y[None].float() + off[..., 0]
    x = taps_x[None].float() + off[..., 1]
    return _bilinear_gather(images, y, x)


class DeformableConv(nn.Module):
    """DCNv2: the offset and modulator convs -> bilinear taps -> the kernel
    contraction, NCHW in and out, f32 sums."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 1, bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k, t = kernel, kernel * kernel
        self.kernel, self.stride = kernel, stride
        self.offset_conv = Conv(in_ch, 2 * t, k, stride=stride, padding=k // 2, generator=generator)
        self.modulator_conv = Conv(in_ch, t, k, stride=stride, padding=k // 2, generator=generator)
        with torch.no_grad():
            for conv in (self.offset_conv, self.modulator_conv):  # zero init: a regular conv at init
                conv.weight.zero_()
                conv.bias.zero_()
        # He normal on fan-out (flax variance_scaling(2, "fan_out") of [T, C, F]: fan_out = T * F)
        self.weight = nn.Parameter(torch.empty(t, in_ch, features).normal_(0.0, math.sqrt(2.0 / (t * features)),
                                                                           generator=generator))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        offsets = self.offset_conv(x).permute(0, 2, 3, 1)
        modulator = 2.0 * torch.sigmoid(self.modulator_conv(x)).permute(0, 2, 3, 1)
        taps = deform_sample(x.permute(0, 2, 3, 1), offsets, self.kernel, self.stride)  # [B, Ho, Wo, T, C]
        taps = taps * modulator[..., None]
        b, ho, wo, t, c = taps.shape
        out = (taps.reshape(b * ho * wo, t * c) @ self.weight.reshape(t * c, -1)).reshape(b, ho, wo, -1)
        if self.bias is not None:
            out = out + self.bias
        return out.permute(0, 3, 1, 2)
