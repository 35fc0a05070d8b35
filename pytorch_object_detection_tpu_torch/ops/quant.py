"""Post-training int8 quantization primitives.

Counterpart of ``pytorch_object_detection_tpu/ops/quant.py``: symmetric
int8, per-out-channel scales for conv weights, per-tensor abs-max scales for
activations.  Every function repeats the JAX one's f32 operations in the
same order (``acc * A + B``, then ``max 0``, then round), and rounds half to
even (``torch.round``) before clipping to +-127, so the two packages give
the same int8 values bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

INT8_MAX = 127.0


def weight_qparams(w: torch.Tensor, axis: int = -1, eps: float = 1e-12) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel symmetric int8 quantization of a conv kernel along ``axis``
    (the output channels).  Returns (w_q int8, scale f32[cout])."""
    w = w.float()
    axis = axis % w.dim()
    reduce_dims = [i for i in range(w.dim()) if i != axis]
    absmax = w.abs().amax(dim=reduce_dims)
    scale = torch.clamp(absmax, min=eps) / INT8_MAX
    shape = [1] * w.dim()
    shape[axis] = -1
    w_q = torch.clamp(torch.round(w / scale.reshape(shape)), -INT8_MAX, INT8_MAX).to(torch.int8)
    return w_q, scale


def act_scale(absmax, eps: float = 1e-12) -> torch.Tensor:
    """Per-tensor activation scale (a 0-d f32 tensor) from a calibrated abs-max."""
    return torch.clamp(torch.as_tensor(absmax, dtype=torch.float32), min=eps) / INT8_MAX


def quantize_act(x: torch.Tensor, scale) -> torch.Tensor:
    """f32/bf16 -> int8 with the given per-tensor scale."""
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -INT8_MAX, INT8_MAX).to(torch.int8)


def clip8(y: torch.Tensor) -> torch.Tensor:
    """f32 -> int8: round half to even, clip to +-127."""
    return torch.clamp(torch.round(y), -INT8_MAX, INT8_MAX).to(torch.int8)


def requantize(acc_f32: torch.Tensor, inv_out_scale_mul, shift, relu: bool = True) -> torch.Tensor:
    """Fused epilogue: f32 pre-activation ``acc * mul + shift`` (already
    divided by the output scale) -> int8 at the next layer's scale."""
    y = acc_f32 * inv_out_scale_mul + shift
    if relu:
        y = torch.clamp(y, min=0.0)
    return clip8(y)


def int_mm(m: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``m [M, K] @ w [N, K]^T`` of int8 operands (``torch._int_mm``,
    which takes more than 16 rows and, on the card, a multiple of 8 columns
    and a depth that is a multiple of 8: the operands are padded with zeros
    and the result cut back)."""
    rows, cols = m.shape[0], w.shape[0]
    if rows <= 16:
        m = torch.nn.functional.pad(m, (0, 0, 0, 17 - rows))
    if cols % 8:
        w = torch.nn.functional.pad(w, (0, 0, 0, 8 - cols % 8))
    if m.shape[1] % 8:  # the direct 7x7 stem: 7 * 7 * 4 = 196 taps
        depth = 8 - m.shape[1] % 8
        m, w = torch.nn.functional.pad(m, (0, depth)), torch.nn.functional.pad(w, (0, depth))
    return torch._int_mm(m.contiguous(), w.t())[:rows, :cols]


def conv_i8(x: torch.Tensor, w: torch.Tensor, stride: int = 1, dilation: int = 1,
            pad: Optional[int] = None) -> torch.Tensor:
    """int8 NHWC conv with an exact int32 accumulator, returned as f32
    (rounded to nearest where it exceeds 2**24, as the JAX oracle's
    ``astype`` does).

    x ``[B, H, W, C]`` int8; w ``[N, C]`` (1x1) or ``[N, kh, kw, C]`` int8
    (each output channel's K-vector contiguous); zero padding ``pad``, by
    default ``dilation * (k - 1) // 2``.  Returns ``[B, Ho, Wo, N]`` f32.
    """
    k = 1 if w.dim() == 2 else w.shape[1]
    pad = dilation * (k - 1) // 2 if pad is None else pad
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    b, h, wd, _ = x.shape
    span = dilation * (k - 1)
    ho, wo = (h - span - 1) // stride + 1, (wd - span - 1) // stride + 1
    cols = torch.cat([x[:, ky * dilation:ky * dilation + stride * (ho - 1) + 1:stride,
                        kx * dilation:kx * dilation + stride * (wo - 1) + 1:stride]
                      for ky in range(k) for kx in range(k)], dim=-1)
    acc = int_mm(cols.reshape(b * ho * wo, -1), w.reshape(w.shape[0], -1))
    return acc.float().reshape(b, ho, wo, -1)
