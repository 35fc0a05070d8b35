"""Post-training int8 quantization primitives.

Counterpart of ``pytorch_object_detection_tpu/ops/quant.py``: symmetric
int8, per-out-channel scales for conv weights, per-tensor abs-max scales for
activations.  Every function repeats the JAX one's f32 operations in the
same order (``acc * A + B``, then ``max 0``, then round), and rounds half to
even (``torch.round``) before clipping to +-127, so the two packages give
the same int8 values bit for bit.
"""
from __future__ import annotations

from typing import Tuple

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


def requantize(acc_f32: torch.Tensor, inv_out_scale_mul, shift, relu: bool = True) -> torch.Tensor:
    """Fused epilogue: f32 pre-activation ``acc * mul + shift`` (already
    divided by the output scale) -> int8 at the next layer's scale."""
    y = acc_f32 * inv_out_scale_mul + shift
    if relu:
        y = torch.clamp(y, min=0.0)
    return torch.clamp(torch.round(y), -INT8_MAX, INT8_MAX).to(torch.int8)
