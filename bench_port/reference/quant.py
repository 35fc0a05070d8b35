"""Lower-precision operands for the controls.

A control is the plain reference computed one precision step below what a
configuration states, put in the program's place: its readings must fail
the comparison that decides ``correct``.  Each function here returns
``quant(tensor, role)`` for ``models.conv``: the tensor rounded to the
lower precision and returned in float32, so the convolution itself runs
in float32 on the rounded operands.

- ``int4``: the step below int8 serving.  Activations symmetric per
  tensor, weights symmetric per output channel, both by their largest
  magnitude (dynamic, which if anything favours the control).
- ``fp8``: the step below bfloat16 training, float8 e4m3 with one scale a
  tensor (the largest magnitude to 448); the backward passes the gradient
  through the rounding unchanged.
"""
from __future__ import annotations

import torch


def _int_round(x: torch.Tensor, bits: int, dims) -> torch.Tensor:
    top = 2 ** (bits - 1) - 1
    amax = x.detach().abs().amax(dim=dims, keepdim=True) if dims else x.detach().abs().max()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return torch.clamp(torch.round(x / scale), -top, top) * scale


def int4(x: torch.Tensor, role: str) -> torch.Tensor:
    return _int_round(x, 4, (1, 2, 3) if role == "weight" else None)


def fp8(x: torch.Tensor, role: str) -> torch.Tensor:
    amax = x.detach().abs().max()
    scale = torch.where(amax > 0, 448.0 / amax, torch.ones_like(amax))
    rounded = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (rounded - x).detach()


CONTROLS = {"int4": int4, "fp8": fp8}
