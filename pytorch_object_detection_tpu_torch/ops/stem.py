"""K17: the bf16 stem tail (BN + ReLU, 3x3/2 max pool, int8 quantize) in CUDA (``csrc/stem.cu``), and its plain version.

Replaces ``pytorch_object_detection_tpu/ops/pallas_stem.py:stem_bn_pool_quant``,
the float stem's tail on ``backend="pallas_stem_tail"``: the bf16 output of
the 7x7/2 stem conv ``[B, H, W, C]`` NHWC -> the pooled int8 ``[B, (H - 1) //
2 + 1, (W - 1) // 2 + 1, C]``.  ``mult``, ``shift`` are the folded BN's f32
scale and shift, rounded to bf16 as the JAX kernel does; ``scale`` is the
stem's activation scale, whose inverse is taken once in f32 (the JAX
kernel's ``x * (1 / s)``, not ``quantize_act``'s ``x / s``).

Layout: the stem conv runs on NHWC frames, which ``permute(0, 3, 1, 2)``
turns into a channels-last NCHW view, so the conv's bf16 output is
channels-last too and its NHWC permute is contiguous: K17 reads it with no
layout copy, where an NCHW reader would need a transpose of the 67 MB map
(B=8, 512x512).  The plain version repeats the kernel's bf16 ops in its
order; on a CPU tensor the wrapper runs it, on a CUDA tensor it launches K17
or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

SOURCE = "stem.cu"
# no FMA contraction: a fused multiply-add moves values across a rounding boundary
NVCC_FLAGS = ("-fmad=false",)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load K17; its C signature is declared here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE, NVCC_FLAGS)
    lib.stem_tail_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.stem_tail_launch.restype = ctypes.c_int
    return lib


def stem_bn_pool_quant_plain(x: torch.Tensor, mult_b: torch.Tensor, shift_b: torch.Tensor,
                             inv_s: torch.Tensor) -> torch.Tensor:
    """The kernel's ops in plain PyTorch: BN + ReLU in ``x``'s dtype (bf16:
    each op rounded to bf16), the 3x3/2 pool over zero padding (exact after
    the ReLU), then ``clip8(pooled * inv_s)`` in f32."""
    y = torch.clamp(x * mult_b + shift_b, min=0)
    pooled = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)
    return torch.clamp(torch.round(pooled.float() * inv_s), -127.0, 127.0).to(torch.int8).contiguous()


def stem_bn_pool_quant(x: torch.Tensor, mult: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, *,
                       plain: bool = False) -> torch.Tensor:
    """bf16 stem-conv output ``[B, H, W, C]`` (NHWC) -> int8 ``[B, (H - 1) //
    2 + 1, (W - 1) // 2 + 1, C]``: BN + ReLU in bf16, 3x3/2 max pool, int8 at
    ``scale`` (a 0-d f32 tensor).  An f32 stem (the CPU tests' compute
    dtype) runs the plain version in f32 with the bf16-rounded ``mult`` and
    ``shift``, as the JAX kernel does with an f32 input.

    On a CPU tensor this is :func:`stem_bn_pool_quant_plain`; on a CUDA
    tensor it launches K17 or raises.  ``plain=True`` runs the plain version
    on any device, for the comparison only.  ``stem_bn_pool_quant.launches``
    counts kernel launches.
    """
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 4:
        raise ValueError(f"x must be bf16 (or f32) [B, H, W, C] (NHWC); got {x.dtype} {tuple(x.shape)}")
    b, h, w, c = x.shape
    for name, v in (("mult", mult), ("shift", shift)):
        if v.dtype != torch.float32 or tuple(v.shape) != (c,):
            raise ValueError(f"{name} must be float32 [{c}]; got {v.dtype} {tuple(v.shape)}")
    if scale.dtype != torch.float32 or scale.numel() != 1:
        raise ValueError(f"scale must be one float32 value; got {scale.dtype} {tuple(scale.shape)}")
    mult_b, shift_b = mult.to(torch.bfloat16), shift.to(torch.bfloat16)
    inv_s = (1.0 / scale).reshape(())
    if plain or x.device.type == "cpu":
        return stem_bn_pool_quant_plain(x, mult_b, shift_b, inv_s)
    if x.device.type != "cuda":
        raise ValueError(f"K17 runs on CUDA tensors; got {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"K17 takes the bf16 stem; got {x.dtype}")
    if any(t.device != x.device for t in (mult, shift, scale)):
        raise ValueError(f"K17: every operand must be on {x.device}")
    if not x.is_contiguous() or c % 8 or x.data_ptr() % 16:
        raise ValueError(f"K17 reads x in 16-byte words: it must be NHWC-contiguous, 16-byte aligned, with C a "
                         f"multiple of 8 (got {c})")
    out = torch.empty((b, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = _lib().stem_tail_launch(x.data_ptr(), mult_b.data_ptr(), shift_b.data_ptr(), inv_s.data_ptr(),
                                      out.data_ptr(), b, h, w, c, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K17 launch failed: cudaError {err}")
    stem_bn_pool_quant.launches += 1
    return out


stem_bn_pool_quant.launches = 0
