"""K4: int8 GEMM with the fused requant epilogue in CUDA (``csrc/qconv.cu``), and its plain version.

Replaces ``pytorch_object_detection_tpu/ops/pallas_qconv.py:qmatmul`` (with
and without the int8 residual) and ``:qconv1x1``; on the serving path it
runs the HisFPN's three lateral 1x1 convs.  The epilogue, in the oracle's
order (``pallas_qconv.py:38-44``)::

    y = acc * a + b;  y += res * res_scale;  y = relu(y);  out = clip8(y)

Layouts: ``x [M, K]`` int8 (``qconv1x1``: NHWC ``[B, H, W, K]``), ``w
[N, K]`` int8 (each output channel's K-vector contiguous, the port's 1x1
layout), ``a``, ``b`` f32 ``[N]``, ``res [M, N]`` int8 and ``res_scale`` a
0-d f32 tensor.  K must be a multiple of 16 on the card.  The plain version
is ``torch._int_mm`` (exact int32) and the same epilogue; on a CPU tensor
the wrappers run it, on a CUDA tensor they launch K4 or raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from pytorch_object_detection_tpu_torch.ops.quant import clip8, int_mm

SOURCE = "qconv.cu"
# no FMA contraction: a fused multiply-add moves values across a requant boundary
NVCC_FLAGS = ("-fmad=false",)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load K4; its C signature is declared here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE, NVCC_FLAGS)
    lib.qmm_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.qmm_launch.restype = ctypes.c_int
    return lib


def qmatmul_plain(x, w, a, b, *, relu: bool = True, res=None, res_scale=None) -> torch.Tensor:
    """The GEMM and its epilogue in plain PyTorch ops (the reference for K4)."""
    y = int_mm(x, w).float() * a + b
    if res is not None:
        y = y + res.float() * res_scale
    if relu:
        y = torch.clamp(y, min=0.0)
    return clip8(y)


def _check(x, w, a, b, res, res_scale) -> None:
    if x.dtype != torch.int8 or x.dim() != 2:
        raise ValueError(f"x must be int8 [M, K]; got {x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    n = w.shape[0]
    if w.dtype != torch.int8 or tuple(w.shape) != (n, k):
        raise ValueError(f"w must be int8 [N, {k}]; got {w.dtype} {tuple(w.shape)}")
    for name, v in (("a", a), ("b", b)):
        if v.dtype != torch.float32 or tuple(v.shape) != (n,):
            raise ValueError(f"{name} must be float32 [{n}]; got {v.dtype} {tuple(v.shape)}")
    if res is not None:
        if res.dtype != torch.int8 or tuple(res.shape) != (m, n):
            raise ValueError(f"res must be int8 [{m}, {n}]; got {res.dtype} {tuple(res.shape)}")
        if res_scale is None or res_scale.numel() != 1:
            raise ValueError("res needs res_scale (one f32 value)")


def qmatmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *, relu: bool = True,
            res: Optional[torch.Tensor] = None, res_scale=None, plain: bool = False) -> torch.Tensor:
    """int8 ``x [M, K]`` x ``w [N, K]^T`` -> int8 ``[M, N]`` with the fused
    epilogue (module docstring).  On a CPU tensor this is
    :func:`qmatmul_plain`; on a CUDA tensor it launches K4 or raises.
    ``plain=True`` runs the plain version on any device, for the comparison
    only.  ``qmatmul.launches`` counts kernel launches."""
    if res is not None and not isinstance(res_scale, torch.Tensor):
        res_scale = torch.tensor(float(res_scale), dtype=torch.float32, device=x.device)
    _check(x, w, a, b, res, res_scale)
    if plain or x.device.type == "cpu":
        return qmatmul_plain(x, w, a, b, relu=relu, res=res, res_scale=res_scale)
    if x.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA tensors; got {x.device}")
    operands = [x, w, a, b] + ([res, res_scale] if res is not None else [])
    if any(t.device != x.device for t in operands):
        raise ValueError(f"K4: every operand must be on {x.device}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("K4 takes contiguous operands")
    m, k = x.shape
    n = w.shape[0]
    if k % 16 or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"K4 reads x and w in 16-byte words: K must be a multiple of 16 (got {k}) "
                         "and both must start 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    if -(-n // 64) > 65535:
        raise ValueError(f"K4 takes at most {65535 * 64} output channels; got {n}")
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = _lib().qmm_launch(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), ptr(res),
                                ptr(res_scale if res is not None else None), out.data_ptr(), m, n, k, int(relu),
                                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed: cudaError {err}")
    qmatmul.launches += 1
    return out


def qconv1x1(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *, relu: bool = True,
             res: Optional[torch.Tensor] = None, res_scale=None, plain: bool = False) -> torch.Tensor:
    """1x1 conv through :func:`qmatmul`: NHWC int8 ``[B, H, W, K]`` ->
    ``[B, H, W, N]``; ``res`` NHWC ``[B, H, W, N]``."""
    bsz, h, wd, k = x.shape
    n = w.shape[0]
    r2 = None if res is None else res.reshape(bsz * h * wd, n)
    return qmatmul(x.reshape(bsz * h * wd, k), w, a, b, relu=relu, res=r2, res_scale=res_scale,
                   plain=plain).reshape(bsz, h, wd, n)


qmatmul.launches = 0
