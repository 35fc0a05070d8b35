"""K6 and K10: the int8 max pools in CUDA (``csrc/qpool.cu``), and their plain versions.

K6 replaces ``pytorch_object_detection_tpu/ops/pallas_pool.py:qmaxpool2x2``
(the HisFPN's downsamples and the seeds of its two extra levels).  Layout
int8 NHWC ``[B, H, W, C]`` -> ``[B, H // 2, W // 2, C]``: a VALID window,
so an odd row or column is dropped.  The plain version is the JAX oracle
``nn/fpn_int8._maxpool2x2_i8`` (``reduce_window`` with init -128).
:func:`qmaxpool2x2_seeds` is K6 as the HisFPN launches it: the two seeds of
its extra levels, ``pool(t5)`` and ``pool(pool(t5))``, from one read of
``t5`` in one launch (its four level pools run inside K5's load,
``ops/qhis.py`` ``combine="pool_add"``).

K10 replaces ``pallas_pool.py:qmaxpool3x3s2`` (the pool after the direct
7x7/2 uint8 stem conv): 3x3 window, stride 2, padding 1 with -128, ``[B, H,
W, C]`` -> ``[B, (H - 1) // 2 + 1, (W - 1) // 2 + 1, C]``; its plain version
is ``reduce_window`` with init -128 as slices.  The TPU kernel's
``emit_merged`` (the row-pair lane-merged layout of its stage-1 kernels) has
no counterpart.

Unlike the Pallas wrappers, the kernels take every shape and never fall back.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

SOURCE = "qpool.cu"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load K6 and K10; their C signatures are declared here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE)
    lib.qpool_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.qpool_launch.restype = ctypes.c_int
    lib.qpool_seeds_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.qpool_seeds_launch.restype = ctypes.c_int
    lib.qpool3_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.qpool3_launch.restype = ctypes.c_int
    return lib


def qmaxpool2x2_plain(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 VALID max pool of int8 NHWC in plain PyTorch ops."""
    b, h, w, c = x.shape
    ho, wo = h // 2, w // 2
    return x[:, :2 * ho, :2 * wo].reshape(b, ho, 2, wo, 2, c).amax(dim=(2, 4))


def qmaxpool2x2(x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """int8 ``[B, H, W, C]`` -> ``[B, H // 2, W // 2, C]``, 2x2 window, stride 2.

    On a CPU tensor this is :func:`qmaxpool2x2_plain`; on a CUDA tensor it
    launches K6 (NHWC-contiguous int8) or raises.  ``plain=True`` runs the
    plain version on any device, for the comparison only.
    ``qmaxpool2x2.launches`` counts kernel launches.
    """
    if _check_k6(x, plain):
        return qmaxpool2x2_plain(x)
    b, h, w, c = x.shape
    out = torch.empty((b, h // 2, w // 2, c), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = _lib().qpool_launch(x.data_ptr(), out.data_ptr(), b, h, w, c,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K6 launch failed: cudaError {err}")
    qmaxpool2x2.launches += 1
    return out


def _check_k6(x: torch.Tensor, plain: bool) -> bool:
    """Checks K6's operand; True where the plain version runs."""
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"x must be int8 [B, H, W, C] (NHWC); got {x.dtype} {tuple(x.shape)}")
    if plain or x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"K6 runs on CUDA tensors; got {x.device}")
    if not x.is_contiguous() or (x.shape[-1] % 16 == 0 and x.data_ptr() % 16):
        raise ValueError("K6 takes NHWC-contiguous int8 (16-byte aligned where C % 16 == 0)")
    return False


def qmaxpool2x2_seeds_plain(x: torch.Tensor):
    """``(pool(x), pool(pool(x)))`` with :func:`qmaxpool2x2_plain`."""
    s6 = qmaxpool2x2_plain(x)
    return s6, qmaxpool2x2_plain(s6)


def qmaxpool2x2_seeds(x: torch.Tensor, *, plain: bool = False):
    """int8 ``[B, H, W, C]`` -> ``(seed6 [B, H // 2, W // 2, C], seed7 [B,
    H // 2 // 2, W // 2 // 2, C])``: the 2x2/2 VALID pool and the pool of
    that, the HisFPN's extra-level seeds.

    On a CPU tensor this is :func:`qmaxpool2x2_seeds_plain`; on a CUDA
    tensor it launches K6's seeds kernel once or raises (C must be a
    multiple of 16, as t5's 2 x K5's half width is).  ``plain=True`` runs
    the plain version on any device, for the comparison only.
    ``qmaxpool2x2_seeds.launches`` counts kernel launches.
    """
    if _check_k6(x, plain):
        return qmaxpool2x2_seeds_plain(x)
    b, h, w, c = x.shape
    if c % 16:
        raise ValueError(f"K6's seeds kernel reads 16-channel words: C must be a multiple of 16; got {c}")
    s6 = torch.empty((b, h // 2, w // 2, c), dtype=torch.int8, device=x.device)
    s7 = torch.empty((b, h // 4, w // 4, c), dtype=torch.int8, device=x.device)
    if s6.numel() == 0:
        return s6, s7
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = _lib().qpool_seeds_launch(x.data_ptr(), s6.data_ptr(), s7.data_ptr(), b, h, w, c,
                                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K6 (seeds) launch failed: cudaError {err}")
    qmaxpool2x2_seeds.launches += 1
    return s6, s7


def qmaxpool3x3s2_plain(x: torch.Tensor) -> torch.Tensor:
    """int8 3x3/2 max pool, padding 1 (pad value -128), NHWC, in plain PyTorch ops."""
    xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=-128)
    ho, wo = (x.shape[1] - 1) // 2 + 1, (x.shape[2] - 1) // 2 + 1
    out = None
    for ky in range(3):
        for kx in range(3):
            win = xp[:, ky:ky + 2 * ho - 1:2, kx:kx + 2 * wo - 1:2]
            out = win if out is None else torch.maximum(out, win)
    return out.contiguous()


def qmaxpool3x3s2(x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """int8 ``[B, H, W, C]`` -> ``[B, (H - 1) // 2 + 1, (W - 1) // 2 + 1, C]``,
    3x3 window, stride 2, padding 1 (-128).

    On a CPU tensor this is :func:`qmaxpool3x3s2_plain`; on a CUDA tensor it
    launches K10 (NHWC-contiguous int8) or raises.  ``plain=True`` runs the
    plain version on any device, for the comparison only.
    ``qmaxpool3x3s2.launches`` counts kernel launches.
    """
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"x must be int8 [B, H, W, C] (NHWC); got {x.dtype} {tuple(x.shape)}")
    if plain or x.device.type == "cpu":
        return qmaxpool3x3s2_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"K10 runs on CUDA tensors; got {x.device}")
    b, h, w, c = x.shape
    if not x.is_contiguous() or (c % 16 == 0 and x.data_ptr() % 16):
        raise ValueError("K10 takes NHWC-contiguous int8 (16-byte aligned where C % 16 == 0)")
    out = torch.empty((b, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = _lib().qpool3_launch(x.data_ptr(), out.data_ptr(), b, h, w, c, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K10 launch failed: cudaError {err}")
    qmaxpool3x3s2.launches += 1
    return out


qmaxpool2x2.launches = 0
qmaxpool2x2_seeds.launches = 0
qmaxpool3x3s2.launches = 0
