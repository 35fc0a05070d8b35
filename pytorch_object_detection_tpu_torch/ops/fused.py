"""K16: the matmul with the fused frozen-BN, residual and ReLU epilogue in CUDA, and its plain version.

K16 (``csrc/fused.cu``) replaces
``pytorch_object_detection_tpu/ops/pallas_fused.py:matmul_bn_act`` and
``:conv1x1_bn_act``::

    out = act((x @ w^T) * scale + shift (+ residual))

with the product accumulated in f32 on the tensor cores and the epilogue in
f32 before the one store in ``x``'s dtype.  The fused ResNet-50
(``nn/fused_resnet.resnet50_fused_forward``) runs every bottleneck's conv1
and conv3 through it.

Layouts: ``x [M, K]``, ``w [N, K]`` (the port's OIHW 1x1 weight, each
output channel's K-vector contiguous), ``residual [M, N]`` in ``x``'s dtype,
``scale`` and ``shift`` f32 ``[N]``.  Unlike the TPU kernel, M, N and K may
be anything.  On the card the kernel takes bfloat16 only; the f32 tests run
the plain version on the CPU.

On the card the tile is 128 x 128 output elements, or 128 x 64 where N <=
64 or where 128 x 128 tiles would leave SMs idle (:func:`pick_k16_tile`);
K runs through a ring of cp.async stages into wgmma (``csrc/fused.cu``).

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from pytorch_object_detection_tpu_torch.ops.qblock import card_limits

SOURCE = "fused.cu"
# no FMA contraction: the epilogue's multiply and add stay two roundings, as in the reference
NVCC_FLAGS = ("-fmad=false",)
K16_BM = 128  # output rows of a tile
K16_BNS = (128, 64)
K16_STAGES = 3  # kRingStages in csrc/fused.cu
K16_STEP = 128  # bytes of K per stage: 64 bf16


def k16_smem_bytes(bn: int) -> int:
    """Dynamic shared memory of one block with 128 x ``bn`` tiles
    (``RingShape<BN>::kSmem``): the ring of x and w strips, reused for the
    f32 sums (rows of bn + 8 words), and 1024 bytes to align the ring for
    wgmma's 128-byte swizzle."""
    return max(K16_STAGES * (K16_BM + bn) * K16_STEP, K16_BM * (bn + 8) * 4) + 1024


@functools.lru_cache(maxsize=None)
def pick_k16_tile(m: int, n: int, k: int, sm_count: int, smem_max: int) -> int:
    """Width ``bn`` of K16's 128 x bn output tiles for ``[M, K] x [N,
    K]^T``: 64 where N <= 64, else 128 where those tiles reach one block per
    SM, else 64 (twice the blocks).  ``k`` does not change the choice: every
    block walks the whole K."""
    fits = [bn for bn in K16_BNS if k16_smem_bytes(bn) <= smem_max]
    if not fits:
        raise ValueError(f"K16: a tile needs {k16_smem_bytes(K16_BNS[-1])} bytes of shared memory (> {smem_max})")
    if n > 64 and fits[0] == 128 and -(-m // K16_BM) * -(-n // 128) >= sm_count:
        return 128
    return fits[-1]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load K16; its C signature is declared here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE, NVCC_FLAGS)
    lib.matmul_bn_act_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.matmul_bn_act_launch.restype = ctypes.c_int
    lib.matmul_bn_act_smem.argtypes = [ctypes.c_int]
    lib.matmul_bn_act_smem.restype = ctypes.c_int
    for bn in K16_BNS:  # the chooser's arithmetic is the kernel's
        if lib.matmul_bn_act_smem(bn) != k16_smem_bytes(bn):
            raise RuntimeError(f"K16: a 128 x {bn} tile takes {lib.matmul_bn_act_smem(bn)} bytes of shared memory, "
                               f"the chooser {k16_smem_bytes(bn)}")
    return lib


def matmul_bn_act_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                        residual: Optional[torch.Tensor] = None, act: bool = True) -> torch.Tensor:
    """The GEMM and its epilogue in plain PyTorch ops, f32 throughout (the reference for K16)."""
    y = (x.float() @ w.float().t()) * scale.float() + shift.float()
    if residual is not None:
        y = y + residual.float()
    if act:
        y = torch.relu(y)
    return y.to(x.dtype)


def _check(x, w, scale, shift, residual) -> None:
    if x.dim() != 2 or not x.is_floating_point():
        raise ValueError(f"x must be a float [M, K]; got {x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    n = w.shape[0]
    if w.dtype != x.dtype or tuple(w.shape) != (n, k):
        raise ValueError(f"w must be {x.dtype} [N, {k}]; got {w.dtype} {tuple(w.shape)}")
    for name, v in (("scale", scale), ("shift", shift)):
        if v.dtype != torch.float32 or tuple(v.shape) != (n,):
            raise ValueError(f"{name} must be float32 [{n}]; got {v.dtype} {tuple(v.shape)}")
    if residual is not None and (residual.dtype != x.dtype or tuple(residual.shape) != (m, n)):
        raise ValueError(f"residual must be {x.dtype} [{m}, {n}]; got {residual.dtype} {tuple(residual.shape)}")


def matmul_bn_act(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                  residual: Optional[torch.Tensor] = None, act: bool = True, plain: bool = False) -> torch.Tensor:
    """``act((x @ w^T) * scale + shift (+ residual))``, ``[M, N]`` in
    ``x``'s dtype (module docstring).  On a CPU tensor this is
    :func:`matmul_bn_act_plain`; on a CUDA tensor it launches K16 (bfloat16
    only) or raises.  ``plain=True`` runs the plain version on any device,
    for the comparison only.  ``matmul_bn_act.launches`` counts kernel
    launches."""
    _check(x, w, scale, shift, residual)
    if plain or x.device.type == "cpu":
        return matmul_bn_act_plain(x, w, scale, shift, residual, act)
    if x.device.type != "cuda":
        raise ValueError(f"K16 runs on CUDA tensors; got {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"K16 takes bfloat16 on the card; got {x.dtype}")
    operands = [x, w, scale, shift] + ([residual] if residual is not None else [])
    if any(t.device != x.device for t in operands):
        raise ValueError(f"K16: every operand must be on {x.device}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("K16 takes contiguous operands")
    m, k = x.shape
    n = w.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if k == 0:
        raise ValueError("K16 needs K >= 1")
    bn = pick_k16_tile(m, n, k, *card_limits(x.device))
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = _lib().matmul_bn_act_launch(x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                                          None if residual is None else residual.data_ptr(), out.data_ptr(), m, n, k,
                                          int(act), bn, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K16 launch failed: cudaError {err}")
    matmul_bn_act.launches += 1
    return out


def conv1x1_bn_act(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                   residual: Optional[torch.Tensor] = None, act: bool = True, plain: bool = False) -> torch.Tensor:
    """1x1 stride-1 conv (+ BN epilogue, + residual, + ReLU) through
    :func:`matmul_bn_act`: NHWC ``[B, H, W, K]`` -> ``[B, H, W, N]``; ``w``
    ``[N, K]`` or the OIHW ``[N, K, 1, 1]``; ``residual`` NHWC."""
    b, h, wd, k = x.shape
    w2 = w.reshape(w.shape[0], k)
    n = w2.shape[0]
    r2 = None if residual is None else residual.reshape(b * h * wd, n)
    return matmul_bn_act(x.reshape(b * h * wd, k), w2, scale, shift, r2, act, plain).reshape(b, h, wd, n)


matmul_bn_act.launches = 0
