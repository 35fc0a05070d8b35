"""K12: one whole int8 MNBlock in CUDA (``csrc/qmnblock.cu``), and its plain version.

Replaces ``pytorch_object_detection_tpu/ops/pallas_qmnblock.py:qmnblock``,
the MNFCOS building block in int8::

    a1  = clip8((dw(x) * (s_in * swdw) + bdw) / s_a1)     k x k depthwise, dilation d, "same" padding
    z   = conv1x1(a1, w1) * (s_a1 * sw1) + b1              C -> cmid
    a2  = clip8(z * sigmoid(z) / s_a2)
    y   = conv1x1(a2, w2) * (s_a2 * sw2) + b2              cmid -> C
    out = clip8(y / s_out + x * (s_in / s_out))

(``clip8``: round half to even, clip to +-127; the BN is folded into the
depthwise kernel before its quantization, so ``bdw`` is the BN shift.)

Layouts: ``x_q`` int8 NHWC ``[B, H, W, C]``, contiguous; one block's
parameters as ``models/mnfcos_int8.quantize_lwfpn`` / ``quantize_mnhead``
make them: ``wdw [k, k, C]``, ``w1 [cmid, C]``, ``w2 [C, cmid]`` int8 (each
output channel's K-vector contiguous); ``swdw``, ``bdw``, ``sw2``, ``b2``
f32 ``[C]``, ``sw1``, ``b1`` f32 ``[cmid]``; ``sc`` holds ``s_in``, ``s_a1``,
``s_a2``, ``s_out`` (0-d f32 tensors).  k is odd, the dilation 1 or 2; on
the card C must be a multiple of 16.

The plain version is the JAX oracle ``models/mnfcos_int8._mnblock_i8``
(``use_pallas=False``, ``:153-160``) operation for operation: the depthwise
and the 1x1 convs as exact int32 sums, the f32 epilogues in the oracle's
order, division by the per-tensor scales (not multiplication by their
reciprocals).  The kernel repeats those f32 steps one by one under
``-fmad=false``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from pytorch_object_detection_tpu_torch.ops.qblock import card_limits
from pytorch_object_detection_tpu_torch.ops.qhis import depthwise_i8
from pytorch_object_detection_tpu_torch.ops.quant import clip8, conv_i8

SOURCE = "qmnblock.cu"
# no FMA contraction: a fused multiply-add moves values across a requant boundary
NVCC_FLAGS = ("-fmad=false",)
# the pointer table of qmnblock_launch, in csrc/qmnblock.cu's order (then the output)
_PARAMS = ("wdw", "swdw", "bdw", "w1", "sw1", "b1", "w2", "sw2", "b2")
_SCALES = ("s_in", "s_a1", "s_a2", "s_out")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load K12; its C signatures are declared here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE, NVCC_FLAGS)
    lib.qmnblock_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.qmnblock_smem_bytes.restype = ctypes.c_size_t
    lib.qmnblock_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.qmnblock_launch.restype = ctypes.c_int
    return lib


def qmnblock_plain(blk: Dict, sc: Dict, x_q: torch.Tensor, kernel: int, dilation: int) -> torch.Tensor:
    """The MNBlock in plain PyTorch ops (the reference for K12); ``kernel``
    is the size of ``blk["wdw"]``."""
    acc = depthwise_i8(x_q, blk["wdw"], dilation)
    a1 = clip8((acc * (sc["s_in"] * blk["swdw"]) + blk["bdw"]) / sc["s_a1"])
    z = conv_i8(a1, blk["w1"]) * (sc["s_a1"] * blk["sw1"]) + blk["b1"]
    a2 = clip8(z * torch.sigmoid(z) / sc["s_a2"])  # the oracle's SiLU, not F.silu's
    y = conv_i8(a2, blk["w2"]) * (sc["s_a2"] * blk["sw2"]) + blk["b2"]
    return clip8(y / sc["s_out"] + x_q.float() * (sc["s_in"] / sc["s_out"]))


def _check(blk: Dict, sc: Dict, x_q: torch.Tensor, kernel: int, dilation: int) -> None:
    if x_q.dtype != torch.int8 or x_q.dim() != 4:
        raise ValueError(f"x_q must be int8 [B, H, W, C] (NHWC); got {x_q.dtype} {tuple(x_q.shape)}")
    if kernel % 2 != 1 or kernel < 1 or dilation not in (1, 2):
        raise ValueError(f"K12 takes an odd kernel size and dilation 1 or 2; got kernel={kernel}, dilation={dilation}")
    c = x_q.shape[-1]
    cmid = blk["w1"].shape[0]
    shapes = {"wdw": (kernel, kernel, c), "w1": (cmid, c), "w2": (c, cmid)}
    shapes.update({k: (c,) for k in ("swdw", "bdw", "sw2", "b2")})
    shapes.update({k: (cmid,) for k in ("sw1", "b1")})
    for name, shape in shapes.items():
        t = blk[name]
        dtype = torch.int8 if name in ("wdw", "w1", "w2") else torch.float32
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {list(shape)} for a {kernel}x{kernel} block on {c} channels; "
                             f"got {t.dtype} {list(t.shape)}")
    for name in _SCALES:
        t = sc[name]
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError(f"{name} must be one float32 value in a tensor; got {t!r}")


def _launch(blk: Dict, sc: Dict, x_q: torch.Tensor, kernel: int, dilation: int) -> torch.Tensor:
    """K12 on CUDA tensors (checked by ``_check`` first)."""
    dev = x_q.device
    operands = [x_q] + [blk[k] for k in _PARAMS] + [sc[k] for k in _SCALES]
    if any(t.device != dev for t in operands):
        raise ValueError(f"K12: every operand must be on {dev}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("K12 takes contiguous operands (x_q NHWC-contiguous)")
    b, h, w, c = x_q.shape
    cmid = blk["w1"].shape[0]
    if c % 16 or any(t.data_ptr() % 16 for t in (x_q, blk["w1"], blk["w2"])):
        raise ValueError(f"K12 reads x_q, w1 and w2 in 16-byte words: C must be a multiple of 16 (got {c}) "
                         "and they must start 16-byte aligned")
    out = torch.empty_like(x_q)
    if out.numel() == 0:
        return out
    if b > 65535:
        raise ValueError(f"K12 takes at most 65535 images per call; got {b}")
    lib = _lib()
    smem, smem_max = lib.qmnblock_smem_bytes(c, cmid, kernel, dilation), card_limits(dev)[1]
    if smem > smem_max:
        raise ValueError(f"K12: a {kernel}x{kernel} d{dilation} block on {c} -> {cmid} channels needs {smem} bytes "
                         f"of shared memory (> {smem_max})")
    ptrs = operands + [out]
    table = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.qmnblock_launch(table, b, h, w, c, cmid, kernel, dilation, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K12 launch failed: cudaError {err}")
    qmnblock.launches += 1
    return out


def qmnblock(blk: Dict, sc: Dict, x_q: torch.Tensor, kernel: int, dilation: int, *,
             plain: bool = False) -> torch.Tensor:
    """Fused int8 MNBlock (the JAX ``_mnblock_i8`` signature): int8 NHWC
    ``[B, H, W, C]`` in and out.

    On a CPU tensor this is :func:`qmnblock_plain`; on a CUDA tensor it
    launches K12 or raises.  ``plain=True`` runs the plain version on any
    device, for the comparison only.  ``qmnblock.launches`` counts kernel
    launches.
    """
    _check(blk, sc, x_q, kernel, dilation)
    if plain or x_q.device.type == "cpu":
        return qmnblock_plain(blk, sc, x_q, kernel, dilation)
    if x_q.device.type != "cuda":
        raise ValueError(f"K12 runs on CUDA tensors; got {x_q.device}")
    return _launch(blk, sc, x_q, kernel, dilation)


qmnblock.launches = 0
