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
import math
from typing import Dict, Optional, Tuple

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


TILE_WIDTHS = (16, 8)
SPLITS = (1, 2, 4, 8)
TILE_ROWS = 8  # a tile's rows (fewer where the map is shorter)
STAGES, STEP_BYTES = 4, 64  # the weights' cp.async ring: stages of 64-byte K steps


def _align128(n: int) -> int:
    return (n + 127) // 128 * 128


def mn_rows(h: int, w: int, tw: int, ipb: int) -> int:
    """GEMM rows of the fullest block: ``ipb`` images of one tile."""
    return ipb * min(TILE_ROWS, h) * min(tw, w)


def mn_nc(c: int, cmid: int, split: int, mc: int) -> Tuple[int, int]:
    """Output channels a GEMM chunk of pw1 and of pw2 for blocks of ``mc``
    rows (``csrc/qmnblock.cu``'s nc1_of, nc2_of)."""
    n1, n2 = cmid // split, c // split
    nc1 = 256 if mc == 64 and n1 % 256 == 0 else 128 if n1 % 128 == 0 else 64
    return nc1, (128 if n2 % 128 == 0 else 64 if n2 % 64 == 0 else 32)


def mn_smem_bytes(h: int, w: int, c: int, cmid: int, k: int, d: int, tw: int, ipb: int, split: int) -> int:
    """Dynamic shared memory of one K12 block (``csrc/qmnblock.cu``'s
    layout()): the region that holds the staged input window of each image
    and the depthwise weights, then the ring and the staged sums; a1; a2."""
    hd = d * (k - 1) // 2
    mc = 64 if mn_rows(h, w, tw, ipb) <= 64 else 128
    nc1, nc2 = mn_nc(c, cmid, split, mc)
    ry, rx = min(h, min(TILE_ROWS, h) + 2 * hd), min(w, min(tw, w) + 2 * hd)
    staged = _align128(ipb * ry * rx * c) + _align128(k * k * c)
    region = _align128(max(staged, STAGES * max(nc1, nc2) * STEP_BYTES, mc * (nc2 + 8) * 4))
    return region + _align128(mc * c) + _align128(mc * cmid)


def mn_tiles(h: int, w: int, tw: int) -> Tuple[int, int]:
    """(tile rows, tile columns) of the map."""
    return -(-h // TILE_ROWS), -(-w // tw)


def mn_blocks(batch: int, h: int, w: int, tw: int, ipb: int, split: int) -> int:
    ty, tx = mn_tiles(h, w, tw)
    return ty * tx * -(-batch // ipb) * split


def mn_ipbs(batch: int, h: int, w: int, tw: int) -> Tuple[int, ...]:
    """Images a tile: 1 where a tile is part of a map, else every power of
    two (and the batch) that keeps the block at 128 rows or fewer."""
    if h > TILE_ROWS or w > tw:
        return (1,)
    per = h * w
    return tuple(sorted({min(batch, m) for m in (1, 2, 4, 8, 16, 32, 64, 128) if m * per <= 128}))


def mn_cost(batch: int, h: int, w: int, c: int, cmid: int, k: int, tw: int, ipb: int, split: int, sm_count: int,
            per_sm: int) -> float:
    """Modelled SM cycles of one launch under (tw, ipb, split): the busiest
    SM's blocks times one block's time.  A block: the depthwise on the CUDA
    cores (its rows x k^2 x C multiply-adds at 64 a cycle), pw1 and pw2 on
    the tensor cores (a warp's rows, rounded up to 16, x 2 C cmid / split at
    2048 a cycle over two warp rows), their epilogues (a cycle an output),
    1600 cycles a GEMM chunk to fill the ring and 1500 to stage and start.
    Clusters of split > 1 blocks find room on three quarters of the SMs at
    two blocks an SM, nine tenths at one; two blocks on one SM take 1.6
    times one.  The constants were fitted to a sweep of every tile at the
    MNFCOS ladder's call shapes on an H100 (PERF.md §6): the pick is
    within 1.15x of the fastest tile there."""
    rows = mn_rows(h, w, tw, ipb)
    mc = 64 if rows <= 64 else 128
    nc1, nc2 = mn_nc(c, cmid, split, mc)
    warp_rows = -(-min(rows, mc // 2) // 16) * 16
    chunks = -(-cmid // split // nc1) + -(-c // split // nc2)
    block = (rows * k * k * c / 64 + 2 * warp_rows * 2 * c * cmid / split / 2048 + rows * (cmid + c) / split
             + 1600 * chunks + 1500)
    slots = sm_count if split == 1 else sm_count * (0.75 if per_sm == 2 else 0.9)
    busy = math.ceil(mn_blocks(batch, h, w, tw, ipb, split) / slots)
    return (-(-busy // 2) * 1.6 if per_sm == 2 and busy > 1 else busy) * block


def pick_mn_tile(batch: int, h: int, w: int, c: int, cmid: int, k: int, d: int, sm_count: int,
                 smem_max: int) -> Tuple[int, int, int]:
    """``(tw, ipb, split)`` for K12: tiles of 8 x ``tw`` positions of ``ipb``
    images, ``split`` blocks (a cluster) a tile, each taking 1/split of pw1's
    and pw2's output channels.  Of the options that fit ``smem_max`` bytes of
    shared memory (:func:`mn_options`), the least :func:`mn_cost` at
    :func:`mn_per_sm` blocks an SM, ties to the fewest blocks; raises where
    none fits."""
    return _pick_mn_tile(batch, h, w, c, cmid, k, d, sm_count, smem_max)


def mn_options(batch: int, h: int, w: int, c: int, cmid: int, k: int, d: int,
               smem_max: int) -> Tuple[Tuple[int, int, int], ...]:
    """Every (tw, ipb, split) K12 takes for this call within ``smem_max``
    bytes of shared memory."""
    return tuple((tw, ipb, split) for tw in TILE_WIDTHS if not (tw == 16 and w <= 8)  # tw 16 = tw 8 there
                 for ipb in mn_ipbs(batch, h, w, tw) if -(-batch // ipb) <= 65535
                 for split in SPLITS if c % (16 * split) == 0 and cmid % (16 * split) == 0
                 and mn_smem_bytes(h, w, c, cmid, k, d, tw, ipb, split) <= smem_max)


def mn_per_sm(h: int, w: int, c: int, cmid: int, k: int, d: int, tw: int, ipb: int, split: int,
              smem_max: int) -> int:
    """K12 blocks an SM holds: two where a 64-row block's two fit (an SM
    holds ``smem_max`` + 1 KB, each block 1 KB more than it asks for)."""
    smem = mn_smem_bytes(h, w, c, cmid, k, d, tw, ipb, split)
    return 2 if mn_rows(h, w, tw, ipb) <= 64 and 2 * (smem + 1024) <= smem_max + 1024 else 1


@functools.lru_cache(maxsize=None)
def _pick_mn_tile(batch, h, w, c, cmid, k, d, sm_count, smem_max):
    opts = mn_options(batch, h, w, c, cmid, k, d, smem_max)
    if not opts:
        raise ValueError(f"K12: no tile of a {k}x{k} d{d} block on {c} -> {cmid} channels at {h}x{w} fits "
                         f"{smem_max} bytes of shared memory")
    key = lambda o: (mn_cost(batch, h, w, c, cmid, k, *o, sm_count,
                             mn_per_sm(h, w, c, cmid, k, d, *o, smem_max)), mn_blocks(batch, h, w, *o))
    return min(opts, key=key)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load K12; its C signatures are declared here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE, NVCC_FLAGS)
    lib.qmnblock_smem_bytes.argtypes = [ctypes.c_int] * 9
    lib.qmnblock_smem_bytes.restype = ctypes.c_int
    lib.qmnblock_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 10 + [ctypes.c_void_p]
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


@functools.lru_cache(maxsize=None)
def _tile(b, h, w, c, cmid, kernel, dilation, sm_count, smem_max, tile):
    """The chooser's tile for one call shape, or the forced ``tile``, checked
    against what K12 takes."""
    tw, ipb, split = tile if tile is not None else pick_mn_tile(b, h, w, c, cmid, kernel, dilation, sm_count,
                                                                smem_max)
    smem = mn_smem_bytes(h, w, c, cmid, kernel, dilation, tw, ipb, split)
    if (tw not in TILE_WIDTHS or split not in SPLITS or ipb < 1 or mn_rows(h, w, tw, ipb) > 128
            or c % (16 * split) or cmid % (16 * split) or smem > smem_max or -(-b // ipb) > 65535):
        raise ValueError(f"K12 does not take tile (tw, ipb, split) = {(tw, ipb, split)} for a {kernel}x{kernel} "
                         f"d{dilation} block on {c} -> {cmid} channels at {b}x{h}x{w} ({smem} bytes of shared "
                         f"memory of {smem_max})")
    return tw, ipb, split


def _launch(blk: Dict, sc: Dict, x_q: torch.Tensor, kernel: int, dilation: int,
            tile: Optional[Tuple[int, int, int]]) -> torch.Tensor:
    """K12 on CUDA tensors (checked by ``_check`` first)."""
    dev = x_q.device
    operands = [x_q] + [blk[k] for k in _PARAMS] + [sc[k] for k in _SCALES]
    if any(t.device != dev for t in operands):
        raise ValueError(f"K12: every operand must be on {dev}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("K12 takes contiguous operands (x_q NHWC-contiguous)")
    b, h, w, c = x_q.shape
    cmid = blk["w1"].shape[0]
    if c % 16 or any(t.data_ptr() % 16 for t in (x_q, blk["wdw"], blk["w1"], blk["w2"])):
        raise ValueError(f"K12 reads x_q, wdw, w1 and w2 in 16-byte words: C must be a multiple of 16 (got {c}) "
                         "and they must start 16-byte aligned")
    out = torch.empty_like(x_q)
    if out.numel() == 0:
        return out
    tw, ipb, split = _tile(b, h, w, c, cmid, kernel, dilation, *card_limits(dev), tile and tuple(tile))
    lib = _lib()
    ptrs = operands + [out]
    table = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.qmnblock_launch(table, b, h, w, c, cmid, kernel, dilation, tw, ipb, split,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K12 launch failed: cudaError {err}")
    qmnblock.launches += 1
    return out


def qmnblock(blk: Dict, sc: Dict, x_q: torch.Tensor, kernel: int, dilation: int, *,
             plain: bool = False, tile: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Fused int8 MNBlock (the JAX ``_mnblock_i8`` signature): int8 NHWC
    ``[B, H, W, C]`` in and out.

    On a CPU tensor this is :func:`qmnblock_plain`; on a CUDA tensor it
    launches K12 or raises.  ``plain=True`` runs the plain version on any
    device, for the comparison only.  ``tile=(tw, ipb, split)`` forces
    K12's tile (:func:`pick_mn_tile` chooses otherwise); the output does not
    depend on it.  ``qmnblock.launches`` counts kernel launches.
    """
    _check(blk, sc, x_q, kernel, dilation)
    if plain or x_q.device.type == "cpu":
        return qmnblock_plain(blk, sc, x_q, kernel, dilation)
    if x_q.device.type != "cuda":
        raise ValueError(f"K12 runs on CUDA tensors; got {x_q.device}")
    return _launch(blk, sc, x_q, kernel, dilation, tile)


qmnblock.launches = 0
