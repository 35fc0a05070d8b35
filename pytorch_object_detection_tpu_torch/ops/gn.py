"""Kernel B: GroupNorm + activation in CUDA (``csrc/gn.cu``), and its plain version.

Replaces ``pytorch_object_detection_tpu/ops/pallas_gn.py:groupnorm_act``.
The source note in ``csrc/gn.cu`` says what bounds it on the card and how
the design answers.  Both versions take the layout the port's modules
produce, NCHW, with groups contiguous in channel (channel c is in group
``c // (C / groups)``), f32 statistics, biased variance clamped at 0 (as
flax ``nn.GroupNorm``), and return the input's dtype.

:func:`pick_gn_tile` chooses, from the card's limits, how the kernel cuts
the (image, group) slabs: staged in shared memory (``"resident"``) or read
twice from device memory (``"stream"``), the blocks of a thread block
cluster a slab is split across, and the slabs a block takes.  The kernel
sums each slab in fixed 4 KB chunks folded in order, so every tile gives
the same bits.

While a tracer runs (``utils/export.py``) the wrappers call their ops,
``podt::groupnorm_act`` (``ops/library.py``): the same launch on CUDA, the
plain version on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from pytorch_object_detection_tpu_torch.ops import library
from pytorch_object_detection_tpu_torch.ops.qblock import card_limits

SOURCE = "gn.cu"
ACTS = {"none": 0, "relu": 1, "silu": 2}
GN_CHUNK_UNITS = 256  # kChunkUnits: 16-byte units a chunk (4 KB), the unit of the sums' order
GN_PATHS = ("resident", "stream")
GN_SPLITS = (1, 2, 4, 8)  # blocks a cluster
GN_PER_BLOCK = (1, 2, 4, 8)  # slabs a block (split 1)
GN_MAX_WARPS = 8  # kMaxThreads / 32: a block's warps, shared by its slabs
GN_BLOCK_CHUNKS = 16  # chunks (64 KB) a resident block stages where a cluster allows
GN_PACK_CHUNKS = 8  # chunks (32 KB) a block of several slabs stages at most

GnTile = Tuple[str, int, int]  # (path, split, per_block)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load kernel B; the C functions' signatures
    are declared once here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE)
    lib.gn_act_launch.argtypes = [ctypes.c_void_p] * 6
    lib.gn_act_launch.restype = ctypes.c_int
    lib.gn_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.gn_smem_bytes.restype = ctypes.c_int
    return lib


def gn_chunks(channels: int, hw: int, groups: int, itemsize: int) -> int:
    """4 KB chunks of the longest slab, counted from the 16-byte boundary at
    or below its first element: a slab whose length is a whole number of
    16-byte units starts on one, any other may start up to a unit early."""
    unit = 16 // itemsize
    n = channels // groups * hw
    units = n // unit if n % unit == 0 else -(-(n + unit - 1) // unit)
    return -(-units // GN_CHUNK_UNITS)


def gn_geometry(tile: GnTile, nc: int) -> Tuple[int, int]:
    """(warps a slab, chunks a rank) of ``tile`` on slabs of ``nc`` chunks."""
    return GN_MAX_WARPS // tile[2], -(-nc // tile[1])


def gn_smem_bytes(tile: GnTile, nc: int, cg: int) -> int:
    """Dynamic shared memory of a block (``gn_act_kernel``'s layout): per
    slab the rank's staged chunks (resident), a partial sum pair a chunk,
    the statistics, the staging's mbarrier and a (mul, add) pair a channel,
    rounded up to 16 bytes."""
    path, _, per_block = tile
    cpr = gn_geometry(tile, nc)[1]
    team = (cpr * GN_CHUNK_UNITS * 16 if path == "resident" else 0) + cpr * 8 + 16 + cg * 8
    return per_block * -(-team // 16) * 16


def gn_options(batch: int, channels: int, hw: int, groups: int, itemsize: int, smem_max: int) -> List[GnTile]:
    """Every tile kernel B takes for this call: each path, each split that
    leaves every rank of a cluster a chunk, and (split 1) each number of
    slabs a block; those whose shared memory fits."""
    nc, cg, nslabs = gn_chunks(channels, hw, groups, itemsize), channels // groups, batch * groups
    out = []
    for path in GN_PATHS:
        for split in GN_SPLITS:
            if split > 1 and -(-nc // split) * (split - 1) >= nc:
                continue
            for per_block in GN_PER_BLOCK if split == 1 else (1,):
                tile = (path, split, per_block)
                if per_block <= nslabs and gn_smem_bytes(tile, nc, cg) <= smem_max:
                    out.append(tile)
    return out


def gn_blocks(tile: GnTile, batch: int, groups: int) -> int:
    """Blocks of a launch: the slabs' blocks times the cluster's."""
    return -(-batch * groups // tile[2]) * tile[1]


def pick_gn_tile(batch: int, channels: int, hw: int, groups: int, itemsize: int, sm_count: int,
                 smem_max: int) -> GnTile:
    """``(path, split, per_block)`` for kernel B: the resident path where a
    cluster of up to 8 holds a slab, else the streaming one.  Resident: the
    smallest cluster whose blocks stage at most ``GN_BLOCK_CHUNKS`` chunks
    (64 KB; else the largest that fits), then on slabs of a few chunks the
    most slabs a block that stages at most ``GN_PACK_CHUNKS`` and still
    launches ``2 * sm_count`` blocks.  Streaming: the smallest cluster
    that launches ``2 * sm_count`` blocks, else the largest.  Raises
    ``ValueError`` where no tile fits."""
    return _pick_gn_tile(batch, channels, hw, groups, itemsize, sm_count, smem_max)


@functools.lru_cache(maxsize=1024)
def _pick_gn_tile(batch, channels, hw, groups, itemsize, sm_count, smem_max):
    opts = gn_options(batch, channels, hw, groups, itemsize, smem_max)
    if not opts:
        raise ValueError(f"kernel B: no tile fits {channels // groups} channels a group in {smem_max} bytes of "
                         f"shared memory")
    nc = gn_chunks(channels, hw, groups, itemsize)
    resident = [t for t in opts if t[0] == "resident"]
    if not resident:
        full = [t for t in opts if gn_blocks(t, batch, groups) >= 2 * sm_count]
        return min(full, key=lambda t: t[1]) if full else max(opts, key=lambda t: t[1])
    small = [t for t in resident if t[2] == 1 and -(-nc // t[1]) <= GN_BLOCK_CHUNKS]
    split = min(t[1] for t in small) if small else max(t[1] for t in resident)
    packed = [t for t in resident if t[1] == split and t[2] * -(-nc // split) <= GN_PACK_CHUNKS
              and gn_blocks(t, batch, groups) >= 2 * sm_count]
    return max(packed, key=lambda t: t[2]) if packed else ("resident", split, 1)


def groupnorm_act_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                        groups: int = 32, eps: float = 1e-5, act: str = "none") -> torch.Tensor:
    """GroupNorm + activation in plain PyTorch ops (the reference for kernel B)."""
    b, c = x.shape[:2]
    cg = c // groups
    xf = x.float()
    g = xf.reshape(b, groups, -1)
    mean = g.mean(dim=-1)
    var = ((g * g).mean(dim=-1) - mean * mean).clamp(min=0.0)
    inv = torch.rsqrt(var + eps)
    mul = inv.repeat_interleave(cg, dim=1) * scale.float()  # [B, C]
    add = bias.float() - mean.repeat_interleave(cg, dim=1) * mul
    y = xf * mul[:, :, None, None] + add[:, :, None, None]
    if act == "relu":
        y = torch.relu(y)
    elif act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


class _Call(ctypes.Structure):
    """``GnCall`` of csrc/gn.cu: one call's shape and tile."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "x_f32", "param_f32", "batch", "channels", "hw", "groups", "act", "resident", "split", "per_block", "warps",
        "cpr")] + [("eps", ctypes.c_float)]


# (shape, x dtype, scale dtype, act, eps, groups, device index, forced tile) -> (the GnCall, its address)
_CALLS: Dict[tuple, Tuple[_Call, int]] = {}


def groupnorm_act_autograd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                           groups: int = 32, eps: float = 1e-5, act: str = "none") -> torch.Tensor:
    """``F.group_norm`` + activation, on any device, with a backward: the
    path ``nn/layers.GroupNorm32`` takes where autograd records (a train
    step), since kernel B has none."""
    y = F.group_norm(x, groups, scale, bias, eps)
    if act == "relu":
        return F.relu(y)
    if act == "silu":
        return F.silu(y)
    return y


def _make_call(x: torch.Tensor, scale: torch.Tensor, groups: int, eps: float, act: str, tile) -> Tuple[_Call, int]:
    """The launch's ``GnCall`` for the chooser's tile, or for a forced one
    checked against :func:`gn_options`."""
    b, c, h, w = x.shape
    itemsize = x.element_size()
    sm_count, smem_max = card_limits(x.device)
    if tile is None:
        tile = pick_gn_tile(b, c, h * w, groups, itemsize, sm_count, smem_max)
    elif tuple(tile) not in gn_options(b, c, h * w, groups, itemsize, smem_max):
        raise ValueError(f"kernel B does not take tile {tile} here; it takes "
                         f"{gn_options(b, c, h * w, groups, itemsize, smem_max)}")
    tile = tuple(tile)
    nc = gn_chunks(c, h * w, groups, itemsize)
    warps, cpr = gn_geometry(tile, nc)
    resident = int(tile[0] == "resident")
    if _lib().gn_smem_bytes(resident, cpr, c // groups, tile[2]) != gn_smem_bytes(tile, nc, c // groups):
        raise RuntimeError(f"kernel B: the kernel's shared memory for {tile} is not the chooser's")
    call = _Call(int(x.dtype == torch.float32), int(scale.dtype == torch.float32), b, c, h * w, groups, ACTS[act],
                 resident, tile[1], tile[2], warps, cpr, eps)
    return call, ctypes.addressof(call)


def groupnorm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *, groups: int = 32,
                  eps: float = 1e-5, act: str = "none", plain: bool = False, tile=None) -> torch.Tensor:
    """GroupNorm + optional relu/silu over ``x [B, C, H, W]``; scale/bias ``[C]``.

    On a CPU tensor this is :func:`groupnorm_act_plain`; on a CUDA tensor it
    launches kernel B (x float32 or bfloat16, NCHW contiguous and 16-byte
    aligned; scale and bias float32 or bfloat16, read in their own dtype)
    or raises.  ``tile=(path, split, per_block)`` forces one of
    :func:`gn_options`'s tiles instead of :func:`pick_gn_tile`'s, for the
    checks; the output does not depend on it.  ``plain=True`` runs the plain
    version on any device; it exists only to compare the kernel with its
    plain version.  ``groupnorm_act.launches`` counts kernel launches.
    The kernel has no backward: on a CUDA tensor, a call that autograd would
    record (grad enabled and ``x``, ``scale`` or ``bias`` requiring grad)
    raises rather than return a result cut from the graph;
    :func:`groupnorm_act_autograd` is the path with a backward.
    """
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}; got {act!r}")
    if x.dim() != 4 or x.shape[1] % groups:
        raise ValueError(f"x must be [B, C, H, W] with C divisible by {groups}; got {tuple(x.shape)}")
    if plain:
        return groupnorm_act_plain(x, scale, bias, groups=groups, eps=eps, act=act)
    if library.route(x):
        if tile is None and x.is_cuda:
            b, c, h, w = x.shape
            tile = pick_gn_tile(b, c, h * w, groups, x.element_size(), *card_limits(x.device))
        ints = None if tile is None else [GN_PATHS.index(tile[0]), int(tile[1]), int(tile[2])]
        return groupnorm_act_op(x, scale, bias, groups, float(eps), act, ints)
    if x.is_cpu:
        return groupnorm_act_plain(x, scale, bias, groups=groups, eps=eps, act=act)
    return _launch(x, scale, bias, groups, eps, act, tile)


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int, eps: float, act: str,
            tile) -> torch.Tensor:
    """Kernel B on CUDA tensors, counted in ``groupnorm_act.launches``."""
    if not x.is_cuda:
        raise ValueError(f"kernel B runs on CUDA tensors; got {x.device}")
    dtype, pdtype = x.dtype, scale.dtype
    if dtype is not torch.bfloat16 and dtype is not torch.float32:
        raise ValueError(f"kernel B takes float32 or bfloat16; got {dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("kernel B takes NCHW-contiguous, 16-byte aligned input (the port's module layout)")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or bias.requires_grad):
        raise RuntimeError("kernel B has no backward: call it under torch.no_grad() or inference_mode()")
    c = x.shape[1]
    if (pdtype is not torch.bfloat16 and pdtype is not torch.float32) or bias.dtype is not pdtype or \
            scale.dim() != 1 or scale.shape != bias.shape or scale.numel() != c or \
            not (scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"scale and bias must be [{c}] float32 or bfloat16, the same dtype, contiguous")
    index = x.get_device()
    if scale.get_device() != index or bias.get_device() != index:
        raise ValueError(f"scale and bias must be on {x.device}")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    key = (x.shape, dtype, pdtype, act, eps, groups, index, None if tile is None else tuple(tile))
    call = _CALLS.get(key)
    if call is None:
        call = _CALLS[key] = _make_call(x, scale, groups, eps, act, tile)
    args = (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), call[1])
    if index == torch._C._cuda_getDevice():
        err = _lib().gn_act_launch(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):  # the launch goes to the current device
            err = _lib().gn_act_launch(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"kernel B launch failed: cudaError {err}")
    groupnorm_act.launches += 1
    return y


groupnorm_act.launches = 0


def _op_cuda(x, scale, bias, groups, eps, act, tile):
    return _launch(x, scale, bias, groups, eps, act, None if tile is None else (GN_PATHS[tile[0]], *tile[1:]))


groupnorm_act_op = library.define(
    "groupnorm_act", "(Tensor x, Tensor scale, Tensor bias, int groups, float eps, str act, int[]? tile) -> Tensor",
    cpu=lambda x, scale, bias, groups, eps, act, tile: groupnorm_act_plain(x, scale, bias, groups=groups, eps=eps,
                                                                          act=act),
    cuda=_op_cuda, fake=lambda x, *_: torch.empty_like(x, memory_format=torch.contiguous_format))
