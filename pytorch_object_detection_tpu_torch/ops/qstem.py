"""K1: the exact uint8 ResNet stem with its fused 3x3/2 max pool in CUDA
(``csrc/qstem.cu``), and its plain version.

Replaces ``pytorch_object_detection_tpu/ops/pallas_qstem.py:qstem_conv``
(``pool=True``).  Input: raw uint8 frames ``[B, H, W, 3]`` or RGBX ``[B, H,
W, 4]`` (H, W even); output: the pooled stem ``[B, H/4, W/4, 64]`` int8 (H/4
rounded up).  The stem's parameters are the qtree's ``stem_s2d`` entry
(``nn/resnet_int8.quantize_stem_s2d``): ``w [256, 64]`` int8 (the
space-to-depth taps, (ky, kx, c16) order), ``w7 [64, 7, 7, 4]`` int8 (the
same taps in the direct 7x7 form, which the direct stem reads), ``A``,
``B`` f32 ``[64]``, ``pad [16]`` and ``pad4 [4]`` int8 (the border fill in
the v = u - 128 domain) and ``scale``; and ``wt [64, 256]`` int8, ``w``
transposed (each output channel's taps contiguous), which K1 reads.

The plain version is the JAX oracle ``nn/resnet_int8._stem_s2d_i8_xla``
(``:224-245``) on the space-to-depth of the channel-padded frame: exact
int32 accumulation, the f32 epilogue, the int8 pool.  The kernel computes
the same space-to-depth form as an implicit GEMM on the int8 tensor cores
(``wt``, ``pad``); :func:`pick_stem_tile` chooses the pooled positions a
thread block owns.

While a tracer runs (``utils/export.py``) the wrappers call their ops,
``podt::qstem_conv`` (``ops/library.py``): the same launch on CUDA, the
plain version on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from pytorch_object_detection_tpu_torch.nn.resnet import space_to_depth
from pytorch_object_detection_tpu_torch.ops import library
from pytorch_object_detection_tpu_torch.ops.qblock import card_limits
from pytorch_object_detection_tpu_torch.ops.qpool import qmaxpool3x3s2_plain
from pytorch_object_detection_tpu_torch.ops.quant import clip8, conv_i8

SOURCE = "qstem.cu"
# no FMA contraction: a fused multiply-add moves values across a requant boundary
NVCC_FLAGS = ("-fmad=false",)
COUT = 64
STEM_K = 256  # (ky, kx, c16)
STEM_MC = 128  # kMC: conv positions a GEMM chunk
# pooled rows x columns a block may take
STEM_TILES = tuple((pr, pc) for pr in (32, 16, 8, 4, 2, 1) for pc in (32, 16, 8, 4, 2, 1))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load K1; its C signatures are declared here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE, NVCC_FLAGS)
    lib.qstem_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.qstem_launch.restype = ctypes.c_int
    lib.qstem_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.qstem_smem_bytes.restype = ctypes.c_int
    return lib


def stem_sizes(h: int, w: int) -> Tuple[int, int, int, int]:
    """(Hc, Wc, Hp, Wp): the conv map (the 7x7/2 conv, H/2) and the pooled map of an ``h`` x ``w`` frame."""
    hc, wc = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return hc, wc, (hc - 1) // 2 + 1, (wc - 1) // 2 + 1


def _align(n: int) -> int:
    return -(-n // 128) * 128


def stem_smem_bytes(pr: int, pc: int, cin: int = 4) -> int:
    """Dynamic shared memory of one block of ``pr`` x ``pc`` pooled positions
    (``layout_of`` in csrc/qstem.cu): the int8 conv tile (2 pr + 1) x (2 pc
    + 1) x 64, which first holds the staged frame rows; the s2d patch (the
    conv tile and 3 more rows and columns, 16 bytes a pixel); the weights
    [64][256]; the GEMM rows' table; A, B and the border fill."""
    cr, cc = 2 * pr + 1, 2 * pc + 1
    prs, pcs = cr + 3, cc + 3
    pitch = 16 * ((2 * pcs * cin + 15) // 16 + 1)
    table = -(-cr * cc // STEM_MC) * STEM_MC * 4
    return (_align(max(cr * cc * COUT, 2 * prs * pitch)) + _align(prs * pcs * 16) + COUT * STEM_K + _align(table)
            + _align(2 * COUT * 4 + 16))


def stem_tiles(h: int, w: int, pr: int, pc: int) -> Tuple[int, int]:
    """(tiles down, tiles across) of the pooled map."""
    _, _, hp, wp = stem_sizes(h, w)
    return -(-hp // pr), -(-wp // pc)


def stem_blocks(batch: int, h: int, w: int, pr: int, pc: int) -> int:
    ty, tx = stem_tiles(h, w, pr, pc)
    return batch * ty * tx


def stem_recompute(h: int, w: int, pr: int, pc: int) -> float:
    """The share of the conv map's positions that the blocks compute twice:
    each tile's conv rows and columns reach one past its pooled rows' (the
    pool's window), so each boundary between two tiles is one conv row or
    column computed by both (the map's edge is not computed)."""
    hc, wc, _, _ = stem_sizes(h, w)
    ty, tx = stem_tiles(h, w, pr, pc)
    return (hc + ty - 1) * (wc + tx - 1) / (hc * wc) - 1.0


def stem_load(batch: int, h: int, w: int, pr: int, pc: int, sm_count: int) -> float:
    """The conv positions the busiest SM computes, in a model: the blocks
    spread over the SMs (two may share one, and then share its rate), so
    the busiest takes ceil(blocks / SMs) of them, each the blocks' mean
    count of conv positions (the map and its recompute over the blocks)."""
    hc, wc, _, _ = stem_sizes(h, w)
    blocks = stem_blocks(batch, h, w, pr, pc)
    return -(-blocks // sm_count) * hc * wc * (1.0 + stem_recompute(h, w, pr, pc)) * batch / blocks


def pick_stem_tile(batch: int, h: int, w: int, sm_count: int, smem_max: int) -> Tuple[int, int]:
    """``(pr, pc)`` pooled rows and columns a K1 block takes on ``h`` x ``w``
    frames: of the tiles whose shared memory lets two blocks share an SM
    (an SM holds ``smem_max`` + 1 KB, each block 1 KB more than it asks
    for), the one whose busiest SM computes the fewest conv positions
    (:func:`stem_load`); then the least recompute (:func:`stem_recompute`);
    then the least shared memory.  A large batch fills every SM with any
    tile, and the least recompute wins (16 x 16 at 512x512 from B=2 up); a
    small one spreads over smaller tiles (8 x 16 at B=1)."""
    return _pick_stem_tile(batch, h, w, sm_count, smem_max)


@functools.lru_cache(maxsize=256)
def _pick_stem_tile(batch, h, w, sm_count, smem_max):
    fits = [t for t in STEM_TILES if 2 * (stem_smem_bytes(*t) + 1024) <= smem_max + 1024]
    if not fits:
        raise ValueError(f"K1: no tile fits two blocks in {smem_max + 1024} bytes of shared memory an SM")
    return min(fits, key=lambda t: (round(stem_load(batch, h, w, *t, sm_count), 6),
                                    round(stem_recompute(h, w, *t), 12), stem_smem_bytes(*t)))


@functools.lru_cache(maxsize=None)
def _check_smem(pr: int, pc: int, cin: int) -> None:
    """The chooser's shared-memory arithmetic is the kernel's (once per tile and channel count)."""
    got = _lib().qstem_smem_bytes(pr, pc, cin)
    if got != stem_smem_bytes(pr, pc, cin):
        raise RuntimeError(f"K1: the kernel takes {got} bytes of shared memory, the chooser "
                           f"{stem_smem_bytes(pr, pc, cin)}")


def to_rgbx(images: torch.Tensor) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` -> ``[B, H, W, 4]`` with a fourth channel of 128
    (v = 0, and its weights are 0); a 4-channel frame passes as it is."""
    if images.shape[-1] == 4:
        return images
    return F.pad(images, (0, 1), value=128)


def qstem_plain(st: Dict, xs_u8: torch.Tensor) -> torch.Tensor:
    """The s2d oracle (``_stem_s2d_i8_xla``): ``xs_u8 [B, Hs, Ws, 16]`` uint8,
    the space-to-depth of the RGBX frame -> pooled int8 ``[B, Hs', Ws', 64]``."""
    xs = (xs_u8.to(torch.int16) - 128).to(torch.int8)
    b, hs, ws, c = xs.shape
    pad = st["pad"].to(xs.device).reshape(1, 1, 1, c)
    prow = pad.expand(b, 1, ws, c)
    xp = torch.cat([prow, prow, xs, prow], dim=1)
    pcol = pad.expand(b, hs + 3, 1, c)
    xp = torch.cat([pcol, pcol, xp, pcol], dim=2)
    w = st["w"].reshape(4, 4, c, -1).permute(3, 0, 1, 2)  # (ky, kx, c16) x O -> O, ky, kx, c16
    acc = conv_i8(xp, w.contiguous(), pad=0)
    x_q = clip8(torch.clamp(acc * st["A"] + st["B"], min=0.0))
    return qmaxpool3x3s2_plain(x_q)


# K1's operands of a stem entry: name -> (dtype, shape)
_OPERANDS = {"wt": (torch.int8, (COUT, STEM_K)), "A": (torch.float32, (COUT,)), "B": (torch.float32, (COUT,)),
             "pad": (torch.int8, (16,))}


def _operands(st: Dict, device: torch.device):
    """``wt``, ``A``, ``B``, ``pad`` of a stem entry, checked."""
    ops = []
    for name, (dtype, shape) in _OPERANDS.items():
        v = st.get(name)
        if v is None:
            raise KeyError(f"the stem entry has no {name!r}: make it with nn/resnet_int8.quantize_stem_s2d or "
                           f"train/checkpoints.load_backbone_qtree")
        if v.dtype != dtype or v.shape != shape or v.device != device or not v.is_contiguous():
            raise ValueError(f"stem_s2d {name} must be contiguous {dtype} {list(shape)} on {device}; "
                             f"got {v.dtype} {tuple(v.shape)} on {v.device}")
        ops.append(v)
    return ops


def qstem_conv(images: torch.Tensor, st: Dict, *, plain: bool = False,
               tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Raw uint8 frames ``[B, H, W, 3 or 4]`` (H, W even) -> the pooled stem
    ``[B, (H/2 - 1)//2 + 1, (W/2 - 1)//2 + 1, 64]`` int8.

    On a CPU tensor this is :func:`qstem_plain` on the space-to-depth of
    :func:`to_rgbx` of the frames; on a CUDA tensor it launches K1 or
    raises.  ``plain=True`` runs the plain version on any device, for the
    comparison only.  ``tile`` forces :func:`pick_stem_tile`'s ``(pr, pc)``
    (the output does not depend on it).  ``qstem_conv.launches`` counts
    kernel launches.
    """
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] not in (3, 4):
        raise ValueError(f"images must be uint8 [B, H, W, 3 or 4]; got {images.dtype} {tuple(images.shape)}")
    b, h, w, cin = images.shape
    if h % 2 or w % 2:
        raise ValueError(f"the space-to-depth stem takes even H and W; got {h}x{w}")
    if plain:
        return qstem_plain(st, space_to_depth(to_rgbx(images), 2))
    if library.route(images):
        if tile is None and images.is_cuda:
            tile = pick_stem_tile(b, h, w, *card_limits(images.device))
        return qstem_conv_op(images, [st.get(k) for k in _OP_KEYS], library.tile_ints(tile))
    if images.device.type == "cpu":
        return qstem_plain(st, space_to_depth(to_rgbx(images), 2))
    return _launch(images, st, tile)


def _launch(images: torch.Tensor, st: Dict, tile: Optional[Tuple[int, int]]) -> torch.Tensor:
    """K1 on CUDA frames, counted in ``qstem_conv.launches``."""
    b, h, w, cin = images.shape
    if images.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors; got {images.device}")
    if not images.is_contiguous() or images.data_ptr() % 16:
        raise ValueError("K1 takes NHWC-contiguous frames that start 16-byte aligned")
    wt, a, bb, pad = _operands(st, images.device)
    _, _, hp, wp = stem_sizes(h, w)
    out = torch.empty((b, hp, wp, COUT), dtype=torch.int8, device=images.device)
    if out.numel() == 0:
        return out
    pr, pc = tile if tile is not None else pick_stem_tile(b, h, w, *card_limits(images.device))
    if b > 65535:
        raise ValueError(f"K1 takes at most 65535 frames; got {b}")
    _check_smem(pr, pc, cin)
    with torch.cuda.device(images.device):  # the launch goes to the current device
        err = _lib().qstem_launch(images.data_ptr(), wt.data_ptr(), a.data_ptr(), bb.data_ptr(), pad.data_ptr(),
                                  out.data_ptr(), b, h, w, cin, pr, pc, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    qstem_conv.launches += 1
    return out


qstem_conv.launches = 0

# the stem entry's tensors as the op takes them: the plain version's, then K1's ``wt``
_OP_KEYS = ("w", "A", "B", "pad", "wt")


def _op_fake(images, st, tile):
    b, h, w, _ = images.shape
    return library.empty_like_shape(images, (b, *stem_sizes(h, w)[2:], COUT), torch.int8)


qstem_conv_op = library.define(
    "qstem_conv", "(Tensor images, Tensor?[] st, int[]? tile) -> Tensor",
    cpu=lambda images, st, tile: qstem_plain(dict(zip(_OP_KEYS, st)), space_to_depth(to_rgbx(images), 2)),
    cuda=lambda images, st, tile: _launch(images, dict(zip(_OP_KEYS, st)), library.tile_tuple(tile)),
    fake=_op_fake)
