"""K4 and K11: the int8 convs of the per-conv backend in CUDA, and their plain versions.

K4 (``csrc/qconv.cu``), the int8 GEMM with the fused requant epilogue,
replaces ``pytorch_object_detection_tpu/ops/pallas_qconv.py:qmatmul`` (with
and without the int8 residual) and ``:qconv1x1``; it runs the HisFPN's three
lateral 1x1 convs and, on the per-conv backend (``backend="pallas"``), the
bottlenecks' 1x1 convs.  The epilogue, in the oracle's order
(``pallas_qconv.py:38-44``)::

    y = acc * a + b;  y += res * res_scale;  y = relu(y);  out = clip8(y)

Layouts: ``x [M, K]`` int8 (``qconv1x1``: NHWC ``[B, H, W, K]``), ``w
[N, K]`` int8 (each output channel's K-vector contiguous, the port's 1x1
layout), ``a``, ``b`` f32 ``[N]``, ``res [M, N]`` int8 and ``res_scale`` a
0-d f32 tensor.  K must be a multiple of 16 on the card.  The plain version
is ``torch._int_mm`` (exact int32) and the same epilogue.  K4 runs on the
int8 tensor cores in tiles of 128 x 128 or 128 x 64 outputs;
:func:`pick_qmm_tile` chooses the tile and, where M x N has too few tiles
to fill the card, splits K across thread blocks (int32 partial sums, exact,
added in a second pass).

K11 (``csrc/qconv3.cu``), :func:`qconv3x3`, replaces ``pallas_qconv.py:
qconv3x3``: the stride-1 SAME 3x3 conv with the ReLU epilogue, NHWC ``[B, H,
W, Cin]`` int8 with weights ``[Cout, 3, 3, Cin]`` (the port's 3x3 layout);
channel counts multiples of 16 on the card, any H and W.  It is kernel C's
conv2 phase on the int8 tensor cores, its input halo staged from device
memory, in tiles of 8 x 16 or 8 x 8 output positions with channel slices
from :func:`pick_conv3_tile`.  Its plain version is ``ops/quant.conv_i8``
and ``requantize``.

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch their kernel or raise.

While a tracer runs (``utils/export.py``) the wrappers call their ops,
``podt::qmatmul`` and ``podt::qconv3x3`` (``ops/library.py``): the same
launch on CUDA, the plain version on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from pytorch_object_detection_tpu_torch.ops import library
from pytorch_object_detection_tpu_torch.ops.qblock import card_limits
from pytorch_object_detection_tpu_torch.ops.quant import clip8, conv_i8, int_mm, requantize

SOURCE = "qconv.cu"
SOURCE_3X3 = "qconv3.cu"
# no FMA contraction: a fused multiply-add moves values across a requant boundary
NVCC_FLAGS = ("-fmad=false",)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load K4; its C signature is declared here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE, NVCC_FLAGS)
    lib.qmm_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.qmm_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib3() -> ctypes.CDLL:
    """Build (at first use) and load K11; its C signature is declared here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE_3X3, NVCC_FLAGS)
    lib.qconv3_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.qconv3_launch.restype = ctypes.c_int
    return lib


QMM_BM = 128  # kQmmBM in csrc/qmm_tile.cuh
QMM_BNS = (128, 64)
QMM_STEP = 64  # K bytes per pipeline step (kStepBytes)
QMM_STAGES = 4  # kQmmStages


def qmm_smem_bytes(bn: int) -> int:
    """K4's shared memory per block for 128 x ``bn`` tiles
    (``QmmShape<BN>::kSmem``): the cp.async ring of A and B strips, which
    then holds the tile's int32 sums (rows padded by 8 words)."""
    return max(QMM_STAGES * (QMM_BM + bn) * QMM_STEP, QMM_BM * (bn + 8) * 4)


@functools.lru_cache(maxsize=256)
def pick_qmm_tile(m: int, n: int, k: int, sm_count: int, smem_max: int) -> Tuple[int, int, int]:
    """``(bn, splits, steps_per)`` for K4 on ``[M, K] x [N, K]^T``: tiles of
    128 x ``bn``, the first of 128 and 64 whose tile count reaches one block
    per SM; where neither does, 128 x 64 tiles with K split into ``splits``
    slices of ``steps_per`` 64-byte steps (the last one the rest), enough
    slices to reach one block per SM where K has that many steps."""
    steps = -(-k // QMM_STEP)
    fits = [bn for bn in QMM_BNS if qmm_smem_bytes(bn) <= smem_max]
    if not fits:
        raise ValueError(f"K4: a tile needs {qmm_smem_bytes(QMM_BNS[-1])} bytes of shared memory (> {smem_max})")
    for bn in fits:
        if -(-m // QMM_BM) * -(-n // bn) >= sm_count:
            return bn, 1, steps
    bn = fits[-1]
    want = min(-(-sm_count // (-(-m // QMM_BM) * -(-n // bn))), steps)
    per = max(1, steps // want)
    return bn, -(-steps // per), per


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
            res: Optional[torch.Tensor] = None, res_scale=None, tile: Optional[Tuple[int, int]] = None,
            plain: bool = False) -> torch.Tensor:
    """int8 ``x [M, K]`` x ``w [N, K]^T`` -> int8 ``[M, N]`` with the fused
    epilogue (module docstring).  On a CPU tensor this is
    :func:`qmatmul_plain`; on a CUDA tensor it launches K4 or raises.
    ``plain=True`` runs the plain version on any device, for the comparison
    only.  ``tile`` ``(bn, splits)`` overrides :func:`pick_qmm_tile`; the
    result does not depend on it.  ``qmatmul.launches`` counts calls that
    launch K4: one per call, also when split K adds its second pass."""
    if res is not None and not isinstance(res_scale, torch.Tensor):
        res_scale = torch.tensor(float(res_scale), dtype=torch.float32, device=x.device)
    _check(x, w, a, b, res, res_scale)
    if plain:
        return qmatmul_plain(x, w, a, b, relu=relu, res=res, res_scale=res_scale)
    if library.route(x):
        if x.is_cuda:
            tile = _qmm_tile(tile, *x.shape, w.shape[0], x.device)
        return qmatmul_op(x, w, a, b, relu, res, res_scale if res is not None else None, library.tile_ints(tile))
    if x.device.type == "cpu":
        return qmatmul_plain(x, w, a, b, relu=relu, res=res, res_scale=res_scale)
    return _launch(x, w, a, b, relu, res, res_scale, tile)


def _qmm_tile(tile, m: int, k: int, n: int, device: torch.device) -> Tuple[int, int, int]:
    """``(bn, splits, steps_per)`` of a launch: the chooser's, or a forced
    ``(bn, splits)`` checked (``splits`` rounded to what whole slices of
    64-byte steps give), or an exported triple as it is."""
    if tile is not None and len(tile) == 3:
        return tuple(tile)
    bn, splits, per = pick_qmm_tile(m, n, k, *card_limits(device))
    if tile is not None:
        bn, splits = tile
        steps = -(-k // QMM_STEP)
        if bn not in QMM_BNS or not 1 <= splits <= steps:
            raise ValueError(f"tile={tile}: K4 takes tiles of 128 x 128 or 128 x 64 and 1 to {steps} K slices")
        per = -(-steps // splits)
        splits = -(-steps // per)
    return bn, splits, per


def _launch(x, w, a, b, relu, res, res_scale, tile) -> torch.Tensor:
    """K4 on CUDA tensors, counted in ``qmatmul.launches``."""
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
    bn, splits, per = _qmm_tile(tile, m, k, n, x.device)
    if -(-n // bn) > 65535:
        raise ValueError(f"K4 takes at most {65535 * bn} output channels; got {n}")
    ws = torch.empty(splits * m * n, dtype=torch.int32, device=x.device) if splits > 1 else None
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = _lib().qmm_launch(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), ptr(res),
                                ptr(res_scale if res is not None else None), out.data_ptr(),
                                ptr(ws), m, n, k, int(relu), bn, splits, per,
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


def qconv3x3_plain(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 3x3 conv and its epilogue in plain PyTorch ops (the reference for K11)."""
    return requantize(conv_i8(x, w), a, b)


CONV3_TILE_ROWS = 8  # kTH in csrc/qblock_tile.cuh
CONV3_TILE_WIDTHS = (16, 8)
CONV3_SPLITS = (1, 2, 4, 8)  # output-channel slices a tile
RING_BYTES = 48 * 1024  # kRingBytes in csrc/qblock_tile.cuh


def conv3_smem_bytes(tw: int, cin: int) -> int:
    """K11's shared memory per block for tiles of 8 x ``tw`` output
    positions (``conv3_smem_bytes`` in ``csrc/qconv3.cu``): the input halo,
    (8 + 2) x (tw + 2) positions, then the cp.async ring."""
    return (CONV3_TILE_ROWS + 2) * (tw + 2) * cin + RING_BYTES


def conv3_blocks(batch: int, h: int, w: int, tw: int, split: int) -> int:
    """K11's thread blocks: tiles of 8 x ``tw`` over the map, ``split`` each."""
    return batch * -(-h // CONV3_TILE_ROWS) * -(-w // tw) * split


@functools.lru_cache(maxsize=256)
def pick_conv3_tile(batch: int, h: int, w: int, cin: int, cout: int, sm_count: int, smem_max: int
                    ) -> Tuple[int, int]:
    """``(tw, split)`` for K11: tiles of 8 x ``tw`` output positions, each
    in ``split`` blocks of ``cout / split`` output channels.  Of the options
    that fit in shared memory, the fewest blocks that give every SM one with
    two blocks' shared memory on an SM (an SM holds ``smem_max`` + 1 KB, each
    block 1 KB more than it asks for); else the fewest that give every SM
    one; else the most blocks.  Ties go to the wider tile, whose staged
    weights serve more positions; on the small maps channel slices are
    what fills the card."""
    options = [(tw, sp) for tw in CONV3_TILE_WIDTHS for sp in CONV3_SPLITS
               if cout % (16 * sp) == 0 and conv3_smem_bytes(tw, cin) <= smem_max]
    if not options:
        raise ValueError(f"K11: a tile of a map with {cin} channels needs {conv3_smem_bytes(8, cin)} bytes of "
                         f"shared memory (> {smem_max})")
    blocks = lambda o: conv3_blocks(batch, h, w, *o)
    two_per_sm = lambda o: 2 * (conv3_smem_bytes(o[0], cin) + 1024) <= smem_max + 1024
    for ok in (lambda o: blocks(o) >= sm_count and two_per_sm(o), lambda o: blocks(o) >= sm_count):
        fill = [o for o in options if ok(o)]
        if fill:
            return min(fill, key=lambda o: (blocks(o), -o[0]))
    return max(options, key=lambda o: (blocks(o), o[0]))


def qconv3x3(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
             tile: Optional[Tuple[int, int]] = None, plain: bool = False) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv, int8 NHWC ``[B, H, W, Cin]`` x ``w [Cout, 3, 3,
    Cin]`` -> int8 ``[B, H, W, Cout]``, epilogue ``clip8(relu(acc * a + b))``.

    On a CPU tensor this is :func:`qconv3x3_plain`; on a CUDA tensor it
    launches K11 or raises.  ``plain=True`` runs the plain version on any
    device, for the comparison only.  ``tile`` ``(tw, split)`` overrides
    :func:`pick_conv3_tile`; the result does not depend on it.
    ``qconv3x3.launches`` counts kernel launches.
    """
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"x must be int8 [B, H, W, C] (NHWC); got {x.dtype} {tuple(x.shape)}")
    bsz, h, wd, cin = x.shape
    cout = w.shape[0]
    if w.dtype != torch.int8 or tuple(w.shape) != (cout, 3, 3, cin):
        raise ValueError(f"w must be int8 [Cout, 3, 3, {cin}]; got {w.dtype} {tuple(w.shape)}")
    for name, v in (("a", a), ("b", b)):
        if v.dtype != torch.float32 or tuple(v.shape) != (cout,):
            raise ValueError(f"{name} must be float32 [{cout}]; got {v.dtype} {tuple(v.shape)}")
    if plain:
        return qconv3x3_plain(x, w, a, b)
    if library.route(x):
        if tile is None and x.is_cuda:
            tile = pick_conv3_tile(bsz, h, wd, cin, cout, *card_limits(x.device))
        return qconv3x3_op(x, w, a, b, library.tile_ints(tile))
    if x.device.type == "cpu":
        return qconv3x3_plain(x, w, a, b)
    return _launch3(x, w, a, b, tile)


def _launch3(x, w, a, b, tile) -> torch.Tensor:
    """K11 on CUDA tensors, counted in ``qconv3x3.launches``."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[0]
    if x.device.type != "cuda":
        raise ValueError(f"K11 runs on CUDA tensors; got {x.device}")
    operands = (x, w, a, b)
    if any(t.device != x.device for t in operands):
        raise ValueError(f"K11: every operand must be on {x.device}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("K11 takes contiguous operands (x NHWC-contiguous)")
    if cin % 16 or cout % 16 or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"K11 reads x and w in 16-byte words: channel counts must be multiples of 16 (got {cin}, "
                         f"{cout}) and both must start 16-byte aligned")
    out = torch.empty((bsz, h, wd, cout), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    sm_count, smem_max = card_limits(x.device)
    tw, split = pick_conv3_tile(bsz, h, wd, cin, cout, sm_count, smem_max) if tile is None else tile
    if tw not in CONV3_TILE_WIDTHS or split not in CONV3_SPLITS or cout % (16 * split):
        raise ValueError(f"tile={tile}: K11 takes tiles of width 8 or 16 and 1, 2, 4 or 8 channel slices of "
                         f"Cout={cout} that are multiples of 16")
    if conv3_smem_bytes(tw, cin) > smem_max:
        raise ValueError(f"tile={tile}: K11's tile does not fit in shared memory")
    if conv3_blocks(bsz, h, wd, tw, split) > 2**31 - 1:
        raise ValueError(f"K11: {conv3_blocks(bsz, h, wd, tw, split)} blocks exceed one launch")
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = _lib3().qconv3_launch(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, h,
                                    wd, cin, cout, tw, split, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K11 launch failed: cudaError {err}")
    qconv3x3.launches += 1
    return out


qmatmul.launches = 0
qconv3x3.launches = 0


qmatmul_op = library.define(
    "qmatmul", "(Tensor x, Tensor w, Tensor a, Tensor b, bool relu, Tensor? res, Tensor? res_scale, int[]? tile) "
               "-> Tensor",
    cpu=lambda x, w, a, b, relu, res, res_scale, tile: qmatmul_plain(x, w, a, b, relu=relu, res=res,
                                                                     res_scale=res_scale),
    cuda=lambda x, w, a, b, relu, res, res_scale, tile: _launch(x, w, a, b, relu, res, res_scale,
                                                                library.tile_tuple(tile)),
    fake=lambda x, w, *_: library.empty_like_shape(x, (x.shape[0], w.shape[0])))
qconv3x3_op = library.define(
    "qconv3x3", "(Tensor x, Tensor w, Tensor a, Tensor b, int[]? tile) -> Tensor",
    cpu=lambda x, w, a, b, tile: qconv3x3_plain(x, w, a, b),
    cuda=lambda x, w, a, b, tile: _launch3(x, w, a, b, library.tile_tuple(tile)),
    fake=lambda x, w, *_: library.empty_like_shape(x, (*x.shape[:3], w.shape[0])))
