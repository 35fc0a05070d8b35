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
no counterpart.  A K10 block stages a band of input rows once in shared
memory and pools from there; :func:`pick_pool3_tile` picks the band.

Unlike the Pallas wrappers, the kernels take every shape and never fall back.

While a tracer runs (``utils/export.py``) the wrappers call their ops,
``podt::qmaxpool2x2``, ``podt::qmaxpool2x2_seeds`` and
``podt::qmaxpool3x3s2`` (``ops/library.py``): the same launch on CUDA, the
plain version on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from pytorch_object_detection_tpu_torch.ops import library
from pytorch_object_detection_tpu_torch.ops.qblock import card_limits

SOURCE = "qpool.cu"
POOL3_ROWS = (1, 2, 4, 8, 16, 32)  # output rows a K10 block may take
POOL3_COLS = (8, 16, 32, 64, 128)  # output columns a K10 block may take
POOL3_PER_SM = 5  # K10 blocks an SM holds at least under the chooser's band


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load K6 and K10; their C signatures are declared here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE)
    lib.qpool_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.qpool_launch.restype = ctypes.c_int
    lib.qpool_seeds_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.qpool_seeds_launch.restype = ctypes.c_int
    lib.qpool3_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.qpool3_launch.restype = ctypes.c_int
    lib.qpool3_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.qpool3_smem_bytes.restype = ctypes.c_int
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
    if library.route(x):
        return qmaxpool2x2_op(x)
    return _launch2(x)


def _launch2(x: torch.Tensor) -> torch.Tensor:
    """K6 on a CUDA tensor, counted in ``qmaxpool2x2.launches``."""
    _check_k6_cuda(x)
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
    """Checks K6's operand; True where the plain version runs (``plain``, or
    a CPU tensor outside a tracer)."""
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"x must be int8 [B, H, W, C] (NHWC); got {x.dtype} {tuple(x.shape)}")
    return plain or (x.device.type == "cpu" and not library.route(x))


def _check_k6_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"K6 runs on CUDA tensors; got {x.device}")
    if not x.is_contiguous() or (x.shape[-1] % 16 == 0 and x.data_ptr() % 16):
        raise ValueError("K6 takes NHWC-contiguous int8 (16-byte aligned where C % 16 == 0)")


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
    if library.route(x):
        return qmaxpool2x2_seeds_op(x)
    return _launch_seeds(x)


def _launch_seeds(x: torch.Tensor):
    """K6's seeds kernel on a CUDA tensor, counted in ``qmaxpool2x2_seeds.launches``."""
    _check_k6_cuda(x)
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


def pool3_smem_bytes(c: int, rows: int, cols: int) -> int:
    """Shared memory of a K10 block (``qpool3_band``'s layout): the band's 2
    rows + 1 input rows over 2 cols + 1 input columns, C bytes a pixel."""
    return (2 * rows + 1) * (2 * cols + 1) * c


def pool3_blocks(batch: int, h: int, w: int, rows: int, cols: int) -> int:
    """K10's blocks: bands x spans x images."""
    return batch * -(-((h - 1) // 2 + 1) // rows) * -(-((w - 1) // 2 + 1) // cols)


def pick_pool3_tile(batch: int, h: int, w: int, sm_count: int, smem_max: int, c: int = 64) -> Tuple[int, int]:
    """``(rows, cols)`` output rows and columns a K10 block takes on a ``[B,
    h, w, c]`` int8 map: of the bands whose shared memory lets
    ``POOL3_PER_SM`` blocks share an SM (an SM holds ``smem_max`` + 1 KB,
    each block 1 KB more than it asks for), those with the most blocks up to
    ``2 * sm_count`` (the card filled), then the widest span (the longest
    contiguous staged rows), then the most rows: 2 x 64 on the 512x512 stem
    map from B=3 up (1 x 64 at B=2), 2 x 64 on the COCO canvas's.  A sweep
    of every band on the card (``scripts/port_kernel_times.py --only
    k10tile``) put 2 x 64 first at B=64 and within 2 % of the best at B=8.
    Raises ``ValueError`` where no band fits."""
    return _pick_pool3_tile(batch, h, w, sm_count, smem_max, c)


@functools.lru_cache(maxsize=256)
def _pick_pool3_tile(batch, h, w, sm_count, smem_max, c):
    fits = [(r, cl) for r in POOL3_ROWS for cl in POOL3_COLS
            if POOL3_PER_SM * (pool3_smem_bytes(c, r, cl) + 1024) <= smem_max + 1024]
    if not fits:
        raise ValueError(f"K10: no band fits {POOL3_PER_SM} blocks in {smem_max + 1024} bytes of shared memory an "
                         f"SM at C={c}")
    return min(fits, key=lambda t: (-min(pool3_blocks(batch, h, w, *t), 2 * sm_count), -t[1], -t[0]))


@functools.lru_cache(maxsize=None)
def _check_pool3_smem(c: int, rows: int, cols: int) -> None:
    """The chooser's shared-memory arithmetic is the kernel's (once per band and channel count)."""
    got = _lib().qpool3_smem_bytes(c, rows, cols)
    if got != pool3_smem_bytes(c, rows, cols):
        raise RuntimeError(f"K10: the kernel takes {got} bytes of shared memory, the chooser "
                           f"{pool3_smem_bytes(c, rows, cols)}")


@functools.lru_cache(maxsize=256)
def _pool3_launch_tile(b: int, h: int, w: int, c: int, index: int) -> Tuple[int, int]:
    """The chooser's band for a launch on device ``index`` (the one-byte form takes none)."""
    if c % 16:
        return 0, 0
    tile = pick_pool3_tile(b, h, w, *card_limits(torch.device("cuda", index)), c=c)
    _check_pool3_smem(c, *tile)
    return tile


def qmaxpool3x3s2(x: torch.Tensor, *, plain: bool = False, tile=None) -> torch.Tensor:
    """int8 ``[B, H, W, C]`` -> ``[B, (H - 1) // 2 + 1, (W - 1) // 2 + 1, C]``,
    3x3 window, stride 2, padding 1 (-128).

    On a CPU tensor this is :func:`qmaxpool3x3s2_plain`; on a CUDA tensor it
    launches K10 (NHWC-contiguous int8) or raises.  ``tile=(rows, cols)``
    forces the output rows and columns a block takes (C a multiple of 16)
    instead of :func:`pick_pool3_tile`'s, for the checks; the output does
    not depend on it.  ``plain=True`` runs the plain version on any device,
    for the comparison only.  ``qmaxpool3x3s2.launches`` counts kernel
    launches.
    """
    if x.dtype is not torch.int8 or x.dim() != 4:
        raise ValueError(f"x must be int8 [B, H, W, C] (NHWC); got {x.dtype} {tuple(x.shape)}")
    if plain:
        return qmaxpool3x3s2_plain(x)
    if library.route(x):
        if tile is None and x.is_cuda:
            tile = _pool3_launch_tile(*x.shape, x.get_device())
        return qmaxpool3x3s2_op(x, library.tile_ints(tile))
    if x.is_cpu:
        return qmaxpool3x3s2_plain(x)
    return _launch3(x, tile)


def _launch3(x: torch.Tensor, tile) -> torch.Tensor:
    """K10 on a CUDA tensor, counted in ``qmaxpool3x3s2.launches``."""
    if not x.is_cuda:
        raise ValueError(f"K10 runs on CUDA tensors; got {x.device}")
    b, h, w, c = x.shape
    if not x.is_contiguous() or (c % 16 == 0 and x.data_ptr() % 16):
        raise ValueError("K10 takes NHWC-contiguous int8 (16-byte aligned where C % 16 == 0)")
    out = torch.empty((b, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    index = x.get_device()
    if tile is None or tuple(tile) == _pool3_launch_tile(b, h, w, c, index):
        tile = _pool3_launch_tile(b, h, w, c, index)
    elif c % 16 or tuple(tile) not in [(r, cl) for r in POOL3_ROWS for cl in POOL3_COLS] or pool3_smem_bytes(
            c, *tile) > card_limits(x.device)[1]:
        raise ValueError(f"K10 does not take tile {tile}: rows in {POOL3_ROWS}, columns in {POOL3_COLS}, within the "
                         f"card's shared memory, C a multiple of 16 (got {c})")
    else:
        _check_pool3_smem(c, *tile)
    args = (x.data_ptr(), out.data_ptr(), b, h, w, c, *tile)
    if index == torch._C._cuda_getDevice():
        err = _lib().qpool3_launch(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):  # the launch goes to the current device
            err = _lib().qpool3_launch(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"K10 launch failed: cudaError {err}")
    qmaxpool3x3s2.launches += 1
    return out


qmaxpool2x2.launches = 0
qmaxpool2x2_seeds.launches = 0
qmaxpool3x3s2.launches = 0


def _pool_shape(x: torch.Tensor, k: int):
    b, h, w, c = x.shape
    return b, h // k, w // k, c


qmaxpool2x2_op = library.define(
    "qmaxpool2x2", "(Tensor x) -> Tensor", cpu=qmaxpool2x2_plain, cuda=_launch2,
    fake=lambda x: library.empty_like_shape(x, _pool_shape(x, 2)))
qmaxpool2x2_seeds_op = library.define(
    "qmaxpool2x2_seeds", "(Tensor x) -> (Tensor, Tensor)", cpu=qmaxpool2x2_seeds_plain, cuda=_launch_seeds,
    fake=lambda x: (library.empty_like_shape(x, _pool_shape(x, 2)),
                    library.empty_like_shape(x, (x.shape[0], x.shape[1] // 2 // 2, x.shape[2] // 2 // 2, x.shape[3]))))
qmaxpool3x3s2_op = library.define(
    "qmaxpool3x3s2", "(Tensor x, int[]? tile) -> Tensor",
    cpu=lambda x, tile: qmaxpool3x3s2_plain(x),
    cuda=lambda x, tile: _launch3(x, library.tile_tuple(tile)),
    fake=lambda x, tile: library.empty_like_shape(
        x, (x.shape[0], (x.shape[1] - 1) // 2 + 1, (x.shape[2] - 1) // 2 + 1, x.shape[3])))
