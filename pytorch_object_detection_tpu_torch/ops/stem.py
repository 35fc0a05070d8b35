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
or raises.  The stem tail keeps the bf16 ``mult`` and ``shift`` once per
qtree (``nn/resnet_int8.stem_tail_params``), so a call launches K17 alone.

While a tracer runs (``utils/export.py``) the wrappers call their ops,
``podt::stem_bn_pool_quant`` (``ops/library.py``): the same launch on CUDA,
the plain version on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from pytorch_object_detection_tpu_torch.ops import library
from pytorch_object_detection_tpu_torch.ops.qblock import card_limits

SOURCE = "stem.cu"
# no FMA contraction: a fused multiply-add moves values across a rounding boundary
NVCC_FLAGS = ("-fmad=false",)
STEM_TAIL_ROWS = (1, 2, 4, 8, 16, 32)  # pooled rows a block may take
STEM_TAIL_COLS = (8, 16, 32, 64, 128)  # pooled columns a block may take
STEM_TAIL_PER_SM = 5  # blocks an SM holds at least under the chooser's band


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load K17; its C signatures are declared here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE, NVCC_FLAGS)
    lib.stem_tail_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.stem_tail_launch.restype = ctypes.c_int
    lib.stem_tail_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.stem_tail_smem_bytes.restype = ctypes.c_int
    return lib


def stem_tail_smem_bytes(c: int, rows: int, cols: int) -> int:
    """Shared memory of a K17 block (``stem_tail_kernel``'s layout): mult and
    shift, then BN + ReLU of the band's 2 rows + 1 input rows over 2 cols +
    1 input columns, C bf16 a pixel."""
    return (2 + (2 * rows + 1) * (2 * cols + 1)) * (c // 8) * 16


def stem_tail_staged(h: int, w: int, rows: int, cols: int) -> int:
    """Input pixels an image's blocks stage: each band's 2 rows + 1 input
    rows times each span's 2 cols + 1 columns (the halo row and column
    read twice)."""
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return (2 * ho + -(-ho // rows)) * (2 * wo + -(-wo // cols))


def stem_tail_blocks(batch: int, h: int, w: int, rows: int, cols: int) -> int:
    """K17's blocks: bands x spans x images."""
    return batch * -(-((h - 1) // 2 + 1) // rows) * -(-((w - 1) // 2 + 1) // cols)


def pick_stem_tail_tile(batch: int, h: int, w: int, sm_count: int, smem_max: int, c: int = 64) -> Tuple[int, int]:
    """``(rows, cols)`` pooled rows and columns a K17 block takes on a ``[B,
    h, w, c]`` stem map: of the bands whose shared memory lets five blocks
    share an SM (an SM holds ``smem_max`` + 1 KB, each block 1 KB more than
    it asks for: enough loads in flight), those with the most blocks up to
    ``2 * sm_count`` (the card filled), then the fewest input pixels staged
    (the halo re-read), then the widest span: 8 x 8 on the 512x512 canvas
    from B=2 up.  Raises ``ValueError`` where no band fits."""
    return _pick_stem_tail_tile(batch, h, w, sm_count, smem_max, c)


@functools.lru_cache(maxsize=256)
def _pick_stem_tail_tile(batch, h, w, sm_count, smem_max, c):
    fits = [(r, cl) for r in STEM_TAIL_ROWS for cl in STEM_TAIL_COLS
            if STEM_TAIL_PER_SM * (stem_tail_smem_bytes(c, r, cl) + 1024) <= smem_max + 1024]
    if not fits:
        raise ValueError(f"K17: no band fits {STEM_TAIL_PER_SM} blocks in {smem_max + 1024} bytes of shared memory "
                         f"an SM at C={c}")
    return min(fits, key=lambda t: (-min(stem_tail_blocks(batch, h, w, *t), 2 * sm_count),
                                    stem_tail_staged(h, w, *t), -t[1]))


@functools.lru_cache(maxsize=None)
def _check_smem(c: int, rows: int, cols: int) -> None:
    """The chooser's shared-memory arithmetic is the kernel's (once per band and channel count)."""
    got = _lib().stem_tail_smem_bytes(c, rows, cols)
    if got != stem_tail_smem_bytes(c, rows, cols):
        raise RuntimeError(f"K17: the kernel takes {got} bytes of shared memory, the chooser "
                           f"{stem_tail_smem_bytes(c, rows, cols)}")


def stem_bn_pool_quant_plain(x: torch.Tensor, mult_b: torch.Tensor, shift_b: torch.Tensor,
                             inv_s: torch.Tensor) -> torch.Tensor:
    """The kernel's ops in plain PyTorch: BN + ReLU in ``x``'s dtype (bf16:
    each op rounded to bf16), the 3x3/2 pool over zero padding (exact after
    the ReLU), then ``clip8(pooled * inv_s)`` in f32."""
    y = torch.clamp(x * mult_b + shift_b, min=0)
    pooled = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)
    return torch.clamp(torch.round(pooled.float() * inv_s), -127.0, 127.0).to(torch.int8).contiguous()


def stem_bn_pool_quant(x: torch.Tensor, mult: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, *,
                       plain: bool = False, tile=None) -> torch.Tensor:
    """bf16 stem-conv output ``[B, H, W, C]`` (NHWC) -> int8 ``[B, (H - 1) //
    2 + 1, (W - 1) // 2 + 1, C]``: BN + ReLU in bf16, 3x3/2 max pool, int8 at
    ``scale`` (a 0-d f32 tensor).  ``mult`` and ``shift`` are the folded
    BN's, f32 (rounded to bf16 here, as the JAX kernel does) or already
    bf16 (the stem tail's cached operands: no cast kernel then).  An f32
    stem (the CPU tests' compute dtype) runs the plain version in f32 with
    the bf16-rounded ``mult`` and ``shift``, as the JAX kernel does with an
    f32 input.

    On a CPU tensor this is :func:`stem_bn_pool_quant_plain`; on a CUDA
    tensor it launches K17 (which takes ``1 / scale`` itself) or raises.
    ``tile=(rows, cols)`` forces the pooled rows and columns a block takes
    instead of :func:`pick_stem_tail_tile`'s, for the checks; the output
    does not depend on it.  ``plain=True`` runs the plain version on any
    device, for the comparison only.  ``stem_bn_pool_quant.launches`` counts
    kernel launches.
    """
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 4:
        raise ValueError(f"x must be bf16 (or f32) [B, H, W, C] (NHWC); got {x.dtype} {tuple(x.shape)}")
    b, h, w, c = x.shape
    for name, v in (("mult", mult), ("shift", shift)):
        if v.dtype not in (torch.float32, torch.bfloat16) or tuple(v.shape) != (c,):
            raise ValueError(f"{name} must be float32 or bfloat16 [{c}]; got {v.dtype} {tuple(v.shape)}")
    if scale.dtype != torch.float32 or scale.numel() != 1:
        raise ValueError(f"scale must be one float32 value; got {scale.dtype} {tuple(scale.shape)}")
    mult_b, shift_b = mult.to(torch.bfloat16), shift.to(torch.bfloat16)
    if plain:
        return stem_bn_pool_quant_plain(x, mult_b, shift_b, (1.0 / scale).reshape(()))
    if library.route(x):
        if tile is None and x.is_cuda:
            tile = pick_stem_tail_tile(b, h, w, *card_limits(x.device), c=c)
        return stem_bn_pool_quant_op(x, mult_b, shift_b, scale, library.tile_ints(tile))
    if x.device.type == "cpu":
        return stem_bn_pool_quant_plain(x, mult_b, shift_b, (1.0 / scale).reshape(()))
    return _launch(x, mult_b, shift_b, scale, tile)


def _launch(x: torch.Tensor, mult_b: torch.Tensor, shift_b: torch.Tensor, scale: torch.Tensor, tile) -> torch.Tensor:
    """K17 on CUDA tensors (``mult`` and ``shift`` in bf16), counted in ``stem_bn_pool_quant.launches``."""
    b, h, w, c = x.shape
    if x.device.type != "cuda":
        raise ValueError(f"K17 runs on CUDA tensors; got {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"K17 takes the bf16 stem; got {x.dtype}")
    if any(t.device != x.device for t in (mult_b, shift_b, scale)):
        raise ValueError(f"K17: every operand must be on {x.device}")
    if not x.is_contiguous() or c % 8 or x.data_ptr() % 16 or mult_b.data_ptr() % 16 or shift_b.data_ptr() % 16:
        raise ValueError(f"K17 reads x, mult and shift in 16-byte words: NHWC-contiguous, 16-byte aligned, with C a "
                         f"multiple of 8 (got {c})")
    out = torch.empty((b, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    if tile is None:
        tile = pick_stem_tail_tile(b, h, w, *card_limits(x.device), c=c)
    elif tuple(tile) not in [(r, cl) for r in STEM_TAIL_ROWS for cl in STEM_TAIL_COLS] or stem_tail_smem_bytes(
            c, *tile) > card_limits(x.device)[1]:
        raise ValueError(f"K17 does not take tile {tile}: rows in {STEM_TAIL_ROWS}, columns in {STEM_TAIL_COLS}, "
                         f"within the card's shared memory")
    _check_smem(c, *tile)
    index = x.get_device()
    args = (x.data_ptr(), mult_b.data_ptr(), shift_b.data_ptr(), scale.data_ptr(), out.data_ptr(), b, h, w, c,
            *tile)
    if index == torch.cuda.current_device():
        err = _lib().stem_tail_launch(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):  # the launch goes to the current device
            err = _lib().stem_tail_launch(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"K17 launch failed: cudaError {err}")
    stem_bn_pool_quant.launches += 1
    return out


stem_bn_pool_quant.launches = 0


stem_bn_pool_quant_op = library.define(
    "stem_bn_pool_quant", "(Tensor x, Tensor mult_b, Tensor shift_b, Tensor scale, int[]? tile) -> Tensor",
    cpu=lambda x, mult_b, shift_b, scale, tile: stem_bn_pool_quant_plain(x, mult_b, shift_b,
                                                                         (1.0 / scale).reshape(())),
    cuda=lambda x, mult_b, shift_b, scale, tile: _launch(x, mult_b, shift_b, scale, library.tile_tuple(tile)),
    fake=lambda x, *_: library.empty_like_shape(
        x, (x.shape[0], (x.shape[1] - 1) // 2 + 1, (x.shape[2] - 1) // 2 + 1, x.shape[3]), torch.int8))
