"""K7 and K9: one level of the int8 HISHead in CUDA (``csrc/qhead.cu``), and their plain version.

Replace ``pytorch_object_detection_tpu/ops/pallas_qhead.py``'s
``qhishead_level`` (K7) and ``qhishead_level2`` (K9).  One call maps an int8
pyramid level to the head's two prediction maps:

  pw1 (1x1, C -> 2C) -> GN32 + ReLU -> dw3x3 -> GN32 + SiLU -> pw2 (1x1, 2C -> C)
  + bias + residual -> [cls 3x3 -> GN32 + ReLU -> cls_pred 3x3]
                       [reg 3x3 -> GN32 + ReLU -> cnt|reg pred 3x3]

Each conv is int8 x int8 with an exact int32 sum; its pre-norm map is
``float(acc) * A`` (the per-channel dequant comes before the GroupNorm's
statistics), each GroupNorm output is requantized at a per-level scale.

Layouts: ``x_q`` int8 NHWC ``[B, H, W, C]``, contiguous; the qtree as
``models/head_int8.quantize_hishead`` makes it: ``w1 [2C, C]``, ``wdw [3, 3,
2C]``, ``w2 [C, 2C]``, ``wc``/``wr [C, 3, 3, C]``, ``wpc [nc, 3, 3, C]``,
``wcr [5, 3, 3, C]`` int8 (each output channel's K-vector contiguous);
``b2``, ``bpc``, ``bcr`` f32; ``gn1``, ``gn2`` (2C) and ``gnc``, ``gnr`` (C)
as (gamma, beta) f32; ``lv`` one entry of ``q["levels"]`` (``A1, inv_x1,
Adw, inv_x2, A2, B2, res_mul, Ac, inv_c, Ar, inv_r, Apc, Acr``, the scalars
0-d).  Returns ``(cls [B, H, W, nc], cr [B, H, W, 5])`` f32, ``cr`` =
[cnt, reg x 4] before the ScaleExp.  On the card C must be a multiple of 32.

The plain version is the JAX per-op oracle ``models/head_int8.py:
_hishead_level_i8_xla`` (``:187-205``) operation for operation: exact int32
convolutions, the f32 epilogues in the oracle's association, each GroupNorm
in f32 over the whole (H*W, group) extent with a two-pass variance.  The
kernels take their GroupNorm statistics exactly (int64 sums of the int32
accumulators, combined in double), so a group mean or variance can differ
from the plain f32 one in its last bits, and SiLU goes through the card's
``expf``: an int8 intermediate can move by one step, which the later convs
carry into the outputs (the JAX kernels' own contract, ``tests/
test_quant.py:586-629``: max error under 0.05 of max|cls|, cosine over 0.999).

On the card each pass's thread block owns one 8x8 tile (smaller at the
map's edges) of ``ipb`` images and one slice of the pass's output channels;
:func:`pick_head_tile` chooses them per level from the card's SM count and
shared memory, and the GEMM-shaped passes run on the int8 tensor cores
(``csrc/qhead.cu``).  The outputs do not depend on the choice.

While a tracer runs (``utils/export.py``) the wrappers call their ops,
``podt::qhishead_level`` and ``podt::qhishead_level2`` (``ops/library.py``):
the same launch on CUDA, the plain version on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from pytorch_object_detection_tpu_torch.ops import library
from pytorch_object_detection_tpu_torch.ops.qblock import card_limits
from pytorch_object_detection_tpu_torch.ops.qhis import depthwise3x3_i8
from pytorch_object_detection_tpu_torch.ops.quant import clip8, conv_i8

SOURCE = "qhead.cu"
# no FMA contraction: a fused multiply-add moves values across a requant boundary
NVCC_FLAGS = ("-fmad=false",)
GN_EPS = 1e-5
NUM_GROUPS = 32
# the pointer table of qhead_launch, in csrc/qhead.cu's order (gn* expand to gamma, beta)
_SHARED = ("w1", "wdw", "w2", "wc", "wr", "wpc", "wcr", "bpc", "bcr", "gn1", "gn2", "gnc", "gnr")
_LEVEL = ("A1", "inv_x1", "Adw", "inv_x2", "A2", "B2", "res_mul", "Ac", "inv_c", "Ar", "inv_r", "Apc", "Acr")

# the passes of csrc/qhead.cu that take a tile choice, in qhead_launch's order
HEAD_PASSES = ("pw1", "dw", "pw2", "towers", "pred")
HEAD_TILE = 8  # kT: tiles of at most 8x8 positions
HEAD_STAGES = 4  # kStages: the weights' cp.async ring
HEAD_STEP = 64  # kStepBytes: K bytes per ring stage
PRED_NC = 32  # kPredNC: classes per pred block
HEAD_SPLITS = (1, 2, 4, 8)


def head_tile_dims(h: int, w: int) -> Tuple[int, int, int]:
    """(positions of a full tile, halo rows of one image, halo row width)."""
    th, tw = min(HEAD_TILE, h), min(HEAD_TILE, w)
    return th * tw, (th + 2) * (tw + 2), tw + 2


def head_pass_width(pass_: str, c: int, nc: int) -> int:
    """Output channels a pass splits across blocks (pred: its column blocks)."""
    if pass_ == "pred":
        return -(-nc // PRED_NC) + 1
    return c if pass_ == "pw2" else 2 * c


def head_slices(pass_: str, c: int, nc: int):
    """The channel-slice counts a pass may take: whole 16-channel groups, at
    least 64 channels a slice where split; pred's is fixed."""
    n = head_pass_width(pass_, c, nc)
    if pass_ == "pred":
        return (n,)
    return tuple(s for s in HEAD_SPLITS if n % (16 * s) == 0 and (s == 1 or n // s >= 64))


def _align(n: int) -> int:
    return -(-n // 128) * 128


def head_smem_bytes(pass_: str, ipb: int, h: int, w: int, c: int, nc: int, split: int, pair: bool) -> int:
    """Dynamic shared memory of one block of a pass (``smem_of`` in
    csrc/qhead.cu): the GroupNorm table of a normalizing pass, the A operand
    or halo, the rows' halo positions, and the weights' ring, reused for the
    int32 sums (rows of NC + 8 words)."""
    npos, halo, _ = head_tile_dims(h, w)
    mc = 64 if ipb * npos <= 64 else 128
    slice_ = PRED_NC if pass_ == "pred" else head_pass_width(pass_, c, nc) // split
    ncol = 128 if slice_ % 128 == 0 else 64
    ring = HEAD_STAGES * ncol * HEAD_STEP
    ring_or_sums = max(ring, mc * (ncol + 8) * 4)
    if pass_ == "pw1":
        return _align(mc * c + 64) + ring_or_sums
    if pass_ == "dw":  # GN1 table [ipb][slice] float4, x1q on the halo, its sums (K9: x on the halo, the ring)
        if not pair:
            return _align(ipb * slice_ * 16) + _align(ipb * halo * slice_) + 2 * ipb * slice_ * 8
        return (_align(ipb * slice_ * 16) + _align(ipb * halo * c + 64) + _align(ipb * halo * slice_)
                + _align(2 * ipb * slice_ * 8) + ring)
    if pass_ == "pw2":  # GN2 table [ipb][2C], x2q rows
        return _align(ipb * 2 * c * 16) + _align(mc * 2 * c + 64) + ring_or_sums
    if pass_ == "towers":  # 256 channels a chunk where the slice allows, at 64 rows
        if mc == 64 and slice_ % 256 == 0:
            ring_or_sums = max(HEAD_STAGES * 256 * HEAD_STEP, mc * (256 + 8) * 4)
        return _align(ipb * halo * c + 64) + _align(mc * 4) + ring_or_sums
    return _align(ipb * c * 16) + _align(ipb * halo * c + 64) + _align(mc * 4) + HEAD_STAGES * PRED_NC * HEAD_STEP


def head_blocks(batch: int, h: int, w: int, ipb: int, split: int) -> int:
    """Thread blocks of one pass: tiles x image groups x slices."""
    return -(-h // HEAD_TILE) * -(-w // HEAD_TILE) * -(-batch // ipb) * split


def head_ipbs(batch: int, h: int, w: int, pair: bool):
    """Images a block may take, largest first: M rows (ipb x a full tile's
    positions) at most 64 (K7) or 128 (K9, whose blocks take image pairs)."""
    npos = head_tile_dims(h, w)[0]
    step = 2 if pair else 1
    top = max(step, min(batch, (128 if pair else 64) // npos) // step * step)
    out = []
    while top >= step:
        out.append(top)
        top = top // 2 // step * step
    return tuple(out)


def pick_head_tile(batch: int, h: int, w: int, c: int, nc: int, sm_count: int, smem_max: int,
                   pair: bool = False) -> Dict[str, Tuple[int, int]]:
    """``{pass: (ipb, split)}`` for one level: per pass the largest image
    group, then the fewest channel slices, whose blocks reach one per SM and
    fit the shared memory; where none reaches, the most blocks.  ``pair``:
    K9's tiles, even image groups."""
    return dict(_pick_head_tile(batch, h, w, c, nc, sm_count, smem_max, bool(pair)))


@functools.lru_cache(maxsize=None)
def _pick_head_tile(batch, h, w, c, nc, sm_count, smem_max, pair):
    out = {}
    for pass_ in HEAD_PASSES:
        best = None
        for ipb in head_ipbs(batch, h, w, pair):
            for split in head_slices(pass_, c, nc):
                if head_smem_bytes(pass_, ipb, h, w, c, nc, split, pair) > smem_max:
                    continue
                blocks = head_blocks(batch, h, w, ipb, split)
                if blocks >= sm_count:
                    best = (ipb, split)
                    break
                if best is None or blocks > head_blocks(batch, h, w, *best):
                    best = (ipb, split)
            else:
                continue
            break
        if best is None:
            raise ValueError(f"K{9 if pair else 7}: no {pass_} tile fits {smem_max} bytes of shared memory "
                             f"at {h}x{w}, C={c}")
        out[pass_] = best
    return tuple(out.items())


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load K7/K9; their C signatures are declared here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE, NVCC_FLAGS)
    lib.qhead_scratch_bytes.argtypes = [ctypes.c_int] * 5
    lib.qhead_scratch_bytes.restype = ctypes.c_size_t
    lib.qhead_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
    lib.qhead_launch.restype = ctypes.c_int
    lib.qhead_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.qhead_smem_bytes.restype = ctypes.c_int
    return lib


def _gn(z: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, act: str) -> torch.Tensor:
    """GroupNorm32 + activation on f32 NHWC (the JAX ``_gn``: two-pass
    variance over the whole (H*W, group) extent, then ``* gamma + beta``)."""
    b, h, w, c = z.shape
    g = z.reshape(b, h * w, NUM_GROUPS, c // NUM_GROUPS)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + GN_EPS)).reshape(b, h, w, c)
    y = y * gamma + beta
    if act == "relu":
        return torch.clamp(y, min=0.0)
    return y * torch.sigmoid(y)  # the oracle's SiLU, not F.silu's


def qhishead_level_plain(q: Dict, lv: Dict, x_q: torch.Tensor, num_classes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One head level in plain PyTorch ops (the reference for K7 and K9).
    ``num_classes`` is unused: the pred weights carry the channel count."""
    z = conv_i8(x_q, q["w1"]) * lv["A1"]
    x1q = clip8(_gn(z, *q["gn1"], act="relu") * lv["inv_x1"])
    z = depthwise3x3_i8(x1q, q["wdw"]) * lv["Adw"]
    x2q = clip8(_gn(z, *q["gn2"], act="silu") * lv["inv_x2"])
    y = conv_i8(x2q, q["w2"]) * lv["A2"] + lv["B2"] + x_q.float() * lv["res_mul"]
    yq = clip8(y)
    zc = conv_i8(yq, q["wc"]) * lv["Ac"]
    cq = clip8(_gn(zc, *q["gnc"], act="relu") * lv["inv_c"])
    zr = conv_i8(yq, q["wr"]) * lv["Ar"]
    rq = clip8(_gn(zr, *q["gnr"], act="relu") * lv["inv_r"])
    cls = conv_i8(cq, q["wpc"]) * lv["Apc"] + q["bpc"]
    cr = conv_i8(rq, q["wcr"]) * lv["Acr"] + q["bcr"]
    return cls, cr


def _check(q: Dict, x_q: torch.Tensor, num_classes) -> int:
    """Shapes and types of the input; returns the class count."""
    if x_q.dtype != torch.int8 or x_q.dim() != 4:
        raise ValueError(f"x_q must be int8 [B, H, W, C] (NHWC); got {x_q.dtype} {tuple(x_q.shape)}")
    c2, c = q["w1"].shape
    if c2 != 2 * c or x_q.shape[-1] != c:
        raise ValueError(f"the head takes C = {c} channels (w1 [2C, C]); got x_q {tuple(x_q.shape)}")
    nc = q["wpc"].shape[0]
    if num_classes is not None and int(num_classes) != nc:
        raise ValueError(f"num_classes={num_classes} but the cls pred weights have {nc} outputs")
    return nc


@functools.lru_cache(maxsize=None)
def _check_smem(pair: bool, h: int, w: int, c: int, nc: int, cfg: Tuple[int, ...]) -> None:
    """The chooser's shared-memory arithmetic is the kernel's (once per level shape and choice)."""
    for i, p in enumerate(HEAD_PASSES):
        ipb, split = cfg[2 * i], cfg[2 * i + 1]
        got = _lib().qhead_smem_bytes(i, int(pair), ipb, h, w, c, split)
        if got != head_smem_bytes(p, ipb, h, w, c, nc, split, pair):
            raise RuntimeError(f"K7/K9 {p}: the kernel takes {got} bytes of shared memory, the chooser "
                               f"{head_smem_bytes(p, ipb, h, w, c, nc, split, pair)}")


def _launch(q: Dict, lv: Dict, x_q: torch.Tensor, nc: int, pair: bool,
            tile: Optional[Dict[str, Tuple[int, int]]]) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 (``pair=False``) or K9 on CUDA tensors (checked by ``_check`` first)."""
    dev = x_q.device
    b, h, w, c = x_q.shape
    if c % 32:
        raise ValueError(f"K7/K9 need a width divisible by 32; got {c}")
    shared = [t for k in _SHARED for t in (q[k] if k.startswith("gn") else (q[k],))]
    level = [lv[k] for k in _LEVEL]
    if x_q.device.type != "cuda" or any(t.device != dev for t in shared + level):
        raise ValueError(f"K7/K9: every operand must be on {dev}")
    if not x_q.is_contiguous() or any(t.data_ptr() % 16 for t in [x_q] + shared[:7]):
        raise ValueError("K7/K9 take x_q NHWC-contiguous, and x_q and the weights 16-byte aligned")
    if any(not t.is_contiguous() for t in shared + level) or any(t.dtype != torch.int8 for t in shared[:7]) \
            or any(t.dtype != torch.float32 for t in shared[7:] + level):
        raise ValueError("K7/K9 take contiguous int8 weights and f32 vectors and scalars")
    want = {"A1": 2 * c, "Adw": 2 * c, "A2": c, "B2": c, "Ac": c, "Ar": c, "Apc": nc, "Acr": 5}
    if any(lv[k].numel() != n for k, n in want.items()) or any(lv[k].numel() != 1 for k in _LEVEL if k not in want):
        raise ValueError(f"the level's epilogue vectors do not fit C={c}, nc={nc}")
    cls = torch.empty((b, h, w, nc), dtype=torch.float32, device=dev)
    cr = torch.empty((b, h, w, 5), dtype=torch.float32, device=dev)
    if cls.numel() == 0:
        return cls, cr
    if tile is None:
        tile = pick_head_tile(b, h, w, c, nc, *card_limits(dev), pair=pair)
    if any(-(-b // tile[p][0]) > 65535 for p in HEAD_PASSES):
        raise ValueError(f"K7/K9 take at most 65535 image groups; got {tuple(x_q.shape)} and {tile}")
    lib = _lib()
    cfg = tuple(v for p in HEAD_PASSES for v in tile[p])
    _check_smem(pair, h, w, c, nc, cfg)
    scratch = torch.empty(lib.qhead_scratch_bytes(b, h, w, c, int(pair)), dtype=torch.uint8, device=dev)
    ptrs = [x_q, *shared, *level, cls, cr]
    table = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])
    cfg = (ctypes.c_int * 10)(*cfg)
    with torch.cuda.device(dev):  # the launches go to the current device
        err = lib.qhead_launch(table, b, h, w, c, nc, int(pair), cfg, scratch.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K{9 if pair else 7} launch failed: cudaError {err}")
    return cls, cr


def qhishead_level(q: Dict, lv: Dict, x_q: torch.Tensor, *, num_classes=None, plain: bool = False,
                   tile: Optional[Dict[str, Tuple[int, int]]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pyramid level through the int8 head (the JAX signature, less
    ``row_chunk`` and ``interpret``).  ``tile`` forces
    :func:`pick_head_tile`'s choice (the outputs do not depend on it).

    On a CPU tensor this is :func:`qhishead_level_plain`; on a CUDA tensor
    it launches K7 (eight CUDA kernels, counted as one launch) or raises.
    ``plain=True`` runs the plain version on any device, for the comparison
    only.  ``qhishead_level.launches`` counts kernel launches.
    """
    nc = _check(q, x_q, num_classes)
    if plain:
        return qhishead_level_plain(q, lv, x_q)
    if library.route(x_q):
        return _route(qhishead_level_op, q, lv, x_q, nc, False, tile)
    if x_q.device.type == "cpu":
        return qhishead_level_plain(q, lv, x_q)
    return _cuda(q, lv, x_q, nc, False, tile)


def qhishead_level2(q: Dict, lv: Dict, x_q: torch.Tensor, *, num_classes=None, plain: bool = False,
                    tile: Optional[Dict[str, Tuple[int, int]]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9: :func:`qhishead_level` on image pairs, with the pw1 pre-norm map
    recomputed where the depthwise conv needs it instead of stored.  Same
    outputs and plain version.  An odd batch runs K7, as the JAX function
    does (``pallas_qhead.py:658-660``).  ``qhishead_level2.launches``
    counts K9's launches only."""
    nc = _check(q, x_q, num_classes)
    if plain or (x_q.device.type == "cpu" and not library.route(x_q)):
        return qhishead_level_plain(q, lv, x_q)
    if x_q.shape[0] % 2:
        return qhishead_level(q, lv, x_q, num_classes=num_classes)
    if library.route(x_q):
        return _route(qhishead_level2_op, q, lv, x_q, nc, True, tile)
    return _cuda(q, lv, x_q, nc, True, tile)


def _cuda(q: Dict, lv: Dict, x_q: torch.Tensor, nc: int, pair: bool, tile) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 (``pair=False``) or K9 on CUDA tensors, counted in
    ``qhishead_level.launches`` or ``qhishead_level2.launches``."""
    out = _launch(q, lv, x_q, nc, pair, tile)
    if out[0].numel():
        (qhishead_level2 if pair else qhishead_level).launches += 1
    return out


def _route(op, q: Dict, lv: Dict, x_q: torch.Tensor, nc: int, pair: bool, tile):
    """The call through ``op``, with the card's tile where ``x_q`` is on one."""
    if tile is None and x_q.is_cuda:
        tile = pick_head_tile(*x_q.shape, nc, *card_limits(x_q.device), pair=pair)
    shared = [t for k in _SHARED for t in (q[k] if k.startswith("gn") else (q[k],))]
    return op(x_q, shared, [lv[k] for k in _LEVEL], nc, library.tile_ints(
        None if tile is None else [tile[p] for p in HEAD_PASSES]))


qhishead_level.launches = 0
qhishead_level2.launches = 0


def _unflatten(shared, level):
    """(q, lv) from the op's tensor lists (``_SHARED``'s GroupNorm pairs whole)."""
    n = sum(not k.startswith("gn") for k in _SHARED)
    q = dict(zip(_SHARED[:n], shared[:n]))
    q.update({k: (shared[n + 2 * i], shared[n + 2 * i + 1]) for i, k in enumerate(_SHARED[n:])})
    return q, dict(zip(_LEVEL, level))


def _define(name: str, pair: bool):
    def cpu(x_q, shared, level, nc, tile):
        return qhishead_level_plain(*_unflatten(shared, level), x_q)

    def cuda(x_q, shared, level, nc, tile):
        return _cuda(*_unflatten(shared, level), x_q, nc, pair, library.pairs(tile, HEAD_PASSES))

    def fake(x_q, shared, level, nc, tile):
        b, h, w, _ = x_q.shape
        return (library.empty_like_shape(x_q, (b, h, w, nc), torch.float32),
                library.empty_like_shape(x_q, (b, h, w, 5), torch.float32))

    return library.define(name, "(Tensor x_q, Tensor[] shared, Tensor[] level, int nc, int[]? tile) "
                                "-> (Tensor, Tensor)", cpu=cpu, cuda=cuda, fake=fake)


qhishead_level_op = _define("qhishead_level", False)
qhishead_level2_op = _define("qhishead_level2", True)
