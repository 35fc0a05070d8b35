"""K13: a chain of int8 ResNet bottlenecks in one CUDA launch (``csrc/qchain.cu``), and its plain version.

Replaces ``pytorch_object_detection_tpu/ops/pallas_qchain.py:qchain``, which
runs a backbone segment of bottlenecks ([layer1_0 .. layer2_3] -> C3,
[layer3_*] -> C4, [layer4_*] -> C5) as one kernel with the intermediate
activations in VMEM.  It computes exactly what kernel C (``ops/qblock.py``)
computes block after block, with kernel C's phases
(``csrc/qblock_tile.cuh``): a cooperative launch of clusters walks each
bottleneck's kernel C tiles and meets at a grid-wide barrier before the
next; the intermediates go to two ping-pong scratch buffers in device
memory.  ``csrc/qchain.cu`` says why, and what bounds it.
:func:`pick_chain_tile` chooses each bottleneck's tile.

The JAX package's ``plan_chains`` splits a segment to fit a VMEM budget of
the TPU; nothing here has such a budget (scratch lives in device memory), so
every chain runs whole, as one launch.  The JAX row-pair lane-merged layout
(``merged``) has no counterpart: the chain takes and gives canonical NHWC.

A chain is a sequence of ``(blk, stride)``: ``blk`` a bottleneck of the
backbone qtree (``nn/resnet_int8.quantize_resnet50``: ``w1 [Cw, Cin]``,
``w2 [Cw, 3, 3, Cw]``, ``w3 [Cout, Cw]``, ``A1`` .. ``B3``, then ``wd``,
``Ad``, ``Bd`` or ``short_mul``), ``stride`` 1 or 2.  The plain version runs
kernel C's plain version block after block; on a CPU tensor the wrapper
runs it, on a CUDA tensor it launches K13 or raises.

While a tracer runs (``utils/export.py``) the wrappers call their ops,
``podt::qchain`` (``ops/library.py``): the same launch on CUDA, the plain
version on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from pytorch_object_detection_tpu_torch.ops import library
from pytorch_object_detection_tpu_torch.ops.qblock import (
    SPLITS, TILE_WIDTHS, _check, card_limits, out_hw, qbottleneck_plain, smem_bytes, tile_grid)

SOURCE = "qchain.cu"
# no FMA contraction, as kernel C, whose phases this runs
NVCC_FLAGS = ("-fmad=false",)
MAX_CHAIN = 8  # kMaxChain in csrc/qchain.cu
# a block's tensors in the order of qchain_launch's pointer table (after x),
# and the keys of the identity shortcut's and the projection's extras
_VEC_KEYS = ("A1", "B1", "A2", "B2", "A3", "B3")
_KEYS = ("w1", "w2", "w3", "wd", *_VEC_KEYS, "Ad", "Bd", "short_mul")

Chain = Sequence[Tuple[Dict, int]]
Tile = Tuple[int, int]


@functools.lru_cache(maxsize=None)
def _lib(min_blocks: int = 2) -> ctypes.CDLL:
    """Build (at first use) and load K13 for ``min_blocks`` resident blocks
    an SM (2: registers capped at 128; 1: up to 255); its C signature is
    declared here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE, (*NVCC_FLAGS, f"-DQCHAIN_MIN_BLOCKS={min_blocks}"))
    lib.qchain_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p]
    lib.qchain_launch.restype = ctypes.c_int
    return lib


def chain_shapes(x_shape, blocks: Chain) -> List[Tuple[Tuple[int, int, int], Tuple[int, int, int]]]:
    """Per block ``((H, W, Cin), (Ho, Wo, Cout))`` from the chain's input
    shape ``(H, W, C)`` (no batch dimension)."""
    shapes = []
    h, w, c = x_shape
    for blk, stride in blocks:
        ho, wo = out_hw(h, w, stride)
        shapes.append(((h, w, c), (ho, wo, blk["w3"].shape[0])))
        h, w, c = shapes[-1][1]
    return shapes


def chain_smem_bytes(convs, tiles: Sequence[Tile]) -> int:
    """K13's dynamic shared memory: the largest of its bottlenecks' kernel C
    tiles (``convs``: per block ``(H, W, Cw, Cout, stride)``)."""
    return max(smem_bytes(stride, tw, cw) for (_, _, cw, _, stride), (tw, _) in zip(convs, tiles))


def tile_blocks(ho: int, wo: int, tw: int) -> int:
    """Tiles of 8 x ``tw`` over one image's ``ho x wo`` output map."""
    ty, tx = tile_grid(ho, wo, tw)
    return ty * tx


def two_per_sm(nbytes: int, smem_max: int) -> bool:
    """Whether two blocks of ``nbytes`` dynamic shared memory fit on one SM
    (an SM holds ``smem_max`` + 1 KB, each block 1 KB more than it asks for)."""
    return 2 * (nbytes + 1024) <= smem_max + 1024


@functools.lru_cache(maxsize=256)
def pick_chain_tile(batch: int, convs: Tuple[Tuple[int, int, int, int, int], ...], sm_count: int,
                    smem_max: int) -> Tuple[Tuple[Tile, ...], int]:
    """``(tiles, cluster)`` for K13 on the bottlenecks ``convs`` (per block
    ``(H, W, Cw, Cout, stride)``).  The launch has one shared-memory size,
    its largest tile's (:func:`chain_smem_bytes`), so one residency: two
    blocks an SM where every block has a kernel C tile that leaves room for
    two, else one.  Each block then takes kernel C's rule
    (:func:`ops.qblock.pick_tile`) under that residency: of (16, 1), (8, 1),
    (8, 2), (8, 4), (8, 8), the first that fits and gives at least one block
    per SM, else the one with the most blocks.  The launch's cluster size is
    the largest split, which every other split divides."""
    opts = [[(tw, sp) for tw in TILE_WIDTHS for sp in SPLITS
             if (tw == 8 or sp == 1) and cw % (16 * sp) == 0 and cout % (16 * sp) == 0
             and smem_bytes(stride, tw, cw) <= smem_max] for _, _, cw, cout, stride in convs]
    if not all(opts):
        raise ValueError(f"K13: a bottleneck of the chain has no kernel C tile that fits in {smem_max} bytes")
    two = all(any(two_per_sm(smem_bytes(c[4], tw, c[2]), smem_max) for tw, _ in o) for c, o in zip(convs, opts))
    tiles = []
    for (h, w, cw, _, stride), o in zip(convs, opts):
        if two:
            o = [t for t in o if two_per_sm(smem_bytes(stride, t[0], cw), smem_max)]
        ho, wo = out_hw(h, w, stride)
        ctas = lambda t: batch * tile_blocks(ho, wo, t[0]) * t[1]
        tiles.append(next((t for t in o if ctas(t) >= sm_count), None) or max(o, key=ctas))
    return tuple(tiles), max(split for _, split in tiles)


def _operands(blk: Dict, device: torch.device):
    """(epilogue vectors by kernel C's names, wd or None, short_mul or None)."""
    vecs = {k.lower(): blk[k] for k in _VEC_KEYS}
    if "wd" in blk:
        vecs.update(ad=blk["Ad"], bd=blk["Bd"])
        return vecs, blk["wd"], None
    short_mul = blk["short_mul"]
    if not isinstance(short_mul, torch.Tensor):
        short_mul = torch.tensor(float(short_mul), dtype=torch.float32, device=device)
    return vecs, None, short_mul


def qchain_plain(x: torch.Tensor, blocks: Chain) -> torch.Tensor:
    """The chain in plain PyTorch ops: kernel C's plain version, block after block."""
    for blk, stride in blocks:
        vecs, wd, short_mul = _operands(blk, x.device)
        x = qbottleneck_plain(x, blk["w1"], blk["w2"], blk["w3"], **vecs, stride=stride, wd=wd, short_mul=short_mul)
    return x


class _Plan:
    """A chain checked against one input shape and device: its shapes, each
    block's ``(H, W, Cw, Cout, stride)`` and, made at the first launch, the
    pointer table of its weights and epilogue vectors (the per-call x and
    outputs left 0).  It holds the blocks' tensors, so their ids stay
    theirs while it lives."""

    def __init__(self, x: torch.Tensor, blocks: Chain):
        self.held = [tuple(blk.get(k) for k in _KEYS) for blk, _ in blocks]
        self.shapes = chain_shapes(x.shape[1:], blocks)
        self.args = []
        for (blk, stride), ((h, w, cin), _) in zip(blocks, self.shapes):
            vecs, wd, short_mul = _operands(blk, x.device)
            _check(x.new_empty((0, h, w, cin)), blk["w1"], blk["w2"], blk["w3"], vecs, stride, wd, short_mul)
            self.args.append((blk, vecs, wd, short_mul))
        self.convs = tuple((h, w, blk["w1"].shape[0], cout, stride)
                           for (blk, stride), ((h, w, _), (_, _, cout)) in zip(blocks, self.shapes))
        self.ptrs = None

    def holds(self, blocks: Chain) -> bool:
        """Whether ``blocks`` still hold the tensors this plan checked."""
        return all(all(blk.get(k) is t for k, t in zip(_KEYS, held)) for (blk, _), held in zip(blocks, self.held))

    def table(self, x: torch.Tensor):
        """The kernel's pointer table, after the checks a launch needs (once)."""
        if self.ptrs is not None:
            return self.ptrs
        tensors = [t for blk, vecs, wd, sm in self.args
                   for t in (blk["w1"], blk["w2"], blk["w3"], *vecs.values(), wd if wd is not None else sm)]
        if any(t.device != x.device for t in tensors):
            raise ValueError(f"K13: every operand must be on {x.device}")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("K13 takes contiguous operands (x NHWC-contiguous)")
        if any(t.data_ptr() % 16 for blk, _, wd, _ in self.args for t in (blk["w1"], blk["w2"], blk["w3"], wd)
               if t is not None):
            raise ValueError("K13 reads x and the weights in 16-byte words: they must start 16-byte aligned")
        if any(c % 16 for _, _, cw, cout, _ in self.convs for c in (cw, cout)) or x.shape[-1] % 16:
            raise ValueError("K13 needs channel counts divisible by 16")
        ptr = lambda t: 0 if t is None else t.data_ptr()
        table = []
        for blk, vecs, wd, short_mul in self.args:  # short_mul held here: the table points at it
            table += [0, ptr(blk["w1"]), ptr(blk["w2"]), ptr(blk["w3"]), ptr(wd),
                      *(ptr(vecs[k.lower()]) for k in _VEC_KEYS), ptr(vecs.get("ad", short_mul)),
                      ptr(vecs.get("bd")), 0]
        self.ptrs = (ctypes.c_void_p * len(table))(*table)
        return self.ptrs


_plans: Dict[tuple, _Plan] = {}
_MAX_PLANS = 16


def _plan(x: torch.Tensor, blocks: Chain) -> _Plan:
    """The chain's checked plan for ``x``'s shape and device, made once per
    list of block dicts (the dicts by identity, their tensors held and
    compared by identity on every call)."""
    if library.tracing(x):  # a tracer's tensors are fake: a plan made of them is kept nowhere
        return _Plan(x, blocks)
    key = (tuple(x.shape[1:]), x.device, tuple((id(blk), stride) for blk, stride in blocks))
    plan = _plans.get(key)
    if plan is None or not plan.holds(blocks):
        plan = _Plan(x, blocks)
        if len(_plans) >= _MAX_PLANS:
            _plans.pop(next(iter(_plans)))
        _plans[key] = plan
    return plan


def _tiles(tile, plan: _Plan, batch: int, sm_count: int, smem_max: int):
    """(tiles, cluster): the chooser's, or ``tile`` (one ``(tw, split)`` for
    every block, or one per block) checked against every block."""
    if tile is None:
        return pick_chain_tile(batch, plan.convs, sm_count, smem_max)
    tiles = [tuple(tile)] * len(plan.convs) if isinstance(tile[0], int) else [tuple(t) for t in tile]
    if len(tiles) != len(plan.convs):
        raise ValueError(f"tile={tile}: one (tw, split) for the chain or one per block ({len(plan.convs)})")
    for (tw, split), (_, _, cw, cout, _) in zip(tiles, plan.convs):
        if tw not in TILE_WIDTHS or split not in SPLITS or cw % (16 * split) or cout % (16 * split):
            raise ValueError(f"tile={tile}: K13 takes kernel C's tiles: width 8 or 16, 1, 2, 4 or 8 blocks per "
                             f"tile that divide Cw={cw} and Cout={cout} into multiples of 16")
    if chain_smem_bytes(plan.convs, tiles) > smem_max:
        raise ValueError(f"tile={tile}: a tile of the chain does not fit in shared memory")
    return tuple(tiles), max(split for _, split in tiles)


def qchain(x: torch.Tensor, blocks: Chain, *, tile: Optional[Union[Tile, Sequence[Tile]]] = None,
           plain: bool = False) -> torch.Tensor:
    """int8 NHWC ``x [B, H, W, C]`` through the chain's bottlenecks -> the last
    block's int8 output.

    On a CPU tensor this is :func:`qchain_plain`; on a CUDA tensor it
    launches K13 once or raises.  ``plain=True`` runs the plain version on
    any device, for the comparison only.  ``tile`` ``(tw, split)`` for every
    block, or one per block, overrides :func:`pick_chain_tile`; the result
    does not depend on it.  ``qchain.launches`` counts kernel launches,
    ``qchain.grid`` holds the last launch's thread blocks.  It raises on a
    stream that a CUDA graph is capturing.
    """
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"x must be int8 [B, H, W, C] (NHWC); got {x.dtype} {tuple(x.shape)}")
    if not 1 <= len(blocks) <= MAX_CHAIN:
        raise ValueError(f"a chain has 1 to {MAX_CHAIN} bottlenecks; got {len(blocks)}")
    plan = _plan(x, blocks)
    if plain:
        return qchain_plain(x, blocks)
    if library.route(x):
        if x.is_cuda:
            tile = _tiles(tile, plan, x.shape[0], *card_limits(x.device))[0]
        flat = [t for blk, _ in blocks for t in _flat_block(blk, x.device)]
        return qchain_op(x, flat, [stride for _, stride in blocks], library.tile_ints(tile))
    if x.device.type == "cpu":
        return qchain_plain(x, blocks)
    return _launch(x, blocks, plan, tile)


def _launch(x: torch.Tensor, blocks: Chain, plan: _Plan, tile) -> torch.Tensor:
    """K13 on a CUDA tensor, counted in ``qchain.launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"K13 runs on CUDA tensors; got {x.device}")
    if not x.is_contiguous():
        raise ValueError("K13 takes contiguous operands (x NHWC-contiguous)")
    if x.data_ptr() % 16:
        raise ValueError("K13 reads x and the weights in 16-byte words: they must start 16-byte aligned")

    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("K13 cannot be captured in a CUDA graph: it copies its chain's arguments from host "
                           "memory before each launch")
    b = x.shape[0]
    sm_count, smem_max = card_limits(x.device)
    tiles, cluster = _tiles(tile, plan, b, sm_count, smem_max)
    shapes = plan.shapes
    # block i writes scratch[i % 2] (the last block: out); block i + 1 reads it
    inter = [b * ho * wo * c for _, (ho, wo, c) in shapes[:-1]]
    scratch = [torch.empty(max(inter[i::2], default=0), dtype=torch.int8, device=x.device) for i in range(2)]
    out = torch.empty((b, *shapes[-1][1]), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    n = len(shapes)
    table = plan.table(x)
    ptrs = type(table).from_buffer_copy(table)
    dims = (ctypes.c_int * (8 * n))()
    src = x
    for i, ((h, w, cw, cout, stride), (tw, split)) in enumerate(zip(plan.convs, tiles)):
        dst = out if i == n - 1 else scratch[i % 2]
        ptrs[14 * i], ptrs[14 * i + 13] = src.data_ptr(), dst.data_ptr()
        dims[8 * i:8 * i + 8] = (h, w, shapes[i][0][2], cw, cout, stride, tw, split)
        src = dst
    grid = ctypes.c_int(0)
    lib = _lib(2 if two_per_sm(chain_smem_bytes(plan.convs, tiles), smem_max) else 1)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = lib.qchain_launch(ptrs, dims, n, b, cluster, ctypes.byref(grid), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K13 launch failed: cudaError {err}")
    qchain.launches += 1
    qchain.grid = grid.value
    return out


qchain.launches = 0
qchain.grid = 0


def _flat_block(blk: Dict, device: torch.device):
    """A block's tensors in ``_KEYS`` order, None where it has none, ``short_mul`` as a 0-d tensor."""
    out = [blk.get(k) for k in _KEYS]
    if out[-1] is not None:
        out[-1] = _operands(blk, device)[2]
    return out


def _blocks(flat, strides) -> List[Tuple[Dict, int]]:
    """The inverse of :func:`_flat_block` over a chain."""
    n = len(_KEYS)
    return [({k: v for k, v in zip(_KEYS, flat[n * i:n * i + n]) if v is not None}, s) for i, s in enumerate(strides)]


def _op_cuda(x, flat, strides, tile):
    blocks = _blocks(flat, strides)
    tiles = None if tile is None else [tuple(tile[2 * i:2 * i + 2]) for i in range(len(tile) // 2)]
    return _launch(x, blocks, _plan(x, blocks), tiles)


def _op_fake(x, flat, strides, tile):
    b, h, w, _ = x.shape
    n = len(_KEYS)
    for s in strides:
        h, w = out_hw(h, w, s)
    return library.empty_like_shape(x, (b, h, w, flat[n * (len(strides) - 1) + 2].shape[0]))


qchain_op = library.define(
    "qchain", "(Tensor x, Tensor?[] blocks, int[] strides, int[]? tile) -> Tensor",
    cpu=lambda x, flat, strides, tile: qchain_plain(x, _blocks(flat, strides)), cuda=_op_cuda, fake=_op_fake)
