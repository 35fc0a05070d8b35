"""K13: a chain of int8 ResNet bottlenecks in one CUDA launch (``csrc/qchain.cu``), and its plain version.

Replaces ``pytorch_object_detection_tpu/ops/pallas_qchain.py:qchain``, which
runs a backbone segment of bottlenecks ([layer1_0 .. layer2_3] -> C3,
[layer3_*] -> C4, [layer4_*] -> C5) as one kernel with the intermediate
activations in VMEM.  It computes exactly what kernel C (``ops/qblock.py``)
computes block after block: a cooperative launch walks each bottleneck's
(image, band) items with the band body of ``csrc/qblock_band.cuh`` and meets
at a grid-wide barrier before the next; the intermediates go to two ping-pong scratch
buffers in device memory.  ``csrc/qchain.cu`` says why, and what bounds it.

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
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch

from pytorch_object_detection_tpu_torch.ops.qblock import _check, card_limits, out_hw, qbottleneck_plain

SOURCE = "qchain.cu"
# no FMA contraction, as kernel C, whose band body this runs
NVCC_FLAGS = ("-fmad=false",)
MAX_CHAIN = 16  # kMaxChain in csrc/qchain.cu

Chain = Sequence[Tuple[Dict, int]]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load K13; its C signature is declared here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE, NVCC_FLAGS)
    lib.qchain_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p]
    lib.qchain_launch.restype = ctypes.c_int
    return lib


def smem_bytes(rows: int, stride: int, w: int, cw: int) -> int:
    """K13's shared memory for a band of ``rows`` output rows (the band body
    of ``csrc/qblock_band.cuh``): a1 with its halo rows and two zero
    columns, then a2."""
    wo = (w - 1) // stride + 1
    return ((rows - 1) * stride + 3) * (w + 2) * cw + rows * wo * cw


def pick_rows(batch: int, h: int, w: int, cw: int, stride: int, sm_count: int, smem_max: int) -> int:
    """Output rows per band of K13's band body: the largest of 8, 4, 2, 1
    that leaves two blocks' shared memory per SM and at least two waves of
    blocks on the card; else the smallest band (most blocks) that fits."""
    ho = (h - 1) // stride + 1
    fits = [r for r in (8, 4, 2, 1) if r <= max(ho, 1) and smem_bytes(r, stride, w, cw) <= smem_max]
    if not fits:
        raise ValueError(f"K13: one output row of a {h}x{w} map with {cw} channels needs "
                         f"{smem_bytes(1, stride, w, cw)} bytes of shared memory (> {smem_max})")
    for r in fits:
        if smem_bytes(r, stride, w, cw) <= smem_max // 2 and batch * -(-ho // r) >= 2 * sm_count:
            return r
    return fits[-1]


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


def _operands(blk: Dict, device: torch.device):
    """(epilogue vectors by kernel C's names, wd or None, short_mul or None)."""
    vecs = {k.lower(): blk[k] for k in ("A1", "B1", "A2", "B2", "A3", "B3")}
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


def qchain(x: torch.Tensor, blocks: Chain, *, plain: bool = False) -> torch.Tensor:
    """int8 NHWC ``x [B, H, W, C]`` through the chain's bottlenecks -> the last
    block's int8 output.

    On a CPU tensor this is :func:`qchain_plain`; on a CUDA tensor it
    launches K13 once or raises.  ``plain=True`` runs the plain version on
    any device, for the comparison only.  ``qchain.launches`` counts kernel
    launches.
    """
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"x must be int8 [B, H, W, C] (NHWC); got {x.dtype} {tuple(x.shape)}")
    if not 1 <= len(blocks) <= MAX_CHAIN:
        raise ValueError(f"a chain has 1 to {MAX_CHAIN} bottlenecks; got {len(blocks)}")
    shapes = chain_shapes(x.shape[1:], blocks)
    args = []
    for (blk, stride), ((h, w, cin), _) in zip(blocks, shapes):
        vecs, wd, short_mul = _operands(blk, x.device)
        _check(x.new_empty((0, h, w, cin)), blk["w1"], blk["w2"], blk["w3"], vecs, stride, wd, short_mul)
        args.append((blk, stride, vecs, wd, short_mul))
    if plain or x.device.type == "cpu":
        return qchain_plain(x, blocks)
    if x.device.type != "cuda":
        raise ValueError(f"K13 runs on CUDA tensors; got {x.device}")
    tensors = [x] + [t for blk, _, vecs, wd, sm in args
                     for t in (blk["w1"], blk["w2"], blk["w3"], *vecs.values(), wd if wd is not None else sm)]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"K13: every operand must be on {x.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K13 takes contiguous operands (x NHWC-contiguous)")
    if any(t.data_ptr() % 16 for blk, _, _, wd, _ in args for t in (blk["w1"], blk["w2"], blk["w3"], wd)
           if t is not None) or x.data_ptr() % 16:
        raise ValueError("K13 reads x and the weights in 16-byte words: they must start 16-byte aligned")
    if any(c % 16 for (_, _, cin), (_, _, cout) in shapes for c in (cin, cout)) or \
            any(blk["w1"].shape[0] % 16 for blk, _ in blocks):
        raise ValueError("K13 needs channel counts divisible by 16")

    b = x.shape[0]
    sm_count, smem_max = card_limits(x.device)
    # block i writes scratch[i % 2] (the last block: out); block i + 1 reads it
    inter = [b * ho * wo * c for _, (ho, wo, c) in shapes[:-1]]
    scratch = [torch.empty(max(inter[i::2], default=0), dtype=torch.int8, device=x.device) for i in range(2)]
    out = torch.empty((b, *shapes[-1][1]), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    ptrs, dims = [], []
    src = x
    for i, ((blk, stride, vecs, wd, short_mul), ((h, w, cin), _)) in enumerate(zip(args, shapes)):
        dst = out if i == len(args) - 1 else scratch[i % 2]
        cw, cout = blk["w1"].shape[0], blk["w3"].shape[0]
        rows = pick_rows(b, h, w, cw, stride, sm_count, smem_max)
        ptr = lambda t: 0 if t is None else t.data_ptr()
        ptrs += [src.data_ptr(), ptr(blk["w1"]), ptr(blk["w2"]), ptr(blk["w3"]), ptr(wd), ptr(vecs["a1"]),
                 ptr(vecs["b1"]), ptr(vecs["a2"]), ptr(vecs["b2"]), ptr(vecs["a3"]), ptr(vecs["b3"]),
                 ptr(vecs.get("ad", short_mul)), ptr(vecs.get("bd")), dst.data_ptr()]
        dims += [h, w, cin, cw, cout, stride, rows]
        src = dst
    ptr_table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    dim_table = (ctypes.c_int * len(dims))(*dims)
    grid = ctypes.c_int(0)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = _lib().qchain_launch(ptr_table, dim_table, len(args), b, ctypes.byref(grid),
                                   torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K13 launch failed: cudaError {err}")
    qchain.launches += 1
    qchain.grid = grid.value
    return out


qchain.launches = 0
qchain.grid = 0
