"""Kernel C: a whole int8 ResNet bottleneck in CUDA (``csrc/qblock.cu``), and its plain version.

Replaces ``pytorch_object_detection_tpu/ops/pallas_qblock.py``:
``qbottleneck`` (K2, the stride-1 blocks) and ``qbottleneck_s2`` (K3, the
three stride-2 blocks).  One kernel serves both, with the stride as an
argument.  The source note in ``csrc/qblock.cu`` says what bounds it on the
card and how the design answers: clusters of thread blocks, each cluster
one spatial tile of 8 x tw output positions, every conv on the int8 tensor
cores.  :func:`pick_tile` chooses the tile width and the cluster size.

Layouts: activations int8 NHWC ``[B, H, W, C]``, contiguous.  Weights int8
with each output channel's K-vector contiguous (the JAX HWIO kernels
transposed): ``w1 [Cw, Cin]``, ``w2 [Cw, 3, 3, Cw]``, ``w3 [Cout, Cw]``,
``wd [Cout, Cin]``.  Epilogue vectors f32 per channel; ``short_mul`` a 0-d
f32 tensor.  Channel counts must be multiples of 16 (the kernel reads
16-byte words).

The plain version is the XLA oracle of ``nn/resnet_int8.py:546-555``,
operation for operation: exact int32 accumulation (``ops/quant.conv_i8``,
``torch._int_mm`` over an im2col of the int8 input), then the f32
epilogues in the oracle's order.  On a CPU tensor the wrappers run it; on a CUDA tensor they launch
kernel C or raise.

While a tracer runs (``utils/export.py``) the wrappers call their ops,
``podt::qbottleneck`` and ``podt::qbottleneck_s2`` (``ops/library.py``): the
same launch on CUDA, the plain version on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from pytorch_object_detection_tpu_torch.ops import library
from pytorch_object_detection_tpu_torch.ops.quant import clip8, conv_i8, requantize

SOURCE = "qblock.cu"
# no FMA contraction anywhere in the kernel (its epilogues also spell out
# __fmul_rn/__fadd_rn): a fused multiply-add moves values across a requant
# boundary
NVCC_FLAGS = ("-fmad=false",)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load kernel C; the C function's signature is
    declared once here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE, NVCC_FLAGS)
    fn = lib.qblock_launch
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def out_hw(h: int, w: int, stride: int):
    """Output size of the block: 3x3 pad 1 (and 1x1 pad 0) at ``stride``."""
    return (h - 1) // stride + 1, (w - 1) // stride + 1


TILE_ROWS = 8  # kTH in csrc/qblock.cu
TILE_WIDTHS = (16, 8)
SPLITS = (1, 2, 4, 8)  # blocks per tile: a thread block cluster, at most the portable 8
RING_BYTES = 48 * 1024  # kRingBytes in csrc/qblock.cu: the cp.async ring


def smem_bytes(stride: int, tw: int, cw: int) -> int:
    """Kernel C's shared memory per block for tiles of 8 x ``tw`` output
    positions (``smem_bytes`` in ``csrc/qblock.cu``): a1 on the tile
    and its 3x3 halo, a2 on the tile, and the cp.async ring."""
    halo = ((TILE_ROWS - 1) * stride + 3) * ((tw - 1) * stride + 3)
    return halo * cw + TILE_ROWS * tw * cw + RING_BYTES


def tile_grid(ho: int, wo: int, tw: int):
    """(tile rows, tile columns) of one image's ``ho x wo`` output map."""
    return -(-ho // TILE_ROWS), -(-wo // tw)


def recompute_factor(h: int, w: int, stride: int, tw: int) -> float:
    """conv1's positions computed by kernel C on an ``h x w`` map (each
    tile's halo, whole) over the ``h * w`` that the block's conv1 has."""
    ty, tx = tile_grid(*out_hw(h, w, stride), tw)
    halo = ((TILE_ROWS - 1) * stride + 3) * ((tw - 1) * stride + 3)
    return ty * tx * halo / (h * w)


@functools.lru_cache(maxsize=256)
def pick_tile(batch: int, h: int, w: int, cw: int, cout: int, stride: int, sm_count: int, smem_max: int):
    """``(tw, split)`` for kernel C: tiles of 8 x ``tw`` output positions,
    ``split`` blocks (a cluster) per tile, each taking 1/split of every
    conv's output channels.  Of (16, 1), (8, 1), (8, 2), (8, 4), (8, 8), the
    ones that fit in shared memory: the first that gives at least one block
    per SM with two blocks' shared memory on an SM (an SM holds ``smem_max``
    + 1 KB, each block 1 KB more than it asks for: 228 KB and 227 KB on an
    H100); else the first that gives one block per SM; else the one with
    the most blocks."""
    ho, wo = out_hw(h, w, stride)
    options = [(tw, sp) for tw in TILE_WIDTHS for sp in SPLITS
               if (tw == 8 or sp == 1) and cw % (16 * sp) == 0 and cout % (16 * sp) == 0
               and smem_bytes(stride, tw, cw) <= smem_max]
    if not options:
        raise ValueError(f"kernel C: a tile of a block with {cw} channels at stride {stride} needs "
                         f"{smem_bytes(stride, 8, cw)} bytes of shared memory (> {smem_max})")

    def ctas(opt):
        ty, tx = tile_grid(ho, wo, opt[0])
        return batch * ty * tx * opt[1]

    def two_per_sm(opt):
        return 2 * (smem_bytes(stride, opt[0], cw) + 1024) <= smem_max + 1024

    for ok in (lambda o: ctas(o) >= sm_count and two_per_sm(o), lambda o: ctas(o) >= sm_count):
        for opt in options:
            if ok(opt):
                return opt
    return max(options, key=ctas)


def card_limits(device: torch.device):
    """(SM count, bytes of shared memory one block may opt in to) of a CUDA device."""
    return _card_limits(device.index if device.index is not None else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _card_limits(index: int):
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def qbottleneck_plain(x, w1, w2, w3, a1, b1, a2, b2, a3, b3, *, stride: int = 1, short_mul=None,
                      wd=None, ad=None, bd=None) -> torch.Tensor:
    """The bottleneck in plain PyTorch ops (the reference for kernel C)."""
    y1 = requantize(conv_i8(x, w1), a1, b1)
    y2 = requantize(conv_i8(y1, w2, stride), a2, b2)
    pre = conv_i8(y2, w3) * a3 + b3
    if wd is not None:
        short = conv_i8(x, wd, stride) * ad + bd
    else:
        short = x.float() * short_mul
    return clip8(torch.clamp(pre + short, min=0.0))


def _check(x, w1, w2, w3, vecs, stride, wd, short_mul) -> None:
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"x must be int8 [B, H, W, C] (NHWC); got {x.dtype} {tuple(x.shape)}")
    cin, cw, cout = x.shape[-1], w1.shape[0], w3.shape[0]
    want = {"w1": (cw, cin), "w2": (cw, 3, 3, cw), "w3": (cout, cw)}
    if wd is not None:
        want["wd"] = (cout, cin)
    elif cin != cout:
        raise ValueError(f"an identity shortcut needs Cin == Cout; got {cin} and {cout} (NCHW input?)")
    for name, t in (("w1", w1), ("w2", w2), ("w3", w3), ("wd", wd)):
        if name in want and (t.dtype != torch.int8 or tuple(t.shape) != want[name]):
            raise ValueError(f"{name} must be int8 {want[name]} for x {tuple(x.shape)}; "
                             f"got {t.dtype} {tuple(t.shape)}")
    for name, v in vecs.items():
        n = cw if name[-1] in "12" else cout
        if v.dtype != torch.float32 or tuple(v.shape) != (n,):
            raise ValueError(f"{name} must be float32 [{n}]; got {v.dtype} {tuple(v.shape)}")
    if wd is None and (short_mul is None or short_mul.numel() != 1):
        raise ValueError("an identity shortcut needs short_mul (one f32 value)")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2; got {stride}")


def _launch(x, w1, w2, w3, vecs, stride, wd, short_mul, tile: Optional[Tuple[int, int]]) -> torch.Tensor:
    """Kernel C on CUDA tensors (checked by ``_check`` first)."""
    tensors = [x, w1, w2, w3, *vecs.values()] + ([wd] if wd is not None else [short_mul])
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"kernel C: every operand must be on {x.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel C takes contiguous operands (x NHWC-contiguous)")
    if any(t.data_ptr() % 16 for t in (x, w1, w2, w3, wd) if t is not None):
        raise ValueError("kernel C reads x and the weights in 16-byte words: they must start 16-byte aligned")
    b, h, w, cin = x.shape
    cw, cout = w1.shape[0], w3.shape[0]
    if cin % 16 or cw % 16 or cout % 16:
        raise ValueError(f"kernel C needs channel counts divisible by 16; got {cin}, {cw}, {cout}")
    ho, wo = out_hw(h, w, stride)
    sm_count, smem_max = card_limits(x.device)
    tw, split = pick_tile(b, h, w, cw, cout, stride, sm_count, smem_max) if tile is None else tile
    if tw not in TILE_WIDTHS or split not in SPLITS or cw % (16 * split) or cout % (16 * split):
        raise ValueError(f"tile={tile}: kernel C takes tiles of width 8 or 16 and 1, 2, 4 or 8 blocks per tile "
                         f"that divide Cw={cw} and Cout={cout} into multiples of 16")
    if smem_bytes(stride, tw, cw) > smem_max:
        raise ValueError(f"tile={tile}: kernel C's tile does not fit in shared memory")
    out = torch.empty((b, ho, wo, cout), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    ty, tx = tile_grid(ho, wo, tw)
    if b * ty * tx * split > 2**31 - 1:
        raise ValueError(f"kernel C: {b * ty * tx * split} blocks exceed one launch")
    ptr = lambda t: None if t is None else t.data_ptr()
    ad = vecs.get("ad", short_mul)
    lib = _lib()
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = lib.qblock_launch(
            ptr(x), ptr(w1), ptr(w2), ptr(w3), ptr(wd), ptr(vecs["a1"]), ptr(vecs["b1"]), ptr(vecs["a2"]),
            ptr(vecs["b2"]), ptr(vecs["a3"]), ptr(vecs["b3"]), ptr(ad), ptr(vecs.get("bd")), ptr(out),
            b, h, w, cin, cw, cout, stride, tw, split, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"kernel C launch failed: cudaError {err}")
    return out


def _run(x, w1, w2, w3, vecs, stride, wd, short_mul, tile, plain, counter) -> torch.Tensor:
    """The plain version on a CPU tensor (or with ``plain=True``), else kernel
    C; ``counter`` is the wrapper whose ``launches`` a launch adds one to."""
    if short_mul is not None and not isinstance(short_mul, torch.Tensor):
        short_mul = torch.tensor(float(short_mul), dtype=torch.float32, device=x.device)
    _check(x, w1, w2, w3, vecs, stride, wd, short_mul)
    if plain:
        return qbottleneck_plain(x, w1, w2, w3, **vecs, stride=stride, short_mul=short_mul, wd=wd)
    if library.route(x):
        if tile is None and x.is_cuda:
            tile = pick_tile(*x.shape[:3], w1.shape[0], w3.shape[0], stride, *card_limits(x.device))
        op = qbottleneck_op if stride == 1 else qbottleneck_s2_op
        return op(x, w1, w2, w3, list(vecs.values()), wd, short_mul, library.tile_ints(tile))
    if x.device.type == "cpu":
        return qbottleneck_plain(x, w1, w2, w3, **vecs, stride=stride, short_mul=short_mul, wd=wd)
    return _cuda(x, w1, w2, w3, vecs, stride, wd, short_mul, tile, counter)


def _cuda(x, w1, w2, w3, vecs, stride, wd, short_mul, tile, counter) -> torch.Tensor:
    """Kernel C on CUDA tensors, counted in ``counter.launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel C runs on CUDA tensors; got {x.device}")
    out = _launch(x, w1, w2, w3, vecs, stride, wd, short_mul, tile)
    if out.numel():
        counter.launches += 1
    return out


def qbottleneck(x, w1, w2, w3, a1, b1, a2, b2, a3, b3, *, short_mul=None, wd=None, ad=None, bd=None,
                tile: Optional[Tuple[int, int]] = None, plain: bool = False) -> torch.Tensor:
    """Fused stride-1 bottleneck (K2): x ``[B, H, W, Cin]`` int8 ->
    ``[B, H, W, Cout]`` int8.  Identity shortcut: ``short_mul`` (requires
    Cin == Cout); projection: ``wd``, ``ad``, ``bd``.

    On a CPU tensor this is :func:`qbottleneck_plain`; on a CUDA tensor it
    launches kernel C or raises.  ``plain=True`` runs the plain version on
    any device, for the comparison only.  ``tile`` ``(tw, split)`` overrides
    :func:`pick_tile`; the result does not depend on it.
    ``qbottleneck.launches`` counts kernel launches.
    """
    vecs = dict(a1=a1, b1=b1, a2=a2, b2=b2, a3=a3, b3=b3)
    if wd is not None:
        vecs.update(ad=ad, bd=bd)
    return _run(x, w1, w2, w3, vecs, 1, wd, short_mul, tile, plain, qbottleneck)


def qbottleneck_s2(x, w1, w2, w3, wd, a1, b1, a2, b2, a3, b3, ad, bd, *,
                   tile: Optional[Tuple[int, int]] = None, plain: bool = False) -> torch.Tensor:
    """Fused stride-2 bottleneck with its projection shortcut (K3):
    x ``[B, H, W, Cin]`` int8 -> ``[B, (H+1)//2, (W+1)//2, Cout]`` int8.
    Device rules as :func:`qbottleneck`; ``qbottleneck_s2.launches`` counts
    kernel launches."""
    vecs = dict(a1=a1, b1=b1, a2=a2, b2=b2, a3=a3, b3=b3, ad=ad, bd=bd)
    return _run(x, w1, w2, w3, vecs, 2, wd, None, tile, plain, qbottleneck_s2)


qbottleneck.launches = 0
qbottleneck_s2.launches = 0


_VECS = ("a1", "b1", "a2", "b2", "a3", "b3", "ad", "bd")


def _define(name: str, stride: int, counter):
    """The op of one wrapper: ``vecs`` in ``_VECS`` order (``ad``, ``bd`` with a projection)."""
    def vec_dict(vecs):
        return dict(zip(_VECS, vecs))

    def cpu(x, w1, w2, w3, vecs, wd, short_mul, tile):
        return qbottleneck_plain(x, w1, w2, w3, **vec_dict(vecs), stride=stride, short_mul=short_mul, wd=wd)

    def cuda(x, w1, w2, w3, vecs, wd, short_mul, tile):
        return _cuda(x, w1, w2, w3, vec_dict(vecs), stride, wd, short_mul, library.tile_tuple(tile), counter)

    def fake(x, w1, w2, w3, vecs, wd, short_mul, tile):
        return library.empty_like_shape(x, (x.shape[0], *out_hw(*x.shape[1:3], stride), w3.shape[0]))

    return library.define(name, "(Tensor x, Tensor w1, Tensor w2, Tensor w3, Tensor[] vecs, Tensor? wd, "
                                "Tensor? short_mul, int[]? tile) -> Tensor", cpu=cpu, cuda=cuda, fake=fake)


qbottleneck_op = _define("qbottleneck", 1, qbottleneck)
qbottleneck_s2_op = _define("qbottleneck_s2", 2, qbottleneck_s2)
