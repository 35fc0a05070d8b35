"""K5: one whole int8 HisBlock with its level glue in CUDA (``csrc/qhis.cu``), and its plain version.

Replaces ``pytorch_object_detection_tpu/ops/pallas_qhis.py:qhisblock``.
The block input is ``x_q`` (``combine=None``), ``clip8(x_q * ca + xb_q *
cb)`` (``"add"``, two maps of one size), the same with ``x_q`` the coarser
level, 2x nearest-upsampled (``"up_add"``), or with ``x_q`` the finer level,
2x2 VALID max-pooled (``"pool_add"``: ``x_q [B, H', W', C]`` with ``H' // 2
== H``, ``W' // 2 == W``; the pool runs on the producer's loads, exact):
the HisFPN's pool-add and upsample-add, each rescaling two int8 maps to the
block's input scale.

Layouts: int8 NHWC maps, contiguous; one block's parameters as
``nn/fpn_int8.quantize_hisfpn`` makes them (``cin = 2 * half``, ``r`` the SE
width): ``w1``, ``w2 [half, cin]``, ``wdw [3, 3, half]``, ``w3 [half, 3, 3,
cin]``, ``w4 [cin, 3, 3, cin]`` int8; ``A*``, ``B*`` f32 per channel;
``se_w1 [half, r]``, ``se_b1 [r]``, ``se_w2 [r, half]``, ``se_b2 [half]``
f32; ``inv_x1``, ``inv_out``, ``se_premul`` 0-d f32.  On the card ``half``
must be a multiple of 16 and ``r`` at most ``half``.

The plain version is the JAX oracle ``nn/fpn_int8._hisblock_i8_xla``
(``:303-328``) after the glue of ``:64-67``, operation for operation: exact
int32 convolutions, the f32 epilogues in the oracle's order, the SE mean as
``float(sum) / (H * W) * se_premul``.  The kernel agrees with it within one
int8 step on a few elements: SiLU and sigmoid go through the card's
``expf`` and the SE dots sum in another order.

On the card the three kernels' convolutions run on the int8 tensor cores
(``csrc/qhis.cu``); :func:`pick_his_tile` chooses each kernel's rows or
images a block and its channel slices from the card's SM count and shared
memory.  The int32 sums are exact in any order, so the outputs do not
depend on the choice.

While a tracer runs (``utils/export.py``) the wrappers call their ops,
``podt::qhisblock`` (``ops/library.py``): the same launch on CUDA, the plain
version on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from pytorch_object_detection_tpu_torch.ops import library
from pytorch_object_detection_tpu_torch.ops.qblock import card_limits
from pytorch_object_detection_tpu_torch.ops.qpool import qmaxpool2x2_plain
from pytorch_object_detection_tpu_torch.ops.quant import clip8, conv_i8, requantize

SOURCE = "qhis.cu"
# no FMA contraction: a fused multiply-add moves values across a requant boundary
NVCC_FLAGS = ("-fmad=false",)
COMBINES = (None, "add", "up_add", "pool_add")
# the pointer table of qhis_launch, in csrc/qhis.cu's order
_PARAMS = ("w1", "w2", "A1", "B1", "A2", "B2", "wdw", "Adw", "Bdw", "se_w1", "se_b1", "se_w2", "se_b2",
           "w3", "A3", "B3", "w4", "A4", "B4")

# the kernels of csrc/qhis.cu that take a tile choice, in qhis_launch's order
HIS_KERNELS = ("produce", "mid", "out")
HIS_TILE = 8  # kT: consumer tiles of at most 8x8 positions
HIS_ROWS = 64  # kMC: a consumer block's M rows at most
HIS_PRODUCE_ROWS = (128, 64)  # the producer's M rows a block
HIS_STAGES = 4  # kStages: the weights' cp.async ring
HIS_STEP = 64  # kStepBytes: K bytes per ring stage
HIS_SPLITS = (1, 2, 4, 8)


def his_width(kernel: str, cin: int) -> int:
    """Output channels a kernel splits across blocks: conv1|conv2, conv3, conv4."""
    return cin // 2 if kernel == "mid" else cin


def his_slices(kernel: str, cin: int) -> Tuple[int, ...]:
    """The channel-slice counts a kernel may take: whole 16-channel groups,
    at least 32 channels a slice where split."""
    n = his_width(kernel, cin)
    return tuple(s for s in HIS_SPLITS if n % (16 * s) == 0 and (s == 1 or n // s >= 32))


def his_chunk(kernel: str, slice_: int) -> int:
    """Output channels of one GEMM chunk (``chunk_of``): 256 (out), 128, 64 or 32."""
    if kernel == "out" and slice_ % 256 == 0:
        return 256
    return 128 if slice_ % 128 == 0 else 64 if slice_ % 64 == 0 else 32


def _align(n: int) -> int:
    return -(-n // 128) * 128


def his_smem_bytes(kernel: str, ipb: int, h: int, w: int, cin: int, split: int) -> int:
    """Dynamic shared memory of one block (``smem_of`` in csrc/qhis.cu):
    ``ipb`` the producer's rows a block, else images a block.  The
    producer's x rows; mid's SE vectors, x1q on the 2-halo and [aq, bq] on
    the 1-halo; out's [mq, x2q] on the 2-halo; the consumers' rows' halo
    positions; and the weights' ring, reused for the int32 sums (rows of
    NC + 8 words)."""
    th, tw, half = min(HIS_TILE, h), min(HIS_TILE, w), cin // 2
    nc = his_chunk(kernel, his_width(kernel, cin) // split)
    mc = ipb if kernel == "produce" else HIS_ROWS
    ring_or_sums = max(HIS_STAGES * nc * HIS_STEP, mc * (nc + 8) * 4)
    if kernel == "produce":
        return _align(ipb * cin + 64) + ring_or_sums
    if kernel == "mid":
        return (_align(ipb * 3 * half * 4) + _align(ipb * (th + 4) * (tw + 4) * half)
                + _align(ipb * (th + 2) * (tw + 2) * cin + 64) + _align(HIS_ROWS * 4) + ring_or_sums)
    return _align(ipb * (th + 4) * (tw + 4) * cin + 64) + _align(HIS_ROWS * 4) + ring_or_sums


def his_blocks(kernel: str, batch: int, h: int, w: int, ipb: int, split: int) -> int:
    """Thread blocks of one kernel: the producer's row blocks x slices, a
    consumer's tiles x image groups x slices."""
    if kernel == "produce":
        return -(-batch * h * w // ipb) * split
    return -(-h // HIS_TILE) * -(-w // HIS_TILE) * -(-batch // ipb) * split


def his_ipbs(kernel: str, batch: int, h: int, w: int) -> Tuple[int, ...]:
    """The producer's rows a block, or the images a consumer block may
    take, largest first (a consumer's M rows, ipb x a full tile's
    positions, at most 64)."""
    if kernel == "produce":
        return HIS_PRODUCE_ROWS
    top = max(1, min(batch, HIS_ROWS // (min(HIS_TILE, h) * min(HIS_TILE, w))))
    out = []
    while top >= 1:
        out.append(top)
        top //= 2
    return tuple(out)


def pick_his_tile(batch: int, h: int, w: int, cin: int, sm_count: int, smem_max: int) -> Dict[str, Tuple[int, int]]:
    """``{kernel: (ipb, split)}`` for one HisBlock call at the output size
    ``h`` x ``w``: per kernel the most rows (produce) or images a block,
    then the fewest channel slices, whose blocks reach one per SM and fit
    the shared memory; where none reaches, the most blocks."""
    return dict(_pick_his_tile(batch, h, w, cin, sm_count, smem_max))


@functools.lru_cache(maxsize=None)
def _pick_his_tile(batch, h, w, cin, sm_count, smem_max):
    out = {}
    for kernel in HIS_KERNELS:
        best = None
        for ipb in his_ipbs(kernel, batch, h, w):
            for split in his_slices(kernel, cin):
                if his_smem_bytes(kernel, ipb, h, w, cin, split) > smem_max:
                    continue
                blocks = his_blocks(kernel, batch, h, w, ipb, split)
                if blocks >= sm_count:
                    best = (ipb, split)
                    break
                if best is None or blocks > his_blocks(kernel, batch, h, w, *best):
                    best = (ipb, split)
            else:
                continue
            break
        if best is None:
            raise ValueError(f"K5: no {kernel} tile fits {smem_max} bytes of shared memory at {h}x{w}, cin={cin}")
        out[kernel] = best
    return tuple(out.items())


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load K5; its C signature is declared here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE, NVCC_FLAGS)
    lib.qhis_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2
    lib.qhis_launch.restype = ctypes.c_int
    lib.qhis_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.qhis_smem_bytes.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _check_smem(h: int, w: int, cin: int, cfg: Tuple[int, ...]) -> None:
    """The chooser's shared-memory arithmetic is the kernel's (once per level shape and choice)."""
    for i, k in enumerate(HIS_KERNELS):
        got = _lib().qhis_smem_bytes(i, cfg[2 * i], h, w, cin, cfg[2 * i + 1])
        if got != his_smem_bytes(k, cfg[2 * i], h, w, cin, cfg[2 * i + 1]):
            raise RuntimeError(f"K5 {k}: the kernel takes {got} bytes of shared memory, the chooser "
                               f"{his_smem_bytes(k, cfg[2 * i], h, w, cin, cfg[2 * i + 1])}")


def _silu(z: torch.Tensor) -> torch.Tensor:
    return z * torch.sigmoid(z)  # the oracle's form, not F.silu's


def upsample2x_i8(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample of NHWC ``[B, H, W, C]``."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def combine_plain(x_q, xb_q, combine, ca, cb) -> torch.Tensor:
    """The block's int8 input: ``x_q``, or ``clip8(xa * ca + xb * cb)`` with
    ``xa`` 2x-upsampled for ``"up_add"``, 2x2-max-pooled for ``"pool_add"``
    (the JAX ``_upsample2x_i8`` / ``_maxpool2x2_i8``, then ``_add_requant``)."""
    if combine is None:
        return x_q
    xa = upsample2x_i8(x_q) if combine == "up_add" else qmaxpool2x2_plain(x_q) if combine == "pool_add" else x_q
    return clip8(xa.float() * ca + xb_q.float() * cb)


def depthwise_i8(x: torch.Tensor, w: torch.Tensor, dilation: int = 1, stride: int = 1) -> torch.Tensor:
    """Per-channel k x k int8 conv (k odd), dilation ``dilation``, stride
    ``stride``, symmetric zero padding ``dilation * (k - 1) // 2``, exact
    int32 sum as f32 (exact: at k = 7 the largest sum is 127 * 127 * 49 <
    2**24): x ``[B, H, W, C]``, w ``[k, k, C]``.  Each tap reads a strided
    slice of the padded map, so only the strided outputs are computed."""
    k, d, s = w.shape[0], dilation, stride
    pad = d * (k - 1) // 2
    _, h, wd, _ = x.shape
    ho, wo = (h + 2 * pad - d * (k - 1) - 1) // s + 1, (wd + 2 * pad - d * (k - 1) - 1) // s + 1
    xp = F.pad(x, (0, 0, pad, pad, pad, pad)).int()
    acc = sum(xp[:, ky * d:ky * d + s * (ho - 1) + 1:s, kx * d:kx * d + s * (wo - 1) + 1:s] * w[ky, kx].int()
              for ky in range(k) for kx in range(k))
    return acc.float()


def depthwise3x3_i8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`depthwise_i8` at 3x3, dilation 1: w ``[3, 3, C]``."""
    return depthwise_i8(x, w)


def qhisblock_plain(blk: Dict, x_q: torch.Tensor) -> torch.Tensor:
    """The HisBlock on its int8 input in plain PyTorch ops (the reference for K5)."""
    h, w = x_q.shape[1:3]
    x1q = clip8(_silu(conv_i8(x_q, blk["w1"]) * blk["A1"] + blk["B1"]) * blk["inv_x1"])
    x2q = requantize(conv_i8(x_q, blk["w2"]), blk["A2"], blk["B2"], relu=False)
    aq = requantize(depthwise3x3_i8(x1q, blk["wdw"]), blk["Adw"], blk["Bdw"])
    mean = x1q.float().sum(dim=(1, 2)) / float(h * w) * blk["se_premul"]  # [B, half]
    g = _silu(mean @ blk["se_w1"] + blk["se_b1"])
    g = torch.sigmoid(g @ blk["se_w2"] + blk["se_b2"])
    bq = clip8(x1q.float() * g[:, None, None, :])
    mq = requantize(conv_i8(torch.cat([aq, bq], dim=-1), blk["w3"]), blk["A3"], blk["B3"])
    acc4 = conv_i8(torch.cat([mq, x2q], dim=-1), blk["w4"], dilation=2)
    return clip8(_silu(acc4 * blk["A4"] + blk["B4"]) * blk["inv_out"])


def _check(blk, x_q, xb_q, combine) -> None:
    if combine not in COMBINES:
        raise ValueError(f"combine must be one of {COMBINES}; got {combine!r}")
    for name, t in (("x_q", x_q), ("xb_q", xb_q)):
        if t is not None and (t.dtype != torch.int8 or t.dim() != 4):
            raise ValueError(f"{name} must be int8 [B, H, W, C] (NHWC); got {t.dtype} {tuple(t.shape)}")
    if (xb_q is None) != (combine is None):
        raise ValueError(f"combine={combine!r} {'takes no' if combine is None else 'needs an'} xb_q")
    half, cin = blk["w1"].shape
    if cin != 2 * half or x_q.shape[-1] != cin:
        raise ValueError(f"the block takes {cin} = 2 * {half} channels; got x_q {tuple(x_q.shape)}")
    if combine == "add" and xb_q.shape != x_q.shape:
        raise ValueError(f"combine='add' takes two maps of one shape; got {tuple(x_q.shape)}, {tuple(xb_q.shape)}")
    if combine == "up_add":
        b, h, w, c = xb_q.shape
        if h % 2 or w % 2 or tuple(x_q.shape) != (b, h // 2, w // 2, c):
            raise ValueError(f"combine='up_add' takes x_q at half the size of xb_q (even); "
                             f"got {tuple(x_q.shape)}, {tuple(xb_q.shape)}")
    if combine == "pool_add":
        b, h, w, c = xb_q.shape
        if x_q.shape[0] != b or x_q.shape[1] // 2 != h or x_q.shape[2] // 2 != w or x_q.shape[3] != c:
            raise ValueError(f"combine='pool_add' takes x_q whose 2x2 VALID pool has the size of xb_q; "
                             f"got {tuple(x_q.shape)}, {tuple(xb_q.shape)}")


def _scalar(v, device) -> torch.Tensor:
    return v.to(device, torch.float32).reshape(()) if isinstance(v, torch.Tensor) else \
        torch.tensor(float(v), dtype=torch.float32, device=device)


def _launch(blk, x_q, xb_q, combine, ca, cb, tile) -> torch.Tensor:
    """K5 on CUDA tensors (checked by ``_check`` first)."""
    dev = x_q.device
    params = [blk[k] for k in _PARAMS]
    maps = [x_q] + ([xb_q] if xb_q is not None else [])
    if any(t.device != dev for t in params + maps):
        raise ValueError(f"K5: every operand must be on {dev}")
    if not all(t.is_contiguous() for t in params + maps):
        raise ValueError("K5 takes contiguous operands (maps NHWC-contiguous)")
    if any(t.data_ptr() % 16 for t in maps):
        raise ValueError("K5 reads the maps in 16-byte words: they must start 16-byte aligned")
    half, cin = blk["w1"].shape
    r = blk["se_w1"].shape[1]
    if half % 16 or r > half:
        raise ValueError(f"K5 needs a half width divisible by 16 and an SE width at most half; got {half}, {r}")
    b, h, w, _ = (xb_q if combine is not None else x_q).shape
    out = torch.empty((b, h, w, cin), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    if tile is None:
        tile = pick_his_tile(b, h, w, cin, *card_limits(dev))
    cfg = tuple(int(v) for k in HIS_KERNELS for v in tile[k])
    if any(-(-b // tile[k][0]) > 65535 for k in HIS_KERNELS[1:]):
        raise ValueError(f"K5 takes at most 65535 image groups; got {tuple(out.shape)} and {tile}")
    _check_smem(h, w, cin, cfg)
    scratch = torch.empty((3, b, h, w, half), dtype=torch.int8, device=dev)  # x1q, x2q, mq
    se_sum = torch.empty((b, half), dtype=torch.int32, device=dev)
    if combine is None:  # the kernel reads no rescale: fill its slots from the device, with no host copy
        ca = cb = blk["inv_x1"]
    sc = torch.stack([_scalar(blk["inv_x1"], dev), _scalar(blk["inv_out"], dev), _scalar(blk["se_premul"], dev),
                      _scalar(ca, dev), _scalar(cb, dev)])
    ptrs = [x_q, xb_q, *params, sc, scratch[0], scratch[1], scratch[2], se_sum, out]
    table = (ctypes.c_void_p * len(ptrs))(*[None if t is None else t.data_ptr() for t in ptrs])
    with torch.cuda.device(dev):  # the launches go to the current device
        err = _lib().qhis_launch(table, b, h, w, cin, half, r, COMBINES.index(combine), *x_q.shape[1:3],
                                 (ctypes.c_int * 6)(*cfg), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K5 launch failed: cudaError {err}")
    return out


def qhisblock(blk: Dict, x_q: torch.Tensor, *, xb_q: Optional[torch.Tensor] = None, combine: Optional[str] = None,
              ca=1.0, cb=0.0, plain: bool = False, tile: Optional[Dict[str, Tuple[int, int]]] = None) -> torch.Tensor:
    """Fused HisBlock (the JAX signature): int8 NHWC in, ``[B, H, W, cin]``
    int8 out, at the size of ``xb_q`` where there is one.  ``ca``, ``cb``:
    the glue's f32 rescales (floats or 0-d tensors).  ``tile`` forces
    :func:`pick_his_tile`'s choice (the outputs do not depend on it).

    On a CPU tensor this is :func:`qhisblock_plain` after
    :func:`combine_plain`; on a CUDA tensor it launches K5 (three CUDA
    kernels, counted as one launch) or raises.  ``plain=True`` runs the
    plain version on any device, for the comparison only.
    ``qhisblock.launches`` counts kernel launches, ``pool_add_launches``
    those with ``combine="pool_add"`` among them.
    """
    _check(blk, x_q, xb_q, combine)
    if plain:
        return qhisblock_plain(blk, combine_plain(x_q, xb_q, combine, ca, cb))
    if library.route(x_q):
        if tile is None and x_q.is_cuda:
            b, h, w, cin = (xb_q if combine is not None else x_q).shape
            tile = pick_his_tile(b, h, w, cin, *card_limits(x_q.device))
        dev = x_q.device
        return qhisblock_op(x_q, [_scalar(blk[k], dev) if k in _SCALARS else blk[k] for k in _OP_KEYS], xb_q,
                            combine, _scalar(ca, dev), _scalar(cb, dev),
                            library.tile_ints(None if tile is None else [tile[k] for k in HIS_KERNELS]))
    if x_q.device.type == "cpu":
        return qhisblock_plain(blk, combine_plain(x_q, xb_q, combine, ca, cb))
    return _cuda(blk, x_q, xb_q, combine, ca, cb, tile)


def _cuda(blk, x_q, xb_q, combine, ca, cb, tile) -> torch.Tensor:
    """K5 on CUDA tensors, counted in ``qhisblock.launches``."""
    if x_q.device.type != "cuda":
        raise ValueError(f"K5 runs on CUDA tensors; got {x_q.device}")
    out = _launch(blk, x_q, xb_q, combine, ca, cb, tile)
    if out.numel():
        qhisblock.launches += 1
        qhisblock.pool_add_launches += combine == "pool_add"
    return out


qhisblock.launches = 0
qhisblock.pool_add_launches = 0

# a block's tensors as the op takes them: the kernel's, then its three scalars (0-d f32)
_SCALARS = ("inv_x1", "inv_out", "se_premul")
_OP_KEYS = _PARAMS + _SCALARS


def _op_cpu(x_q, blk, xb_q, combine, ca, cb, tile):
    return qhisblock_plain(dict(zip(_OP_KEYS, blk)), combine_plain(x_q, xb_q, combine, ca, cb))


def _op_cuda(x_q, blk, xb_q, combine, ca, cb, tile):
    return _cuda(dict(zip(_OP_KEYS, blk)), x_q, xb_q, combine, ca, cb, library.pairs(tile, HIS_KERNELS))


def _op_fake(x_q, blk, xb_q, combine, ca, cb, tile):
    b, h, w, _ = (xb_q if combine is not None else x_q).shape
    return library.empty_like_shape(x_q, (b, h, w, x_q.shape[-1]))


qhisblock_op = library.define(
    "qhisblock", "(Tensor x_q, Tensor[] blk, Tensor? xb_q, str? combine, Tensor ca, Tensor cb, int[]? tile) -> Tensor",
    cpu=_op_cpu, cuda=_op_cuda, fake=_op_fake)
