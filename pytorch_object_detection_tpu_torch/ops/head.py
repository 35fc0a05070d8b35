"""K15: one pyramid level through the whole bf16 HISHead in CUDA, and its plain version.

K15 (``csrc/head.cu``) replaces
``pytorch_object_detection_tpu/ops/pallas_head.py:hishead_level_fused``:
NHWC ``[B, H, W, f]`` in, the packed bf16 ``[B, H, W, nc + 5]`` map out
(cls logits | cnt | raw reg, before ScaleExp), with every intermediate and
the four GroupNorms' statistics inside one call (five CUDA kernels; the
source note in ``csrc/head.cu`` says how).  ``make_eval_forward_int8``
runs it with ``fused_head=True`` behind the float HisFPN.

:func:`hishead_params_pack` packs the weights of the port's ``HISHead``
module once: the JAX packer's operand set (``pallas_head.py:204-240``),
which the plain version reads, and the same weights in the kernel's
``[N, K]`` layouts.  :func:`hishead_level_fused_plain` is the JAX kernel's
function, not the float ``HISHead``'s: it repeats its bf16 steps (module
docstring of ``csrc/head.cu``).

On a CPU tensor :func:`hishead_level_fused` runs the plain version; on a
CUDA tensor it launches the kernel (bf16 NHWC input, f a multiple of 32 up
to 256) or raises.

While a tracer runs (``utils/export.py``) the wrappers call their ops,
``podt::hishead_level_fused`` (``ops/library.py``): the same launch on CUDA,
the plain version on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from pytorch_object_detection_tpu_torch.ops import library
from pytorch_object_detection_tpu_torch.ops.qblock import card_limits

SOURCE = "head.cu"
# no FMA contraction: each bf16 step is an f32 operation rounded once, as in the reference
NVCC_FLAGS = ("-fmad=false",)
GROUPS = 32
EPS = 1e-5
MAX_FEATURES = 256  # a producer folds 2f GroupNorm channels in its shared memory


# the passes of csrc/head.cu, in hishead_launch's order
FHEAD_PASSES = ("pw1", "dw", "pw2", "towers", "pred")
FHEAD_TILE = 8  # kT: tiles of at most 8x8 positions
FHEAD_ROWS = 64  # kMC: GEMM rows a block (images x a tile's positions)
FHEAD_STAGES, FHEAD_STEP = 4, 64  # the weights' cp.async ring: 4 stages of a 64-byte K step, or 3 of two
FHEAD_PRED_NC = 32  # kPredNC: classes per pred block
FHEAD_POS = 8  # kPos: positions a depthwise item walks
FHEAD_SPLITS = (1, 2, 4, 8)


def fhead_tile_dims(h: int, w: int, tw: int = FHEAD_TILE) -> Tuple[int, int]:
    """(positions of a full tile of 8 x ``tw``, halo rows of one image)."""
    th, twc = min(FHEAD_TILE, h), min(tw, w)
    return th * twc, (th + 2) * (twc + 2)


_WIDE = ("pw1", "towers", "pred")  # the passes with a wgmma kernel on 128-row blocks


def fhead_widths(pass_: str, w: int) -> Tuple[int, ...]:
    """Tile widths a pass may take: 8, and 16 for pw1, the towers and pred
    on maps wider than 8 (their wgmma kernels: 128 GEMM rows, each weight
    byte staged serving twice the rows)."""
    return (16, FHEAD_TILE) if pass_ in _WIDE and w > FHEAD_TILE else (FHEAD_TILE,)


def fhead_rows(pass_: str, tw: int) -> int:
    """GEMM rows a block of a pass may hold: 128 for pred, and for pw1 and
    the towers on 8x16 tiles (two warpgroups of wgmma), else 64."""
    return 2 * FHEAD_ROWS if pass_ == "pred" or (pass_ in _WIDE and tw == 16) else FHEAD_ROWS


def fhead_pass_width(pass_: str, f: int, nc: int) -> int:
    """Output channels a pass splits across blocks (pred: its column blocks)."""
    if pass_ == "pred":
        return -(-nc // FHEAD_PRED_NC) + 1
    return f if pass_ == "pw2" else 2 * f


def fhead_slices(pass_: str, f: int, nc: int) -> Tuple[int, ...]:
    """The channel-slice counts a pass may take: whole 16-channel groups, at
    least 64 channels a slice where split; pred's is fixed."""
    n = fhead_pass_width(pass_, f, nc)
    if pass_ == "pred":
        return (n,)
    return tuple(s for s in FHEAD_SPLITS if n % (16 * s) == 0 and (s == 1 or n // s >= 64))


def _align(n: int) -> int:
    return -(-n // 128) * 128


def _fold_bytes(f2: int) -> int:
    """A producer's scratch for its GroupNorm fold: 512 bytes of flags, the
    per-channel sums and the group statistics."""
    return 512 + _align((2 * f2 + 256) * 4)


def fhead_smem_bytes(pass_: str, ipb: int, h: int, w: int, f: int, nc: int, split: int,
                     tw: int = FHEAD_TILE) -> int:
    """Dynamic shared memory of one block of a pass on tiles of 8 x ``tw``
    (``smem_of`` in csrc/head.cu): a GroupNorm table of a normalizing pass,
    the A operand or halo, the rows' halo positions, and the weights' ring,
    reused for the f32 sums (rows of NC + 8 words) and a producer's fold."""
    npos, halo = fhead_tile_dims(h, w, tw)
    mc = FHEAD_ROWS if ipb * npos <= FHEAD_ROWS else 2 * FHEAD_ROWS
    f2 = 2 * f
    slice_ = FHEAD_PRED_NC if pass_ == "pred" else fhead_pass_width(pass_, f, nc) // split
    ncol = 128 if slice_ % 128 == 0 else 64
    # the ring: 4 stages of one 64-byte K step (pw2), or 3 of two (the others)
    ring = (FHEAD_STAGES if pass_ == "pw2" else 3 * 2) * (FHEAD_PRED_NC if pass_ == "pred" else ncol) * FHEAD_STEP
    ring_or_sums = max(ring, mc * (ncol + 8) * 4, _fold_bytes(f2))
    # a wgmma kernel's region (128 rows): its ring 1024-aligned, reused for the sums and the fold
    wg = max(max(3 * 128 * 128, 128 * 136 * 4) + 1024, _fold_bytes(f2))
    if pass_ == "pw1":
        return _align(mc * 2 * f) + (wg if mc > FHEAD_ROWS else ring_or_sums)
    if pass_ == "dw":  # GN1 table [ipb][slice] float2, u on the halo (or the fold), each item's sums
        u = max(_align(ipb * halo * slice_ * 2), _fold_bytes(f2))
        npg = -(-FHEAD_TILE * FHEAD_TILE // FHEAD_POS)
        return _align(ipb * slice_ * 8) + u + 2 * npg * ipb * slice_ * 4
    if pass_ == "pw2":  # GN2 table [ipb][2f], SiLU(GN2(t2)) rows
        return _align(ipb * f2 * 8) + _align(FHEAD_ROWS * 2 * f2) + ring_or_sums
    if pass_ == "towers":
        return _align(ipb * halo * 2 * f) + _align(mc * 4) + (wg if mc > FHEAD_ROWS else ring_or_sums)
    # pred: the tower's GN table, its halo, 128 rows' positions, a ring of 3 stages of 32 rows of 128 bytes
    return (_align(ipb * f * 8) + _align(ipb * halo * 2 * f) + _align(2 * FHEAD_ROWS * 4)
            + 3 * FHEAD_PRED_NC * 128 + 1024)


def fhead_blocks(batch: int, h: int, w: int, ipb: int, split: int, tw: int = FHEAD_TILE) -> int:
    """Thread blocks of one pass: tiles x image groups x slices."""
    return -(-h // FHEAD_TILE) * -(-w // tw) * -(-batch // ipb) * split


def fhead_ipbs(batch: int, h: int, w: int, tw: int = FHEAD_TILE, rows: int = FHEAD_ROWS) -> Tuple[int, ...]:
    """Images a block may take, largest first: ipb x a full tile's positions
    at most ``rows`` (:func:`fhead_rows`)."""
    top = max(1, min(batch, rows // fhead_tile_dims(h, w, tw)[0]))
    out = []
    while top >= 1:
        out.append(top)
        top //= 2
    return tuple(out)


def pick_fhead_tile(batch: int, h: int, w: int, f: int, nc: int, sm_count: int,
                    smem_max: int) -> Dict[str, Tuple[int, int, int]]:
    """``{pass: (ipb, split, tw)}`` for one level: per pass, of the options
    that fit ``smem_max`` bytes of shared memory (the wider tiles first, then
    the largest image groups, then the fewest channel slices), the first
    whose blocks reach one per SM with two blocks' shared memory on an SM (an
    SM holds ``smem_max`` + 1 KB, each block 1 KB more than it asks for);
    else the first that reaches one per SM; else the one with the most
    blocks.  pw1 and the towers, on maps wider than 8, take their wgmma
    kernels' tiles (8 x 16, slices of 128 channels) where there are any:
    the fewest slices whose blocks reach nine tenths of the SMs, else the
    most blocks (the towers' measured faster on half the SMs than the
    mma.sync tiles on all of them).  Raises where no option of a pass
    fits."""
    return dict(_pick_fhead_tile(batch, h, w, f, nc, sm_count, smem_max))


def fhead_options(pass_: str, batch: int, h: int, w: int, f: int, nc: int,
                  smem_max: int) -> Tuple[Tuple[int, int, int], ...]:
    """Every (ipb, split, tw) of a pass that fits ``smem_max`` bytes of shared
    memory, in the chooser's order of preference; blocks of more than 64
    rows (wgmma) take slices of 128 channels."""
    return tuple((ipb, split, tw) for tw in fhead_widths(pass_, w)
                 for ipb in fhead_ipbs(batch, h, w, tw, fhead_rows(pass_, tw))
                 for split in fhead_slices(pass_, f, nc)
                 if fhead_smem_bytes(pass_, ipb, h, w, f, nc, split, tw) <= smem_max
                 and (pass_ == "pred" or ipb * fhead_tile_dims(h, w, tw)[0] <= FHEAD_ROWS
                      or (fhead_pass_width(pass_, f, nc) // split) % 128 == 0))


@functools.lru_cache(maxsize=None)
def _pick_fhead_tile(batch, h, w, f, nc, sm_count, smem_max):
    out = []
    for pass_ in FHEAD_PASSES:
        opts = fhead_options(pass_, batch, h, w, f, nc, smem_max)
        if not opts:
            raise ValueError(f"K15: no {pass_} block fits {smem_max} bytes of shared memory at {h}x{w}, f={f}")
        blocks = lambda o: fhead_blocks(batch, h, w, *o)
        wgmma = [o for o in opts if pass_ in ("pw1", "towers") and o[2] == 16]
        if wgmma:  # the wgmma kernels: the fewest slices that near one block an SM
            pick = next((o for o in wgmma if 10 * blocks(o) >= 9 * sm_count), max(wgmma, key=blocks))
        else:
            two = lambda o: 2 * (fhead_smem_bytes(pass_, o[0], h, w, f, nc, o[1], o[2]) + 1024) <= smem_max + 1024
            pick = next((o for o in opts if blocks(o) >= sm_count and two(o)),
                        next((o for o in opts if blocks(o) >= sm_count), max(opts, key=blocks)))
        out.append((pass_, pick))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load K15; its C signatures are declared here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE, NVCC_FLAGS)
    lib.hishead_launch.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
    lib.hishead_launch.restype = ctypes.c_int
    lib.hishead_scratch_sizes.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.hishead_scratch_sizes.restype = None
    lib.hishead_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.hishead_smem_bytes.restype = ctypes.c_int
    return lib


def _nk(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``[O, I, kh, kw]`` -> ``[O, kh * kw * I]``: each output channel's
    (ky, kx, ch) taps contiguous, the im2col's tap-major order."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)


def _k9(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``[O, I, 3, 3]`` -> the JAX packer's ``[9, I, O]``."""
    return w.permute(2, 3, 1, 0).reshape(9, w.shape[1], w.shape[0])


def hishead_params_pack(head, num_classes: int, dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The operands of one head level from the port's ``models/heads.HISHead``.

    JAX layouts (``pallas_head.hishead_params_pack``): ``pw1 [f, 2f]``, ``dw
    [9, 2f]`` f32, ``pw2 [2f, f]``, ``cls_t``/``reg_t [9, f, f]``,
    ``pred_cls [9, f, nc]``, ``pred_cr [9, f, 5]`` (cnt, then reg), ``gn
    [8, 2f]`` f32 (scale, bias of gn1, gn2, cls_gn0, reg_gn0; the towers'
    padded with 0) and ``bias [3, max(f, nc + 5)]`` f32 (pw2's, cls_pred's,
    cnt|reg_pred's); matrices in ``dtype``.  The kernel's layouts, ``[N,
    K]`` and contiguous: ``k_pw1 [2f, f]``, ``k_pw2 [f, 2f]``, ``k_tow [2f,
    9f]`` (the cls tower's output channels, then the reg tower's), ``k_cls
    [nc, 9f]``, ``k_cr [5, 9f]``.  Plus ``f`` and ``f2``.
    """
    f2, f = head.stem_pw1.weight.shape[:2]
    nc = num_classes
    with torch.no_grad():
        w = {name: getattr(head, name).weight.detach().float() for name in (
            "stem_pw1", "stem_dw", "stem_pw2", "cls_tower0", "reg_tower0", "cls_pred", "cnt_pred", "reg_pred")}
        pred_cr = torch.cat([w["cnt_pred"], w["reg_pred"]], dim=0)  # [5, f, 3, 3]
        dev = w["stem_pw1"].device
        pad = lambda v: F.pad(v.detach().float(), (0, f2 - f))
        gn = torch.stack([
            head.stem_gn1.weight.detach().float(), head.stem_gn1.bias.detach().float(),
            head.stem_gn2.weight.detach().float(), head.stem_gn2.bias.detach().float(),
            pad(head.cls_gn0.weight), pad(head.cls_gn0.bias), pad(head.reg_gn0.weight), pad(head.reg_gn0.bias)])
        bias = torch.zeros(3, max(f, nc + 5), dtype=torch.float32, device=dev)
        bias[0, :f] = head.stem_pw2.bias.detach().float()
        bias[1, :nc] = head.cls_pred.bias.detach().float()
        bias[2, 0] = head.cnt_pred.bias.detach().float()[0]
        bias[2, 1:5] = head.reg_pred.bias.detach().float()
        pw1 = w["stem_pw1"].reshape(f2, f)
        pw2 = w["stem_pw2"].reshape(f, f2)
        return dict(
            pw1=pw1.t().to(dtype), dw=w["stem_dw"].reshape(f2, 9).t().contiguous(), pw2=pw2.t().to(dtype),
            cls_t=_k9(w["cls_tower0"]).to(dtype), reg_t=_k9(w["reg_tower0"]).to(dtype),
            pred_cls=_k9(w["cls_pred"]).to(dtype), pred_cr=_k9(pred_cr).to(dtype), gn=gn, bias=bias,
            k_pw1=pw1.to(dtype).contiguous(), k_pw2=pw2.to(dtype).contiguous(),
            k_tow=torch.cat([_nk(w["cls_tower0"]), _nk(w["reg_tower0"])]).to(dtype).contiguous(),
            k_cls=_nk(w["cls_pred"]).to(dtype).contiguous(), k_cr=_nk(pred_cr).to(dtype).contiguous(),
            f=f, f2=f2)


def _gn_vectors(v: torch.Tensor, n: int, scale: torch.Tensor, bias: torch.Tensor):
    """Per-image, per-channel f32 (mul, add) of a GroupNorm over ``v [B, HW,
    C]`` (f32) from E[x^2] - mean^2 over n values a group
    (``pallas_head._gn_vectors``)."""
    b, _, c = v.shape
    cg = c // GROUPS
    gsum = v.sum(1).reshape(b, GROUPS, cg).sum(-1)
    gsq = (v * v).sum(1).reshape(b, GROUPS, cg).sum(-1)
    mean = gsum / n
    inv = torch.rsqrt(gsq / n - mean * mean + EPS)
    mul = inv.repeat_interleave(cg, dim=1) * scale
    return mul, bias - mean.repeat_interleave(cg, dim=1) * mul


def _affine_bf16(t: torch.Tensor, mul: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """``t * bf16(mul) + bf16(add)`` per image and channel, each op in bf16."""
    return t * mul.to(torch.bfloat16)[:, None] + add.to(torch.bfloat16)[:, None]


def _im2col(t: torch.Tensor) -> torch.Tensor:
    """NHWC ``[B, H, W, C]`` -> ``[B, H*W, 9C]``: the 3x3 SAME windows, zero
    padded, in (ky, kx, ch) order (``pallas_head._im2col_rows``)."""
    b, h, w, c = t.shape
    p = F.pad(t, (0, 0, 1, 1, 1, 1))
    return torch.cat([p[:, ky:ky + h, kx:kx + w] for ky in range(3) for kx in range(3)], dim=-1).reshape(
        b, h * w, 9 * c)


def hishead_level_fused_plain(x: torch.Tensor, packed: Dict, num_classes: int) -> torch.Tensor:
    """The JAX kernel's function in plain PyTorch ops (the reference for
    K15): NHWC ``[B, H, W, f]`` -> bf16 ``[B, H, W, nc + 5]``.  f32 matmuls
    over bf16 operands; every bf16 step of ``pallas_head._hishead_kernel``
    rounded where it rounds (torch's bf16 ops compute in f32 and round
    once)."""
    bf = torch.bfloat16
    b, h, w, f = x.shape
    f2, nc, hw = packed["f2"], num_classes, h * w
    gn, bias = packed["gn"], packed["bias"]
    xb = x.to(bf).reshape(b, hw, f)
    # pw1, GN1 statistics from the f32 values, t1 in bf16
    v = xb.float() @ packed["pw1"].float()
    mul1, add1 = _gn_vectors(v, hw * (f2 // GROUPS), gn[0], gn[1])
    u = torch.relu(_affine_bf16(v.to(bf), mul1, add1)).reshape(b, h, w, f2)
    # depthwise 3x3 in bf16: acc += win * tap, (ky, kx) order, each op rounded
    up = F.pad(u, (0, 0, 1, 1, 1, 1))
    dw = packed["dw"].to(bf)
    acc = torch.zeros_like(u)
    for ky in range(3):
        for kx in range(3):
            acc = acc + up[:, ky:ky + h, kx:kx + w] * dw[3 * ky + kx]
    t2 = acc.reshape(b, hw, f2)
    mul2, add2 = _gn_vectors(t2.float(), hw * (f2 // GROUPS), gn[2], gn[3])
    # GN2, SiLU as v * bf16(sigmoid_f32(v)), pw2 + bias + the input
    s = _affine_bf16(t2, mul2, add2)
    s = s * torch.sigmoid(s.float()).to(bf)
    y = (s.float() @ packed["pw2"].float() + bias[0, :f] + xb.float()).to(bf).reshape(b, h, w, f)
    # the two towers from one im2col; statistics in f32, maps in bf16
    col = _im2col(y).float()
    maps = []
    for name, row in (("cls_t", 4), ("reg_t", 6)):
        t = col @ packed[name].reshape(9 * f, f).float()
        mul, add = _gn_vectors(t, hw * (f // GROUPS), gn[row, :f], gn[row + 1, :f])
        maps.append(torch.relu(_affine_bf16(t.to(bf), mul, add)).reshape(b, h, w, f))
    cls = _im2col(maps[0]).float() @ packed["pred_cls"].reshape(9 * f, nc).float() + bias[1, :nc]
    cr = _im2col(maps[1]).float() @ packed["pred_cr"].reshape(9 * f, 5).float() + bias[2, :5]
    return torch.cat([cls, cr], dim=-1).to(bf).reshape(b, h, w, nc + 5)


@functools.lru_cache(maxsize=None)
def _plan(b, h, w, f, nc, sm_count, smem_max, forced):
    """The launch table of hishead_launch's cfg for one call shape: the
    chooser's blocks with the ``forced`` (pass, (ipb, split, tw)) pairs over
    them, each checked against what the kernels take."""
    cfg = pick_fhead_tile(b, h, w, f, nc, sm_count, smem_max)
    cfg.update(dict(forced))
    for pass_, (ipb, split, tw) in cfg.items():
        smem = fhead_smem_bytes(pass_, ipb, h, w, f, nc, split, tw)
        if (pass_ not in FHEAD_PASSES or tw not in fhead_widths(pass_, w) + (FHEAD_TILE,)
                or ipb not in range(1, fhead_ipbs(b, h, w, tw, fhead_rows(pass_, tw))[0] + 1) or -(-b // ipb) > 65535
                or (pass_ != "pred" and split not in fhead_slices(pass_, f, nc)) or smem > smem_max):
            raise ValueError(f"K15 does not take {pass_} blocks (ipb, split, tw) = {(ipb, split, tw)} at "
                             f"{b}x{h}x{w}, f={f} ({smem} bytes of shared memory of {smem_max})")
    return (ctypes.c_int * 15)(*[v for pass_ in FHEAD_PASSES for v in cfg[pass_]])


def hishead_level_fused(x: torch.Tensor, packed: Dict, num_classes: int, plain: bool = False,
                        tile: Optional[Dict[str, Tuple[int, int, int]]] = None) -> torch.Tensor:
    """One pyramid level through the fused head: NHWC ``x [B, H, W, f]`` ->
    bf16 ``[B, H, W, nc + 5]`` (cls | cnt | raw reg).  On a CPU tensor
    this is :func:`hishead_level_fused_plain`; on a CUDA tensor it launches
    K15 or raises.  ``plain=True`` runs the plain version on any device, for
    the comparison only.  ``tile={pass: (ipb, split, tw)}`` forces K15's
    blocks for the passes it names (:func:`pick_fhead_tile` chooses the
    others; pred's split is fixed); the output does not depend on them.
    ``hishead_level_fused.launches`` counts calls that launched the kernel
    chain (one per call)."""
    if x.dim() != 4 or x.shape[-1] != packed["f"]:
        raise ValueError(f"x must be NHWC [B, H, W, {packed['f']}]; got {tuple(x.shape)}")
    nc = num_classes
    if packed["k_cls"].shape[0] != nc or packed["bias"].shape[1] < nc + 5:
        raise ValueError(f"packed holds {packed['k_cls'].shape[0]} classes; got num_classes={nc}")
    if plain:
        return hishead_level_fused_plain(x, packed, nc)
    if library.route(x):
        if x.is_cuda:
            cfg = pick_fhead_tile(*x.shape[:3], packed["f"], nc, *card_limits(x.device))
            cfg.update(tile or {})
            tile = [cfg[p] for p in FHEAD_PASSES]
        return hishead_level_fused_op(x, [packed[k] for k in _OP_KEYS], packed["f"], packed["f2"], nc,
                                      library.tile_ints(tile))
    if x.device.type == "cpu":
        return hishead_level_fused_plain(x, packed, nc)
    return _launch(x, packed, nc, tile)


def _launch(x: torch.Tensor, packed: Dict, nc: int, tile) -> torch.Tensor:
    """K15 on a CUDA tensor, counted in ``hishead_level_fused.launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"K15 runs on CUDA tensors; got {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"K15 takes bfloat16 on the card; got {x.dtype}")
    b, h, w, f = x.shape
    if f % GROUPS or not GROUPS <= f <= MAX_FEATURES:
        raise ValueError(f"K15 takes a multiple of {GROUPS} features up to {MAX_FEATURES}; got {f}")
    names = ("k_pw1", "dw", "k_pw2", "k_tow", "k_cls", "k_cr", "gn", "bias")
    operands = [x] + [packed[k] for k in names]
    if any(t.device != x.device for t in operands):
        raise ValueError(f"K15: x and every packed operand must be on {x.device}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in operands):
        raise ValueError("K15 takes contiguous operands that start 16-byte aligned (x NHWC)")
    out = torch.empty((b, h, w, nc + 5), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    forced = tuple(sorted((k, tuple(v)) for k, v in (tile or {}).items()))
    cfg = _plan(b, h, w, f, nc, *card_limits(x.device), forced)
    lib = _lib()
    sizes = (ctypes.c_longlong * 2)()
    lib.hishead_scratch_sizes(b, h, w, f, sizes)
    scratch_bf16 = torch.empty(sizes[0], dtype=torch.bfloat16, device=x.device)
    scratch_f32 = torch.empty(sizes[1], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):  # the launches go to the current device
        err = lib.hishead_launch(*(t.data_ptr() for t in operands), packed["bias"].shape[1], out.data_ptr(),
                                 scratch_bf16.data_ptr(), scratch_f32.data_ptr(), b, h, w, f, nc, cfg,
                                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K15 launch failed: cudaError {err}")
    hishead_level_fused.launches += 1
    return out


hishead_level_fused.launches = 0

# the packed level's tensors as the op takes them: the plain version's, then the kernel's
_OP_KEYS = ("pw1", "dw", "pw2", "cls_t", "reg_t", "pred_cls", "pred_cr", "gn", "bias", "k_pw1", "k_pw2", "k_tow",
            "k_cls", "k_cr")


def _packed(tensors, f: int, f2: int) -> Dict:
    return dict(zip(_OP_KEYS, tensors), f=f, f2=f2)


hishead_level_fused_op = library.define(
    "hishead_level_fused", "(Tensor x, Tensor[] packed, int f, int f2, int nc, int[]? tile) -> Tensor",
    cpu=lambda x, packed, f, f2, nc, tile: hishead_level_fused_plain(x, _packed(packed, f, f2), nc),
    cuda=lambda x, packed, f, f2, nc, tile: _launch(x, _packed(packed, f, f2), nc,
                                                    library.pairs(tile, FHEAD_PASSES, 3)),
    fake=lambda x, packed, f, f2, nc, tile: library.empty_like_shape(x, (*x.shape[:3], nc + 5), torch.bfloat16))
