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
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch
import torch.nn.functional as F

SOURCE = "head.cu"
# no FMA contraction: each bf16 step is an f32 operation rounded once, as in the reference
NVCC_FLAGS = ("-fmad=false",)
GROUPS = 32
EPS = 1e-5
MAX_FEATURES = 256  # the kernel keeps 2f folded GroupNorm vectors in shared memory


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load K15; its C signatures are declared here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE, NVCC_FLAGS)
    lib.hishead_launch.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.hishead_launch.restype = ctypes.c_int
    lib.hishead_scratch_sizes.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.hishead_scratch_sizes.restype = None
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


def hishead_level_fused(x: torch.Tensor, packed: Dict, num_classes: int, plain: bool = False) -> torch.Tensor:
    """One pyramid level through the fused head: NHWC ``x [B, H, W, f]`` ->
    bf16 ``[B, H, W, nc + 5]`` (cls | cnt | raw reg).  On a CPU tensor
    this is :func:`hishead_level_fused_plain`; on a CUDA tensor it launches
    K15 or raises.  ``plain=True`` runs the plain version on any device, for
    the comparison only.  ``hishead_level_fused.launches`` counts calls that
    launched the kernel chain (one per call)."""
    if x.dim() != 4 or x.shape[-1] != packed["f"]:
        raise ValueError(f"x must be NHWC [B, H, W, {packed['f']}]; got {tuple(x.shape)}")
    nc = num_classes
    if packed["k_cls"].shape[0] != nc or packed["bias"].shape[1] < nc + 5:
        raise ValueError(f"packed holds {packed['k_cls'].shape[0]} classes; got num_classes={nc}")
    if plain or x.device.type == "cpu":
        return hishead_level_fused_plain(x, packed, nc)
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
    lib = _lib()
    sizes = (ctypes.c_longlong * 2)()
    lib.hishead_scratch_sizes(b, h, w, f, sizes)
    scratch_bf16 = torch.empty(sizes[0], dtype=torch.bfloat16, device=x.device)
    scratch_f32 = torch.empty(sizes[1], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):  # the launches go to the current device
        err = lib.hishead_launch(*(t.data_ptr() for t in operands), packed["bias"].shape[1], out.data_ptr(),
                                 scratch_bf16.data_ptr(), scratch_f32.data_ptr(), b, h, w, f, nc,
                                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K15 launch failed: cudaError {err}")
    hishead_level_fused.launches += 1
    return out


hishead_level_fused.launches = 0
