"""int8 PTQ inference forward for the HISFCOS head, GroupNorm-aware (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/models/head_int8.py``.
GroupNorm cannot fold into the conv weights (its statistics depend on the
activation), so each conv runs int8 x int8 -> int32, dequantizes per output
channel to f32 (before the GroupNorm's statistics), normalizes in f32 over
the whole (H*W, group) extent and requantizes at a per-LEVEL calibrated
scale.  The head's weights are shared across levels; the epilogue vectors,
which mix the shared weight scales with the per-level activation scales,
are per level.  ``cnt_pred`` and ``reg_pred`` read the same tower output,
so they are packed into one 5-channel conv.  The ScaleExp of the regression
branch (``exp(pred * s_i)``) runs outside the kernels.

Everything is NHWC, the JAX package's layout and the kernels'.  The qtree
(:func:`quantize_hishead`) is in the kernel layouts of ``ops/qhead.py``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from pytorch_object_detection_tpu_torch.models.heads import HISHead
from pytorch_object_detection_tpu_torch.nn.resnet_int8 import _port_layout
from pytorch_object_detection_tpu_torch.ops.qhead import (
    GN_EPS,
    NUM_GROUPS,
    _gn,
    qhishead_level,
    qhishead_level2,
    qhishead_level_plain,
)
from pytorch_object_detection_tpu_torch.ops.quant import act_scale, weight_qparams

__all__ = ["GN_EPS", "NUM_GROUPS", "_gn", "calibrate_hishead", "quantize_hishead", "_hishead_level_i8_xla",
           "hishead_int8_forward"]

BACKENDS = ("xla", "pallas")
V2_MODES = ("auto", "on", "off")
# the per-op oracle of one level (the JAX :187-205) is K7's and K9's plain version
_hishead_level_i8_xla = qhishead_level_plain


def _conv_f32(x: torch.Tensor, conv: torch.nn.Conv2d, bias: bool = False) -> torch.Tensor:
    """The f32 conv of ``conv``'s weights on NHWC ``x`` (padding and groups its own)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.float(), conv.bias.float() if bias else None,
                 padding=conv.padding, groups=conv.groups)
    return y.permute(0, 2, 3, 1)


@torch.no_grad()
def calibrate_hishead(head: HISHead, levels: Sequence[torch.Tensor]) -> Dict[str, float]:
    """Float HISHead forward (f32, NHWC levels) recording per-level abs-max
    at the requant points: ``L<i>.x1`` (after gn1), ``.x2`` (after gn2),
    ``.y`` (after the residual), ``.c`` and ``.r`` (after the tower GNs)."""
    gn = lambda m: (m.weight.float(), m.bias.float())
    taps: Dict[str, torch.Tensor] = {}
    for i, x in enumerate(levels):
        x = x.float()
        x1 = _gn(_conv_f32(x, head.stem_pw1), *gn(head.stem_gn1), act="relu")
        taps[f"L{i}.x1"] = x1.abs().max()
        x2 = _gn(_conv_f32(x1, head.stem_dw), *gn(head.stem_gn2), act="silu")
        taps[f"L{i}.x2"] = x2.abs().max()
        y = _conv_f32(x2, head.stem_pw2, bias=True) + x
        taps[f"L{i}.y"] = y.abs().max()
        c = _gn(_conv_f32(y, head.cls_tower0), *gn(head.cls_gn0), act="relu")
        taps[f"L{i}.c"] = c.abs().max()
        r = _gn(_conv_f32(y, head.reg_tower0), *gn(head.reg_gn0), act="relu")
        taps[f"L{i}.r"] = r.abs().max()
    return {k: float(v) for k, v in taps.items()}


@torch.no_grad()
def quantize_hishead(head: HISHead, taps: Dict[str, float], level_scales: Sequence, num_classes: int) -> Dict:
    """Quantize the shared head weights once and build the per-level
    epilogue vectors (the JAX function, ``:117-181``).

    ``level_scales``: the int8 scales of the five pyramid levels
    (``hisfpn_int8_forward(..., dequant=False)``).
    """
    dev = head.stem_pw1.weight.device
    f32 = lambda t: t.detach().float()
    w1q, sw1 = weight_qparams(f32(head.stem_pw1.weight), axis=0)
    wdwq, swdw = weight_qparams(f32(head.stem_dw.weight), axis=0)  # [2C, 1, 3, 3]
    w2q, sw2 = weight_qparams(f32(head.stem_pw2.weight), axis=0)
    wcq, swc = weight_qparams(f32(head.cls_tower0.weight), axis=0)
    wrq, swr = weight_qparams(f32(head.reg_tower0.weight), axis=0)
    wpcq, swpc = weight_qparams(f32(head.cls_pred.weight), axis=0)
    wcrq, swcr = weight_qparams(torch.cat([f32(head.cnt_pred.weight), f32(head.reg_pred.weight)]), axis=0)
    gn = lambda m: (f32(m.weight), f32(m.bias))
    q: Dict = dict(
        w1=_port_layout(w1q), wdw=wdwq[:, 0].permute(1, 2, 0).contiguous(),
        w2=_port_layout(w2q), wc=_port_layout(wcq), wr=_port_layout(wrq), wpc=_port_layout(wpcq),
        wcr=_port_layout(wcrq), b2=f32(head.stem_pw2.bias), bpc=f32(head.cls_pred.bias),
        bcr=torch.cat([f32(head.cnt_pred.bias), f32(head.reg_pred.bias)]),
        gn1=gn(head.stem_gn1), gn2=gn(head.stem_gn2), gnc=gn(head.cls_gn0), gnr=gn(head.reg_gn0),
        num_classes=int(num_classes),
        scale_exp=torch.stack([f32(getattr(head, f"scale{i}").scale).reshape(()) for i in range(len(level_scales))]),
    )
    levels = []
    for i, s_lv in enumerate(level_scales):
        s_lv = torch.as_tensor(s_lv, dtype=torch.float32).to(dev)
        s_x1, s_x2, s_y, s_c, s_r = (act_scale(taps[f"L{i}.{t}"]).to(dev) for t in ("x1", "x2", "y", "c", "r"))
        levels.append(dict(
            A1=s_lv * sw1, inv_x1=1.0 / s_x1, Adw=s_x1 * swdw, inv_x2=1.0 / s_x2,
            A2=s_x2 * sw2 / s_y, B2=q["b2"] / s_y, res_mul=s_lv / s_y,
            Ac=s_y * swc, inv_c=1.0 / s_c, Ar=s_y * swr, inv_r=1.0 / s_r,
            Apc=s_c * swpc, Acr=s_r * swcr,
        ))
    q["levels"] = levels
    return q


def hishead_int8_forward(q: Dict, levels_q: Sequence[torch.Tensor], backend: str = "xla", num_classes=None,
                         v2: str = "auto") -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """Per-level f32 NHWC (cls, cnt, reg) from the int8 pyramid levels; reg
    already through the level's ScaleExp (the output contract of the float
    HISHead).

    ``backend="pallas"``: K9 (``ops/qhead.qhishead_level2``) on a level of
    more than 64x64 pixels and K7 otherwise (``v2="auto"``, the JAX rule;
    ``"on"`` always K9, ``"off"`` always K7; the JAX package reads the same
    choice from ``PODT_QHEAD_V2``), each its plain version on a CPU tensor.
    ``"xla"``: the per-op oracle.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    if v2 not in V2_MODES:
        raise ValueError(f"v2 must be one of {V2_MODES}; got {v2!r}")
    nc = int(num_classes) if num_classes is not None else int(q["num_classes"])
    cls_l, cnt_l, reg_l = [], [], []
    for i, x_q in enumerate(levels_q):
        lv = q["levels"][i]
        if backend == "xla":
            cls, cr = _hishead_level_i8_xla(q, lv, x_q)
        else:
            use_v2 = v2 == "on" or (v2 == "auto" and x_q.shape[1] * x_q.shape[2] > 64 * 64)
            cls, cr = (qhishead_level2 if use_v2 else qhishead_level)(q, lv, x_q, num_classes=nc)
        cls_l.append(cls)
        cnt_l.append(cr[..., :1])
        reg_l.append(torch.exp(cr[..., 1:5] * q["scale_exp"][i]))
    return cls_l, cnt_l, reg_l
