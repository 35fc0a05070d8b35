"""int8 PTQ serving ladder for the classic FCOS: the classic FPN and the FCOSHead (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/models/fcos_int8.py``, the
same scheme as the HISFCOS ladders:

  * weights per output channel, activations per tensor (abs-max
    calibration) at every requant point; the FPN convs have no norm, so
    their bias rides the f32 epilogue ``acc * A + B``;
  * the top-down adds requantize to the SUM's scale: the lateral's
    epilogue adds the 2x-upsampled partner at ``partner_q * p_mul`` before
    the one round (``_clip8``); ``down7`` takes ReLU(P6) on the int8 values;
  * the head's tower and prediction weights are shared across levels with
    PER-LEVEL activation scales; each tower conv dequantizes its int32 sum
    per output channel (``acc * A``), runs GroupNorm32 + ReLU in f32 on it
    (``ops/qhead._gn``, the JAX ``_gn``) and requantizes at the level's
    scale; cnt and reg are packed into one 5-channel conv, and the ScaleExp
    runs in f32 after it.

Every function repeats the JAX one's f32 operations in the JAX order, NHWC
throughout.  Every conv is per-op ``ops/quant.conv_i8`` (exact int32 sums:
im2col and ``torch._int_mm``), as JAX computes them with XLA's int8 convs
outside any Pallas kernel; no kernel of the port runs here.

The qtrees: :func:`quantize_fpn_classic` gives ``lateral5/4/3``,
``smooth5/4/3``, ``down6``, ``down7`` {``w`` int8 ``[F, Cin]`` (1x1) or
``[F, 3, 3, F]``, ``A``, ``B`` f32 ``[F]``}, ``t5_to_m4``, ``p4_to_m3`` and
``scales`` {``t5 m4 p4 m3 p3 p5 p6 p7``}; :func:`quantize_fcoshead` gives
``num_classes``, ``wc0..3``, ``wr0..3 [F, 3, 3, F]``, ``wpc [nc, 3, 3, F]``,
``wcr [5, 3, 3, F]`` int8, ``gnc0..3``, ``gnr0..3`` (gamma, beta), ``bpc``,
``bcr``, ``scale_exp`` and ``levels`` (per level ``Ac0..3``, ``inv_c0..3``,
``Ar0..3``, ``inv_r0..3``, ``Apc``, ``Acr``); scalars are 0-d f32 tensors.
``train/checkpoints.load_fpn_classic_qtree`` and ``load_fcoshead_qtree``
carry the JAX package's trees across.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from pytorch_object_detection_tpu_torch.models.heads import FCOS_TOWER, FCOSHead
from pytorch_object_detection_tpu_torch.models.mnfcos_int8 import _conv_f, _gn_of, _kb
from pytorch_object_detection_tpu_torch.nn.fpn import FPN
from pytorch_object_detection_tpu_torch.nn.resnet_int8 import _port_layout
from pytorch_object_detection_tpu_torch.ops.qhead import _gn
from pytorch_object_detection_tpu_torch.ops.qhis import upsample2x_i8
from pytorch_object_detection_tpu_torch.ops.quant import act_scale, clip8, conv_i8, weight_qparams

FPN_TAPS = ("t5", "m4", "p4", "m3", "p3", "p5", "p6", "p7")


# ------------------------------------------------------------ classic FPN


@torch.no_grad()
def calibrate_fpn_classic(fpn: FPN, feats: Sequence[torch.Tensor]) -> Dict[str, float]:
    """Float classic-FPN forward (f32, NHWC C3..C5) recording the abs-max at
    every requant point (:data:`FPN_TAPS`)."""
    c3, c4, c5 = [f.float() for f in feats]
    taps: Dict[str, torch.Tensor] = {}
    t5 = _conv_f(c5, *_kb(fpn.lateral5))
    taps["t5"] = t5.abs().max()
    m4 = upsample2x_i8(t5) + _conv_f(c4, *_kb(fpn.lateral4))
    taps["m4"] = m4.abs().max()
    p4 = _conv_f(m4, *_kb(fpn.smooth4))
    taps["p4"] = p4.abs().max()
    m3 = upsample2x_i8(p4) + _conv_f(c3, *_kb(fpn.lateral3))
    taps["m3"] = m3.abs().max()
    taps["p3"] = _conv_f(m3, *_kb(fpn.smooth3)).abs().max()
    p5 = _conv_f(t5, *_kb(fpn.smooth5))
    taps["p5"] = p5.abs().max()
    p6 = _conv_f(p5, *_kb(fpn.down6), stride=2)
    taps["p6"] = p6.abs().max()
    taps["p7"] = _conv_f(torch.clamp(p6, min=0.0), *_kb(fpn.down7), stride=2).abs().max()
    return {k: float(v) for k, v in taps.items()}


@torch.no_grad()
def quantize_fpn_classic(fpn: FPN, taps: Dict[str, float], feat_scales: Sequence) -> Dict:
    """Quantize the classic FPN and fold the epilogue scales; ``feat_scales``
    are the int8 scales of (C3, C4, C5) from the quantized backbone.  The
    laterals of P4 and P3 requantize to the sum's scale (``m4``, ``m3``)."""
    dev = fpn.lateral5.weight.device
    s3, s4, s5 = (torch.as_tensor(s, dtype=torch.float32).to(dev) for s in feat_scales)
    s = {k: act_scale(taps[k]).to(dev) for k in FPN_TAPS}
    q: Dict = {"scales": dict(s)}

    def conv(name, s_in, s_out):
        m = getattr(fpn, name)
        wq, sw = weight_qparams(m.weight.detach().float(), axis=0)
        return dict(w=_port_layout(wq), A=s_in * sw / s_out, B=m.bias.detach().float() / s_out)

    q["lateral5"] = conv("lateral5", s5, s["t5"])
    q["lateral4"] = conv("lateral4", s4, s["m4"])
    q["lateral3"] = conv("lateral3", s3, s["m3"])
    q["smooth4"] = conv("smooth4", s["m4"], s["p4"])
    q["smooth3"] = conv("smooth3", s["m3"], s["p3"])
    q["smooth5"] = conv("smooth5", s["t5"], s["p5"])
    q["down6"] = conv("down6", s["p5"], s["p6"])
    q["down7"] = conv("down7", s["p6"], s["p7"])
    q["t5_to_m4"] = s["t5"] / s["m4"]
    q["p4_to_m3"] = s["p4"] / s["m3"]
    return q


def fpn_classic_int8_forward(qtree: Dict, feats_q: Sequence[torch.Tensor],
                             compute_dtype: torch.dtype = torch.bfloat16, backend: str = "xla", dequant: bool = True):
    """(C3, C4, C5) int8 NHWC -> the five int8 levels P3..P7.  ``dequant=True``
    returns them in ``compute_dtype`` (``level_q`` cast to ``compute_dtype``,
    times its scale in ``compute_dtype``, as JAX does); ``False`` returns
    ``(levels_q, scales)``.  ``backend`` is unused (every backend runs these
    per-op convs, as JAX's are XLA int8 convs on every backend); it is taken
    for the pyramids' common signature."""
    del backend
    c3, c4, c5 = feats_q

    def rq(x_q, blk, stride=1, partner=None, p_mul=None, relu_in=False):
        if relu_in:
            x_q = torch.clamp(x_q, min=0)
        y = conv_i8(x_q, blk["w"], stride=stride) * blk["A"] + blk["B"]
        if partner is not None:
            y = y + partner.float() * p_mul
        return clip8(y)

    t5 = rq(c5, qtree["lateral5"])
    m4 = rq(c4, qtree["lateral4"], partner=upsample2x_i8(t5), p_mul=qtree["t5_to_m4"])
    p4 = rq(m4, qtree["smooth4"])
    m3 = rq(c3, qtree["lateral3"], partner=upsample2x_i8(p4), p_mul=qtree["p4_to_m3"])
    p3 = rq(m3, qtree["smooth3"])
    p5 = rq(t5, qtree["smooth5"])
    p6 = rq(p5, qtree["down6"], stride=2)
    p7 = rq(p6, qtree["down7"], stride=2, relu_in=True)
    levels = (p3, p4, p5, p6, p7)
    scales = tuple(qtree["scales"][k] for k in ("p3", "p4", "p5", "p6", "p7"))
    if not dequant:
        return levels, scales
    return tuple(lq.float().to(compute_dtype) * s.to(compute_dtype) for lq, s in zip(levels, scales))


# ------------------------------------------------------------ FCOS head


@torch.no_grad()
def calibrate_fcoshead(head: FCOSHead, levels: Sequence[torch.Tensor]) -> Dict[str, float]:
    """Float FCOSHead forward (f32, NHWC levels) recording per-level abs-maxes
    after every tower GN+ReLU: ``L<i>.c<j>`` and ``L<i>.r<j>``."""
    taps: Dict[str, torch.Tensor] = {}
    for i, x in enumerate(levels):
        c = r = x.float()
        for j in range(FCOS_TOWER):
            c = _gn(_conv_f(c, *_kb(getattr(head, f"cls_tower{j}"))), *_gn_of(getattr(head, f"cls_gn{j}")), act="relu")
            taps[f"L{i}.c{j}"] = c.abs().max()
            r = _gn(_conv_f(r, *_kb(getattr(head, f"reg_tower{j}"))), *_gn_of(getattr(head, f"reg_gn{j}")), act="relu")
            taps[f"L{i}.r{j}"] = r.abs().max()
    return {k: float(v) for k, v in taps.items()}


@torch.no_grad()
def quantize_fcoshead(head: FCOSHead, taps: Dict[str, float], level_scales: Sequence, num_classes: int) -> Dict:
    """The shared tower and prediction weights quantized once; the per-level
    epilogues from ``level_scales`` (the int8 scales of P3..P7)."""
    dev = head.cls_pred.weight.device
    f32 = lambda t: t.detach().float()
    q: Dict = {"num_classes": int(num_classes)}
    swc, swr = [], []
    for j in range(FCOS_TOWER):
        wq, sw = weight_qparams(f32(getattr(head, f"cls_tower{j}").weight), axis=0)
        q[f"wc{j}"] = _port_layout(wq)
        swc.append(sw)
        wq, sw = weight_qparams(f32(getattr(head, f"reg_tower{j}").weight), axis=0)
        q[f"wr{j}"] = _port_layout(wq)
        swr.append(sw)
        q[f"gnc{j}"] = _gn_of(getattr(head, f"cls_gn{j}"))
        q[f"gnr{j}"] = _gn_of(getattr(head, f"reg_gn{j}"))
    wpc, swpc = weight_qparams(f32(head.cls_pred.weight), axis=0)
    wcr, swcr = weight_qparams(torch.cat([f32(head.cnt_pred.weight), f32(head.reg_pred.weight)]), axis=0)
    q.update(wpc=_port_layout(wpc), wcr=_port_layout(wcr), bpc=f32(head.cls_pred.bias),
             bcr=torch.cat([f32(head.cnt_pred.bias), f32(head.reg_pred.bias)]),
             scale_exp=torch.stack([f32(getattr(head, f"scale{i}").scale).reshape(())
                                    for i in range(len(level_scales))]))
    levels = []
    for i, s_lv in enumerate(level_scales):
        s_prev_c = s_prev_r = torch.as_tensor(s_lv, dtype=torch.float32).to(dev)
        lv: Dict = {}
        for j in range(FCOS_TOWER):
            s_c, s_r = act_scale(taps[f"L{i}.c{j}"]).to(dev), act_scale(taps[f"L{i}.r{j}"]).to(dev)
            lv.update({f"Ac{j}": s_prev_c * swc[j], f"inv_c{j}": 1.0 / s_c, f"Ar{j}": s_prev_r * swr[j],
                       f"inv_r{j}": 1.0 / s_r})
            s_prev_c, s_prev_r = s_c, s_r
        lv.update(Apc=s_prev_c * swpc, Acr=s_prev_r * swcr)
        levels.append(lv)
    q["levels"] = levels
    return q


def fcoshead_tower_i8(q: Dict, lv: Dict, x_q: torch.Tensor, branch: str, j: int) -> torch.Tensor:
    """Tower stage ``j`` of branch ``"c"`` (cls) or ``"r"`` (reg) on its int8
    input: int8 conv, per-channel dequant, GroupNorm32 + ReLU in f32, the
    level's requant."""
    z = conv_i8(x_q, q[f"w{branch}{j}"]) * lv[f"A{branch}{j}"]
    return clip8(_gn(z, *q[f"gn{branch}{j}"], act="relu") * lv[f"inv_{branch}{j}"])


def fcoshead_int8_forward(q: Dict, levels_q: Sequence[torch.Tensor], num_classes=None, backend: str = "xla"
                          ) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """Per-level f32 NHWC (cls, cnt, reg) from the int8 levels, reg through
    the level's ScaleExp (the float FCOSHead's output contract).
    ``num_classes`` and ``backend`` are unused (the pred weights carry the
    class count; every backend runs these per-op convs); they are taken for
    the heads' common signature."""
    del num_classes, backend
    cls_l, cnt_l, reg_l = [], [], []
    for i, x_q in enumerate(levels_q):
        lv = q["levels"][i]
        c = r = x_q
        for j in range(FCOS_TOWER):
            c = fcoshead_tower_i8(q, lv, c, "c", j)
            r = fcoshead_tower_i8(q, lv, r, "r", j)
        cls = conv_i8(c, q["wpc"]) * lv["Apc"] + q["bpc"]
        cr = conv_i8(r, q["wcr"]) * lv["Acr"] + q["bcr"]
        cls_l.append(cls)
        cnt_l.append(cr[..., :1])
        reg_l.append(torch.exp(cr[..., 1:5] * q["scale_exp"][i]))
    return cls_l, cnt_l, reg_l
