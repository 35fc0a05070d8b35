"""int8 PTQ serving ladder for MNFCOS: the LightweightFPN and the MNHead (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/models/mnfcos_int8.py``, the
same scheme as the HISFCOS ladders:

  * weights per output channel, activations per tensor (abs-max
    calibration) at every requant point; each MNBlock's BN folds into its
    depthwise kernel before the kernel is quantized (per channel, since the
    conv has one group per channel);
  * SiLU runs in the f32 epilogue before the requant;
  * the residual add requantizes to the block's output scale with the input
    riding along (``x_q * s_in / s_out``); a lateral's top-down add takes the
    upsampled partner at ``partner_q * p_mul``;
  * the 2x nearest upsample and the 2x2 max pool are exact on int8;
  * the head's MNBlocks, towers and predictions share their weights across
    levels with PER-LEVEL activation scales; the cnt and reg predictions are
    packed into one 5-channel conv, and the ScaleExp runs in f32 after it.

Every function repeats the JAX one's f32 operations in the JAX order.
Everything runs NHWC.  The laterals, towers and predictions are per-op
``ops/quant.conv_i8`` (exact int32 sums), as JAX computes them outside any
Pallas kernel; each MNBlock is ``ops/qmnblock``: ``backend="pallas"``
launches K12 on CUDA tensors (all fifteen blocks of a forward, or none: the
JAX ``PODT_QMN=1``), ``"xla"`` runs the per-op oracle (K12's plain version,
the JAX default ``PODT_QMN=0``).

The qtrees: ``quantize_lwfpn`` gives ``lateral5``/``4``/``3`` {``w [F, Cin]``
int8, ``A``, ``B`` f32 ``[F]``}, ``mnb3``..``mnb7`` (the block entries
``ops/qmnblock.py`` lists), ``sc`` {block: {``s_in``, ``s_a1``, ``s_a2``,
``s_out``}} and ``p5_to_m4``, ``p4_to_m3``; ``quantize_mnhead`` gives
``num_classes``, ``block1``, ``block2``, ``wc``, ``wr [C, 3, 3, C]``,
``wpc [nc, C]``, ``wcr [5, C]`` int8, ``gnc``, ``gnr`` (gamma, beta),
``bpc``, ``bcr``, ``scale_exp`` and ``levels`` (per level: the two blocks'
scales, ``Ac``, ``inv_c``, ``Ar``, ``inv_r``, ``Apc``, ``Acr``); scalars are
0-d f32 tensors.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from pytorch_object_detection_tpu_torch.models.heads import MNHead
from pytorch_object_detection_tpu_torch.nn.fpn import LightweightFPN
from pytorch_object_detection_tpu_torch.nn.fused_resnet import fold_bn
from pytorch_object_detection_tpu_torch.nn.layers import MNBlock
from pytorch_object_detection_tpu_torch.nn.resnet_int8 import _port_layout
from pytorch_object_detection_tpu_torch.ops.qhead import _gn
from pytorch_object_detection_tpu_torch.ops.qhis import upsample2x_i8
from pytorch_object_detection_tpu_torch.ops.qmnblock import qmnblock
from pytorch_object_detection_tpu_torch.ops.qpool import qmaxpool2x2_plain
from pytorch_object_detection_tpu_torch.ops.quant import act_scale, clip8, conv_i8, weight_qparams

# (name, kernel, dilation) of the five pyramid MNBlocks (nn/fpn.LightweightFPN)
FPN_BLOCKS = (("mnb5", 5, 2), ("mnb4", 3, 2), ("mnb3", 3, 1), ("mnb6", 5, 1), ("mnb7", 7, 1))
# the head's MNBlocks: MNHead block1/block2 are MNBlock(f, 3, dilation=2, alpha=2)
HEAD_BLOCKS = (("block1", 3, 2), ("block2", 3, 2))
BACKENDS = ("xla", "pallas")


def _conv_f(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None, stride: int = 1,
            dilation: int = 1, groups: int = 1, pad: Optional[int] = None) -> torch.Tensor:
    """The f32 conv of the OIHW kernel ``w`` on NHWC ``x`` with the port's
    ``Conv`` padding ``dilation * (k - 1) // 2`` (or ``pad``), the bias added
    after it, as the JAX ``_conv_f`` does."""
    pad = dilation * (w.shape[-1] - 1) // 2 if pad is None else pad
    y = F.conv2d(x.permute(0, 3, 1, 2), w.float(), None, stride=stride, padding=pad,
                 dilation=dilation, groups=groups).permute(0, 2, 3, 1)
    return y if bias is None else y + bias.float()


def _kb(conv) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``conv``'s kernel and bias (``None`` without one), detached, in f32."""
    return conv.weight.detach().float(), None if conv.bias is None else conv.bias.detach().float()


# ------------------------------------------------------------ MNBlock


def _mnblock_f32(blk: MNBlock, x: torch.Tensor, taps: Dict, prefix: str) -> torch.Tensor:
    """Float MNBlock (BN folded, as the JAX one) recording the three
    requant-point abs-maxes."""
    mult, shift = fold_bn(blk.bn1)
    a1 = _conv_f(x, blk.ddw.weight, dilation=blk.ddw.dilation[0], groups=blk.ddw.groups) * mult + shift
    taps[f"{prefix}.a1"] = a1.abs().max()
    a2 = _conv_f(a1, *_kb(blk.pw1))
    a2 = a2 * torch.sigmoid(a2)
    taps[f"{prefix}.a2"] = a2.abs().max()
    out = x + _conv_f(a2, *_kb(blk.pw2))
    taps[f"{prefix}.out"] = out.abs().max()
    return out


def _quantize_mnblock(blk: MNBlock) -> Dict:
    """Weight-side quantization of one MNBlock (the activation scales come
    separately: the head's shared blocks have per-level scales)."""
    mult, shift = fold_bn(blk.bn1)
    kdw = blk.ddw.weight.detach().float() * mult[:, None, None, None]  # [C, 1, k, k]
    wdw, swdw = weight_qparams(kdw, axis=0)
    w1, sw1 = weight_qparams(blk.pw1.weight.detach().float(), axis=0)
    w2, sw2 = weight_qparams(blk.pw2.weight.detach().float(), axis=0)
    return dict(wdw=wdw[:, 0].permute(1, 2, 0).contiguous(), swdw=swdw, bdw=shift,
                w1=_port_layout(w1), sw1=sw1, b1=blk.pw1.bias.detach().float(),
                w2=_port_layout(w2), sw2=sw2, b2=blk.pw2.bias.detach().float())


def _block_scales(taps: Dict[str, float], prefix: str, s_in, device) -> Dict[str, torch.Tensor]:
    return dict(s_in=torch.as_tensor(s_in, dtype=torch.float32).to(device),
                s_a1=act_scale(taps[f"{prefix}.a1"]).to(device),
                s_a2=act_scale(taps[f"{prefix}.a2"]).to(device),
                s_out=act_scale(taps[f"{prefix}.out"]).to(device))


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")


# ------------------------------------------------------------ lightweight FPN


@torch.no_grad()
def calibrate_lwfpn(fpn: LightweightFPN, feats: Sequence[torch.Tensor]) -> Dict[str, float]:
    """Float LightweightFPN forward (f32, NHWC C3..C5) recording the abs-max
    at every requant point: ``l5``, ``m4``, ``m3`` and per block
    ``<block>.a1``, ``.a2``, ``.out``."""
    c3, c4, c5 = [f.float() for f in feats]
    taps: Dict[str, torch.Tensor] = {}

    def mnb(x, name):
        return _mnblock_f32(getattr(fpn, name), x, taps, name)

    l5 = _conv_f(c5, *_kb(fpn.lateral5))
    taps["l5"] = l5.abs().max()
    p5 = mnb(l5, "mnb5")
    m4 = upsample2x_i8(p5) + _conv_f(c4, *_kb(fpn.lateral4))
    taps["m4"] = m4.abs().max()
    p4 = mnb(m4, "mnb4")
    m3 = upsample2x_i8(p4) + _conv_f(c3, *_kb(fpn.lateral3))
    taps["m3"] = m3.abs().max()
    mnb(m3, "mnb3")
    p6 = mnb(qmaxpool2x2_plain(p5), "mnb6")
    mnb(qmaxpool2x2_plain(p6), "mnb7")
    return {k: float(v) for k, v in taps.items()}


@torch.no_grad()
def quantize_lwfpn(fpn: LightweightFPN, taps: Dict[str, float], feat_scales) -> Dict:
    """Quantize the LightweightFPN; ``feat_scales`` are the int8 scales of
    (C3, C4, C5) from the quantized backbone."""
    dev = fpn.lateral5.weight.device
    s3, s4, s5 = (torch.as_tensor(s, dtype=torch.float32).to(dev) for s in feat_scales)
    q: Dict = {}

    def lat(conv, s_in, s_out):
        wq, sw = weight_qparams(conv.weight.detach().float(), axis=0)
        return dict(w=_port_layout(wq), A=s_in * sw / s_out, B=conv.bias.detach().float() / s_out)

    s_l5, s_m4, s_m3 = (act_scale(taps[t]).to(dev) for t in ("l5", "m4", "m3"))
    q["lateral5"] = lat(fpn.lateral5, s5, s_l5)
    q["lateral4"] = lat(fpn.lateral4, s4, s_m4)
    q["lateral3"] = lat(fpn.lateral3, s3, s_m3)
    for name, _, _ in FPN_BLOCKS:
        q[name] = _quantize_mnblock(getattr(fpn, name))
    sc = {"mnb5": _block_scales(taps, "mnb5", s_l5, dev), "mnb4": _block_scales(taps, "mnb4", s_m4, dev),
          "mnb3": _block_scales(taps, "mnb3", s_m3, dev)}
    sc["mnb6"] = _block_scales(taps, "mnb6", sc["mnb5"]["s_out"], dev)
    sc["mnb7"] = _block_scales(taps, "mnb7", sc["mnb6"]["s_out"], dev)
    q["sc"] = sc
    q["p5_to_m4"] = sc["mnb5"]["s_out"] / s_m4
    q["p4_to_m3"] = sc["mnb4"]["s_out"] / s_m3
    return q


def lwfpn_int8_forward(qtree: Dict, feats_q: Sequence[torch.Tensor], compute_dtype: torch.dtype = torch.bfloat16,
                       dequant: bool = True, backend: str = "xla"):
    """(C3, C4, C5) int8 NHWC -> five int8 pyramid levels P3..P7.

    ``backend`` selects the MNBlocks' route (module docstring).
    ``dequant=True`` returns ``compute_dtype`` levels (``level_q`` cast to
    ``compute_dtype``, times its scale in ``compute_dtype``, as JAX does);
    ``False`` returns ``(levels_q, scales)``.
    """
    _check_backend(backend)
    c3, c4, c5 = feats_q
    sc = qtree["sc"]

    def lat(x_q, blk, partner=None, p_mul=None):
        y = conv_i8(x_q, blk["w"]) * blk["A"] + blk["B"]
        if partner is not None:
            y = y + partner.float() * p_mul
        return clip8(y)

    kd = {name: (k, d) for name, k, d in FPN_BLOCKS}

    def mnb(name, x_q):
        return qmnblock(qtree[name], sc[name], x_q, *kd[name], plain=backend == "xla")

    p5 = mnb("mnb5", lat(c5, qtree["lateral5"]))
    p4 = mnb("mnb4", lat(c4, qtree["lateral4"], partner=upsample2x_i8(p5), p_mul=qtree["p5_to_m4"]))
    p3 = mnb("mnb3", lat(c3, qtree["lateral3"], partner=upsample2x_i8(p4), p_mul=qtree["p4_to_m3"]))
    p6 = mnb("mnb6", qmaxpool2x2_plain(p5))
    p7 = mnb("mnb7", qmaxpool2x2_plain(p6))
    levels = (p3, p4, p5, p6, p7)
    scales = tuple(sc[name]["s_out"] for name in ("mnb3", "mnb4", "mnb5", "mnb6", "mnb7"))
    if not dequant:
        return levels, scales
    return tuple(lq.float().to(compute_dtype) * s.to(compute_dtype) for lq, s in zip(levels, scales))


# ------------------------------------------------------------ MN head


def _gn_of(m) -> Tuple[torch.Tensor, torch.Tensor]:
    return m.weight.detach().float(), m.bias.detach().float()


@torch.no_grad()
def calibrate_mnhead(head: MNHead, levels: Sequence[torch.Tensor]) -> Dict[str, float]:
    """Float MNHead forward (f32, NHWC levels) recording per-level abs-maxes:
    ``L<i>.block1.a1`` .. ``.block2.out`` and the towers' ``L<i>.c``, ``.r``."""
    taps: Dict[str, torch.Tensor] = {}
    for i, x in enumerate(levels):
        y = x.float()
        for name, _, _ in HEAD_BLOCKS:
            y = _mnblock_f32(getattr(head, name), y, taps, f"L{i}.{name}")
        c = _gn(_conv_f(y, *_kb(head.cls_tower0)), *_gn_of(head.cls_gn0), act="silu")
        taps[f"L{i}.c"] = c.abs().max()
        r = _gn(_conv_f(y, *_kb(head.reg_tower0)), *_gn_of(head.reg_gn0), act="silu")
        taps[f"L{i}.r"] = r.abs().max()
    return {k: float(v) for k, v in taps.items()}


@torch.no_grad()
def quantize_mnhead(head: MNHead, taps: Dict[str, float], level_scales: Sequence, num_classes: int) -> Dict:
    """The shared block, tower and prediction weights quantized once; the
    per-level scales (``level_scales``: the int8 scales of P3..P7)."""
    dev = head.cls_tower0.weight.device
    f32 = lambda t: t.detach().float()
    q: Dict = {"num_classes": int(num_classes)}
    for name, _, _ in HEAD_BLOCKS:
        q[name] = _quantize_mnblock(getattr(head, name))
    wc, swc = weight_qparams(f32(head.cls_tower0.weight), axis=0)
    wr, swr = weight_qparams(f32(head.reg_tower0.weight), axis=0)
    wpc, swpc = weight_qparams(f32(head.cls_pred.weight), axis=0)
    wcr, swcr = weight_qparams(torch.cat([f32(head.cnt_pred.weight), f32(head.reg_pred.weight)]), axis=0)
    q.update(wc=_port_layout(wc), wr=_port_layout(wr), gnc=_gn_of(head.cls_gn0), gnr=_gn_of(head.reg_gn0),
             wpc=_port_layout(wpc), wcr=_port_layout(wcr), bpc=f32(head.cls_pred.bias),
             bcr=torch.cat([f32(head.cnt_pred.bias), f32(head.reg_pred.bias)]),
             scale_exp=torch.stack([f32(getattr(head, f"scale{i}").scale).reshape(())
                                    for i in range(len(level_scales))]))
    levels = []
    for i, s_lv in enumerate(level_scales):
        lv: Dict = {}
        s_prev = torch.as_tensor(s_lv, dtype=torch.float32).to(dev)
        for name, _, _ in HEAD_BLOCKS:
            lv[name] = _block_scales(taps, f"L{i}.{name}", s_prev, dev)
            s_prev = lv[name]["s_out"]
        s_c, s_r = act_scale(taps[f"L{i}.c"]).to(dev), act_scale(taps[f"L{i}.r"]).to(dev)
        lv.update(Ac=s_prev * swc, inv_c=1.0 / s_c, Ar=s_prev * swr, inv_r=1.0 / s_r, Apc=s_c * swpc,
                  Acr=s_r * swcr)
        levels.append(lv)
    q["levels"] = levels
    return q


def mnhead_int8_forward(q: Dict, levels_q: Sequence[torch.Tensor], num_classes=None, backend: str = "xla"
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """Per-level f32 NHWC (cls, cnt, reg) from the int8 levels, reg through
    the level's ScaleExp (the float MNHead's output contract).
    ``num_classes`` is unused: the pred weights carry the class count.
    ``backend`` selects the MNBlocks' route (module docstring)."""
    _check_backend(backend)
    cls_l, cnt_l, reg_l = [], [], []
    for i, x_q in enumerate(levels_q):
        lv = q["levels"][i]
        y = x_q
        for name, kernel, dil in HEAD_BLOCKS:
            y = qmnblock(q[name], lv[name], y, kernel, dil, plain=backend == "xla")
        zc = conv_i8(y, q["wc"]) * lv["Ac"]
        c = clip8(_gn(zc, *q["gnc"], act="silu") * lv["inv_c"])
        zr = conv_i8(y, q["wr"]) * lv["Ar"]
        r = clip8(_gn(zr, *q["gnr"], act="silu") * lv["inv_r"])
        cls = conv_i8(c, q["wpc"]) * lv["Apc"] + q["bpc"]
        cr = conv_i8(r, q["wcr"]) * lv["Acr"] + q["bcr"]
        cls_l.append(cls)
        cnt_l.append(cr[..., :1])
        reg_l.append(torch.exp(cr[..., 1:5] * q["scale_exp"][i]))
    return cls_l, cnt_l, reg_l
