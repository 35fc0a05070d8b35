"""int8 PTQ serving ladder for MC_FCOS: the FFM, the MBConv FPN, the refine stage and the head (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/models/mcfcos_int8.py``:

  * weights per output channel with the trailing BatchNorm folded into the
    conv (kernel * gamma/sigma, the bias into the f32 epilogue);
    activations per tensor (abs-max calibration) at every requant point;
    SiLU in the f32 epilogue before the requant;
  * the SE gate in f32 from the int8 tensor's mean (the exact int sum over
    H*W, divided, times the tensor's scale), applied as one
    dequant -> multiply -> requant pass at the SAME scale (the gate is at
    most 1, so nothing clips);
  * a channel concat feeding a 1x1 conv is split along the int8 kernel's
    input channels (``conv(cat[a, b]) = conv_a(a) + conv_b(b)``, each part
    at its own scale), so no cross-branch requant is needed; an
    elementwise sum of two int8 tensors (the top-down adds, the refine
    outputs) requantizes to a calibrated sum scale in one f32 pass;
  * the head's weights are shared across the 4 levels with PER-LEVEL
    activation scales; cnt and reg are packed into one 5-channel conv, and
    reg is the RAW conv output (MC_FCOS has no ScaleExp).

Every function repeats the JAX one's f32 operations in the JAX order, NHWC
throughout.  The neck and head are per-op ``ops/quant.conv_i8`` (exact
int32 sums) and plain PyTorch, as JAX computes them with XLA outside any
Pallas kernel; the backbone is the shared ResNet-50 ladder
(``nn/resnet_int8``: K1 for the raw uint8 frames and kernel C on the card).

The qtree of :func:`quantize_mcfcos_neck_head` has the JAX tree's keys:
each MCBlock (``mb_top``, ``ffm_mb1/2``, ``fpn_mb1/2/3``, ``refine_mb1/2``)
is {``s_out``, ``pw1`` {``w [C/2, Cin]`` int8, ``A`` a list of ``[C/2]``
(one per concat part), ``B``, ``inv``}, ``dw`` {``w [3, 3, C/2]`` int8,
``A``, ``B``, ``inv``}, ``se`` {``k1 [C/2, r]``, ``b1``, ``k2 [r, C/2]``,
``b2``, ``s_a2``}, ``pw3``, ``pw4``, ``pw5`` {``w``, ``A``, ``B``,
``inv``}}; ``ffm_pw1/2`` {``w``, ``A`` (two parts), ``B``, ``inv``},
``tf1`` {``w``, ``A``, ``B``, ``inv``}, ``p2in``, ``p3in``, ``h1``, ``h3``,
``h4`` {``m1``, ``m2``}, ``h2`` {``w [F, 3, 3, F]``, ``A``, ``m2``};
the head's ``wt0..3 [F, 3, 3, F]``, ``bt0..3``, ``wpc [nc, 3, 3, F]``,
``wcr [5, 3, 3, F]``, ``levels`` (per level ``A0..3``, ``inv0..3``,
``Apc``, ``Acr``) and ``num_classes``.  Scalars are 0-d f32 tensors.
``train/checkpoints.load_mcfcos_qtree`` carries the JAX tree across.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from pytorch_object_detection_tpu_torch.models.mcfcos import MC_FCOS, MC_TOWER, MCBlock
from pytorch_object_detection_tpu_torch.models.mnfcos_int8 import _conv_f, _kb
from pytorch_object_detection_tpu_torch.nn.fused_resnet import fold_bn
from pytorch_object_detection_tpu_torch.nn.resnet_int8 import _port_layout, resnet50_int8_forward
from pytorch_object_detection_tpu_torch.ops.qhis import _silu, depthwise3x3_i8, upsample2x_i8
from pytorch_object_detection_tpu_torch.ops.qpool import qmaxpool2x2_plain
from pytorch_object_detection_tpu_torch.ops.quant import act_scale, clip8, conv_i8, weight_qparams


def _fold(conv, bn) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel and bias of ``conv`` with the BatchNorm ``bn`` after it folded in."""
    k, b = _kb(conv)
    mult, shift = fold_bn(bn)
    k = k * mult[:, None, None, None]
    return k, shift if b is None else b * mult + shift


# ------------------------------------------------------------ MCBlock


def _se_gate(g: torch.Tensor, se: Dict) -> torch.Tensor:
    """The SE gate ``[B, C]`` from the channel means ``g [B, C]`` (f32)."""
    return torch.sigmoid(_silu(g @ se["k1"] + se["b1"]) @ se["k2"] + se["b2"])


def _mcblock_f32(blk: MCBlock, x: torch.Tensor, taps: Dict, prefix: str) -> torch.Tensor:
    """Float MCBlock (BN folded, as the JAX one) recording the abs-maxes at
    ``<prefix>.a1``, ``.a2``, ``.cat`` and ``.out``."""
    k, b = _fold(blk.pw1, blk.bn1)
    a1 = _silu(_conv_f(x, k, b))
    taps[f"{prefix}.a1"] = a1.abs().max()
    kdw, shift = _fold(blk.dw, blk.bn2)
    a2 = _silu(_conv_f(a1, kdw, shift, groups=a1.shape[-1]))
    taps[f"{prefix}.a2"] = a2.abs().max()
    g = a2.mean(dim=(1, 2))
    a2 = a2 * _se_gate(g, _se_params(blk))[:, None, None, :]
    y = _silu(_conv_f(a2, *_fold(blk.pw3, blk.bn3)))
    skip = _silu(_conv_f(a1, *_fold(blk.pw4, blk.bn4)))
    cat = torch.cat([y, skip], dim=-1)
    taps[f"{prefix}.cat"] = cat.abs().max()
    out = _silu(_conv_f(cat, *_fold(blk.pw5, blk.bn5)))
    taps[f"{prefix}.out"] = out.abs().max()
    return out


def _se_params(blk: MCBlock) -> Dict:
    """The SE's 1x1 convs as matmul operands: ``k1 [C, r]``, ``k2 [r, C]``."""
    k1, b1 = _kb(blk.se.fc1)
    k2, b2 = _kb(blk.se.fc2)
    return dict(k1=k1[:, :, 0, 0].t().contiguous(), b1=b1, k2=k2[:, :, 0, 0].t().contiguous(), b2=b2)


def _wq(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    wq, sw = weight_qparams(k, axis=0)
    return _port_layout(wq), sw


def _quantize_mcblock(blk: MCBlock, taps: Dict[str, float], prefix: str, s_in: Sequence, dev) -> Dict:
    """``s_in``: the input scale of each concat part (one for a plain input)."""
    sa1, sa2, scat, sout = (act_scale(taps[f"{prefix}.{t}"]).to(dev) for t in ("a1", "a2", "cat", "out"))
    q: Dict = {"s_out": sout}
    k, b = _fold(blk.pw1, blk.bn1)
    w, sw = _wq(k)
    q["pw1"] = dict(w=w, A=[torch.as_tensor(si, dtype=torch.float32).to(dev) * sw for si in s_in], B=b,
                    inv=1.0 / sa1)
    kdw, shift = _fold(blk.dw, blk.bn2)
    wdw, sw = weight_qparams(kdw, axis=0)  # [C, 1, 3, 3]
    q["dw"] = dict(w=wdw[:, 0].permute(1, 2, 0).contiguous(), A=sa1 * sw, B=shift, inv=1.0 / sa2)
    q["se"] = dict(_se_params(blk), s_a2=sa2)
    for name, bn, s_from, s_to in (("pw3", blk.bn3, sa2, scat), ("pw4", blk.bn4, sa1, scat),
                                   ("pw5", blk.bn5, scat, sout)):
        k, b = _fold(getattr(blk, name), bn)
        w, sw = _wq(k)
        q[name] = dict(w=w, A=s_from * sw, B=b, inv=1.0 / s_to)
    return q


def _split_conv(parts: Sequence[torch.Tensor], w: torch.Tensor, scales: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sum_i conv_i8(part_i, w[:, part_i's channels]) * scales[i]``: a 1x1
    conv of the concat of int8 parts at different scales."""
    off, acc = 0, None
    for x_q, a in zip(parts, scales):
        c = x_q.shape[-1]
        z = conv_i8(x_q, w[:, off:off + c].contiguous()) * a
        acc = z if acc is None else acc + z
        off += c
    return acc


def _mcblock_i8(q: Dict, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``parts``: int8 NHWC tensors in the input's concat order.  Returns the
    int8 block output at scale ``q["s_out"]``."""
    blk = q["pw1"]
    a1 = clip8(_silu(_split_conv(parts, blk["w"], blk["A"]) + blk["B"]) * blk["inv"])
    blk = q["dw"]
    a2 = clip8(_silu(depthwise3x3_i8(a1, blk["w"]) * blk["A"] + blk["B"]) * blk["inv"])
    se = q["se"]
    h, w = a2.shape[1:3]
    g = a2.float().sum(dim=(1, 2)) / float(h * w) * se["s_a2"]
    a2 = clip8(a2.float() * _se_gate(g, se)[:, None, None, :])  # the same scale: the gate is at most 1

    def pw(name, x_q):
        b = q[name]
        return clip8(_silu(conv_i8(x_q, b["w"]) * b["A"] + b["B"]) * b["inv"])

    return pw("pw5", torch.cat([pw("pw3", a2), pw("pw4", a1)], dim=-1))


# ------------------------------------------------------------ neck and head


@torch.no_grad()
def calibrate_mcfcos_neck_head(model: MC_FCOS, feats: Sequence[torch.Tensor]) -> Dict[str, float]:
    """Float post-backbone forward (f32, NHWC C3..C5, the BatchNorms folded)
    recording the abs-max at every requant point."""
    m = model
    c3, c4, c5 = [f.float() for f in feats]
    taps: Dict[str, torch.Tensor] = {}

    def mb(name, x):
        return _mcblock_f32(getattr(m, name), x, taps, name)

    x4 = mb("mb_top", qmaxpool2x2_plain(c5))
    t = _conv_f(torch.cat([c4, upsample2x_i8(c5)], dim=-1), *_kb(m.ffm_pw1))
    taps["ffm1"] = t.abs().max()
    x2 = mb("ffm_mb1", t)
    t = _conv_f(torch.cat([c3, upsample2x_i8(c4)], dim=-1), *_kb(m.ffm_pw2))
    taps["ffm2"] = t.abs().max()
    x1 = mb("ffm_mb2", t)
    x3 = _silu(_conv_f(c5, *_fold(m.tf1_conv, m.tf1_bn)))
    taps["tf1"] = x3.abs().max()
    p1 = mb("fpn_mb1", x3)
    t = upsample2x_i8(p1) + x2
    taps["p2in"] = t.abs().max()
    p2 = mb("fpn_mb2", t)
    t = upsample2x_i8(p2) + x1
    taps["p3in"] = t.abs().max()
    p3 = mb("fpn_mb3", t)
    c1 = mb("refine_mb1", torch.cat([upsample2x_i8(p1), p2], dim=-1))
    c1 = mb("refine_mb2", torch.cat([c1, qmaxpool2x2_plain(p3)], dim=-1))
    h1 = upsample2x_i8(c1) + p3
    taps["h1"] = h1.abs().max()
    h2 = _conv_f(c1, m.refine_conv.weight) + p2
    taps["h2"] = h2.abs().max()
    d = qmaxpool2x2_plain(c1)
    h3 = d + p1
    taps["h3"] = h3.abs().max()
    h4 = qmaxpool2x2_plain(d) + x4
    taps["h4"] = h4.abs().max()
    head = m.head
    for i, x in enumerate((h1, h2, h3, h4)):
        for j in range(MC_TOWER):
            k, b = _fold(getattr(head, f"conv{j}"), getattr(head, f"bn{j}"))
            x = _silu(_conv_f(x, k, b))
            taps[f"L{i}.t{j}"] = x.abs().max()
    return {k: float(v) for k, v in taps.items()}


@torch.no_grad()
def quantize_mcfcos_neck_head(model: MC_FCOS, taps: Dict[str, float], feat_scales: Sequence,
                              num_classes: int) -> Dict:
    """Quantize the neck and head; ``feat_scales`` are the int8 scales of
    (C3, C4, C5) from the quantized backbone."""
    m = model
    dev = m.ffm_pw1.weight.device
    s3, s4, s5 = (torch.as_tensor(s, dtype=torch.float32).to(dev) for s in feat_scales)
    a = {k: act_scale(v).to(dev) for k, v in taps.items()}
    q: Dict = {"num_classes": int(num_classes)}

    def mb(name, s_in):
        q[name] = _quantize_mcblock(getattr(m, name), taps, name, s_in, dev)
        return q[name]["s_out"]

    s_x4 = mb("mb_top", [s5])
    for name, s_lo, s_hi, tap in (("ffm_pw1", s4, s5, "ffm1"), ("ffm_pw2", s3, s4, "ffm2")):
        k, b = _kb(getattr(m, name))
        w, sw = _wq(k)
        q[name] = dict(w=w, A=[s_lo * sw, s_hi * sw], B=b, inv=1.0 / a[tap])
    s_x2 = mb("ffm_mb1", [a["ffm1"]])
    s_x1 = mb("ffm_mb2", [a["ffm2"]])
    k, b = _fold(m.tf1_conv, m.tf1_bn)
    w, sw = _wq(k)
    q["tf1"] = dict(w=w, A=s5 * sw, B=b, inv=1.0 / a["tf1"])
    s_p1 = mb("fpn_mb1", [a["tf1"]])
    q["p2in"] = dict(m1=s_p1 / a["p2in"], m2=s_x2 / a["p2in"])
    s_p2 = mb("fpn_mb2", [a["p2in"]])
    q["p3in"] = dict(m1=s_p2 / a["p3in"], m2=s_x1 / a["p3in"])
    s_p3 = mb("fpn_mb3", [a["p3in"]])
    s_c1a = mb("refine_mb1", [s_p1, s_p2])
    s_c1 = mb("refine_mb2", [s_c1a, s_p3])
    q["h1"] = dict(m1=s_c1 / a["h1"], m2=s_p3 / a["h1"])
    w, sw = _wq(m.refine_conv.weight.detach().float())
    q["h2"] = dict(w=w, A=s_c1 * sw / a["h2"], m2=s_p2 / a["h2"])
    q["h3"] = dict(m1=s_c1 / a["h3"], m2=s_p1 / a["h3"])
    q["h4"] = dict(m1=s_c1 / a["h4"], m2=s_x4 / a["h4"])

    head = m.head
    sws = []
    for j in range(MC_TOWER):
        k, b = _fold(getattr(head, f"conv{j}"), getattr(head, f"bn{j}"))
        q[f"wt{j}"], sw = _wq(k)
        q[f"bt{j}"] = b
        sws.append(sw)
    q["wpc"], swpc = _wq(head.cls.weight.detach().float())
    q["wcr"], swcr = _wq(torch.cat([head.cnt.weight.detach().float(), head.reg.weight.detach().float()]))
    levels = []
    for i, tap in enumerate(("h1", "h2", "h3", "h4")):
        s_prev = a[tap]
        lv: Dict = {}
        for j in range(MC_TOWER):
            s_t = a[f"L{i}.t{j}"]
            lv[f"A{j}"] = s_prev * sws[j]
            lv[f"inv{j}"] = 1.0 / s_t
            s_prev = s_t
        lv.update(Apc=s_prev * swpc, Acr=s_prev * swcr)
        levels.append(lv)
    q["levels"] = levels
    return q


def mcfcos_neck_int8(q: Dict, feats_q: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """(C3, C4, C5) int8 NHWC -> the four int8 head inputs h1..h4 (strides 8,
    16, 32, 64), at the scales ``act_scale`` of taps ``h1``..``h4``."""
    c3, c4, c5 = feats_q
    x4 = _mcblock_i8(q["mb_top"], [qmaxpool2x2_plain(c5)])

    def ffm(name, lo, hi):
        blk = q[name]
        return clip8((_split_conv([lo, upsample2x_i8(hi)], blk["w"], blk["A"]) + blk["B"]) * blk["inv"])

    x2 = _mcblock_i8(q["ffm_mb1"], [ffm("ffm_pw1", c4, c5)])
    x1 = _mcblock_i8(q["ffm_mb2"], [ffm("ffm_pw2", c3, c4)])
    blk = q["tf1"]
    x3 = clip8(_silu(conv_i8(c5, blk["w"]) * blk["A"] + blk["B"]) * blk["inv"])

    def add(name, a_q, b_q):
        blk = q[name]
        return clip8(a_q.float() * blk["m1"] + b_q.float() * blk["m2"])

    p1 = _mcblock_i8(q["fpn_mb1"], [x3])
    p2 = _mcblock_i8(q["fpn_mb2"], [add("p2in", upsample2x_i8(p1), x2)])
    p3 = _mcblock_i8(q["fpn_mb3"], [add("p3in", upsample2x_i8(p2), x1)])
    c1 = _mcblock_i8(q["refine_mb1"], [upsample2x_i8(p1), p2])
    c1 = _mcblock_i8(q["refine_mb2"], [c1, qmaxpool2x2_plain(p3)])
    h1 = add("h1", upsample2x_i8(c1), p3)
    blk = q["h2"]
    h2 = clip8(conv_i8(c1, blk["w"]) * blk["A"] + p2.float() * blk["m2"])
    d = qmaxpool2x2_plain(c1)
    return h1, h2, add("h3", d, p1), add("h4", qmaxpool2x2_plain(d), x4)


def mcfcos_tower_i8(q: Dict, lv: Dict, x_q: torch.Tensor, j: int) -> torch.Tensor:
    """Head tower stage ``j`` on its int8 input: int8 conv, the folded BN's
    epilogue, SiLU, the level's requant."""
    return clip8(_silu(conv_i8(x_q, q[f"wt{j}"]) * lv[f"A{j}"] + q[f"bt{j}"]) * lv[f"inv{j}"])


def mcfcos_neck_head_int8(q: Dict, feats_q: Sequence[torch.Tensor]
                          ) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """(C3, C4, C5) int8 NHWC -> per-level f32 NHWC (cls, cnt, reg) at strides
    (8, 16, 32, 64); reg is the raw conv output."""
    cls_l, cnt_l, reg_l = [], [], []
    for i, x in enumerate(mcfcos_neck_int8(q, feats_q)):
        lv = q["levels"][i]
        for j in range(MC_TOWER):
            x = mcfcos_tower_i8(q, lv, x, j)
        cr = conv_i8(x, q["wcr"]) * lv["Acr"]
        cls_l.append(conv_i8(x, q["wpc"]) * lv["Apc"])
        cnt_l.append(cr[..., :1])
        reg_l.append(cr[..., 1:5])
    return cls_l, cnt_l, reg_l


# ------------------------------------------------------------ one-shot


def quantize_mcfcos(model: MC_FCOS, calib_images: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16,
                    mean=None, std=None) -> Dict:
    """Full-detector PTQ: the shared ResNet-50 ladder
    (``train/trainer.quantize_backbone``, its scales calibrated in
    ``compute_dtype``) and the neck/head ladder, calibrated in f32 on the
    int8 backbone's dequantized C3..C5 (the per-op oracle with the float
    stem on the NORMALIZED ``calib_images``: the serving distribution).
    ``mean``/``std`` feed the exact uint8 stem (ImageNet's by default).
    Returns ``{"backbone": ..., "neck_head": ...}``."""
    from pytorch_object_detection_tpu_torch.train.trainer import _backbone_int8_feats, quantize_backbone

    qbb = quantize_backbone(model, calib_images, compute_dtype, mean=mean, std=std)
    feats_q, scales = _backbone_int8_feats(qbb, calib_images)
    feats = [fq.float() * s for fq, s in zip(feats_q, scales)]
    taps = calibrate_mcfcos_neck_head(model, feats)
    return {"backbone": qbb, "neck_head": quantize_mcfcos_neck_head(model, taps, scales, model.num_classes)}


def mcfcos_int8_forward(qtree: Dict, images: torch.Tensor, backend: str = "xla", u8_stem: bool = False,
                        fuse_strided: bool = False, plain: bool = False
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """Images (normalized f32 NHWC, or raw uint8 frames with ``u8_stem``) ->
    per-level f32 NHWC (cls, cnt, reg), MC_FCOS's output contract.  The
    backbone follows ``backend``, ``fuse_strided`` and ``plain`` as
    ``nn/resnet_int8.resnet50_int8_forward`` says (the JAX function takes
    its ``fuse_strided=False`` default; ``eval/evaluator.make_eval_pipeline_int8``
    passes its own, True by default: all 16 blocks on kernel C)."""
    feats_q, _ = resnet50_int8_forward(qtree["backbone"], images, torch.float32, backend=backend,
                                       fuse_strided=fuse_strided, dequant=False, u8_stem=u8_stem, plain=plain)
    return mcfcos_neck_head_int8(qtree["neck_head"], feats_q)
