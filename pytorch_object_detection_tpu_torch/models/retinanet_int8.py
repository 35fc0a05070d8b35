"""int8 PTQ serving ladder for RetinaNet: the RetinaFPN and the two subnets (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/models/retinanet_int8.py``,
the FCOS-family scheme (``models/fcos_int8.py``):

  * weights per output channel, activations per tensor (abs-max
    calibration) at every requant point;
  * the RetinaFPN's BatchNorms fold into the conv kernels and a bias that
    rides the f32 epilogue ``relu(acc * A + B)``; the ReLU comes BEFORE the
    top-down add, which adds the 2x-upsampled int8 partner at its scale
    ratio (``t5_to_m4``, ``m4_to_m3``) before the one round;
  * the subnets' tower and prediction weights are shared across levels,
    their activation scales PER LEVEL; the predictions come out in f32.

Every function repeats the JAX one's f32 operations in the JAX order, NHWC
throughout, and every FPN and subnet conv is the per-op
``ops/quant.conv_i8`` (im2col and ``torch._int_mm``, exact int32 sums), as
JAX runs them with XLA's int8 convs: no kernel of the port.  The backbone is
``nn/resnet_int8.resnet50_int8_forward`` on NORMALIZED float frames in
f32, with JAX's ``fuse_strided=False``: on ``backend="pallas_block"`` its 13
stride-1 blocks run on kernel C (K2) and the three stride-2 blocks in the
per-conv form (w1, wd and w3 on K4, conv2 the plain strided int8 conv).

The qtree of :func:`quantize_retinanet`: ``{"backbone", "fpn", "head"}``;
``fpn`` holds ``p5_1 .. p7`` {``w`` int8 ``[F, Cin]`` (1x1) or ``[F, 3, 3,
Cin]``, ``A``, ``B`` f32 ``[F]``}, ``t5_to_m4``, ``m4_to_m3`` and
``scales`` {``t5 p5 m4 p4 m3 p3 p6 p7``}; ``head`` holds ``wc0..3``,
``wr0..3`` ``[F, 3, 3, F]``, ``wpc [A*C, 3, 3, F]``, ``wpr [A*4, 3, 3, F]``
int8, the biases ``bc0..3``, ``br0..3``, ``bpc``, ``bpr``, the prediction
weight scales ``spc``, ``spr``, and ``levels`` (per level ``Ac0..3``,
``Bc0..3``, ``Ar0..3``, ``Br0..3``, ``Apc``, ``Apr``); scalars are 0-d f32
tensors.  ``train/checkpoints.load_retinanet_qtree`` carries the JAX
package's tree across.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from pytorch_object_detection_tpu_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from pytorch_object_detection_tpu_torch.models.mnfcos_int8 import _conv_f, _kb
from pytorch_object_detection_tpu_torch.models.retinanet import FPN_BLOCKS, NUM_TOWER, RetinaFPN, RetinaNet
from pytorch_object_detection_tpu_torch.nn.fused_resnet import fold_bn
from pytorch_object_detection_tpu_torch.nn.resnet_int8 import (
    _port_layout,
    calibrate_resnet50,
    quantize_resnet50,
    resnet50_int8_forward,
)
from pytorch_object_detection_tpu_torch.ops.qhis import upsample2x_i8
from pytorch_object_detection_tpu_torch.ops.quant import act_scale, clip8, conv_i8, weight_qparams

FPN_TAPS = ("t5", "p5", "m4", "p4", "m3", "p3", "p6", "p7")


def _cba_folded(fpn: RetinaFPN, scope: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One conv + BN block's BN-folded (OIHW kernel, bias), f32."""
    mult, add = fold_bn(getattr(fpn, f"{scope}_bn"))
    return getattr(fpn, f"{scope}_conv").weight.detach().float() * mult[:, None, None, None], add


# ------------------------------------------------------------ RetinaFPN


@torch.no_grad()
def calibrate_retinafpn(fpn: RetinaFPN, feats: Sequence[torch.Tensor]) -> Dict[str, float]:
    """The BN-folded float FPN (f32, NHWC C3..C5) recording the abs-max at
    every requant point (:data:`FPN_TAPS`)."""
    c3, c4, c5 = [f.float() for f in feats]
    kb = {name: _cba_folded(fpn, name) for name, _, _, _ in FPN_BLOCKS}
    r = torch.relu
    taps: Dict[str, torch.Tensor] = {}
    t5 = r(_conv_f(c5, *kb["p5_1"]))
    taps["t5"] = t5.abs().max()
    taps["p5"] = r(_conv_f(t5, *kb["p5_2"])).abs().max()
    m4 = r(_conv_f(c4, *kb["p4_1"])) + upsample2x_i8(t5)
    taps["m4"] = m4.abs().max()
    taps["p4"] = r(_conv_f(m4, *kb["p4_2"])).abs().max()
    m3 = r(_conv_f(c3, *kb["p3_1"])) + upsample2x_i8(m4)
    taps["m3"] = m3.abs().max()
    taps["p3"] = r(_conv_f(m3, *kb["p3_2"])).abs().max()
    p6 = r(_conv_f(c5, *kb["p6"], stride=2))
    taps["p6"] = p6.abs().max()
    taps["p7"] = r(_conv_f(p6, *kb["p7"], stride=2)).abs().max()
    return {k: float(v) for k, v in taps.items()}


@torch.no_grad()
def quantize_retinafpn(fpn: RetinaFPN, taps: Dict[str, float], feat_scales: Sequence) -> Dict:
    """Quantize the BN-folded FPN weights and fold the epilogue scales;
    ``feat_scales``: the int8 scales of C3, C4, C5."""
    s3, s4, s5 = [torch.as_tensor(x, dtype=torch.float32) for x in feat_scales]
    dev = s5.device
    s = {k: act_scale(v).to(dev) for k, v in taps.items()}
    q: Dict = {"scales": dict(s)}

    def blk(scope, s_in, s_out):
        k, b = _cba_folded(fpn, scope)
        wq, sw = weight_qparams(k, axis=0)
        return dict(w=_port_layout(wq), A=s_in * sw / s_out, B=b / s_out)

    for scope, s_in, s_out in (("p5_1", s5, s["t5"]), ("p5_2", s["t5"], s["p5"]), ("p4_1", s4, s["m4"]),
                               ("p4_2", s["m4"], s["p4"]), ("p3_1", s3, s["m3"]), ("p3_2", s["m3"], s["p3"]),
                               ("p6", s5, s["p6"]), ("p7", s["p6"], s["p7"])):
        q[scope] = blk(scope, s_in, s_out)
    q["t5_to_m4"] = s["t5"] / s["m4"]
    q["m4_to_m3"] = s["m4"] / s["m3"]
    return q


def _rq(x_q: torch.Tensor, blk: Dict, stride: int = 1, partner=None, p_mul=None) -> torch.Tensor:
    """One block's requant: ``relu(acc * A + B)`` (the ReLU BEFORE the add),
    plus the int8 partner at ``p_mul``, rounded once."""
    y = torch.clamp(conv_i8(x_q, blk["w"], stride) * blk["A"] + blk["B"], min=0.0)
    if partner is not None:
        y = y + partner.float() * p_mul
    return clip8(y)


def retinafpn_int8_forward(qtree: Dict, feats_q: Sequence[torch.Tensor], compute_dtype: torch.dtype = torch.bfloat16,
                           dequant: bool = True):
    """int8 NHWC (C3, C4, C5) -> the five int8 pyramid levels and their
    scales (``dequant=False``), or the levels dequantized to ``compute_dtype``."""
    c3, c4, c5 = feats_q
    t5 = _rq(c5, qtree["p5_1"])
    p5 = _rq(t5, qtree["p5_2"])
    m4 = _rq(c4, qtree["p4_1"], partner=upsample2x_i8(t5), p_mul=qtree["t5_to_m4"])
    p4 = _rq(m4, qtree["p4_2"])
    m3 = _rq(c3, qtree["p3_1"], partner=upsample2x_i8(m4), p_mul=qtree["m4_to_m3"])
    p3 = _rq(m3, qtree["p3_2"])
    p6 = _rq(c5, qtree["p6"], stride=2)
    p7 = _rq(p6, qtree["p7"], stride=2)
    levels = [p3, p4, p5, p6, p7]
    s = qtree["scales"]
    scales = [s["p3"], s["p4"], s["p5"], s["p6"], s["p7"]]
    if not dequant:
        return levels, scales
    return [lv.float().to(compute_dtype) * sc.to(compute_dtype) for lv, sc in zip(levels, scales)]


# ------------------------------------------------------------ subnets


def _subnet_kb(model: RetinaNet, branch: str, scope: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(OIHW kernel, bias) f32 of ``classification``/``regression`` ``scope``."""
    return _kb(getattr(getattr(model, branch), scope))


@torch.no_grad()
def calibrate_retinahead(model: RetinaNet, levels: Sequence[torch.Tensor]) -> Dict[str, float]:
    """Float subnet towers (f32, NHWC levels) recording the per-level abs-max
    after every tower conv + ReLU: ``L<i>.c<j>`` and ``L<i>.r<j>``."""
    taps: Dict[str, torch.Tensor] = {}
    for i, x in enumerate(levels):
        c = r = x.float()
        for j in range(NUM_TOWER):
            c = torch.relu(_conv_f(c, *_subnet_kb(model, "classification", f"conv{j}")))
            taps[f"L{i}.c{j}"] = c.abs().max()
            r = torch.relu(_conv_f(r, *_subnet_kb(model, "regression", f"conv{j}")))
            taps[f"L{i}.r{j}"] = r.abs().max()
    return {k: float(v) for k, v in taps.items()}


@torch.no_grad()
def quantize_retinahead(model: RetinaNet, taps: Dict[str, float], level_scales: Sequence) -> Dict:
    """The shared tower and prediction weights quantized once, the
    per-level epilogues folded (each level's input scale ``level_scales``)."""
    q: Dict = {}
    swc, swr = [], []
    for j in range(NUM_TOWER):
        for branch, key, sws in (("classification", "c", swc), ("regression", "r", swr)):
            k, b = _subnet_kb(model, branch, f"conv{j}")
            wq, sw = weight_qparams(k, axis=0)
            q[f"w{key}{j}"], q[f"b{key}{j}"] = _port_layout(wq), b
            sws.append(sw)
    for branch, key in (("classification", "c"), ("regression", "r")):
        k, b = _subnet_kb(model, branch, "out")
        wq, q[f"sp{key}"] = weight_qparams(k, axis=0)
        q[f"wp{key}"], q[f"bp{key}"] = _port_layout(wq), b

    levels = []
    for i, s_lv in enumerate(level_scales):
        s_prev_c = s_prev_r = torch.as_tensor(s_lv, dtype=torch.float32)
        lv: Dict = {}
        for j in range(NUM_TOWER):
            s_c = act_scale(taps[f"L{i}.c{j}"]).to(s_prev_c.device)
            s_r = act_scale(taps[f"L{i}.r{j}"]).to(s_prev_r.device)
            lv[f"Ac{j}"] = s_prev_c * swc[j] / s_c
            lv[f"Bc{j}"] = q[f"bc{j}"] / s_c
            lv[f"Ar{j}"] = s_prev_r * swr[j] / s_r
            lv[f"Br{j}"] = q[f"br{j}"] / s_r
            s_prev_c, s_prev_r = s_c, s_r
        lv["Apc"] = s_prev_c * q["spc"]
        lv["Apr"] = s_prev_r * q["spr"]
        levels.append(lv)
    q["levels"] = levels
    return q


def retinahead_int8_forward(q: Dict, levels_q: Sequence[torch.Tensor], num_anchors: int = 9,
                            num_classes: int = 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-level int8 towers -> (loc ``[B, N, 4]``, cls ``[B, N, C]``) f32,
    RetinaNet's output contract."""
    locs: List[torch.Tensor] = []
    clss: List[torch.Tensor] = []
    for i, x_q in enumerate(levels_q):
        lv = q["levels"][i]
        c = r = x_q
        for j in range(NUM_TOWER):
            c = clip8(torch.clamp(conv_i8(c, q[f"wc{j}"]) * lv[f"Ac{j}"] + lv[f"Bc{j}"], min=0.0))
            r = clip8(torch.clamp(conv_i8(r, q[f"wr{j}"]) * lv[f"Ar{j}"] + lv[f"Br{j}"], min=0.0))
        cls = conv_i8(c, q["wpc"]) * lv["Apc"] + q["bpc"]
        loc = conv_i8(r, q["wpr"]) * lv["Apr"] + q["bpr"]
        b = loc.shape[0]
        locs.append(loc.reshape(b, -1, 4))
        clss.append(cls.reshape(b, -1, num_classes))
    return torch.cat(locs, dim=1), torch.cat(clss, dim=1)


# ------------------------------------------------------------ the whole ladder


@torch.no_grad()
def quantize_retinanet(model: RetinaNet, calib_images: torch.Tensor, backend: str = "xla",
                       compute_dtype: torch.dtype = torch.bfloat16, plain: bool = False) -> Dict:
    """PTQ of the whole RetinaNet on a representative NORMALIZED NHWC batch
    on the model's device: the backbone calibrated in ``compute_dtype``
    (the JAX function's ``quantize_backbone`` default, bf16), its int8 C3..C5
    through ``backend`` in f32 (the distribution the FPN sees when serving),
    the FPN's scales on their dequantized values, the subnets' on the int8
    FPN's dequantized levels.  Returns ``{"backbone", "fpn", "head"}``."""
    q_bb = quantize_resnet50(model.backbone, calibrate_resnet50(model.backbone, calib_images, compute_dtype),
                             IMAGENET_MEAN, IMAGENET_STD)
    feats_q, feat_scales = resnet50_int8_forward(q_bb, calib_images, torch.float32, backend=backend, dequant=False,
                                                 plain=plain)
    feats = [f.float() * s for f, s in zip(feats_q, feat_scales)]
    q_fpn = quantize_retinafpn(model.fpn, calibrate_retinafpn(model.fpn, feats), feat_scales)
    levels_q, level_scales = retinafpn_int8_forward(q_fpn, feats_q, dequant=False)
    levels = [lv.float() * s for lv, s in zip(levels_q, level_scales)]
    q_head = quantize_retinahead(model, calibrate_retinahead(model, levels), level_scales)
    return {"backbone": q_bb, "fpn": q_fpn, "head": q_head}


@torch.inference_mode()
def retinanet_int8_forward(model: RetinaNet, qtree: Dict, images: torch.Tensor, backend: str = "xla",
                           plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """NORMALIZED NHWC images -> (loc, cls) f32 through the whole int8
    ladder.  The backbone runs on ``backend`` (``nn/resnet_int8``; its
    kernels' plain versions on a CPU tensor or with ``plain=True``), the FPN
    and subnets per-op."""
    feats_q, _ = resnet50_int8_forward(qtree["backbone"], images, torch.float32, backend=backend, dequant=False,
                                       plain=plain)
    levels_q, _ = retinafpn_int8_forward(qtree["fpn"], feats_q, dequant=False)
    return retinahead_int8_forward(qtree["head"], levels_q, model.num_anchors, model.num_classes)
