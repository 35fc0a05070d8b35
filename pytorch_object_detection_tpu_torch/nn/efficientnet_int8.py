"""int8 PTQ serving ladder of the EfficientNet-V1 backbone (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/nn/efficientnet_int8.py``, the
classic FCOS's other backbone:

  * the stem (3x3/2 conv on 3 channels) stays f32, its BN folded into the
    kernel; its SiLU output is the first quantization point;
  * every MBConv conv runs int8 x int8 -> exact int32: the 1x1 expand and
    project as ``ops/quant.conv_i8`` (im2col and ``torch._int_mm``), the kxk
    depthwise at stride 1 or 2 as ``ops/qhis.depthwise_i8`` (strided slices,
    only the strided outputs computed);
  * BN folds into the conv weights per output channel; the epilogue is
    ``acc * A + B``, SiLU, times the inverse output scale, round and clip;
  * the SE gate runs in f32 on the dequantized depthwise activation (after
    its SiLU), and multiplies it before the requant;
  * the residual adds ``x_q * res_mul`` (the block input's scale) in f32;
  * activations per tensor (abs-max calibration) at every requant point:
    ``<block>.e`` (after expand), ``<block>.d`` (after depthwise and SE),
    ``<block>.out``; weights per output channel (the depthwise's per
    channel).

The JAX ladder is XLA int8 convs outside any Pallas kernel, so no kernel of
the port runs here: the ladder is per-op on every device.  NHWC throughout;
every f32 operation in the JAX order.

The qtree of :func:`quantize_efficientnet`: ``stem`` {``kernel`` f32 OIHW,
``bn`` (mult, shift), ``inv``}, then ``blocks``, a list with per block an
optional ``expand`` and ``dw``, ``project`` {``w`` int8 (``[O, I]`` for the
1x1s, ``[k, k, C]`` for the depthwise), ``A``, ``B`` f32, ``inv``}, ``se``
{``w1 [C, r]``, ``b1``, ``w2 [r, C]``, ``b2``} f32 (the 1x1 kernels as
matmul operands), ``res_mul`` and ``s_out``; scalars are 0-d f32 tensors.
``train/checkpoints.load_efficientnet_qtree`` carries the JAX tree across.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from pytorch_object_detection_tpu_torch.models.mnfcos_int8 import _conv_f
from pytorch_object_detection_tpu_torch.nn.efficientnet import EfficientNet, _B0_BLOCKS, _round_repeats
from pytorch_object_detection_tpu_torch.nn.fused_resnet import fold_bn
from pytorch_object_detection_tpu_torch.nn.resnet_int8 import _port_layout
from pytorch_object_detection_tpu_torch.ops.qhis import _silu, depthwise_i8
from pytorch_object_detection_tpu_torch.ops.quant import act_scale, clip8, conv_i8, weight_qparams


def block_meta(width_mult: float = 1.0, depth_mult: float = 1.0) -> List[Dict]:
    """Per block, in order: name, stride, kernel, expand ratio, and whether
    the PREVIOUS block's output is a pyramid endpoint (the JAX ``block_meta``)."""
    meta: List[Dict] = []
    for expand, _, repeats, stride, kernel in _B0_BLOCKS:
        for r in range(_round_repeats(repeats, depth_mult)):
            s = stride if r == 0 else 1
            meta.append(dict(name=f"block{len(meta)}", stride=s, kernel=kernel, expand=expand,
                             endpoint_before=s == 2))
    return meta


def _se_gate(y_f: torch.Tensor, se: Dict) -> torch.Tensor:
    """The f32 squeeze-excite gate ``[B, 1, 1, C]`` of NHWC ``y_f``."""
    g = y_f.mean(dim=(1, 2))
    g = _silu(g @ se["w1"] + se["b1"])
    g = torch.sigmoid(g @ se["w2"] + se["b2"])
    return g[:, None, None, :]


def _se_params(se) -> Dict:
    """An SEBlock's f32 weights as matmul operands."""
    f32 = lambda t: t.detach().float()
    return {"w1": f32(se.fc1.weight)[:, :, 0, 0].t().contiguous(), "b1": f32(se.fc1.bias),
            "w2": f32(se.fc2.weight)[:, :, 0, 0].t().contiguous(), "b2": f32(se.fc2.bias)}


def _stem_f32(backbone: EfficientNet, x: torch.Tensor) -> torch.Tensor:
    mult, shift = fold_bn(backbone.stem_bn)
    k = backbone.stem_conv.weight.detach().float() * mult[:, None, None, None]
    return _silu(_conv_f(x.float(), k, stride=2) + shift)


def _folded(conv, bn) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kernel * mult per output channel, shift): the BN folded into the conv."""
    mult, shift = fold_bn(bn)
    return conv.weight.detach().float() * mult[:, None, None, None], shift


@torch.no_grad()
def calibrate_efficientnet(backbone: EfficientNet, images: torch.Tensor) -> Dict[str, float]:
    """Float forward (f32, NHWC, BN folded) recording the abs-max at every
    quantization point: ``stem``, and per block ``<name>.e`` / ``<name>.d``
    / ``<name>.out``."""
    taps: Dict[str, torch.Tensor] = {}
    x = _stem_f32(backbone, images)
    taps["stem"] = x.abs().max()
    for m in block_meta(backbone.width_mult, backbone.depth_mult):
        blk = getattr(backbone, m["name"])
        y = x
        if m["expand"] != 1:
            k, sh = _folded(blk.expand, blk.bn0)
            y = _silu(_conv_f(y, k) + sh)
            taps[f"{m['name']}.e"] = y.abs().max()
        k, sh = _folded(blk.dw, blk.bn1)
        y = _silu(_conv_f(y, k, stride=m["stride"], groups=y.shape[-1]) + sh)
        y = y * _se_gate(y, _se_params(blk.se))
        taps[f"{m['name']}.d"] = y.abs().max()
        k, sh = _folded(blk.project, blk.bn2)
        y = _conv_f(y, k) + sh
        if m["stride"] == 1 and x.shape[-1] == y.shape[-1]:
            y = x + y
        taps[f"{m['name']}.out"] = y.abs().max()
        x = y
    return {k: float(v) for k, v in taps.items()}


@torch.no_grad()
def quantize_efficientnet(backbone: EfficientNet, taps: Dict[str, float]) -> Dict:
    """Quantize the MBConv weights and fold every epilogue's scale algebra:
    the qtree :func:`efficientnet_int8_forward` takes (module doc); the
    float stem rides along."""
    dev = backbone.stem_conv.weight.device
    s_stem = act_scale(taps["stem"]).to(dev)
    q: Dict = {"stem": {"kernel": backbone.stem_conv.weight.detach().float(), "bn": fold_bn(backbone.stem_bn),
                        "inv": 1.0 / s_stem},
               "blocks": []}
    s_x = s_stem
    for m in block_meta(backbone.width_mult, backbone.depth_mult):
        blk = getattr(backbone, m["name"])
        e: Dict = {}
        if m["expand"] != 1:
            k, sh = _folded(blk.expand, blk.bn0)
            wq, sw = weight_qparams(k, axis=0)
            s_e = act_scale(taps[f"{m['name']}.e"]).to(dev)
            e["expand"] = dict(w=_port_layout(wq), A=s_x * sw, B=sh, inv=1.0 / s_e)
        else:
            s_e = s_x
        k, sh = _folded(blk.dw, blk.bn1)
        wq, sw = weight_qparams(k, axis=0)  # [C, 1, k, k]: per channel
        s_d = act_scale(taps[f"{m['name']}.d"]).to(dev)
        e["dw"] = dict(w=wq[:, 0].permute(1, 2, 0).contiguous(), A=s_e * sw, B=sh, inv=1.0 / s_d)
        e["se"] = _se_params(blk.se)
        k, sh = _folded(blk.project, blk.bn2)
        wq, sw = weight_qparams(k, axis=0)
        s_out = act_scale(taps[f"{m['name']}.out"]).to(dev)
        e["project"] = dict(w=_port_layout(wq), A=s_d * sw, B=sh, inv=1.0 / s_out)
        e["res_mul"] = s_x  # the block input's scale: x_q's dequant for the residual
        e["s_out"] = s_out
        q["blocks"].append(e)
        s_x = s_out
    return q


def expand_i8(blk: Dict, x_q: torch.Tensor) -> torch.Tensor:
    """The ``.e`` point: the 1x1 expand, BN folded, SiLU, requantized (the
    block input where the block has no expand)."""
    if "expand" not in blk:
        return x_q
    e = blk["expand"]
    return clip8(_silu(conv_i8(x_q, e["w"]) * e["A"] + e["B"]) * e["inv"])


def dw_se_i8(blk: Dict, stride: int, y_q: torch.Tensor) -> torch.Tensor:
    """The ``.d`` point: the depthwise at ``stride``, BN folded, SiLU, the
    f32 SE gate on that dequantized map, requantized."""
    d = blk["dw"]
    y_f = _silu(depthwise_i8(y_q, d["w"], stride=stride) * d["A"] + d["B"])
    return clip8(y_f * _se_gate(y_f, blk["se"]) * d["inv"])


def project_i8(blk: Dict, stride: int, y_q: torch.Tensor, x_q: torch.Tensor) -> torch.Tensor:
    """The ``.out`` point: the 1x1 project, BN folded, plus ``x_q * res_mul``
    at stride 1 with equal widths, requantized."""
    pr = blk["project"]
    y_f = conv_i8(y_q, pr["w"]) * pr["A"] + pr["B"]
    if stride == 1 and x_q.shape[-1] == pr["w"].shape[0]:  # [O, I]: the output width is axis 0
        y_f = y_f + x_q.float() * blk["res_mul"]
    return clip8(y_f * pr["inv"])


def mbconv_int8(blk: Dict, stride: int, x_q: torch.Tensor) -> torch.Tensor:
    """One MBConv on its int8 NHWC input: the block's int8 output."""
    return project_i8(blk, stride, dw_se_i8(blk, stride, expand_i8(blk, x_q)), x_q)


def stem_int8(st: Dict, images: torch.Tensor) -> torch.Tensor:
    """The f32 stem (BN folded) on NHWC float images, quantized."""
    mult, shift = st["bn"]
    y = _conv_f(images.float(), st["kernel"] * mult[:, None, None, None], stride=2)
    return clip8(_silu(y + shift) * st["inv"])


def efficientnet_int8_forward(qtree: Dict, images: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16,
                              dequant: bool = True, width_mult: float = 1.0, depth_mult: float = 1.0):
    """NHWC float images (normalized) -> the last three endpoints (C3, C4, C5).

    ``dequant=True``: the endpoints in ``compute_dtype`` (``q`` cast to
    ``compute_dtype``, times its scale in ``compute_dtype``, as JAX does).
    ``dequant=False``: ``([c3, c4, c5] int8, [s3, s4, s5] f32 scales)`` for
    the classic-FPN int8 ladder."""
    x_q = stem_int8(qtree["stem"], images)
    endpoints: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for m, blk in zip(block_meta(width_mult, depth_mult), qtree["blocks"]):
        if m["endpoint_before"]:
            endpoints.append((x_q, blk["res_mul"]))  # res_mul is the block input's scale
        x_q = mbconv_int8(blk, m["stride"], x_q)
    endpoints.append((x_q, qtree["blocks"][-1]["s_out"]))
    feats_q = [e for e, _ in endpoints[-3:]]
    scales = [s for _, s in endpoints[-3:]]
    if not dequant:
        return feats_q, scales
    return [f.float().to(compute_dtype) * s.to(compute_dtype) for f, s in zip(feats_q, scales)]

