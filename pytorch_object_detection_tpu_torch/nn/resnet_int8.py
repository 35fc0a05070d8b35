"""int8 PTQ inference forward for the ResNet-50 backbone (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/nn/resnet_int8.py``: BN is
folded into the conv weights, weights are quantized per output channel,
activations per tensor (abs-max calibration), and every bottleneck runs
int8 x int8 -> int32 with one f32 epilogue per conv:

  a1 = requant(conv(x_q, W1q) * A1 + B1, relu)
  a2 = requant(conv(a1, W2q) * A2 + B2, relu)             (stride here)
  sc = x_q * short_mul  |  conv(x_q, Wdq) * Ad + Bd        (stride here)
  out_q = requant((conv(a2, W3q) * A3 + B3) + sc, relu)

The stem (7x7/2 on 3 channels) stays float in the compute dtype.  The int8
backbone runs NHWC, the JAX package's layout and the one kernel C takes;
the float modules around it run NCHW.

Ported: the 7x7 stem (``u8_stem=False``), ``backend="xla"`` (the per-op
oracle, ``ops/qblock.qbottleneck_plain``) and ``backend="pallas_block"``
with ``fuse_strided=True`` (every block on kernel C).  Left for later
slices, each raising ``NotImplementedError``: the exact uint8
space-to-depth stem (``u8_stem=True``, ``quantize_stem_s2d`` and the
qtree's ``stem_s2d`` entry, ROADMAP queue 2 K1), the per-conv kernels
(``backend="pallas"`` and ``fuse_strided=False``, K4 and K11) and the bf16
stem tail (``backend="pallas_stem_tail"``, K17).

The qtree (from :func:`quantize_resnet50` or
``train/checkpoints.load_backbone_qtree``): ``stem`` {``kernel`` f32 OIHW,
``bn`` {``scale``, ``bias``, ``mean``, ``var``}}, ``stem_scale``, and per
block ``w1 [Cw, Cin]``, ``w2 [Cw, 3, 3, Cw]``, ``w3 [Cout, Cw]`` int8,
``A1..B3`` f32, then ``wd [Cout, Cin]``, ``Ad``, ``Bd`` (projection) or
``short_mul`` (identity), and ``out_scale``.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from pytorch_object_detection_tpu_torch.nn.fused_resnet import conv_bn_act, fold_bn, fold_bn_params
from pytorch_object_detection_tpu_torch.nn.resnet import ResNet50
from pytorch_object_detection_tpu_torch.ops.qblock import qbottleneck, qbottleneck_plain, qbottleneck_s2
from pytorch_object_detection_tpu_torch.ops.quant import act_scale, quantize_act, weight_qparams

STAGE_SIZES = (3, 4, 6, 3)
BACKENDS = ("xla", "pallas_block")
_NOT_PORTED = {
    "pallas": "ROADMAP.md queue 2, K4 (qmatmul / qconv1x1) and K11 (qconv3x3): the per-conv kernels",
    "pallas_stem_tail": "ROADMAP.md queue 2, K17 (stem_bn_pool_quant)",
}


def block_scopes() -> Iterator[Tuple[str, int, int]]:
    """(scope, stage, block) of the 16 bottlenecks; stride 2 where
    ``block == 0 and stage > 0``."""
    for stage, blocks in enumerate(STAGE_SIZES):
        for b in range(blocks):
            yield f"layer{stage + 1}_{b}", stage, b


def _stem_float(kernel: torch.Tensor, mult: torch.Tensor, shift: torch.Tensor, images: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
    """7x7/2 conv + BN + ReLU in ``compute_dtype``: NHWC images -> NCHW."""
    x = images.permute(0, 3, 1, 2).to(compute_dtype)
    y = F.conv2d(x, kernel.to(compute_dtype), None, 2, 3)
    return torch.relu(y * mult.to(y.dtype)[:, None, None] + shift.to(y.dtype)[:, None, None])


def maxpool3x3s2_i8(x: torch.Tensor) -> torch.Tensor:
    """int8 3x3/2 max pool, padding 1 (pad value -128), NHWC."""
    xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=-128)
    ho, wo = (x.shape[1] - 1) // 2 + 1, (x.shape[2] - 1) // 2 + 1
    out = None
    for ky in range(3):
        for kx in range(3):
            win = xp[:, ky:ky + 2 * ho - 1:2, kx:kx + 2 * wo - 1:2]
            out = win if out is None else torch.maximum(out, win)
    return out.contiguous()


@torch.no_grad()
def calibrate_resnet50(backbone: ResNet50, images: torch.Tensor,
                       compute_dtype: torch.dtype = torch.bfloat16) -> Dict[str, float]:
    """Float forward recording the abs-max at every quantization point.

    ``images`` NHWC normalized floats.  Returns {tap: float} with taps
    ``stem_out`` and per block ``<scope>.a1``, ``.a2``, ``.out``.
    """
    taps = {}
    mult, shift = fold_bn(backbone.bn1)
    x = F.max_pool2d(_stem_float(backbone.conv1.weight, mult, shift, images, compute_dtype), 3, 2, padding=1)
    taps["stem_out"] = x.float().abs().max()
    for scope, _, _ in block_scopes():
        blk = getattr(backbone, scope)
        y = conv_bn_act(x, blk.conv1, *fold_bn(blk.bn1))
        taps[f"{scope}.a1"] = y.float().abs().max()
        y = conv_bn_act(y, blk.conv2, *fold_bn(blk.bn2))
        taps[f"{scope}.a2"] = y.float().abs().max()
        if blk.has_projection:
            shortcut = conv_bn_act(x, blk.downsample_conv, *fold_bn(blk.downsample_bn), act=False)
        else:
            shortcut = x
        y = conv_bn_act(y, blk.conv3, *fold_bn(blk.bn3), act=False)
        x = torch.relu(y + shortcut)
        taps[f"{scope}.out"] = x.float().abs().max()
    return {k: float(v) for k, v in taps.items()}


def _port_layout(w_q: torch.Tensor) -> torch.Tensor:
    """int8 OIHW -> the kernel layout: [O, H, W, I], a 1x1 as [O, I]."""
    w = w_q.permute(0, 2, 3, 1).contiguous()
    return w.reshape(w.shape[0], -1) if w.shape[1:3] == (1, 1) else w


@torch.no_grad()
def quantize_resnet50(backbone: ResNet50, act_absmax: Dict[str, float]) -> Dict:
    """Fold BN, quantize weights, and pre-fold all scale algebra.

    act_absmax: the taps of :func:`calibrate_resnet50` (reduced with max over
    calibration batches).  Returns the qtree :func:`resnet50_int8_forward`
    takes.  The JAX function's ``mean``/``std`` arguments (the u8
    space-to-depth stem's ``stem_s2d`` entry) are left out with that stem.
    """
    bn = backbone.bn1
    q = {
        "stem": {"kernel": backbone.conv1.weight.detach().float().clone(),
                 "bn": {"scale": bn.weight.float().clone(), "bias": bn.bias.float().clone(),
                        "mean": bn.running_mean.float().clone(), "var": bn.running_var.float().clone()}},
        "stem_scale": act_scale(act_absmax["stem_out"]).to(bn.weight.device),
    }
    s_prev = q["stem_scale"]
    for scope, _, _ in block_scopes():
        blk = getattr(backbone, scope)
        s_in = s_prev
        s_a1, s_a2, s_out = (act_scale(act_absmax[f"{scope}.{t}"]).to(s_in.device) for t in ("a1", "a2", "out"))

        def folded(conv, bn_mod):
            m, sh = fold_bn(bn_mod)
            w_q, sw = weight_qparams(conv.weight.float() * m[:, None, None, None], axis=0)
            return _port_layout(w_q), sw, sh

        out = {}
        w1, sw1, b1 = folded(blk.conv1, blk.bn1)
        out.update(w1=w1, A1=s_in * sw1 / s_a1, B1=b1 / s_a1)
        w2, sw2, b2 = folded(blk.conv2, blk.bn2)
        out.update(w2=w2, A2=s_a1 * sw2 / s_a2, B2=b2 / s_a2)
        w3, sw3, b3 = folded(blk.conv3, blk.bn3)
        out.update(w3=w3, A3=s_a2 * sw3 / s_out, B3=b3 / s_out)
        if blk.has_projection:
            wd, swd, bd = folded(blk.downsample_conv, blk.downsample_bn)
            out.update(wd=wd, Ad=s_in * swd / s_out, Bd=bd / s_out)
        else:
            out["short_mul"] = s_in / s_out
        out["out_scale"] = s_out
        q[scope] = out
        s_prev = s_out
    return q


def bottleneck_int8(blk: Dict, x_q: torch.Tensor, stride: int, backend: str = "xla",
                    plain: bool = False) -> torch.Tensor:
    """One int8 bottleneck of the qtree on int8 NHWC ``x_q``.
    ``backend="xla"`` runs the per-op oracle, ``"pallas_block"`` kernel C
    (K2 at stride 1, K3 at stride 2; its plain version on a CPU tensor or
    with ``plain=True``)."""
    common = (x_q, blk["w1"], blk["w2"], blk["w3"])
    vecs = (blk["A1"], blk["B1"], blk["A2"], blk["B2"], blk["A3"], blk["B3"])
    short = dict(wd=blk["wd"], ad=blk["Ad"], bd=blk["Bd"]) if "wd" in blk else dict(short_mul=blk["short_mul"])
    if backend == "xla":
        return qbottleneck_plain(*common, *vecs, stride=stride, **short)
    if stride == 1:
        return qbottleneck(*common, *vecs, plain=plain, **short)
    return qbottleneck_s2(*common, blk["wd"], *vecs, blk["Ad"], blk["Bd"], plain=plain)


def resnet50_int8_ladder(qtree: Dict, x_q: torch.Tensor, backend: str = "xla", plain: bool = False):
    """The 16 int8 bottlenecks (:func:`bottleneck_int8`) from the stem's
    pooled int8 NHWC output: [(x_q, out_scale)] after each of the four
    stages."""
    outputs = []
    for scope, stage, b in block_scopes():
        blk = qtree[scope]
        x_q = bottleneck_int8(blk, x_q, 2 if (b == 0 and stage > 0) else 1, backend, plain)
        if b == STAGE_SIZES[stage] - 1:
            outputs.append((x_q, blk["out_scale"]))
    return outputs


def resnet50_int8_stem(qtree: Dict, images: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16,
                       backend: str = "xla") -> torch.Tensor:
    """The stem's pooled int8 NHWC output from NHWC normalized images:
    float conv, BN, ReLU in ``compute_dtype``, then ``backend="xla"``: float
    3x3/2 max pool and quantize; ``"pallas_block"``: quantize and the int8
    max pool (the same int8 values, see :func:`resnet50_int8_forward`)."""
    stem = qtree["stem"]
    mult, shift = fold_bn_params(**stem["bn"])
    x = _stem_float(stem["kernel"], mult, shift, images, compute_dtype)
    if backend == "xla":
        x = F.max_pool2d(x, 3, 2, padding=1)
        return quantize_act(x, qtree["stem_scale"]).permute(0, 2, 3, 1).contiguous()
    return maxpool3x3s2_i8(quantize_act(x, qtree["stem_scale"]).permute(0, 2, 3, 1))


def resnet50_int8_forward(qtree: Dict, images: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16,
                          backend: str = "xla", fuse_strided: bool = False, dequant: bool = True,
                          u8_stem: bool = False, plain: bool = False):
    """(C3, C4, C5) NHWC in ``compute_dtype`` from an int8-quantized backbone.

    ``images``: NHWC normalized floats.  ``dequant=False`` instead returns
    ``((c3_q, c4_q, c5_q) int8 NHWC, (s3, s4, s5))``.

    ``backend="xla"``: float stem, float 3x3/2 max pool, quantize, then the
    per-op oracle for every block.  ``backend="pallas_block"`` (needs
    ``fuse_strided=True``): float stem, quantize, then the int8 max pool
    (max commutes with the monotone quantize, so the two stems agree bit
    for bit given the same float conv output), then kernel C for every
    block (``ops/qblock``; its plain version on a CPU tensor or with
    ``plain=True``).
    """
    if u8_stem:
        raise NotImplementedError(
            "u8_stem=True (the exact uint8 space-to-depth stem) is not ported yet: "
            "ROADMAP.md queue 1 item 4 (s2d stem and u8 path) and queue 2 K1 (qstem_conv)")
    if backend in _NOT_PORTED:
        raise NotImplementedError(f"backend={backend!r} is not ported yet: {_NOT_PORTED[backend]}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    if backend == "pallas_block" and not fuse_strided:
        raise NotImplementedError(
            "fuse_strided=False (stride-2 blocks on the per-conv kernels) is not ported yet: "
            f"{_NOT_PORTED['pallas']}")

    outputs = resnet50_int8_ladder(qtree, resnet50_int8_stem(qtree, images, compute_dtype, backend), backend, plain)
    if not dequant:
        return tuple(q for q, _ in outputs[-3:]), tuple(s for _, s in outputs[-3:])
    return tuple((q.float() * s).to(compute_dtype) for q, s in outputs[-3:])
