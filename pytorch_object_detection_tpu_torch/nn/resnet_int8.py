"""int8 PTQ inference forward for the ResNet-50 backbone (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/nn/resnet_int8.py``: BN is
folded into the conv weights, weights are quantized per output channel,
activations per tensor (abs-max calibration), and every bottleneck runs
int8 x int8 -> int32 with one f32 epilogue per conv:

  a1 = requant(conv(x_q, W1q) * A1 + B1, relu)
  a2 = requant(conv(a1, W2q) * A2 + B2, relu)             (stride here)
  sc = x_q * short_mul  |  conv(x_q, Wdq) * Ad + Bd        (stride here)
  out_q = requant((conv(a2, W3q) * A3 + B3) + sc, relu)

The float stem (7x7/2 on 3 channels, ``u8_stem=False``) runs in the
compute dtype.  The exact uint8 stem (``u8_stem=True``) takes raw frames:
the normalize affine and the BN fold live in its int8 weights and f32
epilogue (:func:`quantize_stem_s2d`), so the conv input is ``u - 128`` with
no quantization at all; it runs as K1 (``ops/qstem.py``), or with
``direct_stem=True`` as the direct 7x7/2 int8 conv in plain PyTorch and K10
(``ops/qpool.qmaxpool3x3s2``).  The int8 backbone runs NHWC, the JAX
package's layout and the one the kernels take; the float modules around it
run NCHW.

Every JAX backend is ported: ``"xla"`` (the per-op oracle), ``"pallas"``
(the per-conv kernels: K4 for the 1x1 convs, K11 for the stride-1 3x3),
``"pallas_block"`` (kernel C per bottleneck; with ``fuse_strided=False``
the stride-2 blocks take the per-conv form; with ``chain_segments=True``
the three backbone segments run as K13) and ``"pallas_stem_tail"`` (the
bf16 stem tail on K17, then the per-op oracle).  The JAX function's TPU
input forms of the u8 stem (the 5-D RGBX view and its environment switches)
have no counterpart: frames come as ``[B, H, W, 3]`` or RGBX ``[B, H, W,
4]``.

The qtree (from :func:`quantize_resnet50` or
``train/checkpoints.load_backbone_qtree``): ``stem`` {``kernel`` f32 OIHW,
``bn`` {``scale``, ``bias``, ``mean``, ``var``}}, ``stem_scale``, with
``mean``/``std`` also ``stem_s2d`` (``ops/qstem.py`` lists its entries),
and per block ``w1 [Cw, Cin]``, ``w2 [Cw, 3, 3, Cw]``, ``w3 [Cout, Cw]``
int8, ``A1..B3`` f32, then ``wd [Cout, Cin]``, ``Ad``, ``Bd`` (projection)
or ``short_mul`` (identity), and ``out_scale``.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from pytorch_object_detection_tpu_torch.nn.fused_resnet import conv_bn_act, fold_bn, fold_bn_params
from pytorch_object_detection_tpu_torch.nn.resnet import ResNet50, s2d_stem_kernel
from pytorch_object_detection_tpu_torch.ops.qblock import qbottleneck, qbottleneck_plain, qbottleneck_s2
from pytorch_object_detection_tpu_torch.ops.qchain import qchain
from pytorch_object_detection_tpu_torch.ops.qconv import qconv1x1, qconv3x3
from pytorch_object_detection_tpu_torch.ops.qpool import qmaxpool3x3s2, qmaxpool3x3s2_plain
from pytorch_object_detection_tpu_torch.ops.qstem import qstem_conv, to_rgbx
from pytorch_object_detection_tpu_torch.ops.quant import (act_scale, clip8, conv_i8, quantize_act, requantize,
                                                          weight_qparams)
from pytorch_object_detection_tpu_torch.ops.stem import stem_bn_pool_quant

STAGE_SIZES = (3, 4, 6, 3)
BACKENDS = ("xla", "pallas", "pallas_block", "pallas_stem_tail")
KERNEL_BACKENDS = ("pallas", "pallas_block")
# the chained segments of resnet_int8.py:478-484: [layer1_0 .. layer2_3] -> C3, [layer3_*] -> C4, [layer4_*] -> C5
SEGMENTS = (("layer1_0", "layer1_1", "layer1_2", "layer2_0", "layer2_1", "layer2_2", "layer2_3"),
            tuple(f"layer3_{i}" for i in range(6)), tuple(f"layer4_{i}" for i in range(3)))


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
def quantize_stem_s2d(backbone: ResNet50, mean, std, stem_absmax) -> Dict:
    """The exact uint8 stem (the JAX ``quantize_stem_s2d``, :94-138).

    Frames are uint8, so ``x_f = (u/255 - mean)/std`` is a per-channel
    affine of u: it folds into the conv weights and bias, and ``u - 128`` is
    the int8 input, with no input quantization at all.  BN folds per output
    channel; the requant scale folds into the epilogue.  The input channels
    are padded 3 -> 4 (a fourth channel of zero weights) before the
    space-to-depth rewrite.  Returns ``w [256, 64]`` int8 (the s2d taps,
    (ky, kx, c16) order), ``wt [64, 256]`` (``w`` transposed, each output
    channel's taps contiguous: K1's layout, ``ops/qstem.py``), ``w7 [64, 7,
    7, 4]`` int8 (the same taps in the
    direct 7x7 form: the rewrite only rearranges them and adds zero taps, so
    the per-channel scales and rounded values are the same), ``A``, ``B``
    f32 ``[64]``, ``pad [16]`` and ``pad4 [4]`` int8 (the border fill in the
    ``v = u - 128`` domain: ``round(255 * mean - 128)``, where ``x_f = 0``)
    and ``scale``.
    """
    dev = backbone.conv1.weight.device
    mean = torch.as_tensor(mean, dtype=torch.float32, device=dev).reshape(3)
    std = torch.as_tensor(std, dtype=torch.float32, device=dev).reshape(3)
    mult, shift = fold_bn(backbone.bn1)
    w = backbone.conv1.weight.float().permute(2, 3, 1, 0)  # OIHW -> HWIO [7, 7, 3, 64]
    a_ch = 1.0 / (255.0 * std)  # x_f = u * a + b per input channel
    b_ch = -mean / std
    wn = w * a_ch[None, None, :, None]
    const = torch.sum(w * b_ch[None, None, :, None], dim=(0, 1, 2))
    weff = wn * mult
    bias = mult * (128.0 * torch.sum(wn, dim=(0, 1, 2)) + const) + shift
    weff4 = F.pad(weff, (0, 0, 0, 1))  # [7, 7, 4, 64]
    wq, sw = weight_qparams(s2d_stem_kernel(weff4))  # [4, 4, 16, 64]
    wq7, _ = weight_qparams(weff4)
    s_out = act_scale(stem_absmax).to(dev)
    inv = 1.0 / s_out
    pad3 = torch.clamp(torch.round(255.0 * mean - 128.0), -128, 127).to(torch.int8)
    pad4 = F.pad(pad3, (0, 1))
    w_s2d = wq.reshape(16 * 16, 64)
    return {
        "w": w_s2d,
        "wt": w_s2d.t().contiguous(),
        "w7": wq7.permute(3, 0, 1, 2).contiguous(),
        "A": sw * inv,
        "B": bias * inv,
        "pad": pad4.repeat(4),
        "pad4": pad4,
        "scale": s_out,
    }


@torch.no_grad()
def quantize_resnet50(backbone: ResNet50, act_absmax: Dict[str, float], mean=None, std=None) -> Dict:
    """Fold BN, quantize weights, and pre-fold all scale algebra.

    act_absmax: the taps of :func:`calibrate_resnet50` (reduced with max over
    calibration batches).  Returns the qtree :func:`resnet50_int8_forward`
    takes; with ``mean``/``std`` (the input-normalize constants) it also
    carries the exact uint8 stem, ``stem_s2d`` (:func:`quantize_stem_s2d`).
    """
    bn = backbone.bn1
    q = {
        "stem": {"kernel": backbone.conv1.weight.detach().float().clone(),
                 "bn": {"scale": bn.weight.float().clone(), "bias": bn.bias.float().clone(),
                        "mean": bn.running_mean.float().clone(), "var": bn.running_var.float().clone()}},
        "stem_scale": act_scale(act_absmax["stem_out"]).to(bn.weight.device),
    }
    if mean is not None and std is not None:
        q["stem_s2d"] = quantize_stem_s2d(backbone, mean, std, act_absmax["stem_out"])
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
    (K2 at stride 1, K3 at stride 2), ``"pallas"`` the per-conv form
    (:func:`bottleneck_int8_per_conv`); kernels run their plain versions on
    a CPU tensor or with ``plain=True``."""
    if backend == "pallas":
        return bottleneck_int8_per_conv(blk, x_q, stride, plain)
    common = (x_q, blk["w1"], blk["w2"], blk["w3"])
    vecs = (blk["A1"], blk["B1"], blk["A2"], blk["B2"], blk["A3"], blk["B3"])
    short = dict(wd=blk["wd"], ad=blk["Ad"], bd=blk["Bd"]) if "wd" in blk else dict(short_mul=blk["short_mul"])
    if backend == "xla":
        return qbottleneck_plain(*common, *vecs, stride=stride, **short)
    if stride == 1:
        return qbottleneck(*common, *vecs, plain=plain, **short)
    return qbottleneck_s2(*common, blk["wd"], *vecs, blk["Ad"], blk["Bd"], plain=plain)


def bottleneck_int8_per_conv(blk: Dict, x_q: torch.Tensor, stride: int, plain: bool = False) -> torch.Tensor:
    """The per-conv form (``resnet_int8.py:532-545``): conv1 on K4; conv2 on
    K11 at stride 1, at stride 2 the plain strided int8 conv (the JAX
    function's XLA conv); the projection shortcut on K4 at the block's
    stride with no ReLU, requantized to int8 at the output scale; conv3 on
    K4 with that int8 residual (``res_scale`` 1) or with the block input
    (``short_mul``).  Requantizing the shortcut makes projection blocks
    another function than the oracle's and kernel C's, which add the f32
    ``accd * Ad + Bd``; identity blocks are the same function in all."""
    a1 = qconv1x1(x_q, blk["w1"], blk["A1"], blk["B1"], plain=plain)
    if stride == 1:
        a2 = qconv3x3(a1, blk["w2"], blk["A2"], blk["B2"], plain=plain)
    else:
        a2 = requantize(conv_i8(a1, blk["w2"], stride), blk["A2"], blk["B2"])
    if "wd" in blk:
        x_sub = x_q[:, ::stride, ::stride].contiguous() if stride > 1 else x_q
        short_q = qconv1x1(x_sub, blk["wd"], blk["Ad"], blk["Bd"], relu=False, plain=plain)
        one = torch.ones((), dtype=torch.float32, device=x_q.device)
        return qconv1x1(a2, blk["w3"], blk["A3"], blk["B3"], res=short_q, res_scale=one, plain=plain)
    return qconv1x1(a2, blk["w3"], blk["A3"], blk["B3"], res=x_q, res_scale=blk["short_mul"], plain=plain)


def _stride(stage: int, b: int) -> int:
    return 2 if (b == 0 and stage > 0) else 1


def resnet50_int8_ladder(qtree: Dict, x_q: torch.Tensor, backend: str = "xla", plain: bool = False,
                         fuse_strided: bool = True):
    """The 16 int8 bottlenecks (:func:`bottleneck_int8`) from the stem's
    pooled int8 NHWC output: [(x_q, out_scale)] after each of the four
    stages.  ``backend="pallas_block", fuse_strided=False`` runs the three
    stride-2 blocks in the per-conv form."""
    outputs = []
    for scope, stage, b in block_scopes():
        blk, stride = qtree[scope], _stride(stage, b)
        per_conv = backend == "pallas_block" and stride == 2 and not fuse_strided
        x_q = bottleneck_int8(blk, x_q, stride, "pallas" if per_conv else backend, plain)
        if b == STAGE_SIZES[stage] - 1:
            outputs.append((x_q, blk["out_scale"]))
    return outputs


def resnet50_int8_chains(qtree: Dict, x_q: torch.Tensor, plain: bool = False):
    """The three backbone segments (:data:`SEGMENTS`), each one K13 launch
    (``ops/qchain``; its plain version on a CPU tensor or with
    ``plain=True``): [(x_q, out_scale)] for C3, C4, C5."""
    strides = {scope: _stride(stage, b) for scope, stage, b in block_scopes()}
    outputs = []
    for seg in SEGMENTS:
        x_q = qchain(x_q, [(qtree[scope], strides[scope]) for scope in seg], plain=plain)
        outputs.append((x_q, qtree[seg[-1]]["out_scale"]))
    return outputs


def resnet50_int8_stem(qtree: Dict, images: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16,
                       backend: str = "xla", plain: bool = False) -> torch.Tensor:
    """The stem's pooled int8 NHWC output from NHWC normalized images:
    float conv, BN, ReLU in ``compute_dtype``, then ``backend="xla"``: float
    3x3/2 max pool and quantize; ``"pallas_stem_tail"``: BN, ReLU, pool and
    quantize in K17 (:func:`stem_tail_int8`); otherwise quantize and the
    int8 max pool (the same int8 values as ``"xla"``, see
    :func:`resnet50_int8_forward`)."""
    if backend == "pallas_stem_tail":
        return stem_tail_int8(qtree, images, compute_dtype, plain)
    stem = qtree["stem"]
    mult, shift = fold_bn_params(**stem["bn"])
    x = _stem_float(stem["kernel"], mult, shift, images, compute_dtype)
    if backend == "xla":
        x = F.max_pool2d(x, 3, 2, padding=1)
        return quantize_act(x, qtree["stem_scale"]).permute(0, 2, 3, 1).contiguous()
    return qmaxpool3x3s2_plain(quantize_act(x, qtree["stem_scale"]).permute(0, 2, 3, 1))


def stem_tail_params(stem: Dict, compute_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(conv kernel, mult, shift) of the stem tail: the kernel in
    ``compute_dtype`` and channels-last (the frames' layout, so the conv
    copies nothing), the folded BN rounded to bf16 as the JAX kernel rounds
    it.  Made at a qtree's first stem-tail call, whether the port quantized
    it or it came across from the JAX package, and kept beside the BN in
    ``stem["tail"]``; later calls launch the conv and K17 only.  While a
    tracer runs (``utils/export.py``) the values are fake and nothing is
    kept."""
    keep = not torch.compiler.is_compiling()
    tail = stem.get("tail")
    if tail is None:
        mult, shift = fold_bn_params(**stem["bn"])
        tail = {"mult": mult.to(torch.bfloat16), "shift": shift.to(torch.bfloat16), "kernel": {}}
        if keep:
            stem["tail"] = tail
    kernel = tail["kernel"].get(compute_dtype)
    if kernel is None:
        kernel = stem["kernel"].to(compute_dtype).contiguous(memory_format=torch.channels_last)
        if keep:
            tail["kernel"][compute_dtype] = kernel
    return kernel, tail["mult"], tail["shift"]


def stem_tail_int8(qtree: Dict, images: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16,
                   plain: bool = False) -> torch.Tensor:
    """The float stem with its tail on K17 (``resnet_int8.py:404-412``):
    the 7x7/2 conv in ``compute_dtype``, then BN + ReLU, the 3x3/2 pool and
    the int8 quantize in one pass (``ops/stem.stem_bn_pool_quant``), on the
    operands :func:`stem_tail_params` keeps.  The NHWC frames'
    ``permute(0, 3, 1, 2)`` is channels-last, so the conv's output is too,
    and its NHWC view reaches K17 with no layout copy."""
    kernel, mult_b, shift_b = stem_tail_params(qtree["stem"], compute_dtype)
    x = images.permute(0, 3, 1, 2).to(compute_dtype).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x, kernel, None, 2, 3)
    return stem_bn_pool_quant(y.permute(0, 2, 3, 1).contiguous(), mult_b, shift_b, qtree["stem_scale"],
                              plain=plain)


def stem_direct_i8(st: Dict, u4: torch.Tensor) -> torch.Tensor:
    """The direct 7x7/2 int8 stem conv on raw RGBX frames ``[B, H, W, 4]``
    uint8, unpooled (``_stem_direct_i8_xla(st, u4, pool=False)``,
    ``resnet_int8.py:192-221``): ``v = u - 128`` bordered by ``pad4`` (3
    rows and columns a side), the int32 conv with ``w7``, then
    ``clip8(relu(acc * A + B))``: ``[B, (H - 1) // 2 + 1, (W - 1) // 2 + 1,
    64]`` int8.  The s2d rewrite only rearranges the same quantized taps, so
    after the 3x3/2 pool this equals K1's output bit for bit."""
    v = (u4.to(torch.int16) - 128).to(torch.int8)
    b, h, w, c = v.shape
    pad = st["pad4"].reshape(1, 1, 1, c)
    prow = pad.expand(b, 3, w, c)
    vp = torch.cat([prow, v, prow], dim=1)
    pcol = pad.expand(b, h + 6, 3, c)
    vp = torch.cat([pcol, vp, pcol], dim=2)
    acc = conv_i8(vp, st["w7"], stride=2, pad=0)
    return clip8(torch.clamp(acc * st["A"] + st["B"], min=0.0))


def resnet50_int8_forward(qtree: Dict, images: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16,
                          backend: str = "xla", fuse_strided: bool = False, dequant: bool = True,
                          u8_stem: bool = False, direct_stem: bool = False, chain_segments: bool = False,
                          plain: bool = False):
    """(C3, C4, C5) NHWC in ``compute_dtype`` from an int8-quantized backbone.

    ``images``: NHWC normalized floats, or with ``u8_stem=True`` raw uint8
    frames ``[B, H, W, 3 or 4]`` (H, W even) through the exact uint8 stem
    (the qtree needs ``stem_s2d``).
    ``dequant=False`` instead returns ``((c3_q, c4_q, c5_q) int8 NHWC,
    (s3, s4, s5))``.

    ``backend="xla"``: float stem, float 3x3/2 max pool, quantize (or the u8
    stem's oracle, ``ops/qstem.qstem_plain`` on the space-to-depth of the
    frame, a 3-channel frame padded with 128 as the JAX function does), then
    the per-op oracle for every block.
    ``backend="pallas"``: float stem, quantize, then the int8 max pool (max
    commutes with the monotone quantize, so the two stems agree bit for bit
    given the same float conv output), or K1 for the u8 stem; then every
    block in the per-conv form (:func:`bottleneck_int8_per_conv`: K4, K11).
    ``backend="pallas_block"``: the same stems, then kernel C for every
    block (``ops/qblock``) with ``fuse_strided=True``, or for the stride-1
    blocks only, the stride-2 ones in the per-conv form.
    ``backend="pallas_stem_tail"``: the float stem with its tail on K17
    (:func:`stem_tail_int8`), then the per-op oracle, as in JAX, where this
    backend selects no block kernel; with ``u8_stem`` it is ``"xla"``.

    ``direct_stem=True`` is the JAX package's ``PODT_STEM_XLA7=1``: the u8
    stem as the direct 7x7/2 int8 conv in plain PyTorch
    (:func:`stem_direct_i8`, XLA's conv in JAX) and the int8 3x3/2 pool on
    K10, bit-identical to K1.  ``chain_segments=True`` is ``PODT_QCHAIN=1``:
    the three backbone segments each as one K13 launch (``ops/qchain``),
    bit-identical to kernel C.  Each needs the kernel backends it applies
    to (``u8_stem=True`` and ``"pallas"`` or ``"pallas_block"``; and
    ``"pallas_block"`` with ``fuse_strided=True``) and raises
    ``ValueError`` elsewhere, where the JAX switch is silently ignored.
    Kernels run their plain versions on a CPU tensor or with ``plain=True``.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    kernels = backend in KERNEL_BACKENDS
    if direct_stem and not (u8_stem and kernels):
        raise ValueError("direct_stem=True (PODT_STEM_XLA7=1) needs u8_stem=True and backend 'pallas' or "
                         f"'pallas_block'; got u8_stem={u8_stem}, backend={backend!r}")
    if chain_segments and not (backend == "pallas_block" and fuse_strided):
        raise ValueError("chain_segments=True (PODT_QCHAIN=1) needs backend='pallas_block' and fuse_strided=True; "
                         f"got backend={backend!r}, fuse_strided={fuse_strided}")
    if u8_stem:
        if "stem_s2d" not in qtree:
            raise KeyError("u8_stem=True needs the qtree's stem_s2d entry: quantize with mean and std")
        st = qtree["stem_s2d"]
        if direct_stem:
            x_q = qmaxpool3x3s2(stem_direct_i8(st, to_rgbx(images)), plain=plain)  # K10
        else:
            x_q = qstem_conv(images, st, plain=plain or not kernels)  # K1, or its oracle
    else:
        x_q = resnet50_int8_stem(qtree, images, compute_dtype, backend, plain)
    if chain_segments:
        outputs = resnet50_int8_chains(qtree, x_q, plain)
    else:
        outputs = resnet50_int8_ladder(qtree, x_q, backend if kernels else "xla", plain, fuse_strided)
    if not dequant:
        return tuple(q for q, _ in outputs[-3:]), tuple(s for _, s in outputs[-3:])
    return tuple((q.float() * s).to(compute_dtype) for q, s in outputs[-3:])
