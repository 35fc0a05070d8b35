"""int8 PTQ serving ladder for SSD300 (VGG-16 multibox) in PyTorch.

Counterpart of ``pytorch_object_detection_tpu/models/ssd_int8.py``: every
conv of the VGG backbone (13 stage convs, conv6 at dilation 6, conv7), of
the four extra layers and of the six loc/conf head pairs runs int8 with the
pre-folded f32 epilogue ``acc * A + B -> relu -> round`` (VGG has no norm
layers: nothing to fold), weights per output channel, activations per
tensor at every requant point.  Two SSD-specific moves, as in JAX:

  * the max pools stay int8 (max commutes with the monotone round and
    clip): pool3's ceil-mode pad and pool5's 3x3/1 'same' pad fill with
    -127 (:func:`maxpool_i8`, maxima over strided views: ``F.max_pool2d``
    takes no int8 on CUDA, and JAX runs XLA's ``reduce_window``, no kernel);
  * L2Norm runs straight on conv4_3's int8 codes in f32 (the per-tensor
    scale cancels), then requantizes for the level-0 heads.

Every conv is the per-op ``ops/quant.conv_i8`` (im2col and
``torch._int_mm``, exact int32 sums), NHWC throughout, every f32 operation
in the JAX order: no kernel of the port runs here.

The qtree of :func:`quantize_ssd300`: ``s_input``, ``l2_gamma [512]``,
``s_f1``; per conv (``conv1_1`` .. ``conv7``, ``extra1.c1`` ..
``extra4.c2``) ``w`` int8 ``[O, k, k, I]`` (``[O, I]`` for a 1x1), ``A``,
``B`` f32 ``[O]``; ``loc0..5``, ``conf0..5`` the same with ``A = s_in *
s_w`` and the raw bias (f32 outputs).  ``train/checkpoints.load_ssd300_qtree``
carries the JAX package's tree across.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from pytorch_object_detection_tpu_torch.models.mnfcos_int8 import _conv_f, _kb
from pytorch_object_detection_tpu_torch.models.ssd import NUM_ANCHORS, SSD300
from pytorch_object_detection_tpu_torch.nn.resnet_int8 import _port_layout
from pytorch_object_detection_tpu_torch.nn.vgg import maxpool
from pytorch_object_detection_tpu_torch.ops.quant import act_scale, clip8, conv_i8, quantize_act, weight_qparams

# (name, pad, stride, dilation) in execution order; the pools follow the VGG16 stage schedule (nn/vgg.py)
VGG_CONVS = ([(f"conv{s + 1}_{i + 1}", 1, 1, 1) for s, n in enumerate((2, 2, 3, 3, 3)) for i in range(n)]
             + [("conv6", 6, 1, 6), ("conv7", 0, 1, 1)])
EXTRA_SPECS = (("extra1", 2, 1), ("extra2", 2, 1), ("extra3", 1, 0), ("extra4", 1, 0))  # (scope, stride, pad)
# the pool after a conv: (window, stride, ceil, pad_same)
POOL_AFTER = {"conv1_2": (2, 2, False, False), "conv2_2": (2, 2, False, False), "conv3_3": (2, 2, True, False),
              "conv4_3": (2, 2, False, False), "conv5_3": (3, 1, False, True)}


def maxpool_i8(x: torch.Tensor, window: int = 2, stride: int = 2, ceil: bool = False,
               pad_same: bool = False) -> torch.Tensor:
    """int8 NHWC max pool with ``nn/vgg.maxpool``'s padding arithmetic, the
    padding at -127 (the domain minimum after ``clip8``): the maximum of the
    ``window**2`` strided views (VALID after the pad)."""
    if pad_same:
        x = F.pad(x, (0, 0, 1, 1, 1, 1), value=-127)
    elif ceil:
        ph, pw = (stride - x.shape[1] % stride) % stride, (stride - x.shape[2] % stride) % stride
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph), value=-127)
    ho, wo = (x.shape[1] - window) // stride + 1, (x.shape[2] - window) // stride + 1
    out = None
    for dy in range(window):
        for dx in range(window):
            v = x[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
            out = v if out is None else torch.maximum(out, v)
    return out.contiguous()


def _l2norm_f(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    return x / (torch.sqrt((x * x).sum(dim=-1, keepdim=True)) + 1e-10) * gamma


def _conv_of(model: SSD300, name: str):
    return getattr(model.backbone, name) if name.startswith("conv") else getattr(model, name)


@torch.no_grad()
def calibrate_ssd(model: SSD300, images: torch.Tensor) -> Dict[str, float]:
    """The float forward (f32, NHWC) recording the abs-max at every requant
    point: the normalized input, each VGG and extra conv + ReLU output
    (``conv1_1`` .. ``conv7``, ``extra<k>.c1``, ``.c2``), and the L2Norm
    output ``f1``."""
    x = images.float()
    taps: Dict[str, torch.Tensor] = {"input": x.abs().max()}
    conv4_3 = None
    for name, pad, stride, dil in VGG_CONVS:
        x = torch.relu(_conv_f(x, *_kb(_conv_of(model, name)), stride=stride, dilation=dil, pad=pad))
        taps[name] = x.abs().max()
        if name == "conv4_3":
            conv4_3 = x
        if name in POOL_AFTER:
            x = maxpool(x.permute(0, 3, 1, 2), *POOL_AFTER[name]).permute(0, 2, 3, 1)
    taps["f1"] = _l2norm_f(conv4_3, model.l2norm.scale.detach().float()).abs().max()
    feat = x
    for scope, stride, pad in EXTRA_SPECS:
        layer = getattr(model, scope)
        feat = torch.relu(_conv_f(feat, *_kb(layer.conv1)))
        taps[f"{scope}.c1"] = feat.abs().max()
        feat = torch.relu(_conv_f(feat, *_kb(layer.conv2), stride=stride, pad=pad))
        taps[f"{scope}.c2"] = feat.abs().max()
    return {k: float(v) for k, v in taps.items()}


@torch.no_grad()
def quantize_ssd300(model: SSD300, calib_images: torch.Tensor) -> Dict:
    """PTQ of the whole SSD300 on a representative NORMALIZED NHWC batch on
    the model's device: the qtree :func:`ssd300_int8_forward` takes."""
    taps = calibrate_ssd(model, calib_images)
    dev = calib_images.device
    s = {k: act_scale(v).to(dev) for k, v in taps.items()}

    def blk(conv, s_in, s_out=None):
        k, b = _kb(conv)
        wq, sw = weight_qparams(k, axis=0)
        if s_out is None:  # a head conv: f32 output, the bias unscaled
            return dict(w=_port_layout(wq), A=s_in * sw, B=b)
        return dict(w=_port_layout(wq), A=s_in * sw / s_out, B=b / s_out)

    q: Dict = {"s_input": s["input"], "l2_gamma": model.l2norm.scale.detach().float().clone(), "s_f1": s["f1"]}
    s_prev = s["input"]
    for name, *_ in VGG_CONVS:
        q[name] = blk(_conv_of(model, name), s_prev, s[name])
        s_prev = s[name]
    for scope, *_ in EXTRA_SPECS:
        layer = getattr(model, scope)
        q[f"{scope}.c1"] = blk(layer.conv1, s_prev, s[f"{scope}.c1"])
        q[f"{scope}.c2"] = blk(layer.conv2, s[f"{scope}.c1"], s[f"{scope}.c2"])
        s_prev = s[f"{scope}.c2"]
    level_s = [s["f1"], s["conv7"], s["extra1.c2"], s["extra2.c2"], s["extra3.c2"], s["extra4.c2"]]
    for i, s_lv in enumerate(level_s):
        q[f"loc{i}"] = blk(getattr(model, f"loc{i}"), s_lv)
        q[f"conf{i}"] = blk(getattr(model, f"conf{i}"), s_lv)
    return q


def _rq(x_q: torch.Tensor, blk: Dict, pad: int = 0, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    acc = conv_i8(x_q, blk["w"], stride, dilation, pad)
    return clip8(torch.clamp(acc * blk["A"] + blk["B"], min=0.0))


def ssd300_int8_levels(qtree: Dict, images: torch.Tensor) -> List[torch.Tensor]:
    """NORMALIZED NHWC images -> the six int8 head inputs (the L2Norm'd
    conv4_3, conv7 and the four extra layers' outputs)."""
    q = qtree
    x = quantize_act(images, q["s_input"])
    conv4_3_q = None
    for name, pad, stride, dil in VGG_CONVS:
        x = _rq(x, q[name], pad, stride, dil)
        if name == "conv4_3":
            conv4_3_q = x
        if name in POOL_AFTER:
            x = maxpool_i8(x, *POOL_AFTER[name])
    f1 = clip8(_l2norm_f(conv4_3_q.float(), q["l2_gamma"]) / q["s_f1"])  # the scale cancels: the codes alone
    levels = [f1, x]
    for scope, stride, pad in EXTRA_SPECS:
        y = _rq(levels[-1], q[f"{scope}.c1"])
        levels.append(_rq(y, q[f"{scope}.c2"], pad, stride))
    return levels


@torch.inference_mode()
def ssd300_int8_forward(model: SSD300, qtree: Dict, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """NORMALIZED NHWC images -> (loc ``[B, 8732, 4]``, conf ``[B, 8732, C]``)
    f32 through the whole int8 ladder (SSD300's output contract)."""
    b = images.shape[0]
    locs, confs = [], []
    for i, (feat, _) in enumerate(zip(ssd300_int8_levels(qtree, images), NUM_ANCHORS)):
        loc = conv_i8(feat, qtree[f"loc{i}"]["w"], pad=1) * qtree[f"loc{i}"]["A"] + qtree[f"loc{i}"]["B"]
        conf = conv_i8(feat, qtree[f"conf{i}"]["w"], pad=1) * qtree[f"conf{i}"]["A"] + qtree[f"conf{i}"]["B"]
        locs.append(loc.reshape(b, -1, 4))
        confs.append(conf.reshape(b, -1, model.num_classes))
    return torch.cat(locs, dim=1), torch.cat(confs, dim=1)
