"""Plain float32 forward passes of HISFCOS and FCOS on ResNet-50.

A frozen copy of the published architectures, written against a flat
dict of weights (``name -> tensor``) whose names are the detector's state
dict names (``backbone.layer2_0.conv1.weight``, ``head.cls_pred.bias``):
the benchmark draws that dict from the seed and hands the same tensors to
the program under test and to this file.  Nothing here imports the
program.  Inputs are NHWC images, normalized; outputs per-level NHWC
(cls, cnt, reg) lists, all in the input's dtype.

``conv`` is the one place a convolution happens: a caller may pass
``quant`` (``reference/quant.py``) to compute every convolution from
operands rounded to a lower precision, which is how the benchmark's
controls are made.

HISFCOS: "HISFCOS: Half-Inverted Stage Block for Efficient Object
Detection Based on Deep Learning", J. Imaging 2022 (ResNet-50, the
half-inverted-stage pyramid, the inverted-bottleneck head).  FCOS: Tian et
al., ICCV 2019 (arXiv:1904.01355), ResNet-50-FPN with GroupNorm towers.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor, str], torch.Tensor]]
STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))  # (blocks, width) of ResNet-50's four stages


def conv(w: Weights, name: str, x: torch.Tensor, stride: int = 1, padding: int = 0, dilation: int = 1,
         groups: int = 1, quant: Quant = None) -> torch.Tensor:
    weight, bias = w[f"{name}.weight"], w.get(f"{name}.bias")
    if quant is not None:
        x, weight = quant(x, "act"), quant(weight, "weight")
    return F.conv2d(x, weight, bias, stride, padding, dilation, groups)


def bn(w: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    """Frozen BatchNorm: running statistics, eps 1e-5."""
    scale = w[f"{name}.weight"] * torch.rsqrt(w[f"{name}.running_var"] + 1e-5)
    shift = w[f"{name}.bias"] - w[f"{name}.running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def gn(w: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.group_norm(x, 32, w[f"{name}.weight"], w[f"{name}.bias"], 1e-5)


def bottleneck(w: Weights, p: str, x: torch.Tensor, stride: int, projection: bool, quant: Quant) -> torch.Tensor:
    y = F.relu(bn(w, f"{p}.bn1", conv(w, f"{p}.conv1", x, quant=quant)))
    y = F.relu(bn(w, f"{p}.bn2", conv(w, f"{p}.conv2", y, stride, 1, quant=quant)))
    y = bn(w, f"{p}.bn3", conv(w, f"{p}.conv3", y, quant=quant))
    if projection:
        x = bn(w, f"{p}.downsample_bn", conv(w, f"{p}.downsample_conv", x, stride, quant=quant))
    return F.relu(x + y)


def resnet50(w: Weights, x: torch.Tensor, quant: Quant = None, barrier_after: int = 0) -> Tuple[torch.Tensor, ...]:
    """NCHW -> (C3, C4, C5).  ``barrier_after=k`` stops the gradient after
    stage k (the stages a training recipe freezes)."""
    x = F.relu(bn(w, "backbone.bn1", conv(w, "backbone.conv1", x, 2, 3, quant=quant)))
    x = F.max_pool2d(x, 3, 2, padding=1)
    taps = []
    in_ch = 64
    for s, (blocks, width) in enumerate(STAGES):
        for b in range(blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            x = bottleneck(w, f"backbone.layer{s + 1}_{b}", x, stride, stride != 1 or in_ch != 4 * width, quant)
            in_ch = 4 * width
        if s + 1 == barrier_after:
            x = x.detach()
        taps.append(x)
    return tuple(taps[1:])


def up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def pool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def his_block(w: Weights, p: str, x: torch.Tensor, quant: Quant) -> torch.Tensor:
    """The half-inverted-stage block: a 1x1 half, a depthwise branch and a
    squeeze-excitation branch, a 3x3 merge, then a dilated 3x3 over the merge
    and a 1x1 passthrough."""
    x1 = F.silu(bn(w, f"{p}.bn1", conv(w, f"{p}.conv1", x, quant=quant)))
    x2 = conv(w, f"{p}.conv2", x, quant=quant)
    a = F.relu(bn(w, f"{p}.bn2", conv(w, f"{p}.dwconv", x1, padding=1, groups=x1.shape[1], quant=quant)))
    g = F.silu(conv(w, f"{p}.se.fc1", x1.mean(dim=(2, 3), keepdim=True), quant=quant))
    b = x1 * torch.sigmoid(conv(w, f"{p}.se.fc2", g, quant=quant))
    m = F.relu(bn(w, f"{p}.bn3", conv(w, f"{p}.conv3", torch.cat([a, b], 1), padding=1, quant=quant)))
    y = conv(w, f"{p}.conv4", torch.cat([m, x2], 1), padding=2, dilation=2, quant=quant)
    return F.silu(bn(w, f"{p}.bn4", y))


def his_fpn(w: Weights, feats, quant: Quant) -> List[torch.Tensor]:
    c3, c4, c5 = feats
    t5 = F.relu(bn(w, "fpn.bn_tf1", conv(w, "fpn.tf1", c5, quant=quant)))
    seed6 = pool2(t5)
    seed7 = pool2(seed6)
    d5 = his_block(w, "fpn.his1", t5, quant)
    t4 = F.relu(bn(w, "fpn.bn_lat_shared", conv(w, "fpn.tf2", c4, quant=quant)))
    d4 = his_block(w, "fpn.his2", up2(d5) + t4, quant)
    t3 = F.relu(bn(w, "fpn.bn_lat_shared", conv(w, "fpn.tf3", c3, quant=quant)))
    p3 = his_block(w, "fpn.his3", up2(d4) + t3, quant)
    p4 = his_block(w, "fpn.his4", pool2(p3) + d4, quant)
    p5 = his_block(w, "fpn.his5", pool2(p4) + d5, quant)
    p6 = his_block(w, "fpn.his6", pool2(p5) + seed6, quant)
    p7 = his_block(w, "fpn.his7", pool2(p6) + seed7, quant)
    return [p3, p4, p5, p6, p7]


def his_head(w: Weights, levels, quant: Quant):
    cls_l, cnt_l, reg_l = [], [], []
    for i, x in enumerate(levels):
        y = F.relu(gn(w, "head.stem_gn1", conv(w, "head.stem_pw1", x, quant=quant)))
        y = F.silu(gn(w, "head.stem_gn2", conv(w, "head.stem_dw", y, padding=1, groups=y.shape[1], quant=quant)))
        y = conv(w, "head.stem_pw2", y, quant=quant) + x
        c = F.relu(gn(w, "head.cls_gn0", conv(w, "head.cls_tower0", y, padding=1, quant=quant)))
        r = F.relu(gn(w, "head.reg_gn0", conv(w, "head.reg_tower0", y, padding=1, quant=quant)))
        cls_l.append(conv(w, "head.cls_pred", c, padding=1, quant=quant))
        cnt_l.append(conv(w, "head.cnt_pred", r, padding=1, quant=quant))
        reg_l.append(torch.exp(conv(w, "head.reg_pred", r, padding=1, quant=quant) * w[f"head.scale{i}.scale"]))
    return cls_l, cnt_l, reg_l


def fpn(w: Weights, feats, quant: Quant) -> List[torch.Tensor]:
    c3, c4, c5 = feats
    p5 = conv(w, "fpn.lateral5", c5, quant=quant)
    p4 = conv(w, "fpn.smooth4", up2(p5) + conv(w, "fpn.lateral4", c4, quant=quant), padding=1, quant=quant)
    p3 = conv(w, "fpn.smooth3", up2(p4) + conv(w, "fpn.lateral3", c3, quant=quant), padding=1, quant=quant)
    p5 = conv(w, "fpn.smooth5", p5, padding=1, quant=quant)
    p6 = conv(w, "fpn.down6", p5, 2, 1, quant=quant)
    p7 = conv(w, "fpn.down7", F.relu(p6), 2, 1, quant=quant)
    return [p3, p4, p5, p6, p7]


def fcos_head(w: Weights, levels, quant: Quant, tower: int = 4):
    cls_l, cnt_l, reg_l = [], [], []
    for i, x in enumerate(levels):
        c = r = x
        for j in range(tower):
            c = F.relu(gn(w, f"head.cls_gn{j}", conv(w, f"head.cls_tower{j}", c, padding=1, quant=quant)))
        for j in range(tower):
            r = F.relu(gn(w, f"head.reg_gn{j}", conv(w, f"head.reg_tower{j}", r, padding=1, quant=quant)))
        cls_l.append(conv(w, "head.cls_pred", c, padding=1, quant=quant))
        cnt_l.append(conv(w, "head.cnt_pred", r, padding=1, quant=quant))
        reg_l.append(torch.exp(conv(w, "head.reg_pred", r, padding=1, quant=quant) * w[f"head.scale{i}.scale"]))
    return cls_l, cnt_l, reg_l


FAMILIES = {"HISFCOS": (his_fpn, his_head), "FCOS": (fpn, fcos_head)}


def forward(family: str, w: Weights, images: torch.Tensor, quant: Quant = None, barrier_after: int = 0):
    """images ``[B, H, W, 3]`` normalized -> per-level NHWC (cls, cnt, reg)."""
    neck, head = FAMILIES[family]
    feats = resnet50(w, images.permute(0, 3, 1, 2), quant, barrier_after)
    outs = head(w, neck(w, feats, quant), quant)
    return tuple([t.permute(0, 2, 3, 1) for t in branch] for branch in outs)


def weight_specs(family: str, num_classes: int, features: int = 256) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """``name -> (shape, kind)`` of every tensor the forward reads, in a
    fixed order.  ``kind`` says how ``weights.py`` draws it: ``conv``,
    ``conv_bias``, ``bn_weight``, ``bn_last_weight`` (a residual branch's
    last BatchNorm), ``bn_bias``, ``bn_mean``, ``bn_var``, ``gn_weight``,
    ``gn_bias``, ``cls_bias``, ``reg_bias``, ``pred_cls``, ``pred_cnt``, ``pred_reg`` (the
    prediction convs),
    ``scale``."""
    specs: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def add_conv(name, cin, cout, k, bias=False, groups=1, kind="conv"):
        specs[f"{name}.weight"] = ((cout, cin // groups, k, k), kind)
        if bias:
            specs[f"{name}.bias"] = ((cout,), "conv_bias")

    def add_bn(name, ch, last=False):
        specs[f"{name}.weight"] = ((ch,), "bn_last_weight" if last else "bn_weight")
        specs[f"{name}.bias"] = ((ch,), "bn_bias")
        specs[f"{name}.running_mean"] = ((ch,), "bn_mean")
        specs[f"{name}.running_var"] = ((ch,), "bn_var")

    def add_gn(name, ch):
        specs[f"{name}.weight"] = ((ch,), "gn_weight")
        specs[f"{name}.bias"] = ((ch,), "gn_bias")

    add_conv("backbone.conv1", 3, 64, 7)
    add_bn("backbone.bn1", 64)
    in_ch = 64
    for s, (blocks, width) in enumerate(STAGES):
        for b in range(blocks):
            p = f"backbone.layer{s + 1}_{b}"
            add_conv(f"{p}.conv1", in_ch, width, 1)
            add_bn(f"{p}.bn1", width)
            add_conv(f"{p}.conv2", width, width, 3)
            add_bn(f"{p}.bn2", width)
            add_conv(f"{p}.conv3", width, 4 * width, 1)
            add_bn(f"{p}.bn3", 4 * width, last=True)
            if b == 0:
                add_conv(f"{p}.downsample_conv", in_ch, 4 * width, 1)
                add_bn(f"{p}.downsample_bn", 4 * width)
            in_ch = 4 * width
    f = features
    if family == "HISFCOS":
        add_bn("fpn.bn_lat_shared", f)
        add_conv("fpn.tf1", 2048, f, 1)
        add_bn("fpn.bn_tf1", f)
        add_conv("fpn.tf2", 1024, f, 1)
        add_conv("fpn.tf3", 512, f, 1)
        h = f // 2
        for i in range(1, 8):
            p = f"fpn.his{i}"
            add_conv(f"{p}.conv1", f, h, 1, bias=True)
            add_bn(f"{p}.bn1", h)
            add_conv(f"{p}.conv2", f, h, 1, bias=True)
            add_conv(f"{p}.dwconv", h, h, 3, groups=h)
            add_bn(f"{p}.bn2", h)
            add_conv(f"{p}.se.fc1", h, h // 4, 1, bias=True)
            add_conv(f"{p}.se.fc2", h // 4, h, 1, bias=True)
            add_conv(f"{p}.conv3", 2 * h, h, 3)
            add_bn(f"{p}.bn3", h)
            add_conv(f"{p}.conv4", 2 * h, f, 3)
            add_bn(f"{p}.bn4", f)
        add_conv("head.stem_pw1", f, 2 * f, 1)
        add_gn("head.stem_gn1", 2 * f)
        add_conv("head.stem_dw", 2 * f, 2 * f, 3, groups=2 * f)
        add_gn("head.stem_gn2", 2 * f)
        add_conv("head.stem_pw2", 2 * f, f, 1, bias=True)
        towers = 1
    else:
        for lvl, cin in ((5, 2048), (4, 1024), (3, 512)):
            add_conv(f"fpn.lateral{lvl}", cin, f, 1, bias=True)
        for name in ("smooth4", "smooth3", "smooth5", "down6", "down7"):
            add_conv(f"fpn.{name}", f, f, 3, bias=True)
        towers = 4
    for j in range(towers):
        for branch in ("cls", "reg"):
            add_conv(f"head.{branch}_tower{j}", f, f, 3)
            add_gn(f"head.{branch}_gn{j}", f)
    add_conv("head.cls_pred", f, num_classes, 3, kind="pred_cls")
    specs["head.cls_pred.bias"] = ((num_classes,), "cls_bias")
    add_conv("head.cnt_pred", f, 1, 3, kind="pred_cnt")
    specs["head.cnt_pred.bias"] = ((1,), "conv_bias")
    add_conv("head.reg_pred", f, 4, 3, kind="pred_reg")
    specs["head.reg_pred.bias"] = ((4,), "reg_bias")
    for i in range(5):
        specs[f"head.scale{i}.scale"] = ((1,), "scale")
    return specs
