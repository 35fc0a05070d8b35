"""BN-folded HisFPN inference forward (PyTorch, NCHW).

Counterpart of ``pytorch_object_detection_tpu/nn/fused_fpn.py:
hisfpn_folded_forward``: every frozen BatchNorm of the HisFPN is folded
into the preceding conv's kernel and a bias, so the forward is conv + bias
+ activation chains with no separate normalization pass.  It reads the
port's ``HisFPN`` module (``nn/fpn.py``); :func:`fold_hisfpn` makes the
folded kernels once (in f32, then cast to the compute dtype, as the JAX
function does on each call), and :func:`hisfpn_folded_forward` runs them.
The structure mirrors ``HisFPN`` / ``HisBlock`` / ``SEBlock``; the
numbers equal the module forward's up to rounding.  Given a ``taps`` dict,
the forward also records the abs-max at every point the int8 HisFPN
quantizes (``nn/fpn_int8.calibrate_hisfpn``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_object_detection_tpu_torch.nn.fpn import HisFPN
from pytorch_object_detection_tpu_torch.nn.fused_resnet import fold_bn
from pytorch_object_detection_tpu_torch.nn.layers import BatchNorm, HisBlock, maxpool2x2, upsample2x

# (kernel, bias, conv module) -- the module gives stride, padding, dilation and groups
Folded = Tuple[torch.Tensor, Optional[torch.Tensor], nn.Conv2d]


def _folded(conv: nn.Conv2d, bn: BatchNorm, dtype: torch.dtype) -> Folded:
    """(kernel * mult, shift [+ bias * mult]) for conv -> frozen BN."""
    mult, shift = fold_bn(bn)
    k = conv.weight.float() * mult[:, None, None, None]
    b = shift if conv.bias is None else shift + conv.bias.float() * mult
    return k.to(dtype), b.to(dtype), conv


def _unfolded(conv: nn.Conv2d, dtype: torch.dtype) -> Folded:
    return conv.weight.to(dtype), None if conv.bias is None else conv.bias.to(dtype), conv


def _conv(x: torch.Tensor, f: Folded) -> torch.Tensor:
    k, b, conv = f
    return F.conv2d(x, k, b, conv.stride, conv.padding, conv.dilation, conv.groups)


@torch.no_grad()
def _fold_hisblock(blk: HisBlock, dtype: torch.dtype) -> Dict[str, Folded]:
    return {
        "conv1": _folded(blk.conv1, blk.bn1, dtype),
        "conv2": _unfolded(blk.conv2, dtype),
        "dwconv": _folded(blk.dwconv, blk.bn2, dtype),
        "fc1": _unfolded(blk.se.fc1, dtype),
        "fc2": _unfolded(blk.se.fc2, dtype),
        "conv3": _folded(blk.conv3, blk.bn3, dtype),
        "conv4": _folded(blk.conv4, blk.bn4, dtype),
    }


@torch.no_grad()
def fold_hisfpn(fpn: HisFPN, dtype: torch.dtype) -> Dict:
    """The folded kernels and biases of ``fpn`` in ``dtype`` (computed in f32)."""
    out = {
        "tf1": _folded(fpn.tf1, fpn.bn_tf1, dtype),
        "tf2": _folded(fpn.tf2, fpn.bn_lat_shared, dtype),  # the shared lateral BN
        "tf3": _folded(fpn.tf3, fpn.bn_lat_shared, dtype),
    }
    for i in range(1, 8):
        out[f"his{i}"] = _fold_hisblock(getattr(fpn, f"his{i}"), dtype)
    return out


def _tap(taps: Optional[Dict], name: str, x: torch.Tensor) -> torch.Tensor:
    if taps is not None:
        taps[name] = x.abs().amax()
    return x


def _hisblock(p: Dict[str, Folded], x: torch.Tensor, taps: Optional[Dict] = None, prefix: str = "") -> torch.Tensor:
    x1 = _tap(taps, f"{prefix}.x1", F.silu(_conv(x, p["conv1"])))
    x2 = _tap(taps, f"{prefix}.x2", _conv(x, p["conv2"]))
    a = _tap(taps, f"{prefix}.a", torch.relu(_conv(x1, p["dwconv"])))
    gate = _conv(F.silu(_conv(x1.mean(dim=(2, 3), keepdim=True), p["fc1"])), p["fc2"])
    b = x1 * torch.sigmoid(gate)
    m = _tap(taps, f"{prefix}.m", torch.relu(_conv(torch.cat([a, b], dim=1), p["conv3"])))
    return _tap(taps, f"{prefix}.out", F.silu(_conv(torch.cat([m, x2], dim=1), p["conv4"])))


def hisfpn_folded_forward(fpn: HisFPN, feats: Sequence[torch.Tensor], compute_dtype: torch.dtype = torch.bfloat16,
                          folded: Optional[Dict] = None, taps: Optional[Dict] = None):
    """(P3..P7) NCHW from (C3, C4, C5) NCHW -- BN-folded HisFPN inference.

    ``folded``: :func:`fold_hisfpn` of ``fpn`` in ``compute_dtype``, made
    once by the caller; folded here when not given.  ``taps``: a dict that
    receives the abs-max (0-d tensors) of the laterals ``t5``, ``t4``,
    ``t3``, the block inputs ``in2``..``in7`` and, per block ``his<i>``,
    ``.x1``, ``.x2``, ``.a``, ``.m`` and ``.out``.
    """
    p = fold_hisfpn(fpn, compute_dtype) if folded is None else folded
    c3, c4, c5 = [f.to(compute_dtype) for f in feats]
    t5 = _tap(taps, "t5", torch.relu(_conv(c5, p["tf1"])))
    seed6 = maxpool2x2(t5)
    seed7 = maxpool2x2(seed6)
    d5 = _hisblock(p["his1"], t5, taps, "his1")
    t4 = _tap(taps, "t4", torch.relu(_conv(c4, p["tf2"])))
    d4 = _hisblock(p["his2"], _tap(taps, "in2", upsample2x(d5) + t4), taps, "his2")
    t3 = _tap(taps, "t3", torch.relu(_conv(c3, p["tf3"])))
    p3 = _hisblock(p["his3"], _tap(taps, "in3", upsample2x(d4) + t3), taps, "his3")
    p4 = _hisblock(p["his4"], _tap(taps, "in4", maxpool2x2(p3) + d4), taps, "his4")
    p5 = _hisblock(p["his5"], _tap(taps, "in5", maxpool2x2(p4) + d5), taps, "his5")
    p6 = _hisblock(p["his6"], _tap(taps, "in6", maxpool2x2(p5) + seed6), taps, "his6")
    p7 = _hisblock(p["his7"], _tap(taps, "in7", maxpool2x2(p6) + seed7), taps, "his7")
    return p3, p4, p5, p6, p7
