"""int8 PTQ inference forward for the HisFPN pyramid (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/nn/fpn_int8.py``.  Every
HisFPN BatchNorm is frozen, so BN folds into the conv weights (the port's
``nn/fused_fpn`` folding), weights quantize per output channel, activations
per tensor (abs-max calibration).  The HisBlock's two concat inputs sit at
different activation scales; their per-input-channel scales fold into the
float kernel before weight quantization.  Epilogues (scale algebra made by
:func:`quantize_hisfpn`):

  * linear/ReLU requant:  q = clip8(relu?(acc * A + B))          (A, B per channel)
  * SiLU requant:         q = clip8(silu(acc * A + B) * inv_s)   (inv_s a scalar)

SE stays f32 and its gate applies in the int8 domain, ``b_q = clip8(x1_q *
g)``.  The level glue runs on int8: the 2x2 max pool and the 2x
replication keep the scale, a cross-scale add requantizes to the
calibrated scale of the sum.

Everything runs NHWC, the JAX package's layout and the kernels'.
``backend="pallas"``: the laterals on K4 (``ops/qconv``), the two seeds of
the extra levels in one K6 launch (``ops/qpool.qmaxpool2x2_seeds``), each
HisBlock with its glue on K5 (``ops/qhis``), the four level pools inside
K5's load (``combine="pool_add"``); each kernel runs its plain version on a
CPU tensor.  ``backend="xla"``: the
per-op oracle of the JAX function, which is those plain versions (``nn/fpn_int8.py:44-94``, ``:303-328`` of the JAX package,
operation for operation).

The qtree: ``tf1``..``tf3`` {``w [F, Cin]`` int8, ``A``, ``B`` f32 ``[F]``,
``s``}, and per block ``his1``..``his7`` the entries ``ops/qhis.py`` lists
plus ``s_out`` and ``s_in`` (0-d f32 tensors).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from pytorch_object_detection_tpu_torch.nn.fpn import HisFPN
from pytorch_object_detection_tpu_torch.nn.fused_fpn import fold_hisfpn, hisfpn_folded_forward
from pytorch_object_detection_tpu_torch.nn.resnet_int8 import _port_layout
from pytorch_object_detection_tpu_torch.ops.qconv import qconv1x1
from pytorch_object_detection_tpu_torch.ops.qhis import qhisblock
from pytorch_object_detection_tpu_torch.ops.qpool import qmaxpool2x2_seeds
from pytorch_object_detection_tpu_torch.ops.quant import act_scale, weight_qparams

BLOCKS = ("his1", "his2", "his3", "his4", "his5", "his6", "his7")
BACKENDS = ("xla", "pallas")


@torch.no_grad()
def calibrate_hisfpn(fpn: HisFPN, feats: Sequence[torch.Tensor]) -> Dict[str, float]:
    """Float (f32, BN-folded) HisFPN forward recording the abs-max taps.

    feats: float NHWC (C3, C4, C5).  Returns {tap: float}: ``t5``, ``t4``,
    ``t3``, ``in2``..``in7`` and per block ``his<i>.x1``, ``.x2``, ``.a``,
    ``.m``, ``.out`` (the JAX function's taps).
    """
    taps: Dict[str, torch.Tensor] = {}
    hisfpn_folded_forward(fpn, [f.float().permute(0, 3, 1, 2) for f in feats], torch.float32, taps=taps)
    return {k: float(v) for k, v in taps.items()}


def _quantize_hisblock(p: Dict, s_in: torch.Tensor, taps: Dict[str, float], prefix: str) -> Dict:
    """int8 weights and epilogue scale algebra of one HisBlock, from its
    :func:`nn.fused_fpn.fold_hisfpn` entry (f32)."""
    dev = s_in.device
    s_x1, s_x2, s_a, s_m, s_out = (act_scale(taps[f"{prefix}.{t}"]).to(dev) for t in ("x1", "x2", "a", "m", "out"))
    blk: Dict = {}
    k1, c1 = p["conv1"][:2]
    w1q, sw1 = weight_qparams(k1, axis=0)
    blk.update(w1=_port_layout(w1q), A1=s_in * sw1, B1=c1, inv_x1=1.0 / s_x1)  # silu form

    k2, c2 = p["conv2"][:2]
    w2q, sw2 = weight_qparams(k2, axis=0)
    blk.update(w2=_port_layout(w2q), A2=s_in * sw2 / s_x2, B2=c2 / s_x2)

    kdw, sh2 = p["dwconv"][:2]  # [half, 1, 3, 3]
    wdwq, swdw = weight_qparams(kdw, axis=0)
    blk.update(wdw=wdwq[:, 0].permute(1, 2, 0).contiguous(), Adw=s_x1 * swdw / s_a, Bdw=sh2 / s_a)

    fc1, fc2 = p["fc1"][0], p["fc2"][0]
    blk.update(se_w1=fc1[:, :, 0, 0].t().contiguous(), se_b1=p["fc1"][1],
               se_w2=fc2[:, :, 0, 0].t().contiguous(), se_b2=p["fc2"][1], se_premul=s_x1)

    half = k1.shape[0]
    k3, c3 = p["conv3"][:2]
    k3 = torch.cat([k3[:, :half] * s_a, k3[:, half:] * s_x1], dim=1)
    w3q, sw3 = weight_qparams(k3, axis=0)
    blk.update(w3=_port_layout(w3q), A3=sw3 / s_m, B3=c3 / s_m)

    k4, c4 = p["conv4"][:2]
    k4 = torch.cat([k4[:, :half] * s_m, k4[:, half:] * s_x2], dim=1)
    w4q, sw4 = weight_qparams(k4, axis=0)
    blk.update(w4=_port_layout(w4q), A4=sw4, B4=c4, inv_out=1.0 / s_out, s_out=s_out)  # silu form
    return blk


@torch.no_grad()
def quantize_hisfpn(fpn: HisFPN, taps: Dict[str, float], feat_scales) -> Dict:
    """Fold BN, quantize weights, pre-fold all scale algebra of the HisFPN.

    feat_scales: (s_c3, s_c4, s_c5), the int8 scales of the backbone outputs
    (``resnet50_int8_forward(..., dequant=False)``); taps: the
    batch-reduced dict of :func:`calibrate_hisfpn`.
    """
    p = fold_hisfpn(fpn, torch.float32)
    dev = p["tf1"][0].device
    s_c3, s_c4, s_c5 = (torch.as_tensor(s, dtype=torch.float32).to(dev) for s in feat_scales)
    q: Dict = {}

    def lateral(name, s_c, tap):
        k, c = p[name][:2]
        s_t = act_scale(taps[tap]).to(dev)
        wq, sw = weight_qparams(k, axis=0)
        return {"w": _port_layout(wq), "A": s_c * sw / s_t, "B": c / s_t, "s": s_t}

    q["tf1"] = lateral("tf1", s_c5, "t5")
    q["tf2"] = lateral("tf2", s_c4, "t4")
    q["tf3"] = lateral("tf3", s_c3, "t3")
    s_in = {"his1": q["tf1"]["s"]}
    s_in.update({f"his{i}": act_scale(taps[f"in{i}"]).to(dev) for i in range(2, 8)})
    for name in BLOCKS:
        q[name] = _quantize_hisblock(p[name], s_in[name], taps, name)
        q[name]["s_in"] = s_in[name]
    return q


def hisfpn_int8_forward(qtree: Dict, feats_q: Sequence[torch.Tensor], compute_dtype: torch.dtype = torch.bfloat16,
                        backend: str = "xla", dequant: bool = True):
    """Five pyramid levels (P3..P7, NHWC) from int8 NHWC (C3, C4, C5).

    The backbone's scales are already folded into the lateral epilogues.
    ``backend="pallas"``: K4, K5 and K6 (their plain versions on a CPU
    tensor; the level pools inside K5); ``"xla"``: the per-op oracle, the
    same calls on the plain versions (a pool, then the add).
    ``dequant=True`` returns ``compute_dtype`` levels; ``False`` returns
    ``(levels_q int8, scales)``.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    plain = backend == "xla"  # the per-op oracle is each kernel's plain version
    c3q, c4q, c5q = feats_q

    def lateral(c_q, lat):
        return qconv1x1(c_q, lat["w"], lat["A"], lat["B"], plain=plain)

    def block(name, xa, sa, xb=None, sb=None, combine=None):
        """Block ``name`` on ``clip8(glue(xa) * sa / s_in + xb * sb / s_in)``,
        ``glue`` the 2x upsample (``"up_add"``) or the 2x2 pool
        (``"pool_add"``) (``xb`` None: ``xa`` is already at ``s_in``); K5
        fuses the glue."""
        blk = qtree[name]
        if xb is None:
            return qhisblock(blk, xa, plain=plain)
        return qhisblock(blk, xa, xb_q=xb, combine=combine, ca=sa / blk["s_in"], cb=sb / blk["s_in"], plain=plain)

    t5 = lateral(c5q, qtree["tf1"])
    seed6, seed7 = qmaxpool2x2_seeds(t5, plain=plain)
    s_t5, s_d5, s_d4 = qtree["tf1"]["s"], qtree["his1"]["s_out"], qtree["his2"]["s_out"]

    d5 = block("his1", t5, s_t5)
    t4 = lateral(c4q, qtree["tf2"])
    d4 = block("his2", d5, s_d5, t4, qtree["tf2"]["s"], "up_add")
    t3 = lateral(c3q, qtree["tf3"])
    p3 = block("his3", d4, s_d4, t3, qtree["tf3"]["s"], "up_add")

    p4 = block("his4", p3, qtree["his3"]["s_out"], d4, s_d4, "pool_add")
    p5 = block("his5", p4, qtree["his4"]["s_out"], d5, s_d5, "pool_add")
    p6 = block("his6", p5, qtree["his5"]["s_out"], seed6, s_t5, "pool_add")
    p7 = block("his7", p6, qtree["his6"]["s_out"], seed7, s_t5, "pool_add")

    levels_q = (p3, p4, p5, p6, p7)
    scales = tuple(qtree[b]["s_out"] for b in ("his3", "his4", "his5", "his6", "his7"))
    if not dequant:
        return levels_q, scales
    return tuple((lq.float() * s).to(compute_dtype) for lq, s in zip(levels_q, scales))
