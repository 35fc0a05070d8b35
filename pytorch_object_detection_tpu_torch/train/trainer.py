"""int8 PTQ of the backbone, the FPN and the head, and the int8 eval forwards (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/train/trainer.py``:
``quantize_backbone``, ``_backbone_int8_feats``, ``quantize_fpn`` and
``quantize_head`` (:412-582, the HISFCOS and MNFCOS branches), and
``make_eval_forward_int8`` (:596-776) for the two ResNet-50 FCOS families
ported so far.  An int8 ResNet-50 (its stem float, or the exact uint8 stem
with ``u8_input=True``), then:

  * HISFCOS: either the BN-folded float HisFPN (``int8_fpn=False``) and the
    float HISHead (its GroupNorms on kernel B), or the int8 HisFPN, whose
    levels go dequantized to the float HISHead (``int8_head=False``) or
    stay int8 into the int8 HISHead (``int8_head=True``, the JAX default
    serving path);
  * MNFCOS: either the float LightweightFPN with its BN and the float
    MNHead (``int8_fpn=False``), or the int8 LightweightFPN
    (``models/mnfcos_int8.py``), whose levels go dequantized to the float
    MNHead or stay int8 into the int8 MNHead.

Every int8 backbone backend of the JAX function is ported
(``nn/resnet_int8.resnet50_int8_forward``), and ``fused_head=True``: the
whole-level bf16 HISHead on K15 (``ops/head.py``) behind the float HisFPN.
Not ported yet, raising ``NotImplementedError`` with its ROADMAP item: the
other model families.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Tuple

import torch
from torch import nn

from pytorch_object_detection_tpu_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from pytorch_object_detection_tpu_torch.models.fcos import HISFCOS, MNFCOS
from pytorch_object_detection_tpu_torch.models.head_int8 import calibrate_hishead, hishead_int8_forward, quantize_hishead
from pytorch_object_detection_tpu_torch.models.mnfcos_int8 import (
    calibrate_lwfpn,
    calibrate_mnhead,
    lwfpn_int8_forward,
    mnhead_int8_forward,
    quantize_lwfpn,
    quantize_mnhead,
)
from pytorch_object_detection_tpu_torch.nn.fpn_int8 import calibrate_hisfpn, hisfpn_int8_forward, quantize_hisfpn
from pytorch_object_detection_tpu_torch.nn.fused_fpn import fold_hisfpn, hisfpn_folded_forward
from pytorch_object_detection_tpu_torch.nn.resnet_int8 import (
    calibrate_resnet50,
    quantize_resnet50,
    resnet50_int8_forward,
)
from pytorch_object_detection_tpu_torch.ops.head import hishead_level_fused, hishead_params_pack

Levels = Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]


def _require_ported(model: nn.Module) -> None:
    if not isinstance(model, (HISFCOS, MNFCOS)):
        raise NotImplementedError(
            f"the int8 ladder is ported for the ResNet-50 FCOS families HISFCOS and MNFCOS; got "
            f"{type(model).__name__}: ROADMAP.md queue 1 item 10 (the other families)")


def quantize_backbone(model: nn.Module, calib_images: torch.Tensor,
                      compute_dtype: torch.dtype = torch.bfloat16, mean=None, std=None) -> Dict:
    """PTQ of the detector's ResNet-50: calibrate activation scales on
    ``calib_images`` (a representative NORMALIZED NHWC batch, on the
    model's device) in ``compute_dtype`` and return the int8 qtree for
    :func:`make_eval_forward_int8`.  ``mean``/``std`` (the input-normalize
    constants, ImageNet's by default) make the exact uint8 stem's
    ``stem_s2d`` entry."""
    _require_ported(model)
    taps = calibrate_resnet50(model.backbone, calib_images, compute_dtype)
    return quantize_resnet50(model.backbone, taps, IMAGENET_MEAN if mean is None else mean,
                             IMAGENET_STD if std is None else std)


def _backbone_int8_feats(qtree_bb: Dict, images: torch.Tensor, **kw):
    """(C3..C5) int8 NHWC + scales through the int8 ResNet-50 ladder (the
    per-op oracle unless ``backend`` says otherwise)."""
    kw.setdefault("backend", "xla")
    return resnet50_int8_forward(qtree_bb, images, torch.float32, dequant=False, **kw)


def quantize_fpn(model: nn.Module, qtree_bb: Dict, calib_images: torch.Tensor) -> Dict:
    """PTQ of the FPN (extends :func:`quantize_backbone`; the HisFPN of a
    HISFCOS, the LightweightFPN of an MNFCOS): calibrate its activation
    scales on the int8 backbone's dequantized C3..C5, the distribution the
    int8 FPN sees when serving, and return the FPN qtree for
    ``make_eval_forward_int8(int8_fpn=True)``.

    As the JAX function does, the features come from the per-op oracle with
    the float stem, in f32, on the NORMALIZED ``calib_images`` (not from the
    uint8 stem), whatever compute dtype the pipeline serves in.
    """
    _require_ported(model)
    feats_q, scales = _backbone_int8_feats(qtree_bb, calib_images)
    feats = [q.float() * s for q, s in zip(feats_q, scales)]
    if isinstance(model, MNFCOS):
        return quantize_lwfpn(model.fpn, calibrate_lwfpn(model.fpn, feats), scales)
    return quantize_hisfpn(model.fpn, calibrate_hisfpn(model.fpn, feats), scales)


def quantize_head(model: nn.Module, qtree_bb: Dict, qtree_fpn: Dict, calib_images: torch.Tensor) -> Dict:
    """PTQ of the head (extends :func:`quantize_fpn` through the whole
    detector; the HISHead or the MNHead): calibrate its per-level
    activation scales on the int8 FPN's dequantized levels and return the
    head qtree for ``make_eval_forward_int8(int8_fpn=True, int8_head=True)``.

    As the JAX function does, the levels come from the per-op oracles, in
    f32: the backbone with the float stem on the NORMALIZED
    ``calib_images``, then the int8 FPN with ``dequant=False``.
    """
    _require_ported(model)
    feats_q, _ = _backbone_int8_feats(qtree_bb, calib_images)
    if isinstance(model, MNFCOS):
        levels_q, level_scales = lwfpn_int8_forward(qtree_fpn, feats_q, dequant=False, backend="xla")
        levels = [q.float() * s for q, s in zip(levels_q, level_scales)]
        return quantize_mnhead(model.head, calibrate_mnhead(model.head, levels), level_scales, model.num_classes)
    levels_q, level_scales = hisfpn_int8_forward(qtree_fpn, feats_q, torch.float32, backend="xla", dequant=False)
    levels = [q.float() * s for q, s in zip(levels_q, level_scales)]
    return quantize_hishead(model.head, calibrate_hishead(model.head, levels), level_scales, model.num_classes)


def fused_head_applies(model: nn.Module, backend: str, int8_fpn: bool) -> bool:
    """Whether ``fused_head=True`` puts the head on K15: only for a HISFCOS,
    behind the float HisFPN and an int8 backbone backend other than the
    oracle, as the JAX ``make_eval_forward_int8`` decides (its
    trainer.py:752)."""
    return isinstance(model, HISFCOS) and not int8_fpn and backend != "xla"


def make_eval_forward_int8(model: nn.Module, compute_dtype: torch.dtype = torch.bfloat16,
                           backend: str = "pallas_block", use_pallas_gn: bool = False, fused_head: bool = False,
                           fuse_strided: bool = True, int8_fpn: bool = False, int8_head: bool = False,
                           u8_input: bool = False, direct_stem: bool = False, chain_segments: bool = False,
                           plain: bool = False) -> Callable[[Dict, torch.Tensor], Levels]:
    """Inference forward with an int8-PTQ backbone: ``fwd(qtree, images) ->
    per-level f32 NHWC (cls, cnt, reg)``; ``images`` normalized NHWC
    floats, or raw uint8 frames with ``u8_input=True`` (the exact uint8
    stem).  ``model`` is a HISFCOS or an MNFCOS.

    ``int8_fpn=False``: the int8 C3..C5 are dequantized to
    ``compute_dtype`` and turned NCHW there, once; a HISFCOS's HisFPN runs
    BN-folded (its kernels folded here, once, from the model's f32
    weights), an MNFCOS's LightweightFPN as a ``compute_dtype`` copy of
    ``model.fpn`` with its BatchNorms (JAX folds the BN for HISFCOS only).
    ``int8_fpn=True``: ``qtree`` is ``{"backbone": ..., "fpn": ...}``
    (:func:`quantize_backbone` + :func:`quantize_fpn`); the int8 C3..C5 go
    straight into the int8 FPN, whose levels are dequantized to
    ``compute_dtype``.  The float head runs on a copy of ``model.head`` in
    ``compute_dtype``; later changes to ``model`` are not seen.
    ``int8_fpn=True, int8_head=True``: ``qtree`` also has ``"head"``
    (:func:`quantize_head`); the int8 levels go straight into the int8
    head, which returns f32 maps, with no float seam.

    The int8 FPN and head follow ``backend`` as the JAX function maps it:
    ``"xla"`` (or ``plain=True``) their per-op oracles; any other backend
    their kernels: the HisFPN on K4, K5, K6 and the HISHead on K7 and K9;
    the MNFCOS's fifteen MNBlocks on K12 (the JAX package's ``PODT_QMN=1``;
    its default ``PODT_QMN=0`` is ``backend="xla"``).

    ``fused_head=True`` (the JAX serving bench's ``PODT_FUSED_HEAD=1``):
    for a HISFCOS with ``int8_fpn=False`` and ``backend != "xla"`` each level goes to K15
    (``ops/head.hishead_level_fused``) in bf16, whatever ``compute_dtype``
    (the weights packed here, once, from the model's f32 weights), with
    ScaleExp after it: ``exp(reg * scale_i)`` in f32, cls and cnt cast to
    f32.  Elsewhere it is ignored, as in JAX.

    ``use_pallas_gn`` is the JAX switch between XLA's GroupNorm and the
    Pallas kernel in the float head.  It is accepted, so that callers
    written for the JAX function keep working, and changes nothing: on the
    card the float head's GroupNorms always run on kernel B, since a plain
    version never stands on a path where a card is present.

    ``backend``, ``fuse_strided``, ``direct_stem`` (the JAX package's
    ``PODT_STEM_XLA7=1``) and ``chain_segments`` (``PODT_QCHAIN=1``) go to
    ``resnet50_int8_forward``, which says what each selects.  ``plain=True``
    runs every kernel's plain version, K15's included, for the comparison
    only.
    """
    del use_pallas_gn  # kernel B on the card either way (docstring)
    _require_ported(model)
    int8_head = int8_head and int8_fpn  # the head is int8 only behind an int8 FPN, as in JAX
    fused_head = fused_head and fused_head_applies(model, backend, int8_fpn)
    is_mn = isinstance(model, MNFCOS)
    fpn_int8_forward = lwfpn_int8_forward if is_mn else hisfpn_int8_forward
    head_int8_forward = mnhead_int8_forward if is_mn else hishead_int8_forward
    fpn = model.fpn
    folded = None if int8_fpn or is_mn else fold_hisfpn(fpn, compute_dtype)
    fpn_copy = copy.deepcopy(fpn).to(compute_dtype).eval() if is_mn and not int8_fpn else None
    head = None if int8_head or fused_head else copy.deepcopy(model.head).to(compute_dtype).eval()
    packed = hishead_params_pack(model.head, model.num_classes) if fused_head else None
    scales = [getattr(model.head, f"scale{i}").scale.detach().float() for i in range(5)] if fused_head else None
    sub = "xla" if backend == "xla" or plain else "pallas"  # the JAX mapping, trainer.py:640

    @torch.inference_mode()
    def fwd(qtree: Dict, images: torch.Tensor) -> Levels:
        bb_kw = dict(backend=backend, fuse_strided=fuse_strided, u8_stem=u8_input, direct_stem=direct_stem,
                     chain_segments=chain_segments, plain=plain)
        if int8_head:
            feats_q, _ = resnet50_int8_forward(qtree["backbone"], images, compute_dtype, dequant=False, **bb_kw)
            levels_q, _ = fpn_int8_forward(qtree["fpn"], feats_q, compute_dtype, backend=sub, dequant=False)
            return head_int8_forward(qtree["head"], levels_q, backend=sub, num_classes=model.num_classes)
        if int8_fpn:
            feats_q, _ = resnet50_int8_forward(qtree["backbone"], images, compute_dtype, dequant=False, **bb_kw)
            levels = fpn_int8_forward(qtree["fpn"], feats_q, compute_dtype, backend=sub)
            levels = [lv.permute(0, 3, 1, 2).contiguous() for lv in levels]  # the dequant seam: NHWC -> NCHW
        else:
            feats = resnet50_int8_forward(qtree, images, compute_dtype, **bb_kw)
            feats = [f.permute(0, 3, 1, 2).contiguous() for f in feats]  # the dequant seam: NHWC -> NCHW
            levels = fpn_copy(feats) if is_mn else hisfpn_folded_forward(fpn, feats, compute_dtype, folded=folded)
        if fused_head:
            nc = model.num_classes
            outs = ([], [], [])
            for lv, scale in zip(levels, scales):
                out = hishead_level_fused(lv.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous(), packed, nc,
                                          plain=plain)
                outs[0].append(out[..., :nc].float())
                outs[1].append(out[..., nc:nc + 1].float())
                outs[2].append(torch.exp(out[..., nc + 1:].float() * scale))
            return outs
        outs = head(levels, plain)
        return tuple([o.permute(0, 2, 3, 1).float() for o in branch] for branch in outs)

    return fwd
