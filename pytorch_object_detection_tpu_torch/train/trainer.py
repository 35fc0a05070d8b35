"""int8 PTQ of the backbone and the int8-backbone eval forward (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/train/trainer.py``:
``quantize_backbone`` and ``_backbone_int8_feats`` (:412-467) and the
``int8_fpn=False`` branch of ``make_eval_forward_int8`` (:596-776): an int8
ResNet-50, then the BN-folded float HisFPN and the float HISHead (its
GroupNorms on kernel B) in the compute dtype.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP item:
``int8_fpn=True`` (and so ``int8_head``), ``fused_head=True``, and the
EfficientNet backbones.  The u8 stem (``u8_input=True``) and the per-conv
backend raise in ``nn/resnet_int8.py``.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Tuple

import torch
from torch import nn

from pytorch_object_detection_tpu_torch.models.fcos import HISFCOS
from pytorch_object_detection_tpu_torch.nn.fused_fpn import fold_hisfpn, hisfpn_folded_forward
from pytorch_object_detection_tpu_torch.nn.resnet_int8 import (
    calibrate_resnet50,
    quantize_resnet50,
    resnet50_int8_forward,
)

INT8_FPN_ITEM = ("ROADMAP.md queue 1 item 4 (int8 FPN, int8 head, calibration of FPN and head) "
                 "and queue 2 K4, K5, K6 (and K7, K9 for the int8 head)")
FUSED_HEAD_ITEM = "ROADMAP.md queue 2 K15 (hishead_level_fused)"

Levels = Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]


def _require_hisfcos(model: nn.Module) -> None:
    if not isinstance(model, HISFCOS):
        raise NotImplementedError(
            f"the int8 backbone is ported for HISFCOS (ResNet-50) only; got {type(model).__name__}: "
            "ROADMAP.md queue 1 item 10 (the other families)")


def quantize_backbone(model: nn.Module, calib_images: torch.Tensor,
                      compute_dtype: torch.dtype = torch.bfloat16) -> Dict:
    """PTQ of the detector's ResNet-50: calibrate activation scales on
    ``calib_images`` (a representative NORMALIZED NHWC batch, on the
    model's device) in ``compute_dtype`` and return the int8 qtree for
    :func:`make_eval_forward_int8`.  The JAX function's ``mean``/``std``
    serve only the u8 space-to-depth stem, which is not ported."""
    _require_hisfcos(model)
    taps = calibrate_resnet50(model.backbone, calib_images, compute_dtype)
    return quantize_resnet50(model.backbone, taps)


def _backbone_int8_feats(qtree_bb: Dict, images: torch.Tensor, **kw):
    """(C3..C5) int8 NHWC + scales through the int8 ResNet-50 ladder (the
    per-op oracle unless ``backend`` says otherwise)."""
    kw.setdefault("backend", "xla")
    return resnet50_int8_forward(qtree_bb, images, torch.float32, dequant=False, **kw)


def make_eval_forward_int8(model: nn.Module, compute_dtype: torch.dtype = torch.bfloat16,
                           backend: str = "pallas_block", fused_head: bool = False, fuse_strided: bool = True,
                           int8_fpn: bool = False, int8_head: bool = False, u8_input: bool = False,
                           plain: bool = False) -> Callable[[Dict, torch.Tensor], Levels]:
    """Inference forward with an int8-PTQ backbone: ``fwd(qtree, images) ->
    per-level f32 NHWC (cls, cnt, reg)``, ``images`` normalized NHWC floats.

    The int8 C3..C5 are dequantized to ``compute_dtype`` and turned NCHW
    there, once; the HisFPN runs BN-folded (its kernels folded here, once,
    from the model's f32 weights) and the head runs on a copy of
    ``model.head`` in ``compute_dtype``.  Later changes to ``model`` are
    not seen.  ``plain=True`` runs every kernel's plain version, for the
    comparison only.
    """
    _require_hisfcos(model)
    if int8_fpn or int8_head:
        raise NotImplementedError(f"int8_fpn / int8_head are not ported yet: {INT8_FPN_ITEM}")
    if fused_head:
        raise NotImplementedError(f"fused_head=True is not ported yet: {FUSED_HEAD_ITEM}")
    fpn = model.fpn
    folded = fold_hisfpn(fpn, compute_dtype)
    head = copy.deepcopy(model.head).to(compute_dtype).eval()

    @torch.inference_mode()
    def fwd(qtree: Dict, images: torch.Tensor) -> Levels:
        feats = resnet50_int8_forward(qtree, images, compute_dtype, backend=backend,
                                      fuse_strided=fuse_strided, u8_stem=u8_input, plain=plain)
        feats = [f.permute(0, 3, 1, 2).contiguous() for f in feats]  # the dequant seam: NHWC -> NCHW
        levels = hisfpn_folded_forward(fpn, feats, compute_dtype, folded=folded)
        outs = head(levels, plain)
        return tuple([o.permute(0, 2, 3, 1).float() for o in branch] for branch in outs)

    return fwd
