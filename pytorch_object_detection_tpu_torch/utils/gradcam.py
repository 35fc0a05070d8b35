"""GradCAM for the FCOS-family detectors.

Counterpart of ``pytorch_object_detection_tpu/utils/gradcam.py``: split the
network at the backbone, take ``d(score)/d(C5)`` by autograd, where score is
the summed per-image max class logit of one pyramid level, and weight the C5
activation by the pooled gradients (classic GradCAM).  No hooks: the
backbone's C3..C5 are taken without a graph, and the graph starts at C5.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def gradcam_fcos(model: nn.Module, images: torch.Tensor, level: int = 0) -> np.ndarray:
    """GradCAM heatmaps ``[B, H, W]`` in [0, 1] for a HISFCOS, MNFCOS or FCOS
    (ResNet-50 or EfficientNet-B0 backbone).

    ``images``: NORMALIZED NHWC float frames; they go to the model's device
    and dtype (the card unless the model is on the CPU).  heat = ReLU(sum_c
    w_c * A_c) on the C5 activation, where w = GAP of d(score)/dA and score
    = the sum over images of the max class logit over every location of
    ``level``; upsampled bilinearly to the frame (half-pixel centres, edges
    clamped: ``jax.image.resize``'s ``"bilinear"`` when it enlarges), then
    min-max normalized per image.  The model carries its weights, so there
    is no ``variables`` argument.
    """
    fpn, head = _fpn_head_for(model)
    param = next(model.parameters())
    x = images.to(param.device, param.dtype).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        feats = model.backbone(x)[-3:]  # EfficientNet returns five endpoints
    c5 = feats[2].detach().requires_grad_(True)
    with torch.enable_grad():
        cls_l = head(fpn((feats[0], feats[1], c5)))[0]
        score = cls_l[level].amax(dim=(1, 2, 3)).sum()
        (grads,) = torch.autograd.grad(score, c5)
    with torch.no_grad():
        weights = grads.mean(dim=(2, 3), keepdim=True)
        cam = torch.relu((weights * c5).sum(dim=1, keepdim=True))  # [B, 1, h, w]
        cam = F.interpolate(cam.float(), size=tuple(images.shape[1:3]), mode="bilinear", align_corners=False)[:, 0]
        cam = cam - cam.amin(dim=(1, 2), keepdim=True)
        cam = cam / cam.amax(dim=(1, 2), keepdim=True).clamp(min=1e-8)
    return cam.cpu().numpy()


def _fpn_head_for(model: nn.Module) -> Tuple[nn.Module, nn.Module]:
    """The (fpn, head) of a detector assembly: HISFCOS (HisFPN, HISHead),
    MNFCOS (LightweightFPN, MNHead), FCOS (FPN, FCOSHead).  MC_FCOS has no
    such split (its neck and head are one block, MCBlock) and raises
    ``ValueError``; the JAX function falls through to the FCOS branch there
    and fails looking up ``params["fpn"]`` (a ``KeyError``)."""
    from pytorch_object_detection_tpu_torch.models.fcos import FCOS, HISFCOS, MNFCOS

    if isinstance(model, (HISFCOS, MNFCOS, FCOS)):
        return model.fpn, model.head
    raise ValueError(f"GradCAM splits a HISFCOS, MNFCOS or FCOS at its backbone into the FPN and the head; "
                     f"{type(model).__name__} has no such split")


def overlay_heatmap(image_u8: np.ndarray, cam: np.ndarray, alpha: float = 0.4) -> np.ndarray:
    """Blend a [0,1] heatmap over an RGB uint8 image (OpenCV's JET map)."""
    import cv2

    heat = cv2.applyColorMap((cam * 255).astype(np.uint8), cv2.COLORMAP_JET)
    heat = cv2.cvtColor(heat, cv2.COLOR_BGR2RGB)
    return ((1 - alpha) * image_u8 + alpha * heat).astype(np.uint8)
