"""FCOS losses (PyTorch): sigmoid focal (cls), BCE centerness, IoU/GIoU regression.

Counterpart of ``pytorch_object_detection_tpu/ops/losses.py``, operation
for operation.  Inputs are flattened over levels: ``[B, N, C]`` predictions
against the ``[B, N, ...]`` targets of :mod:`.targets`.  The positive mask
is ``cnt_target > -1``; each loss is a per-sample sum over ``num_pos``
(at least 1), then the batch mean.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_object_detection_tpu_torch.ops.boxes import ltrb_giou, ltrb_iou

# the focal loss's clip window, as f32 values: log(pt) in [log 5e-6, -5e-11], 1 - pt in [5e-11, 1 - 5e-6]
_LOG_PT_MIN = float(np.log(np.float32(5e-6)))


def flatten_level_preds(preds: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate per-level NHWC predictions to ``[B, sum(H*W), C]``."""
    b, c = preds[0].shape[0], preds[0].shape[-1]
    return torch.cat([p.reshape(b, -1, c) for p in preds], dim=1)


def sigmoid_focal_loss(logits: torch.Tensor, targets_onehot: torch.Tensor, gamma: float = 2.0,
                       alpha: float = 0.25) -> torch.Tensor:
    """Elementwise sigmoid focal loss with the probability window ``[5e-6,
    1 - 5e-11]`` applied in log space: ``log(pt)`` from ``logsigmoid`` and
    ``1 - pt`` from the stable ``sigmoid``, each clipped, so the value and
    its gradient stay finite at any logit (in f32 ``1 - 5e-11`` rounds to
    1, ``-5e-11`` does not)."""
    t = targets_onehot
    log_pt = F.logsigmoid(logits) * t + F.logsigmoid(-logits) * (1.0 - t)
    log_pt = log_pt.clamp(_LOG_PT_MIN, -5e-11)
    one_m_pt = torch.sigmoid(-logits) * t + torch.sigmoid(logits) * (1.0 - t)
    one_m_pt = one_m_pt.clamp(5e-11, 1.0 - 5e-6)
    w = alpha * t + (1.0 - alpha) * (1.0 - t)
    return -w * torch.pow(one_m_pt, gamma) * log_pt


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise binary cross entropy with logits."""
    return logits.clamp(min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def distance_centerness_loss(cnt_logits: torch.Tensor, cnt_target: torch.Tensor, reg_preds: torch.Tensor,
                             reg_target: torch.Tensor, mask: torch.Tensor, num_pos: torch.Tensor,
                             distance_weight: float = 0.5) -> torch.Tensor:
    """Distance-aware centerness: BCE on centerness plus ``distance_weight``
    times an L1 between the sigmoids of the predicted and the target box
    diagonals, on positives; per-sample sum over ``num_pos``, batch mean."""
    zero = torch.zeros((), device=cnt_logits.device)
    bce = torch.where(mask, bce_with_logits(cnt_logits[..., 0], torch.where(mask, cnt_target[..., 0], zero)), zero)

    def diag(reg):
        w = reg[..., 0] + reg[..., 2]
        h = reg[..., 1] + reg[..., 3]
        return torch.sigmoid(torch.sqrt((w * w + h * h).clamp(min=0.0)))

    safe_t = torch.where(mask[..., None], reg_target, torch.ones((), device=reg_target.device))
    l1 = torch.where(mask, (diag(reg_preds) - diag(safe_t)).abs(), zero)
    per_sample = (bce + distance_weight * l1).sum(dim=1)
    return (per_sample / num_pos).mean()


def fcos_loss(cls_logits: torch.Tensor, cnt_logits: torch.Tensor, reg_preds: torch.Tensor,
              cls_target: torch.Tensor, cnt_target: torch.Tensor, reg_target: torch.Tensor,
              mode: str = "giou", cnt_mode: str = "bce") -> Dict[str, torch.Tensor]:
    """The FCOS loss: ``cls`` (focal over every location), ``cnt`` (BCE on
    positives, or ``cnt_mode="dcnt"``'s distance-aware form), ``reg``
    (``mode`` ``"giou"``: 1 - GIoU, or ``"iou"``: -log IoU, on positives,
    masked rows set to 1.0 before the overlap) and ``total``, each a 0-d
    tensor on the predictions' device."""
    if mode not in ("giou", "iou"):
        raise NotImplementedError("reg loss only implemented ['iou','giou']")
    if cnt_mode not in ("bce", "dcnt"):
        raise ValueError(f"cnt_mode must be 'bce' or 'dcnt'; got {cnt_mode!r}")
    num_classes = cls_logits.shape[-1]
    dev = cls_logits.device
    zero = torch.zeros((), device=dev)
    one = torch.ones((), device=dev)
    mask = cnt_target[..., 0] > -1  # [B, N]
    num_pos = mask.sum(dim=1).clamp(min=1).float()  # [B]

    onehot = (torch.arange(1, num_classes + 1, dtype=cls_target.dtype, device=dev)[None, None, :]
              == cls_target).float()
    cls_loss = (sigmoid_focal_loss(cls_logits, onehot).sum(dim=(1, 2)) / num_pos).mean()

    if cnt_mode == "dcnt":
        cnt_loss = distance_centerness_loss(cnt_logits, cnt_target, reg_preds, reg_target, mask, num_pos)
    else:
        cnt_elem = bce_with_logits(cnt_logits[..., 0], torch.where(mask, cnt_target[..., 0], zero))
        cnt_loss = (torch.where(mask, cnt_elem, zero).sum(dim=1) / num_pos).mean()

    safe_target = torch.where(mask[..., None], reg_target, one)
    safe_pred = torch.where(mask[..., None], reg_preds, one)
    if mode == "iou":
        reg_elem = -torch.log(ltrb_iou(safe_pred, safe_target).clamp(min=1e-6))
    else:
        reg_elem = 1.0 - ltrb_giou(safe_pred, safe_target)
    reg_loss = (torch.where(mask, reg_elem, zero).sum(dim=1) / num_pos).mean()
    return {"cls": cls_loss, "cnt": cnt_loss, "reg": reg_loss, "total": cls_loss + cnt_loss + reg_loss}
