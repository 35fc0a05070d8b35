"""HISFCOS and MNFCOS detector assembly (PyTorch).

Counterparts of ``pytorch_object_detection_tpu/models/fcos.py``'s ``HISFCOS``
(ResNet-50 -> HisFPN -> HISHead) and ``MNFCOS`` (ResNet-50 with the 7x7 stem
-> LightweightFPN -> MNHead).  The forward takes NHWC float images
(normalized) and returns per-level NHWC (cls, cnt, reg) lists, the JAX
package's layouts; inside, everything runs NCHW.  Every BatchNorm is frozen
(the reference's only trained configuration).  ``frozen_stages=k`` puts the
backbone's gradient barrier after ``layer{k}``; the trainer freezes the
matching parameters (``train/trainer.param_labels``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pytorch_object_detection_tpu_torch.models.heads import HISHead, LevelOutputs, MNHead
from pytorch_object_detection_tpu_torch.nn.fpn import HisFPN, LightweightFPN
from pytorch_object_detection_tpu_torch.nn.resnet import ResNet50


class _Detector(nn.Module):
    """ResNet-50 -> ``fpn`` -> ``head``, set by the subclass."""

    def forward(self, images: torch.Tensor, plain: bool = False) -> LevelOutputs:
        """images ``[B, H, W, 3]`` float -> per-level ``[B, H_i, W_i, C]``
        (cls, cnt, reg).  ``plain=True`` runs every kernel's plain version,
        for the comparison only."""
        x = images.permute(0, 3, 1, 2).contiguous()
        levels = self.fpn(self.backbone(x))
        outs = self.head(levels, plain)
        return tuple([o.permute(0, 2, 3, 1) for o in branch] for branch in outs)


class HISFCOS(_Detector):
    """Half-Inverted-Stage FCOS, the flagship model.

    Weights are drawn on the CPU from ``generator`` (a seed gives the same
    weights whatever the device) and then moved to ``device``: the card by
    default (PyTorch raises where there is none); pass ``device="cpu"`` for
    the CPU.
    """

    def __init__(self, num_classes: int = 20, features: int = 256, stem_mode: str = "conv7", *,
                 frozen_stages: int = 0, device: torch.device | str = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = ResNet50(stem_mode=stem_mode, grad_barrier_stages=frozen_stages, generator=generator)
        self.fpn = HisFPN((512, 1024, 2048), features, generator=generator)
        self.head = HISHead(num_classes, features, generator=generator)
        self.eval()
        self.to(device)


class MNFCOS(_Detector):
    """FCOS with the lightweight MNBlock pyramid and head; weights and
    device as :class:`HISFCOS`.  Its float forward runs kernel B 10 times
    (the head's GroupNorms)."""

    def __init__(self, num_classes: int = 20, features: int = 256, *, frozen_stages: int = 0,
                 device: torch.device | str = "cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = ResNet50(grad_barrier_stages=frozen_stages, generator=generator)
        self.fpn = LightweightFPN((512, 1024, 2048), features, generator=generator)
        self.head = MNHead(num_classes, features, generator=generator)
        self.eval()
        self.to(device)


def default_strides() -> Sequence[int]:
    return (8, 16, 32, 64, 128)
