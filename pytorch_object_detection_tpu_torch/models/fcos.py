"""FCOS, HISFCOS and MNFCOS detector assembly (PyTorch).

Counterparts of ``pytorch_object_detection_tpu/models/fcos.py``'s ``FCOS``
(ResNet-50 or EfficientNet-B0 -> the classic FPN -> FCOSHead), ``HISFCOS`` (ResNet-50 ->
HisFPN -> HISHead) and ``MNFCOS`` (ResNet-50 with the 7x7 stem ->
LightweightFPN -> MNHead).  The forward takes NHWC float images
(normalized) and returns per-level NHWC (cls, cnt, reg) lists, the JAX
package's layouts; inside, everything runs NCHW.  Every BatchNorm is frozen
(the reference's only trained configuration) unless the model is built
with ``freeze_bn=False`` (the JAX field): then its affines are parameters
and, in training mode, it normalizes with the batch's statistics (JAX:
``bn_train = train and not freeze_bn``; ``nn/layers.BatchNorm``).  ``frozen_stages=k`` puts the
ResNet-50's gradient barrier after ``layer{k}``; the trainer freezes the
matching parameters (``train/trainer.param_labels``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pytorch_object_detection_tpu_torch.models.heads import FCOSHead, HISHead, LevelOutputs, MNHead
from pytorch_object_detection_tpu_torch.nn.efficientnet import EfficientNet
from pytorch_object_detection_tpu_torch.nn.fpn import FPN, HisFPN, LightweightFPN
from pytorch_object_detection_tpu_torch.nn.layers import unfreeze_batchnorms
from pytorch_object_detection_tpu_torch.nn.resnet import ResNet50

BACKBONES = ("resnet50", "efficientnet-b0")  # the JAX FCOS's


class _Detector(nn.Module):
    """``backbone`` -> ``fpn`` -> ``head``, set by the subclass."""

    def _finish(self, freeze_bn: bool, device) -> None:
        """Eval mode, the BatchNorms trainable unless ``freeze_bn``, on ``device``."""
        self.freeze_bn = freeze_bn
        if not freeze_bn:
            unfreeze_batchnorms(self)
        self.eval()
        self.to(device)

    def forward(self, images: torch.Tensor, plain: bool = False) -> LevelOutputs:
        """images ``[B, H, W, 3]`` float -> per-level ``[B, H_i, W_i, C]``
        (cls, cnt, reg).  ``plain=True`` runs every kernel's plain version,
        for the comparison only."""
        x = images.permute(0, 3, 1, 2).contiguous()
        levels = self.fpn(self.backbone(x)[-3:])  # EfficientNet returns five endpoints
        outs = self.head(levels, plain)
        return tuple([o.permute(0, 2, 3, 1) for o in branch] for branch in outs)


class FCOS(_Detector):
    """The classic FCOS; weights and device as :class:`HISFCOS`.  Its float
    forward runs kernel B 40 times (the FCOSHead's eight tower GroupNorms a
    level).  ``backbone`` is ``"resnet50"`` or ``"efficientnet-b0"`` (the
    JAX model's two; C3..C5 of 40, 112 and 320 channels into the FPN);
    ``frozen_stages`` puts a gradient barrier into the ResNet-50 only, as
    the JAX model passes it to the ResNet-50 alone."""

    def __init__(self, num_classes: int = 20, features: int = 256, backbone: str = "resnet50", *,
                 frozen_stages: int = 0, freeze_bn: bool = True, device: torch.device | str = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if backbone not in BACKBONES:
            raise ValueError(f"FCOS backbone must be one of {BACKBONES}; got {backbone!r}")
        self.num_classes = num_classes
        self.backbone_name = backbone
        if backbone == "efficientnet-b0":
            self.backbone = EfficientNet.b0(generator=generator)
            in_channels = self.backbone.endpoint_channels()[-3:]
        else:
            self.backbone = ResNet50(grad_barrier_stages=frozen_stages, generator=generator)
            in_channels = (512, 1024, 2048)
        self.fpn = FPN(in_channels, features, generator=generator)
        self.head = FCOSHead(num_classes, features, generator=generator)
        self._finish(freeze_bn, device)


class HISFCOS(_Detector):
    """Half-Inverted-Stage FCOS, the flagship model.

    Weights are drawn on the CPU from ``generator`` (a seed gives the same
    weights whatever the device) and then moved to ``device``: the card by
    default (PyTorch raises where there is none); pass ``device="cpu"`` for
    the CPU.
    """

    def __init__(self, num_classes: int = 20, features: int = 256, stem_mode: str = "conv7", *,
                 frozen_stages: int = 0, freeze_bn: bool = True, device: torch.device | str = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = ResNet50(stem_mode=stem_mode, grad_barrier_stages=frozen_stages, generator=generator)
        self.fpn = HisFPN((512, 1024, 2048), features, generator=generator)
        self.head = HISHead(num_classes, features, generator=generator)
        self._finish(freeze_bn, device)


class MNFCOS(_Detector):
    """FCOS with the lightweight MNBlock pyramid and head; weights and
    device as :class:`HISFCOS`.  Its float forward runs kernel B 10 times
    (the head's GroupNorms)."""

    def __init__(self, num_classes: int = 20, features: int = 256, *, frozen_stages: int = 0,
                 freeze_bn: bool = True, device: torch.device | str = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = ResNet50(grad_barrier_stages=frozen_stages, generator=generator)
        self.fpn = LightweightFPN((512, 1024, 2048), features, generator=generator)
        self.head = MNHead(num_classes, features, generator=generator)
        self._finish(freeze_bn, device)


def default_strides() -> Sequence[int]:
    return (8, 16, 32, 64, 128)
