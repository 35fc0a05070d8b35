"""Model construction by config name (counterpart of the JAX package's registry).

Every name the JAX package registers is ported: FCOS, HISFCOS, MNFCOS,
MC_FCOS and the anchor families RETINANET and SSD300.
"""
from __future__ import annotations

import inspect

from torch import nn

from pytorch_object_detection_tpu_torch.models.fcos import FCOS, HISFCOS, MNFCOS
from pytorch_object_detection_tpu_torch.models.mcfcos import MC_FCOS
from pytorch_object_detection_tpu_torch.models.retinanet import RetinaNet
from pytorch_object_detection_tpu_torch.models.ssd import SSD300

_PORTED = {"FCOS": FCOS, "HISFCOS": HISFCOS, "MNFCOS": MNFCOS, "MC_FCOS": MC_FCOS, "RETINANET": RetinaNet,
           "SSD300": SSD300}


def register(name: str):
    """Decorator: ``@register("NAME")`` on a builder (a class or function
    taking ``num_classes, features, **kwargs``) adds it under ``NAME``
    (case-insensitive) to the table :func:`build_model` reads."""
    def deco(ctor):
        _PORTED[name.upper()] = ctor
        return ctor

    return deco


def available_models():
    return sorted(_PORTED)


def build_model(name: str, num_classes: int, features: int = 256, **kwargs) -> nn.Module:
    """Build a detector by config name.  ``kwargs`` go to the constructor
    (``device``, ``generator``, ``frozen_stages``; HISFCOS also
    ``stem_mode``, FCOS ``backbone``), those it does not take dropped, as
    the JAX registry drops the fields a model lacks (RetinaNet and SSD300
    take no ``frozen_stages``); the model goes to the card unless
    ``device`` says otherwise.  SSD300 gets ``num_classes + 1`` logits a
    box: its softmax carries the background as class 0."""
    key = name.upper()
    if key not in _PORTED:
        raise KeyError(f"unknown model '{name}'; available: {available_models()}")
    ctor = _PORTED[key]
    if key == "SSD300":
        num_classes = num_classes + 1
    taken = inspect.signature(ctor).parameters
    return ctor(num_classes, features, **{k: v for k, v in kwargs.items() if k in taken})
