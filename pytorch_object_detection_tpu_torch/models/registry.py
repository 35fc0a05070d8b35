"""Model construction by config name (counterpart of the JAX package's registry).

HISFCOS and MNFCOS are ported; the other names the JAX package registers
raise and point at the ROADMAP item that ports them.
"""
from __future__ import annotations

from torch import nn

from pytorch_object_detection_tpu_torch.models.fcos import HISFCOS, MNFCOS

_NOT_PORTED = {
    "FCOS": "ROADMAP.md queue 1, item 10 (other families: FCOS)",
    "MC_FCOS": "ROADMAP.md queue 1, item 10 (other families: MC_FCOS)",
    "RETINANET": "ROADMAP.md queue 1, item 10 (other families: RetinaNet)",
    "SSD300": "ROADMAP.md queue 1, item 10 (other families: SSD300)",
}


def available_models():
    return ["HISFCOS", "MNFCOS"]


def build_model(name: str, num_classes: int, features: int = 256, **kwargs) -> nn.Module:
    """Build a detector by config name.  ``kwargs`` go to the constructor
    (``device``, ``generator``, ``frozen_stages``; HISFCOS also ``stem_mode``); the model goes
    to the card unless ``device`` says otherwise."""
    key = name.upper()
    if key == "HISFCOS":
        return HISFCOS(num_classes, features, **kwargs)
    if key == "MNFCOS":
        return MNFCOS(num_classes, features, **kwargs)
    if key in _NOT_PORTED:
        raise NotImplementedError(f"model '{name}' is not ported yet: {_NOT_PORTED[key]}")
    raise KeyError(f"unknown model '{name}'; available: {available_models()}")
