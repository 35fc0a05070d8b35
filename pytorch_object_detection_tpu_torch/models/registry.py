"""Model construction by config name (counterpart of the JAX package's registry).

FCOS, HISFCOS, MNFCOS and MC_FCOS are ported; the other names the JAX
package registers (the anchor families) raise and point at the ROADMAP item
that ports them.
"""
from __future__ import annotations

from torch import nn

from pytorch_object_detection_tpu_torch.models.fcos import FCOS, HISFCOS, MNFCOS
from pytorch_object_detection_tpu_torch.models.mcfcos import MC_FCOS

_PORTED = {"FCOS": FCOS, "HISFCOS": HISFCOS, "MNFCOS": MNFCOS, "MC_FCOS": MC_FCOS}
_NOT_PORTED = {
    "RETINANET": "ROADMAP.md queue 1, item 10 (other families: RetinaNet)",
    "SSD300": "ROADMAP.md queue 1, item 10 (other families: SSD300)",
}


def available_models():
    return sorted(_PORTED)


def build_model(name: str, num_classes: int, features: int = 256, **kwargs) -> nn.Module:
    """Build a detector by config name.  ``kwargs`` go to the constructor
    (``device``, ``generator``, ``frozen_stages``; HISFCOS also ``stem_mode``, FCOS ``backbone``); the
    model goes to the card unless ``device`` says otherwise."""
    key = name.upper()
    if key in _PORTED:
        return _PORTED[key](num_classes, features, **kwargs)
    if key in _NOT_PORTED:
        raise NotImplementedError(f"model '{name}' is not ported yet: {_NOT_PORTED[key]}")
    raise KeyError(f"unknown model '{name}'; available: {available_models()}")
