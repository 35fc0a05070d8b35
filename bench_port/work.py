"""Work counts from shapes, and the card's published peaks.

The operations of a forward pass are counted by running the benchmark's
own reference (``reference/models.py``) on meta tensors under PyTorch's
``FlopCounterMode``: every convolution at its shapes, two operations a
multiply-add, whatever the program runs it with.  Normalizations, pools
and activations are not counted.  Kernel C's work is the 16 bottlenecks
of ResNet-50 (the backbone less its stem conv).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port.reference import models

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit (operations a second)
PEAK_OPS = {"int8": 1979e12, "fp8": 1979e12, "bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def _meta_weights(family: str, num_classes: int, features: int):
    specs = models.weight_specs(family, num_classes, features)
    return {k: torch.empty(shape, device="meta") for k, (shape, _) in specs.items()}


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@functools.lru_cache(maxsize=None)
def forward_ops(family: str, num_classes: int, features: int, h: int, w: int) -> int:
    """Operations of one image's forward pass at an ``h`` x ``w`` canvas."""
    wts = _meta_weights(family, num_classes, features)
    x = torch.empty(1, h, w, 3, device="meta")
    return _count(lambda: models.forward(family, wts, x))


@functools.lru_cache(maxsize=None)
def bottleneck_ops(h: int, w: int) -> int:
    """Operations of ResNet-50's 16 bottlenecks for one image (kernel C's
    13 stride-1 and 3 stride-2 launches)."""
    wts = _meta_weights("HISFCOS", 1, 256)
    x = torch.empty(1, 3, h, w, device="meta")
    stem = _count(lambda: models.conv(wts, "backbone.conv1", x, 2, 3))
    return _count(lambda: models.resnet50(wts, x)) - stem


def roofline_pct(ops: float, seconds: float, peak: str) -> float:
    """Share of the peak that ``ops`` in ``seconds`` of device time reach, in %."""
    return 100.0 * ops / (seconds * PEAK_OPS[peak])
