"""VGG-16 backbone, SSD flavour (PyTorch, NCHW).

Counterpart of ``pytorch_object_detection_tpu/nn/vgg.py``: the 13 stage
convs with ReLU, 2x2/2 pools (pool3 in ceil mode), pool5 as a 3x3/1 'same'
pool (padding at -inf), ``conv6`` a 3x3 conv at dilation 6 to 1024
channels, ``conv7`` a 1x1 to 1024.  Returns (relu(conv4_3) [512 ch, /8],
relu(conv7) [1024 ch, /16]).  Module names follow the flax scopes
(``conv1_1`` .. ``conv5_3``, ``conv6``, ``conv7``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_object_detection_tpu_torch.nn.layers import Conv, relu

STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


def maxpool(x: torch.Tensor, window: int = 2, stride: int = 2, ceil: bool = False,
            pad_same: bool = False) -> torch.Tensor:
    """The JAX ``_maxpool``: ``pad_same`` a 1-pixel -inf border (pool5), ``ceil``
    the last partial window kept (pool3: 75 -> 38)."""
    return F.max_pool2d(x, window, stride, padding=1 if pad_same else 0, ceil_mode=ceil)


class VGG16(nn.Module):
    def __init__(self, ceil_mode_pool3: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ceil_mode_pool3 = ceil_mode_pool3
        in_ch = 3
        for stage, (ch, n) in enumerate(STAGES):
            for i in range(n):
                self.add_module(f"conv{stage + 1}_{i + 1}", Conv(in_ch, ch, 3, generator=generator))
                in_ch = ch
        self.conv6 = Conv(512, 1024, 3, dilation=6, generator=generator)
        self.conv7 = Conv(1024, 1024, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        conv4_3 = None
        for stage, (_, n) in enumerate(STAGES):
            for i in range(n):
                x = relu(getattr(self, f"conv{stage + 1}_{i + 1}")(x))
            if stage == 3:
                conv4_3 = x
            if stage < 4:
                x = maxpool(x, ceil=stage == 2 and self.ceil_mode_pool3)
        x = maxpool(x, window=3, stride=1, pad_same=True)
        x = relu(self.conv6(x))
        return conv4_3, relu(self.conv7(x))
