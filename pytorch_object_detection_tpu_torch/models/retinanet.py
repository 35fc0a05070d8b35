"""RetinaNet (anchor-based, 9 anchors a cell) in PyTorch.

Counterpart of ``pytorch_object_detection_tpu/models/retinanet.py``:
ResNet-50 C3-C5 (``nn/resnet.py``), :class:`RetinaFPN` (conv + frozen BN +
ReLU blocks, P6 a strided conv on C5, P7 one on relu(P6)), and two 4-conv
:class:`SubNet` s shared across the five levels, the classification one
with the focal prior bias on its output.  The forward takes NHWC
normalized float images and returns ``loc [B, N, 4]`` and ``cls [B, N,
C]`` logits over ``N = sum(H * W * A)`` anchors in the order of
``ops/anchors.generate_anchors`` (level, then row-major position, then
anchor); inside, everything runs NCHW.  Names follow the flax scopes
(``backbone``, ``fpn.p5_1_conv``, ``fpn.p5_1_bn``, ``regression.conv0``,
``classification.out``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from pytorch_object_detection_tpu_torch.models.heads import prior_bias
from pytorch_object_detection_tpu_torch.nn.layers import BatchNorm, Conv, relu, unfreeze_batchnorms, upsample2x
from pytorch_object_detection_tpu_torch.nn.resnet import ResNet50

STRIDES = (8, 16, 32, 64, 128)
NUM_TOWER = 4
# (block, input: "c3" | "c4" | "c5" | "f", kernel, stride), the JAX model's order of calls
FPN_BLOCKS = (("p5_1", "c5", 1, 1), ("p5_2", "f", 3, 1), ("p4_1", "c4", 1, 1), ("p4_2", "f", 3, 1),
              ("p3_1", "c3", 1, 1), ("p3_2", "f", 3, 1), ("p6", "c5", 3, 2), ("p7", "f", 3, 2))


class RetinaFPN(nn.Module):
    """conv (no bias) + frozen BN + ReLU blocks: P5 from C5, P4 and P3 with
    the top-down adds (after each lateral's ReLU), P6 a 3x3/2 conv on C5,
    P7 a 3x3/2 conv on relu(P6)."""

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048), features: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cin = dict(zip(("c3", "c4", "c5"), in_channels), f=features)
        for name, src, k, stride in FPN_BLOCKS:
            self.add_module(f"{name}_conv", Conv(cin[src], features, k, stride, bias=False, generator=generator))
            self.add_module(f"{name}_bn", BatchNorm(features))

    def cba(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return relu(getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x)))

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        c3, c4, c5 = feats
        p5 = self.cba(c5, "p5_1")
        p5_out = self.cba(p5, "p5_2")
        p4 = self.cba(c4, "p4_1") + upsample2x(p5)
        p4_out = self.cba(p4, "p4_2")
        p3 = self.cba(c3, "p3_1") + upsample2x(p4)
        p3_out = self.cba(p3, "p3_2")
        p6 = self.cba(c5, "p6")
        p7 = self.cba(relu(p6), "p7")
        return p3_out, p4_out, p5_out, p6, p7


class SubNet(nn.Module):
    """4 x (3x3 conv + ReLU) tower and a 3x3 output conv, all ``head``-init;
    ``bias_const`` sets the output's bias."""

    def __init__(self, out_channels: int, features: int = 256, bias_const: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for i in range(NUM_TOWER):
            self.add_module(f"conv{i}", Conv(features, features, 3, winit="head", generator=generator))
        self.out = Conv(features, out_channels, 3, winit="head", bias_const=bias_const, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(NUM_TOWER):
            x = relu(getattr(self, f"conv{i}")(x))
        return self.out(x)


class RetinaNet(nn.Module):
    """RetinaNet; weights are drawn on the CPU from ``generator`` and moved to
    ``device``: the card by default; pass ``device="cpu"`` for the CPU.
    Every BatchNorm is frozen unless ``freeze_bn=False`` (the JAX model's
    field; ``nn/layers.BatchNorm``)."""

    def __init__(self, num_classes: int = 80, features: int = 256, num_anchors: int = 9, *,
                 freeze_bn: bool = True, device: torch.device | str = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.num_classes, self.features, self.num_anchors = num_classes, features, num_anchors
        self.backbone = ResNet50(generator=g)
        self.fpn = RetinaFPN((512, 1024, 2048), features, generator=g)
        self.regression = SubNet(num_anchors * 4, features, generator=g)
        self.classification = SubNet(num_anchors * num_classes, features, bias_const=prior_bias(0.01), generator=g)
        self.freeze_bn = freeze_bn
        if not freeze_bn:
            unfreeze_batchnorms(self)
        self.eval()
        self.to(device)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images ``[B, H, W, 3]`` -> (loc ``[B, N, 4]``, cls ``[B, N, C]``)."""
        levels = self.fpn(self.backbone(images.permute(0, 3, 1, 2)))
        b = images.shape[0]
        regs: List[torch.Tensor] = []
        clss: List[torch.Tensor] = []
        for lvl in levels:
            regs.append(self.regression(lvl).permute(0, 2, 3, 1).reshape(b, -1, 4))
            clss.append(self.classification(lvl).permute(0, 2, 3, 1).reshape(b, -1, self.num_classes))
        return torch.cat(regs, dim=1), torch.cat(clss, dim=1)

    def level_shapes(self, hw: Tuple[int, int]) -> List[Tuple[int, int]]:
        return [(-(-hw[0] // s), -(-hw[1] // s)) for s in STRIDES]
