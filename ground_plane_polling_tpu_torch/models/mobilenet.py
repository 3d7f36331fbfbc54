"""MobileNet v1 backbones with width multiplier alpha (port of
ground_plane_polling_tpu/models/mobilenet.py).

conv0 (3x3 stride 2 SAME, no bias), bn0 and ReLU6; then 13 blocks, each a
depthwise 3x3 SAME conv `dw{i}` (groups = channels, stride 1 or 2, no
bias), `dw{i}_bn`, ReLU6, a pointwise 1x1 conv `pw{i}` to int(f alpha)
channels, `pw{i}_bn`, ReLU6. C3, C4 and C5 are pw5, pw11 and pw13
(strides 8, 16, 32). The Flax depthwise kernel is HWIO (3, 3, 1, C); the
weight bridge's OIHW transpose makes it (C, 1, 3, 3), a groups=C conv's
weight.
"""

from __future__ import annotations

import functools

import torch.nn.functional as F
from torch import nn

from .common import FrozenBatchNorm
from .fpn import same_conv

__all__ = ["MobileNetBackbone", "REGISTRY"]

# (pointwise filters, stride) of the 13 depthwise-separable blocks
_BLOCKS = [
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
]
_ALPHAS = {"mobilenet224_1.0": 1.0, "mobilenet224_0.75": 0.75,
           "mobilenet224_0.5": 0.5, "mobilenet224_0.25": 0.25}


class MobileNetBackbone(nn.Module):
    def __init__(self, alpha: float = 1.0):
        super().__init__()
        ch = int(32 * alpha)
        self.conv0 = same_conv(3, ch, 3, stride=2, bias=False)
        self.bn0 = FrozenBatchNorm(ch)
        for i, (f, s) in enumerate(_BLOCKS, start=1):
            out = int(f * alpha)
            self.add_module(f"dw{i}", same_conv(ch, ch, 3, stride=s,
                                                groups=ch, bias=False))
            self.add_module(f"dw{i}_bn", FrozenBatchNorm(ch))
            self.add_module(f"pw{i}", nn.Conv2d(ch, out, 1, bias=False))
            self.add_module(f"pw{i}_bn", FrozenBatchNorm(out))
            ch = out
        self.channels = tuple(int(_BLOCKS[i - 1][0] * alpha)
                              for i in (5, 11, 13))

    def forward(self, x):
        x = x.to(self.conv0.weight.dtype)
        x = F.relu6(self.bn0(self.conv0(x)))
        feats = {}
        for i in range(1, len(_BLOCKS) + 1):
            x = F.relu6(getattr(self, f"dw{i}_bn")(getattr(self, f"dw{i}")(x)))
            x = F.relu6(getattr(self, f"pw{i}_bn")(getattr(self, f"pw{i}")(x)))
            feats[i] = x
        return feats[5], feats[11], feats[13]


REGISTRY = {name: functools.partial(MobileNetBackbone, alpha)
            for name, alpha in _ALPHAS.items()}
