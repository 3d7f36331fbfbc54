"""DenseNet-121 / 169 / 201 backbones with frozen BN (port of
ground_plane_polling_tpu/models/densenet.py).

The stem is a 7x7 stride-2 conv with an explicit 3-pixel padding (not
SAME), stem_bn, ReLU and a 3x3 stride-2 max-pool over a 1-pixel -inf
border. A dense layer is bn1, ReLU, a 1x1 conv to 128, bn2, ReLU, a 3x3
SAME conv to 32 (the growth), concatenated to its input. A transition is
bn, ReLU, a 1x1 conv to half the channels and a 2x2 stride-2 average pool
with Flax SAME padding, which counts the padded zeros (Flax's
count_include_pad): the map is zero-padded here, then pooled without
padding. C3, C4 and C5 are the outputs of dense blocks 2, 3 and 4
(strides 8, 16, 32; 512, 1024 and 1024 channels for densenet121).
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import FrozenBatchNorm
from .resnet import same_pad

__all__ = ["DenseNetBackbone", "REGISTRY"]

_CFG = {
    "densenet121": (6, 12, 24, 16),
    "densenet169": (6, 12, 32, 32),
    "densenet201": (6, 12, 48, 32),
}
_GROWTH = 32


class _DenseLayer(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.bn1 = FrozenBatchNorm(cin)
        self.conv1 = nn.Conv2d(cin, 4 * _GROWTH, 1, bias=False)
        self.bn2 = FrozenBatchNorm(4 * _GROWTH)
        self.conv2 = nn.Conv2d(4 * _GROWTH, _GROWTH, 3, padding=1,
                               bias=False)

    def forward(self, x):
        y = self.conv1(F.relu(self.bn1(x)))
        y = self.conv2(F.relu(self.bn2(y)))
        return torch.cat([x, y], dim=1)


class DenseNetBackbone(nn.Module):
    def __init__(self, block_sizes: Sequence[int] = _CFG["densenet121"]):
        super().__init__()
        self.block_sizes = tuple(block_sizes)
        self.stem_conv = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.stem_bn = FrozenBatchNorm(64)
        ch, outs = 64, []
        for b, n in enumerate(self.block_sizes):
            for i in range(n):
                self.add_module(f"block{b + 1}_layer{i + 1}",
                                _DenseLayer(ch))
                ch += _GROWTH
            outs.append(ch)
            if b < len(self.block_sizes) - 1:
                self.add_module(f"trans{b + 1}_bn", FrozenBatchNorm(ch))
                self.add_module(f"trans{b + 1}_conv",
                                nn.Conv2d(ch, ch // 2, 1, bias=False))
                ch //= 2
        self.channels = tuple(outs[1:])

    def forward(self, x):
        x = x.to(self.stem_conv.weight.dtype)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for b, n in enumerate(self.block_sizes):
            for i in range(n):
                x = getattr(self, f"block{b + 1}_layer{i + 1}")(x)
            feats.append(x)
            if b < len(self.block_sizes) - 1:
                x = F.relu(getattr(self, f"trans{b + 1}_bn")(x))
                x = getattr(self, f"trans{b + 1}_conv")(x)
                x = F.avg_pool2d(same_pad(x, 2, 2), 2, stride=2)
        return feats[1], feats[2], feats[3]


REGISTRY = {name: functools.partial(DenseNetBackbone, sizes)
            for name, sizes in _CFG.items()}
