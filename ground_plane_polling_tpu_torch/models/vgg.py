"""VGG-16 / VGG-19 backbones (port of ground_plane_polling_tpu/models/
vgg.py): 3x3 SAME convs with bias and ReLU, and after each block a 2x2
stride-2 max-pool with Flax SAME padding, which on an odd size pads one
-inf row or column at the end. C3, C4 and C5 are pool3, pool4 and pool5
(strides 8, 16, 32; 256, 512 and 512 channels)."""

from __future__ import annotations

import functools
from typing import Sequence

import torch.nn.functional as F
from torch import nn

from . import width

__all__ = ["VGGBackbone", "REGISTRY"]

_CFG = {
    "vgg16": (2, 2, 3, 3, 3),
    "vgg19": (2, 2, 4, 4, 4),
}
_WIDTHS = (64, 128, 256, 512, 512)


class VGGBackbone(nn.Module):
    def __init__(self, blocks: Sequence[int] = _CFG["vgg16"]):
        super().__init__()
        self.blocks = tuple(blocks)
        cin = 3
        for b, (n, w) in enumerate(zip(self.blocks, _WIDTHS)):
            for i in range(n):
                self.add_module(f"block{b + 1}_conv{i + 1}",
                                nn.Conv2d(cin, w, 3, padding=1))
                cin = w
        self.channels = _WIDTHS[2:]

    def forward(self, x):
        x = x.to(self.block1_conv1.weight.dtype)
        feats = []
        for b, n in enumerate(self.blocks):
            for i in range(n):
                x = F.relu(getattr(self, f"block{b + 1}_conv{i + 1}")(x))
            x = width.pool2d(x, "max", 2, 2)
            feats.append(x)
        return feats[2], feats[3], feats[4]


REGISTRY = {name: functools.partial(VGGBackbone, blocks)
            for name, blocks in _CFG.items()}
