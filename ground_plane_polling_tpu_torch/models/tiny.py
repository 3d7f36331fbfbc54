"""A minimal 3-level conv backbone for fast tests and smoke runs (port of
ground_plane_polling_tpu/models/tiny.py): five 3x3 stride-2 SAME convs
with bias and ReLU, of width 32 min(i + 1, 4). Returns conv2, conv3 and
conv4 (strides 8, 16, 32; 96, 128 and 128 channels)."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .fpn import same_conv

__all__ = ["TinyBackbone", "REGISTRY"]


class TinyBackbone(nn.Module):
    def __init__(self, width: int = 32):
        super().__init__()
        cin = 3
        for i in range(5):
            cout = width * min(i + 1, 4)
            self.add_module(f"conv{i}", same_conv(cin, cout, 3, stride=2))
            cin = cout
        self.channels = tuple(width * min(i + 1, 4) for i in (2, 3, 4))

    def forward(self, x):
        x = x.to(self.conv0.weight.dtype)
        feats = []
        for i in range(5):
            x = F.relu(getattr(self, f"conv{i}")(x))
            feats.append(x)
        return feats[2], feats[3], feats[4]


REGISTRY = {"tiny": TinyBackbone}
