"""ResNet v1 backbones (50 / 101 / 152) with frozen BN, NCHW (port of
ground_plane_polling_tpu/models/resnet.py). Returns C3, C4, C5 (strides 8, 16,
32) for the FPN.

Layout details that must match the JAX package for imported weights:
  * the stem pads an explicit 3 pixels before its 7x7 stride-2 conv;
  * the stem max-pool is Flax SAME at stride 2, which pads (0, 1) on an even
    size and (1, 1) on an odd one, with -inf (`same_pad`);
  * in a bottleneck the stride sits on the 1x1 conv1 and on the 1x1
    projection, not on the 3x3.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import FrozenBatchNorm

__all__ = ["ResNetBackbone", "RESNET_STAGES", "same_pad"]

RESNET_STAGES = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}


def same_pad(x: torch.Tensor, kernel: int, stride: int,
             value: float = 0.0) -> torch.Tensor:
    """Pad NCHW `x` as XLA's SAME does for a `kernel` window at `stride`:
    the total padding max((ceil(n/s) - 1) s + k - n, 0) is split with the
    extra pixel after (bottom/right)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad order: W first, then H
        out = -(-n // stride)
        total = max((out - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def _conv(cin, cout, k, stride=1, padding=0):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     bias=False)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with identity or projection shortcut."""

    def __init__(self, cin: int, filters: int, stride: int, project: bool):
        super().__init__()
        cout = 4 * filters
        self.conv1 = _conv(cin, filters, 1, stride)
        self.bn1 = FrozenBatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3, 1, padding=1)
        self.bn2 = FrozenBatchNorm(filters)
        self.conv3 = _conv(filters, cout, 1)
        self.bn3 = FrozenBatchNorm(cout)
        if project:
            self.conv_proj = _conv(cin, cout, 1, stride)
            self.bn_proj = FrozenBatchNorm(cout)
        else:
            self.conv_proj = None

    def forward(self, x):
        shortcut = x
        if self.conv_proj is not None:
            shortcut = self.bn_proj(self.conv_proj(x))
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + shortcut)


class ResNetBackbone(nn.Module):
    """ResNet v1; forward(NCHW images) returns (C3, C4, C5)."""

    def __init__(self, stage_sizes: Sequence[int] = RESNET_STAGES["resnet50"]):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.conv1 = _conv(3, 64, 7, 2, padding=3)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for stage, (n_blocks, w) in enumerate(
                zip(self.stage_sizes, (64, 128, 256, 512))):
            for block in range(n_blocks):
                stride = 2 if (block == 0 and stage > 0) else 1
                self.add_module(
                    f"stage{stage + 1}_block{block + 1}",
                    BottleneckBlock(cin, w, stride, project=(block == 0)))
                cin = 4 * w

    def forward(self, x):
        x = x.to(self.conv1.weight.dtype)  # the compute dtype of the weights
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(same_pad(x, 3, 2, float("-inf")), 3, stride=2)
        outputs = []
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                x = getattr(self, f"stage{stage + 1}_block{block + 1}")(x)
            outputs.append(x)
        return outputs[1], outputs[2], outputs[3]
