"""ResNet v1 backbones (50 / 101 / 152) with frozen BN, NCHW (port of
ground_plane_polling_tpu/models/resnet.py). Returns C3, C4, C5 (strides 8, 16,
32) for the FPN.

Layout details that must match the JAX package for imported weights:
  * the stem pads an explicit 3 pixels before its 7x7 stride-2 conv;
  * the stem max-pool is Flax SAME at stride 2, which pads (0, 1) on an even
    size and (1, 1) on an odd one, with -inf (models/width.py);
  * in a bottleneck the stride sits on the 1x1 conv1 and on the 1x1
    projection, not on the 3x3.

`remat=True` rematerializes each bottleneck block on the backward pass
(torch.utils.checkpoint, non-reentrant, as JAX's nn.remat): the block's
activations are recomputed instead of stored, for less training memory at
the cost of about one more forward.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import width
from .common import FrozenBatchNorm, frozen_bn_act
from .width import same_pad, same_padding

__all__ = ["ResNetBackbone", "RESNET_STAGES", "same_pad", "same_padding"]

RESNET_STAGES = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}


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
        shortcut, shortcut_bn = x, None
        if self.conv_proj is not None:
            shortcut, shortcut_bn = self.conv_proj(x), self.bn_proj
        y = frozen_bn_act(self.conv1(x), self.bn1, relu=True)
        y = frozen_bn_act(self.conv2(y), self.bn2, relu=True)
        return frozen_bn_act(self.conv3(y), self.bn3, relu=True,
                             residual=shortcut, residual_bn=shortcut_bn)


class ResNetBackbone(nn.Module):
    """ResNet v1; forward(NCHW images) returns (C3, C4, C5)."""

    def __init__(self, stage_sizes: Sequence[int] = RESNET_STAGES["resnet50"],
                 remat: bool = False):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.remat = remat
        self.conv1 = _conv(3, 64, 7, 2, padding=3)
        self.bn1 = FrozenBatchNorm(64)
        self.channels = (512, 1024, 2048)  # C3, C4, C5
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
        x = frozen_bn_act(self.conv1(x), self.bn1, relu=True)
        x = width.pool2d(x, "max", 3, 2)
        outputs = []
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                fn = getattr(self, f"stage{stage + 1}_block{block + 1}")
                if self.remat and torch.is_grad_enabled():
                    # the blocks draw no random numbers, so the recompute
                    # keeps no RNG state (nothing is read from the card's
                    # generator while a train step is captured)
                    x = checkpoint(fn, x, use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    x = fn(x)
            outputs.append(x)
        return outputs[1], outputs[2], outputs[3]
