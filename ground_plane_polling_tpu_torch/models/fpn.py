"""Feature Pyramid Network, `feature_size` channels (512 in the detector),
NCHW (port of ground_plane_polling_tpu/models/fpn.py).

P6 and P7 are 3x3 stride-2 convs with Flax SAME padding, padded explicitly
by `same_pad`. Upsampling is nearest-neighbour to the lateral's size: an
exact 2x repeat on canvases padded to 32, and otherwise torch's
'nearest-exact' (half-pixel centres, which is what JAX's image.resize
'nearest' computes).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import same_pad

__all__ = ["FPN", "upsample_to"]


def upsample_to(x: torch.Tensor, target_hw) -> torch.Tensor:
    """Nearest-neighbour resize of NCHW `x` to (target_h, target_w)."""
    h, w = x.shape[2], x.shape[3]
    th, tw = int(target_hw[0]), int(target_hw[1])
    if th == 2 * h and tw == 2 * w:
        return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return F.interpolate(x, size=(th, tw), mode="nearest-exact")


class FPN(nn.Module):
    """(C3, C4, C5) -> [P3, P4, P5, P6, P7], all `feature_size` channels."""

    def __init__(self, in_channels=(512, 1024, 2048), feature_size: int = 512):
        super().__init__()
        c3, c4, c5 = in_channels
        f = feature_size
        self.c5_reduce = nn.Conv2d(c5, f, 1)
        self.p5 = nn.Conv2d(f, f, 3, padding=1)
        self.c4_reduce = nn.Conv2d(c4, f, 1)
        self.p4 = nn.Conv2d(f, f, 3, padding=1)
        self.c3_reduce = nn.Conv2d(c3, f, 1)
        self.p3 = nn.Conv2d(f, f, 3, padding=1)
        self.p6 = nn.Conv2d(c5, f, 3, stride=2)
        self.p7 = nn.Conv2d(f, f, 3, stride=2)

    def forward(self, c3, c4, c5):
        p5_lat = self.c5_reduce(c5)
        p5 = self.p5(p5_lat)
        p4_lat = self.c4_reduce(c4) + upsample_to(p5_lat, c4.shape[2:])
        p4 = self.p4(p4_lat)
        p3_lat = self.c3_reduce(c3) + upsample_to(p4_lat, c3.shape[2:])
        p3 = self.p3(p3_lat)
        p6 = self.p6(same_pad(c5, 3, 2))
        p7 = self.p7(same_pad(F.relu(p6), 3, 2))
        return [p3, p4, p5, p6, p7]
