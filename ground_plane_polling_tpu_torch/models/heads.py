"""Per-level prediction heads, shared across pyramid levels (port of the
split heads of ground_plane_polling_tpu/models/heads.py).

  * classification: 4x conv(256)+relu, out conv -> A * 8C, sigmoid. Layout
    per anchor is 8C = [sign-half 0 | sign-half 1], each half 4*c + o.
  * box/keypoint regression: 4x conv(512)+relu, out conv -> A * 12.
  * dimension regression: 4x conv(128)+relu, out conv -> A * 3C.

Each head returns (B, H*W*A, K) float32 per level. The NCHW map is permuted
to NHWC before the reshape, so anchors come out in (h, w, anchor) order,
matching ops.anchors.anchors_for_shape.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ClassificationHead", "BoxRegressionHead", "DimRegressionHead"]


def _flatten_anchors(x: torch.Tensor, per_anchor: int) -> torch.Tensor:
    b, ch, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w * (ch // per_anchor),
                                         per_anchor)


class _Head(nn.Module):
    """4x conv+relu tower and an out conv; subclasses name the layers."""

    prefix = ""

    def __init__(self, cin: int, width: int, out_ch: int):
        super().__init__()
        for i in range(4):
            self.add_module(f"{self.prefix}_{i}",
                            nn.Conv2d(cin if i == 0 else width, width, 3,
                                      padding=1))
        self.add_module(f"{self.prefix}_out",
                        nn.Conv2d(width, out_ch, 3, padding=1))

    def raw(self, x):
        for i in range(4):
            x = F.relu(getattr(self, f"{self.prefix}_{i}")(x))
        return getattr(self, f"{self.prefix}_out")(x)


class ClassificationHead(_Head):
    prefix = "cls"

    def __init__(self, cin: int, num_classes: int = 1, num_anchors: int = 12,
                 width: int = 256):
        super().__init__(cin, width, num_anchors * 8 * num_classes)
        self.per_anchor = 8 * num_classes

    def forward(self, x):
        logits = _flatten_anchors(self.raw(x), self.per_anchor)
        return torch.sigmoid(logits.float())


class BoxRegressionHead(_Head):
    prefix = "box"

    def __init__(self, cin: int, num_anchors: int = 12, width: int = 512):
        super().__init__(cin, width, num_anchors * 12)

    def forward(self, x):
        return _flatten_anchors(self.raw(x), 12).float()


class DimRegressionHead(_Head):
    prefix = "dim"

    def __init__(self, cin: int, num_classes: int = 1, num_anchors: int = 12,
                 width: int = 128):
        super().__init__(cin, width, num_anchors * 3 * num_classes)
        self.per_anchor = 3 * num_classes

    def forward(self, x):
        return _flatten_anchors(self.raw(x), self.per_anchor).float()
