"""Anchor grid generation (numpy; a copy of ground_plane_polling_tpu/ops/anchors.py).

Anchors are a pure function of the padded image shape, so they are computed
once in numpy per detect function and uploaded as one constant tensor.
Behaviour matches the Keras reference's anchor machinery
(keras_retinanet_3D utils/anchors.py:140-265 and models/retinanet.py:208-235):
P3-P7 pyramid, sizes [32..512], strides [8..128], 3 ratios x 4 scales = 12
anchors per position, grid offset by half a stride.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "AnchorConfig",
    "generate_base_anchors",
    "feature_shapes",
    "shift_anchors",
    "anchors_for_shape",
    "num_anchors_for_shape",
]


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Anchor generation parameters (defaults = reference defaults)."""

    pyramid_levels: tuple = (3, 4, 5, 6, 7)
    strides: tuple = (8, 16, 32, 64, 128)
    sizes: tuple = (32, 64, 128, 256, 512)
    ratios: tuple = (0.5, 1.0, 2.0)
    scales: tuple = (
        2.0 ** (-2.0 / 3.0),
        2.0 ** 0.0,
        2.0 ** (1.0 / 3.0),
        2.0 ** (2.0 / 3.0),
    )

    @property
    def num_anchors(self) -> int:
        return len(self.ratios) * len(self.scales)


DEFAULT = AnchorConfig()


def generate_base_anchors(
    base_size: float,
    ratios=DEFAULT.ratios,
    scales=DEFAULT.scales,
) -> np.ndarray:
    """(R*S, 4) base anchors centred at the origin, ratio-major scale-minor.

    Each anchor has area (base_size*scale)^2 adjusted so height/width = ratio,
    expressed as (x1, y1, x2, y2) around (0, 0). Mirrors
    reference utils/anchors.py:234-265.
    """
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    # ratio-major, scale-minor ordering
    r = np.repeat(ratios, len(scales))
    s = np.tile(scales, len(ratios))
    side = base_size * s
    area = side * side
    w = np.sqrt(area / r)
    h = w * r
    return np.stack([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0], axis=1)


def feature_shapes(image_shape, pyramid_levels=DEFAULT.pyramid_levels):
    """Per-level (h, w) feature map shapes: ceil-div of the image by 2^level.

    Mirrors reference utils/anchors.py:140-152 (`(s + 2^x - 1) // 2^x`).
    """
    hh, ww = int(image_shape[0]), int(image_shape[1])
    return [
        ((hh + 2**lvl - 1) // 2**lvl, (ww + 2**lvl - 1) // 2**lvl)
        for lvl in pyramid_levels
    ]


def shift_anchors(shape, stride, base_anchors: np.ndarray) -> np.ndarray:
    """Tile base anchors over an (h, w) grid with centres at (i+0.5)*stride.

    Returns (h*w*A, 4), position-major anchor-minor, matching
    reference utils/anchors.py:203-231.
    """
    h, w = int(shape[0]), int(shape[1])
    sx = (np.arange(w, dtype=np.float64) + 0.5) * stride
    sy = (np.arange(h, dtype=np.float64) + 0.5) * stride
    gx, gy = np.meshgrid(sx, sy)
    shifts = np.stack([gx.ravel(), gy.ravel(), gx.ravel(), gy.ravel()], axis=1)
    out = base_anchors[None, :, :] + shifts[:, None, :]
    return out.reshape(-1, 4)


def anchors_for_shape(image_shape, config: AnchorConfig = DEFAULT) -> np.ndarray:
    """All anchors for an image shape, concatenated over pyramid levels P3-P7.

    Returns (A_total, 4) float32. A_total ~= 100k+ for an 800x1333 image.
    Mirrors reference utils/anchors.py:155-200.
    """
    shapes = feature_shapes(image_shape, config.pyramid_levels)
    per_level = []
    for (fh, fw), stride, size in zip(shapes, config.strides, config.sizes):
        base = generate_base_anchors(size, config.ratios, config.scales)
        per_level.append(shift_anchors((fh, fw), stride, base))
    return np.concatenate(per_level, axis=0).astype(np.float32)


def num_anchors_for_shape(image_shape, config: AnchorConfig = DEFAULT) -> int:
    """Total anchor count for a static image shape (no materialization)."""
    return sum(
        fh * fw * config.num_anchors
        for fh, fw in feature_shapes(image_shape, config.pyramid_levels)
    )
