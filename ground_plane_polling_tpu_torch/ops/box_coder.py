"""Box / keypoint / dimension decoding (inference half of
ground_plane_polling_tpu/ops/box_coder.py).

The detector regresses, per anchor, 12 values: the 2D box corners
(x1, y1, x2, y2) and four image keypoints (xl, yl, xm, ym, xr, yr, xt, yt).
The x offsets of the "middle" and "top" keypoints are absolute magnitudes
relative to the anchor centre; which side they fall on comes from the sign
half of the classification output.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["BOX_MEAN", "BOX_STD", "DIM_MEAN", "DIM_STD", "decode_boxes",
           "decode_dims"]

# Normalization constants for the 12 regression targets (dataset statistics).
BOX_MEAN = np.array(
    [-0.0373, -0.0165, 0.0373, 0.0171, -0.0286, -0.0478, 0.2929, 0.0114,
     0.0288, -0.0589, 0.2932, -0.0007],
    dtype=np.float32,
)
BOX_STD = np.array(
    [0.1957, 0.1896, 0.1957, 0.1897, 0.1967, 0.2034, 0.2046, 0.1898,
     0.1964, 0.2052, 0.2048, 0.1903],
    dtype=np.float32,
)

# KITTI car (height, width, length) statistics.
DIM_MEAN = np.array([1.6570, 1.7999, 4.2907], dtype=np.float32)
DIM_STD = np.array([0.2681, 0.2243, 0.6281], dtype=np.float32)


def _const(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def decode_boxes(anchors, deltas, sign, mean=BOX_MEAN, std=BOX_STD):
    """Apply regression deltas to anchors, resolving the xm/xt side.

    Args
      anchors: (..., 4)
      deltas:  (..., 12) network output (normalized)
      sign:    (...,) in {-1, +1}: side of the anchor centre for xm and xt.

    Returns (..., 12) decoded (x1,y1,x2,y2,xl,yl,xm,ym,xr,yr,xt,yt) pixels.
    """
    w = anchors[..., 2] - anchors[..., 0]
    h = anchors[..., 3] - anchors[..., 1]
    cx = (anchors[..., 0] + anchors[..., 2]) / 2.0

    d = deltas * _const(std, deltas) + _const(mean, deltas)
    x1 = anchors[..., 0] + d[..., 0] * w
    y1 = anchors[..., 1] + d[..., 1] * h
    x2 = anchors[..., 2] + d[..., 2] * w
    y2 = anchors[..., 3] + d[..., 3] * h
    xl = anchors[..., 0] + d[..., 4] * w
    yl = anchors[..., 3] + d[..., 5] * h
    xm = cx + d[..., 6] * w * sign
    ym = anchors[..., 3] + d[..., 7] * h
    xr = anchors[..., 2] + d[..., 8] * w
    yr = anchors[..., 3] + d[..., 9] * h
    xt = cx + d[..., 10] * w * sign
    yt = anchors[..., 1] + d[..., 11] * h
    return torch.stack([x1, y1, x2, y2, xl, yl, xm, ym, xr, yr, xt, yt],
                       dim=-1)


def decode_dims(dims, mean=DIM_MEAN, std=DIM_STD):
    """Un-normalize the dimension output; for (..., 3C) the per-class
    (h, w, l) triple repeats mean/std across classes."""
    c = dims.shape[-1] // len(mean)
    return dims * _const(np.tile(std, c), dims) + _const(np.tile(mean, c), dims)
