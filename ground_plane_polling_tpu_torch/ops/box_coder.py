"""Box / keypoint / dimension encoding and decoding (port of
ground_plane_polling_tpu/ops/box_coder.py).

The detector regresses, per anchor, 12 values: the 2D box corners
(x1, y1, x2, y2) and four image keypoints (xl, yl, xm, ym, xr, yr, xt, yt).
The x offsets of the "middle" and "top" keypoints are absolute magnitudes
relative to the anchor centre; which side they fall on comes from the sign
half of the classification output; `encode_boxes` returns it as
(sign(dxm) + 1) / 2, which is 0.5 when xm lies exactly on the anchor centre.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["BOX_MEAN", "BOX_STD", "DIM_MEAN", "DIM_STD", "encode_boxes",
           "decode_boxes", "encode_dims", "decode_dims"]

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


_CONSTS = {}  # (values, dtype, device) -> the constant on that device


def _const(values, like: torch.Tensor) -> torch.Tensor:
    """`values` in like's dtype on like's device, copied there once: a copy
    from host memory would stall the host at every call."""
    values = np.asarray(values)
    key = (values.dtype.str, values.shape, values.tobytes(), like.dtype,
           like.device)
    if key not in _CONSTS:
        _CONSTS[key] = torch.as_tensor(values, dtype=like.dtype,
                                       device=like.device)
    return _CONSTS[key]


def encode_boxes(anchors, gt, mean=BOX_MEAN, std=BOX_STD):
    """Encode ground-truth boxes+keypoints against anchors.

    Args
      anchors: (..., 4) anchor boxes (x1, y1, x2, y2).
      gt:      (..., 12) (x1,y1,x2,y2,xl,yl,xm,ym,xr,yr,xt,yt).

    Returns (targets (..., 12) normalized, the xm / xt entries absolute;
    sign (...,) 0 left of the anchor centre, 1 right, 0.5 on it).
    """
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    cx = (anchors[..., 0] + anchors[..., 2]) / 2.0

    dx1 = (gt[..., 0] - anchors[..., 0]) / aw
    dy1 = (gt[..., 1] - anchors[..., 1]) / ah
    dx2 = (gt[..., 2] - anchors[..., 2]) / aw
    dy2 = (gt[..., 3] - anchors[..., 3]) / ah
    dxl = (gt[..., 4] - anchors[..., 0]) / aw
    dyl = (gt[..., 5] - anchors[..., 3]) / ah
    dxm = (gt[..., 6] - cx) / aw
    dym = (gt[..., 7] - anchors[..., 3]) / ah
    dxr = (gt[..., 8] - anchors[..., 2]) / aw
    dyr = (gt[..., 9] - anchors[..., 3]) / ah
    dxt = (gt[..., 10] - cx) / aw
    dyt = (gt[..., 11] - anchors[..., 1]) / ah

    sign = (torch.sign(dxm) + 1.0) / 2.0
    targets = torch.stack([dx1, dy1, dx2, dy2, dxl, dyl, dxm.abs(), dym, dxr,
                           dyr, dxt.abs(), dyt], dim=-1)
    return (targets - _const(mean, targets)) / _const(std, targets), sign


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


def encode_dims(dims, mean=DIM_MEAN, std=DIM_STD):
    """Normalize (h, w, l); `mean`/`std` have the length of the trailing
    axis of `dims` (3, or 3C tiled per class)."""
    return (dims - _const(mean, dims)) / _const(std, dims)


def decode_dims(dims, mean=DIM_MEAN, std=DIM_STD):
    """Un-normalize the dimension output; for (..., 3C) the per-class
    (h, w, l) triple repeats mean/std across classes."""
    c = dims.shape[-1] // len(mean)
    return dims * _const(np.tile(std, c), dims) + _const(np.tile(mean, c), dims)
