"""Pairwise IoU between axis-aligned boxes (port of
ground_plane_polling_tpu/ops/overlap.py::iou_matrix).

The union is clamped at float64 eps, so degenerate or zero boxes give IoU 0,
never NaN.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["iou_matrix"]

_EPS = float(np.finfo(np.float64).eps)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between every box in `a` (..., N, 4) and every box in `b`
    (..., K, 4); returns (..., N, K). Boxes are (x1, y1, x2, y2)."""
    a_ = a[..., :, None, :]
    b_ = b[..., None, :, :]
    iw = (torch.minimum(a_[..., 2], b_[..., 2])
          - torch.maximum(a_[..., 0], b_[..., 0])).clamp(min=0.0)
    ih = (torch.minimum(a_[..., 3], b_[..., 3])
          - torch.maximum(a_[..., 1], b_[..., 1])).clamp(min=0.0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    inter = iw * ih
    union = (area_a[..., :, None] + area_b[..., None, :] - inter).clamp(
        min=_EPS)
    return inter / union
