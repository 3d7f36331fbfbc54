"""Detection losses: focal + smooth-L1 (box/keypoint) + smooth-L1 (dims)
(port of ground_plane_polling_tpu/training/losses.py), as masked reductions.

Anchor-state conventions (ops.targets):
  * classification: the state of an anchor is the max over its 8C label
    columns (-1 ignore / 0 negative / 1 positive); ignored rows add
    nothing; the normalizer counts the positive anchors (at least 1);
  * box regression: y_true (B, N, 13), column 12 the state; rows with state
    1 contribute, normalized by their count (at least 1);
  * dimension regression: y_true (B, N*C, 4), column 3 the per-class state.

`compat_height_only` reproduces the Keras reference's dimension loss, which
penalized only the height component.
"""

from __future__ import annotations

import torch

__all__ = ["focal", "smooth_l1", "smooth_l1_dim"]

_BCE_EPS = 1e-7  # keras-style probability clipping


def _clip(x, lo, hi):
    """jnp.clip's value and gradient: min(max(x, lo), hi), whose gradient is
    0.5 at an input exactly on a bound (torch.clamp passes 1.0 there).
    The bounds are 0-dim CPU tensors, which mix with a tensor on any device
    without a host-to-device copy (a copy would stall the host)."""
    lo = torch.tensor(lo, dtype=x.dtype)
    hi = torch.tensor(hi, dtype=x.dtype)
    return torch.minimum(torch.maximum(x, lo), hi)


def _smooth_l1_elem(diff, sigma_squared):
    """0.5 (sigma x)^2 if |x| < 1/sigma^2 else |x| - 0.5/sigma^2."""
    ad = diff.abs()
    return torch.where(ad < 1.0 / sigma_squared,
                       0.5 * sigma_squared * ad * ad,
                       ad - 0.5 / sigma_squared)


def focal(labels, probs, alpha: float = 0.25, gamma: float = 2.0):
    """Focal loss on sigmoid probabilities.

    labels, probs: (B, N, 8C); -1 marks ignored rows (row state = max).
    Returns the focal-weighted BCE summed over non-ignored anchors over the
    number of positive anchors (at least 1).
    """
    state = labels.amax(dim=2)
    valid = (state != -1.0).to(probs.dtype)
    p = _clip(probs, _BCE_EPS, 1.0 - _BCE_EPS)
    is_pos = labels == 1.0
    alpha_factor = torch.where(is_pos, alpha, 1.0 - alpha)
    focal_weight = alpha_factor * torch.where(is_pos, 1.0 - p, p) ** gamma
    bce = -(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))
    loss = focal_weight * bce * valid[..., None]
    normalizer = (state == 1.0).to(probs.dtype).sum().clamp(min=1.0)
    return loss.sum() / normalizer


def smooth_l1(y_true, y_pred, sigma: float = 3.0):
    """Box/keypoint regression loss; y_true (B, N, 13), y_pred (B, N, 12)."""
    sigma_squared = sigma * sigma
    mask = (y_true[..., 12] == 1.0).to(y_pred.dtype)
    loss = _smooth_l1_elem(y_pred - y_true[..., :12],
                           sigma_squared) * mask[..., None]
    return loss.sum() / mask.sum().clamp(min=1.0)


def smooth_l1_dim(y_true, y_pred, sigma: float = 3.0,
                  compat_height_only: bool = False):
    """Per-class dimension loss; y_true (B, N*C, 4), y_pred (B, N, 3C)."""
    sigma_squared = sigma * sigma
    pred = y_pred.reshape(y_pred.shape[0], -1, 3)
    mask = (y_true[..., 3] == 1.0).to(y_pred.dtype)
    diff = _smooth_l1_elem(pred - y_true[..., :3], sigma_squared)
    if compat_height_only:
        diff = diff[..., :1]
    loss = diff * mask[..., None]
    return loss.sum() / mask.sum().clamp(min=1.0)
