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

Each loss is a sum over a normalizer count (`*_parts`). JAX's normalizers
count over the whole batch, sharded or not. Data-parallel ranks each hold
a part of the batch: `global_terms` all-reduces the three counts (and the
sums, for the logged terms) as one stacked tensor and divides each rank's
sum by the global counts.
"""

from __future__ import annotations

import torch

__all__ = ["focal", "smooth_l1", "smooth_l1_dim", "focal_parts",
           "smooth_l1_parts", "smooth_l1_dim_parts", "normalized",
           "global_terms"]

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


def focal_parts(labels, probs, alpha: float = 0.25, gamma: float = 2.0):
    """Focal loss on sigmoid probabilities, as (sum, normalizer count).

    labels, probs: (B, N, 8C); -1 marks ignored rows (row state = max).
    The sum is the focal-weighted BCE over non-ignored anchors, the count
    the number of positive anchors.
    """
    state = labels.amax(dim=2)
    valid = (state != -1.0).to(probs.dtype)
    p = _clip(probs, _BCE_EPS, 1.0 - _BCE_EPS)
    is_pos = labels == 1.0
    alpha_factor = torch.where(is_pos, alpha, 1.0 - alpha)
    focal_weight = alpha_factor * torch.where(is_pos, 1.0 - p, p) ** gamma
    bce = -(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))
    loss = focal_weight * bce * valid[..., None]
    return loss.sum(), (state == 1.0).to(probs.dtype).sum()


def smooth_l1_parts(y_true, y_pred, sigma: float = 3.0):
    """Box/keypoint regression loss as (sum, count of contributing rows);
    y_true (B, N, 13), y_pred (B, N, 12)."""
    sigma_squared = sigma * sigma
    mask = (y_true[..., 12] == 1.0).to(y_pred.dtype)
    loss = _smooth_l1_elem(y_pred - y_true[..., :12],
                           sigma_squared) * mask[..., None]
    return loss.sum(), mask.sum()


def smooth_l1_dim_parts(y_true, y_pred, sigma: float = 3.0,
                        compat_height_only: bool = False):
    """Per-class dimension loss as (sum, count of contributing rows);
    y_true (B, N*C, 4), y_pred (B, N, 3C)."""
    sigma_squared = sigma * sigma
    pred = y_pred.reshape(y_pred.shape[0], -1, 3)
    mask = (y_true[..., 3] == 1.0).to(y_pred.dtype)
    diff = _smooth_l1_elem(pred - y_true[..., :3], sigma_squared)
    if compat_height_only:
        diff = diff[..., :1]
    loss = diff * mask[..., None]
    return loss.sum(), mask.sum()


def normalized(parts):
    """sum / max(count, 1) of a (sum, count) pair."""
    total, count = parts
    return total / count.clamp(min=1.0)


def focal(labels, probs, alpha: float = 0.25, gamma: float = 2.0):
    """Focal loss over the number of positive anchors (at least 1)."""
    return normalized(focal_parts(labels, probs, alpha, gamma))


def smooth_l1(y_true, y_pred, sigma: float = 3.0):
    """Box/keypoint loss over its contributing rows (at least 1)."""
    return normalized(smooth_l1_parts(y_true, y_pred, sigma))


def smooth_l1_dim(y_true, y_pred, sigma: float = 3.0,
                  compat_height_only: bool = False):
    """Dimension loss over its contributing rows (at least 1)."""
    return normalized(smooth_l1_dim_parts(y_true, y_pred, sigma,
                                          compat_height_only))


def global_terms(parts: dict, mesh):
    """Loss terms normalized over the whole batch of `mesh`'s ranks.

    parts: {name: (this rank's sum, its normalizer count)}. One all-reduce
    of the stacked counts and (detached) sums, enqueued on the stream with
    no host sync; each count is floored at 1 after the reduction. Returns
    ({name: this rank's sum over the global count, times the number of
    ranks}, {name: the global term}): DistributedDataParallel averages the
    ranks' gradients, so the mean of the first terms' gradients is the
    gradient of the global loss; the second are the loss JAX reports."""
    sums = torch.stack([s for s, _ in parts.values()])
    counts = torch.stack([n for _, n in parts.values()])
    stats = mesh.all_reduce(torch.cat([counts, sums.detach()]))
    k = len(parts)
    norm = stats[:k].clamp(min=1.0)
    local = sums / norm * mesh.size
    total = stats[k:] / norm
    return ({name: local[i] for i, name in enumerate(parts)},
            {name: total[i] for i, name in enumerate(parts)})
