"""Ground-plane polling: score every road-plane hypothesis for every
detection and pick the best-fitting plane + 3D keypoints.

This is the plain PyTorch twin of the CUDA kernel in kernels/polling_cuda.py
(port of ground_plane_polling_tpu/ops/polling.py, same math and semantics).
CPU tensors run it; the kernel is checked against it on the card.

Geometry (camera coordinates, KITTI: x right, y down, z forward):
  * each of the 4 image keypoints (l, m, r, t) is back-projected to a ray
    d = P_inv @ (u, v, 1), sign-fixed so it points forward (z > 0);
  * the l/m/r rays are intersected with every plane of the database;
  * the t (top) point is X_m shifted along the plane normal onto the top
    ray's vertical plane;
  * six polls compare induced keypoint distances with the predicted
    dimensions (the orientation picks which dimension each pair measures);
    each poll votes if its residual is at most 0.7 m;
  * planes below the max vote count, or whose l/m/r triangle winds the wrong
    way, are disqualified (residual := 100);
  * the plane with the least residual wins (first index on ties, and the
    first NaN if there is one, like numpy's argmin).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["PollResult", "POLL_THRESHOLD_M", "DISQUALIFIED_RESIDUAL",
           "NUM_POLLS", "normalize_planes", "rays_from_boxes",
           "expected_distances", "poll_scoreboard",
           "fit_road_planes"]

POLL_THRESHOLD_M = 0.7
DISQUALIFIED_RESIDUAL = 100.0
NUM_POLLS = 6


class PollResult(NamedTuple):
    keypoints: torch.Tensor  # (B, D, 4, 3) 3D keypoints (X_l, X_m, X_r, X_t)
    keyplanes: torch.Tensor  # (B, D, 1, 4) winning plane (normalized)
    residuals: torch.Tensor  # (B, D) mean residual of the winning plane


def normalize_planes(planes: torch.Tensor) -> torch.Tensor:
    """Flip signs so the b component is negative (normal points 'up' where y
    is down) and scale to a unit normal. b == 0 gives a NaN plane, as in the
    JAX package."""
    planes = planes * -torch.sign(planes[..., 1:2])
    return planes / torch.linalg.vector_norm(planes[..., 0:3], dim=-1,
                                             keepdim=True)


def rays_from_boxes(boxes: torch.Tensor, P_inv: torch.Tensor) -> torch.Tensor:
    """(B, D, 12) boxes + (B, 4, 3) P_inv -> (B, D, 4, 3) forward rays."""
    b, d, _ = boxes.shape
    kp = boxes[..., 4:12].reshape(b, d, 4, 2)
    kp_h = torch.cat([kp, kp.new_ones(b, d, 4, 1)], dim=-1)
    rays = torch.einsum("bij,bdkj->bdki", P_inv, kp_h)[..., 0:3]
    return rays * torch.sign(rays[..., 2:3])


def expected_distances(dimensions: torch.Tensor,
                       orientations: torch.Tensor) -> torch.Tensor:
    """(B, D, 6) expected distance of each poll (orientation-dependent)."""
    h, w, l = dimensions[..., 0], dimensions[..., 1], dimensions[..., 2]
    d_hw = torch.sqrt(h * h + w * w)
    d_wl = torch.sqrt(w * w + l * l)
    d_hl = torch.sqrt(h * h + l * l)
    # padded rows carry orientation -1: an all-zero row, like JAX's one_hot
    onehot = (orientations[..., None] == torch.arange(
        4, device=orientations.device)).to(dimensions.dtype)

    def pick(d0, d1, d2, d3):
        return (onehot * torch.stack([d0, d1, d2, d3], dim=-1)).sum(-1)

    return torch.stack([
        h,
        pick(l, w, w, l),
        pick(w, l, l, w),
        d_wl,
        pick(d_hl, d_hw, d_hw, d_hl),
        pick(d_hw, d_hl, d_hl, d_hw),
    ], dim=-1)


def _top_point(X_m, n, d_t):
    """X_t = X_m - (perp.X_m / perp.n) n with perp = d_t x (n x d_t)."""
    perp = torch.linalg.cross(d_t, torch.linalg.cross(n, d_t, dim=-1),
                              dim=-1)
    t = (perp * X_m).sum(-1) / (perp * n).sum(-1)
    return X_m - t[..., None] * n


def poll_scoreboard(rays, expected, planes_n):
    """Votes, residuals and winding of every (detection, plane) pair.

    rays (B, D, 4, 3), expected (B, D, 6), planes_n (B, P, 4) -> votes,
    residuals (not yet winding-masked) and wind_y, each (B, D, P), and the
    keypoints X4 (B, D, P, 4, 3).
    """
    normals = planes_n[..., 0:3]              # (B, P, 3)
    offsets = planes_n[..., 3]                # (B, P)
    ndot = torch.einsum("bpc,bdkc->bdpk", normals, rays[:, :, 0:3, :])
    scale = -offsets[:, None, :, None] / ndot  # (B, D, P, 3)
    X_lmr = rays[:, :, None, 0:3, :] * torch.abs(scale)[..., None]
    X_l, X_m, X_r = X_lmr[..., 0, :], X_lmr[..., 1, :], X_lmr[..., 2, :]

    # winding: y component of (X_l - X_m) x (X_r - X_m)
    wind_y = torch.linalg.cross(X_l - X_m, X_r - X_m, dim=-1)[..., 1]

    n_b = normals[:, None, :, :]               # (B, 1, P, 3)
    X_t = _top_point(X_m, n_b, rays[:, :, None, 3, :])

    pairs = [(X_m, X_t), (X_l, X_m), (X_m, X_r), (X_l, X_r), (X_l, X_t),
             (X_r, X_t)]
    votes = torch.zeros_like(wind_y)
    residuals = torch.zeros_like(wind_y)
    for i, (a, c) in enumerate(pairs):
        r = torch.abs(torch.linalg.vector_norm(a - c, dim=-1)
                      - expected[..., i, None])
        votes = votes + (r <= POLL_THRESHOLD_M).to(wind_y.dtype)
        residuals = residuals + r
    X4 = torch.cat([X_lmr, X_t[..., None, :]], dim=-2)
    return votes, residuals, wind_y, X4


def fit_road_planes(boxes, dimensions, orientations, P_inv,
                    planes) -> PollResult:
    """Args
      boxes:        (B, D, 12) filtered boxes; the last 8 columns are the
                    keypoints (xl, yl, xm, ym, xr, yr, xt, yt). Padded rows
                    (-1) give garbage keypoints that callers mask.
      dimensions:   (B, D, 3) predicted (h, w, l).
      orientations: (B, D) int orientation class in [0, 4).
      P_inv:        (B, 4, 3) pseudo-inverse camera projections.
      planes:       (B, P, 4) road-plane coefficient database.
    """
    planes_n = normalize_planes(planes)
    rays = rays_from_boxes(boxes, P_inv)
    expected = expected_distances(dimensions, orientations)
    votes, residuals, wind_y, X4 = poll_scoreboard(rays, expected, planes_n)

    # disqualify wrong-winding and non-max-vote planes
    max_votes = votes.amax(dim=-1, keepdim=True)
    residuals = torch.where((wind_y < 0.0) | (votes < max_votes),
                            DISQUALIFIED_RESIDUAL, residuals)
    best = torch.argmin(residuals, dim=-1)    # (B, D), first NaN / first min

    b, d = best.shape
    keypoints = X4.gather(
        2, best[:, :, None, None, None].expand(b, d, 1, 4, 3))[:, :, 0]
    keyplanes = planes_n.gather(
        1, best.reshape(b, d, 1).expand(b, d, 4))[:, :, None, :]
    best_residual = residuals.gather(-1, best[..., None])[..., 0]
    return PollResult(keypoints=keypoints, keyplanes=keyplanes,
                      residuals=best_residual / float(NUM_POLLS))
