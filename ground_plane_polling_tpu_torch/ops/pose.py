"""Closed-form 6-DoF pose recovery from polled 3D keypoints (port of
ground_plane_polling_tpu/ops/pose.py).

Vectorized, branch-free math. Orientations {1, 2} solve from
(X_m, X_r, X_t) and orientations {0, 3} from (X_l, X_m, X_t):
  height = |X_t - X_m|, edge = |X_sel - X_m| with X_sel = X_r (o in {1,2})
  or X_l (o in {0,3}); y axis = (X_m - X_t)/h, x axis = s_x (X_m - X_sel)/edge
  with s_x = (+1, +1, -1, -1)[o], z axis = x cross y;
  centre = (X_m + X_sel)/2 + s_l z w/2 with s_l = (+1, -1, +1, -1)[o].
The rotation is reported as a Rodrigues (axis-angle) vector like
cv2.Rodrigues. The numpy helpers at the end serve the host-side KITTI
writer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["PoseResult", "solve_pose", "nearest_orthogonal",
           "rodrigues_from_matrix",
           "matrix_from_rodrigues_np", "corners_from_pose"]

_EPS = 1e-12


def rodrigues_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle vector (..., 3), stable in
    the generic, theta ~ 0 and theta ~ pi regimes (|vec| in [0, pi])."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos)
    sin = torch.sqrt(torch.clamp(1.0 - cos * cos, 0.0, 1.0))

    r = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    axis_generic = r / torch.clamp(2.0 * sin, min=_EPS)[..., None]
    # theta ~ pi: R + I = 2 v v^T, so the strongest column of R + I is the axis
    M = R + torch.eye(3, dtype=R.dtype, device=R.device)
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(M, -1, k[..., None, None].expand(*M.shape[:-1], 1))
    col = col[..., 0]
    axis_pi = col / torch.clamp(
        torch.linalg.vector_norm(col, dim=-1, keepdim=True), min=_EPS)

    near_pi = cos < -1.0 + 1e-6
    small = sin < 1e-6
    axis = torch.where(near_pi[..., None], axis_pi, axis_generic)
    vec = theta[..., None] * axis
    vec_small = r / 2.0
    return torch.where((small & ~near_pi)[..., None], vec_small, vec)


def nearest_orthogonal(R: torch.Tensor) -> torch.Tensor:
    """U @ Vh of the SVD of R (..., 3, 3) whose columns x, y are unit
    vectors and whose third column z is orthogonal to both, as in
    solve_pose's frame [x, y, x cross y] (det R = |x cross y|^2 >= 0; with
    z = -(x cross y), det R < 0 and the result is a reflection, as the SVD
    gives it). In closed form, with no iteration and no host sync:
    R^T R = [[1, c, 0], [c, 1, 0], [0, 0, |z|^2]] (c = x . y) has the
    eigenvectors (1, 1, 0) / sqrt 2, (1, -1, 0) / sqrt 2 and (0, 0, 1), so
    R (R^T R)^(-1/2) = [(u + v) / sqrt 2, (u - v) / sqrt 2, z / |z|] with
    u = (x + y) / |x + y| and v = (x - y) / |x - y|. A row where x and y
    are (anti)parallel or z is 0 has no unique nearest rotation; there
    the norms are clamped at eps and the result is finite."""
    x, y, z = R[..., 0], R[..., 1], R[..., 2]

    def unit(a):
        return a / torch.clamp(torch.linalg.vector_norm(a, dim=-1,
                                                        keepdim=True),
                               min=_EPS)

    u, v = unit(x + y), unit(x - y)
    half = 0.5 ** 0.5
    return torch.stack([(u + v) * half, (u - v) * half, unit(z)], dim=-1)


class PoseResult(NamedTuple):
    locations: torch.Tensor   # (..., 3) box bottom-centre in camera coords
    angles: torch.Tensor      # (..., 3) Rodrigues rotation vector
    dimensions: torch.Tensor  # (..., 3) refined (h, w, l)


def solve_pose(keypoints: torch.Tensor, orientations: torch.Tensor,
               dimensions: torch.Tensor) -> PoseResult:
    """Args
      keypoints:    (..., 4, 3) polled 3D keypoints (X_l, X_m, X_r, X_t).
      orientations: (...,) int orientation class in [0, 4).
      dimensions:   (..., 3) predicted (h, w, l).
    """
    X_l = keypoints[..., 0, :]
    X_m = keypoints[..., 1, :]
    X_r = keypoints[..., 2, :]
    X_t = keypoints[..., 3, :]

    o = orientations.long()
    use_right = (o == 1) | (o == 2)
    X_sel = torch.where(use_right[..., None], X_r, X_l)

    h = torch.linalg.vector_norm(X_t - X_m, dim=-1)
    edge = torch.linalg.vector_norm(X_sel - X_m, dim=-1)
    w = dimensions[..., 1]

    # s_x = (+1, +1, -1, -1)[o], s_l = (+1, -1, +1, -1)[o], indexed as the
    # JAX package indexes its tables (o = -1 is entry 3); computed, not
    # looked up, so that no constant is copied from the host
    o4 = o % 4
    s_x = torch.where(o4 < 2, 1.0, -1.0).to(keypoints.dtype)
    s_l = torch.where(o4 % 2 == 0, 1.0, -1.0).to(keypoints.dtype)

    y_dir = (X_m - X_t) / torch.clamp(h, min=_EPS)[..., None]
    x_dir = s_x[..., None] * (X_m - X_sel) / torch.clamp(
        edge, min=_EPS)[..., None]
    z_dir = torch.linalg.cross(x_dir, y_dir, dim=-1)

    # the measured height and edge replace dims[0] and dims[2]; the
    # predicted width stays
    dims_out = torch.stack([h, w, edge], dim=-1)
    locations = ((X_m + X_sel) / 2.0
                 + s_l[..., None] * z_dir * w[..., None] / 2.0)

    # nearest rotation (U @ Vt of the SVD, as cv2.Rodrigues projects),
    # in closed form; rows that are not finite (garbage from padded
    # detections) report NaN angles
    R = torch.stack([x_dir, y_dir, z_dir], dim=-1)  # columns are the axes
    finite = torch.isfinite(R).all(dim=-1).all(dim=-1)
    angles = rodrigues_from_matrix(nearest_orthogonal(R))
    angles = torch.where(finite[..., None], angles, float("nan"))
    return PoseResult(locations=locations, angles=angles, dimensions=dims_out)


def matrix_from_rodrigues_np(vec):
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3), numpy, for host
    formatting code (KITTI writer)."""
    vec = np.asarray(vec)
    theta = np.linalg.norm(vec, axis=-1, keepdims=True)
    axis = vec / np.maximum(theta, _EPS)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = np.zeros_like(x)
    K = np.stack(
        [np.stack([zero, -z, y], axis=-1),
         np.stack([z, zero, -x], axis=-1),
         np.stack([-y, x, zero], axis=-1)],
        axis=-2,
    )
    t = theta[..., None]
    eye = np.broadcast_to(np.eye(3, dtype=vec.dtype), K.shape)
    return eye + np.sin(t) * K + (1.0 - np.cos(t)) * (K @ K)


def corners_from_pose(dimensions, R, location):
    """World-frame 8 corners (3, 8) of a KITTI box from (h, w, l), a rotation
    matrix and the bottom-face-centre location: bottom face first
    (x = +-l/2, z = +-w/2, y = 0), then the top face (y = -h)."""
    h, w, l = [float(v) for v in dimensions]
    x_c = np.array([l / 2, l / 2, -l / 2, -l / 2,
                    l / 2, l / 2, -l / 2, -l / 2])
    y_c = np.array([0.0, 0, 0, 0, -h, -h, -h, -h])
    z_c = np.array([w / 2, -w / 2, -w / 2, w / 2,
                    w / 2, -w / 2, -w / 2, w / 2])
    return (np.asarray(R) @ np.stack([x_c, y_c, z_c])
            + np.asarray(location)[:, None])
