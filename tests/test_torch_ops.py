"""The PyTorch port's geometry ops against the JAX package on the same
numpy-seeded inputs: anchors (equal), box/dim decode and IoU (rtol 1e-6),
and the pose solve (atol 1e-5), including rotations with theta ~ 0 and
theta ~ pi, where the angles of both solves are held to the true rotation
within a bound from the conditioning."""

import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.ops import anchors as jax_anchors
from ground_plane_polling_tpu.ops import box_coder as jax_bc
from ground_plane_polling_tpu.ops.overlap import iou_matrix as jax_iou
from ground_plane_polling_tpu.ops.pose import solve_pose as jax_solve_pose
from ground_plane_polling_tpu_torch.ops import anchors, box_coder
from ground_plane_polling_tpu_torch.ops.overlap import iou_matrix
from ground_plane_polling_tpu_torch.ops.pose import (
    matrix_from_rodrigues_np, solve_pose)

torch.set_num_threads(2)


@pytest.mark.parametrize("shape", [(128, 416), (416, 1344), (96, 160),
                                   (375, 1242)])
def test_anchors_equal(shape):
    np.testing.assert_array_equal(anchors.anchors_for_shape(shape),
                                  jax_anchors.anchors_for_shape(shape))
    assert (anchors.num_anchors_for_shape(shape)
            == jax_anchors.num_anchors_for_shape(shape))


def test_decode_boxes_matches_jax():
    rng = np.random.RandomState(0)
    anc = anchors.anchors_for_shape((128, 160))[:500]
    deltas = rng.normal(0, 1, (2, 500, 12)).astype(np.float32)
    sign = rng.choice([-1.0, 1.0], (2, 500)).astype(np.float32)
    want = np.asarray(jax_bc.decode_boxes(anc[None], deltas, sign))
    got = box_coder.decode_boxes(torch.from_numpy(anc)[None],
                                 torch.from_numpy(deltas),
                                 torch.from_numpy(sign)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("num_classes", [1, 2])
def test_decode_dims_matches_jax(num_classes):
    raw = np.random.RandomState(1).normal(
        0, 1, (3, 7, 3 * num_classes)).astype(np.float32)
    np.testing.assert_allclose(
        box_coder.decode_dims(torch.from_numpy(raw)).numpy(),
        np.asarray(jax_bc.decode_dims(raw)), rtol=1e-6)


def test_box_constants_equal():
    for name in ("BOX_MEAN", "BOX_STD", "DIM_MEAN", "DIM_STD"):
        np.testing.assert_array_equal(getattr(box_coder, name),
                                      getattr(jax_bc, name))


def test_iou_matrix_matches_jax_with_degenerate_boxes():
    rng = np.random.RandomState(2)
    xy = rng.uniform(0, 100, (40, 2))
    wh = rng.uniform(0, 30, (40, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    boxes[:5, 2:] = boxes[:5, :2]        # zero-area boxes: IoU 0, not NaN
    boxes[5] = boxes[6]                  # an exact duplicate: IoU 1
    got = iou_matrix(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    want = np.asarray(jax_iou(boxes, boxes))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[5, 6] == pytest.approx(1.0)
    assert (got[:5, :5] == 0).all()


def _pose_case(R, orientation, rng, noise=0.0):
    """Keypoints of a box with rotation R for one orientation class, so the
    solve's frame is R (x axis along the measured edge, y down)."""
    X_m = np.array([0.5, 1.65, 12.0])
    h, edge = 1.5, 4.2
    s_x = 1.0 if orientation in (0, 1) else -1.0
    x_dir, y_dir = R[:, 0], R[:, 1]
    X_sel = X_m - s_x * edge * x_dir
    X_t = X_m - h * y_dir
    X_other = X_m + rng.normal(0, 1, 3)  # the unused keypoint
    X_l, X_r = ((X_other, X_sel) if orientation in (1, 2)
                else (X_sel, X_other))
    kp = np.stack([X_l, X_m, X_r, X_t]) + rng.normal(0, noise, (4, 3))
    return kp.astype(np.float32)


def _rot(axis, theta):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K


# float32 rounding of the solves' cos theta = (trace - 1) / 2: a few ulps
# of 1 (the trace sums three diagonal entries of U Vh, each within about
# an ulp of the nearest rotation's)
EPS_COS = 4 * 2.0**-23


def _near_pi_bound(theta):
    """Largest geodesic error of a float32 solve of a rotation by `theta`
    near pi: arccos turns EPS_COS of rounding in cos theta into up to about
    EPS_COS / sin(theta) of angle (sqrt(2 EPS_COS) at pi), and near pi the
    axis's sign may flip (theta -> 2 pi - theta, the same rotation at pi)."""
    bound = 0.0
    for c in (np.cos(theta) - EPS_COS, np.cos(theta) + EPS_COS):
        t = np.arccos(np.clip(c, -1.0, 1.0))
        bound = max(bound, abs(t - theta), abs(2 * np.pi - t - theta))
    return bound


def _geodesic(R, vecs):
    """Angle of the rotation between R and each Rodrigues vector's."""
    Rs = matrix_from_rodrigues_np(np.asarray(vecs, np.float64))
    cos = (np.trace(R.T @ Rs, axis1=-2, axis2=-1) - 1.0) / 2.0
    return np.arccos(np.clip(cos, -1.0, 1.0))


@pytest.mark.parametrize("regime,rotations", [
    ("generic", [((0.2, 1.0, -0.1), 0.7), ((1.0, 0.3, 0.2), -1.9),
                 ((0.0, 1.0, 0.0), 2.5)]),
    ("theta_near_0", [((0.0, 1.0, 0.0), 0.0), ((0.3, 1.0, 0.0), 2e-7),
                      ((1.0, 0.0, 0.2), 1e-4)]),
    ("theta_near_pi", [((0.0, 1.0, 0.0), np.pi), ((0.0, 1.0, 0.05), np.pi),
                       ((0.1, 1.0, 0.0), np.pi - 1e-4)]),
])
def test_solve_pose_matches_jax(regime, rotations):
    """Locations and dimensions equal JAX's (atol 1e-5), and so do the
    angles, except near pi: there the angle is float32-limited in both
    solves (d theta / d cos theta = -1 / sin theta, 1e4 at pi - 1e-4), so
    each solve is held to the true rotation within _near_pi_bound."""
    rng = np.random.RandomState(3)
    kps, orients, dims = [], [], []
    for axis, theta in rotations:
        for o in range(4):
            kps.append(_pose_case(_rot(axis, theta), o, rng))
            orients.append(o)
            dims.append(rng.uniform([1.3, 1.5, 3.5], [1.8, 2.0, 4.8]))
    kps = np.stack(kps)[None]
    orients = np.array(orients, np.int32)[None]
    dims = np.stack(dims).astype(np.float32)[None]
    want = jax_solve_pose(kps, orients, dims)
    got = solve_pose(torch.from_numpy(kps), torch.from_numpy(orients),
                     torch.from_numpy(dims))
    for field, g, w in zip(got._fields, got, want):
        if regime == "theta_near_pi" and field == "angles":
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=f"{regime} {field}")
    if regime != "theta_near_pi":
        return
    for i, (axis, theta) in enumerate(rotations):
        rows = slice(4 * i, 4 * i + 4)
        bound = _near_pi_bound(theta) + 1e-5
        for name, vecs in (("port", got.angles[0, rows].numpy()),
                           ("jax", np.asarray(want.angles)[0, rows])):
            err = _geodesic(_rot(axis, theta), vecs)
            assert (err <= bound).all(), (name, theta, err, bound)


def test_solve_pose_noisy_keypoints_match_jax():
    """Noisy keypoints give a near-rotation frame; both project it to the
    nearest rotation (SVD)."""
    rng = np.random.RandomState(4)
    kps = np.stack([_pose_case(_rot(rng.normal(size=3), rng.uniform(-3, 3)),
                               o % 4, rng, noise=0.05) for o in range(40)])
    orients = (np.arange(40) % 4).astype(np.int32)
    dims = rng.uniform([1.3, 1.5, 3.5], [1.8, 2.0, 4.8], (40, 3)).astype(
        np.float32)
    want = jax_solve_pose(kps, orients, dims)
    got = solve_pose(torch.from_numpy(kps), torch.from_numpy(orients),
                     torch.from_numpy(dims))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_solve_pose_non_finite_rows_do_not_raise():
    """Garbage rows (padded detections) may hold inf/NaN keypoints; the
    solve reports NaN angles there instead of failing the whole batch."""
    kps = np.stack([_pose_case(np.eye(3), 1, np.random.RandomState(5)),
                    np.full((4, 3), np.nan, np.float32)])
    got = solve_pose(torch.from_numpy(kps), torch.tensor([1, 1]),
                     torch.ones(2, 3))
    assert np.isfinite(got.angles[0].numpy()).all()
    assert np.isnan(got.angles[1].numpy()).all()
