"""Polling inputs for holding the kernel against its twin: random plausible
detections and crafted edge cases of the fused arg-min.

The CPU tests run these through the JAX package and the twin; chip_smoke.py
runs the same inputs through the CUDA kernel and the twin on the card. All
arrays are numpy float32 / int32, made from fixed seeds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import polling as twin

__all__ = ["K", "P_INV", "scene", "random_case", "crafted_cases",
           "straddle_cases"]

# KITTI-like intrinsics (a 1242 x 375 camera)
K = np.array([[720.0, 0.0, 620.0], [0.0, 720.0, 190.0], [0.0, 0.0, 1.0]])
P = np.concatenate([K, np.zeros((3, 1))], axis=1)
P_INV = np.linalg.pinv(P)


def _project(X):
    x = P @ np.append(X, 1.0)
    return x[:2] / x[2]


def scene(h=1.5, w=1.7, l=4.2, y_ground=1.65, depth=10.0):
    """Orientation-1 box resting on the plane y = y_ground (camera coords:
    x right, y down, z forward). Returns (keypoints_2d (8,), X3d (4, 3) for
    l, m, r, t)."""
    X_m = np.array([0.5, y_ground, depth])
    X_r = X_m - np.array([l, 0, 0])
    X_l = X_m - np.array([0, 0, w])
    X_t = X_m - np.array([0, h, 0])
    pts3 = np.stack([X_l, X_m, X_r, X_t])
    return np.concatenate([_project(X) for X in pts3]), pts3


def random_case(rng, b=2, d=16, p=40):
    """Plausible random detections + plane database, drawn in the same order
    as the JAX package's polling tests draw them."""
    boxes = np.full((b, d, 12), -1.0, np.float32)
    dims = np.zeros((b, d, 3), np.float32)
    orients = rng.randint(0, 4, (b, d)).astype(np.int32)
    for bi in range(b):
        for di in range(d):
            h = rng.uniform(1.3, 1.8)
            w = rng.uniform(1.5, 2.0)
            l = rng.uniform(3.5, 4.8)
            kp2, _ = scene(h, w, l, y_ground=rng.uniform(1.4, 1.9),
                           depth=rng.uniform(8.0, 30.0))
            boxes[bi, di, 4:] = kp2 + rng.normal(0, 2.0, 8)  # pixel noise
            dims[bi, di] = (h, w, l)
    planes = np.stack([
        rng.uniform(-0.05, 0.05, p),
        np.ones(p),
        rng.uniform(-0.05, 0.05, p),
        rng.uniform(-2.2, -1.2, p),
    ], axis=1)
    P_inv = np.tile(P_INV[None], (b, 1, 1)).astype(np.float32)
    return (boxes, dims, orients, P_inv,
            np.tile(planes[None], (b, 1, 1)).astype(np.float32))


def _one(kp2, dims, planes, orientation=1):
    boxes = np.full((1, 1, 12), -1.0, np.float32)
    boxes[0, 0, 4:] = kp2
    return (boxes, np.asarray(dims, np.float32).reshape(1, 1, 3),
            np.array([[orientation]], np.int32),
            P_INV[None].astype(np.float32),
            np.asarray(planes, np.float32)[None])


def _ground(s):
    """The scene's ground plane scaled by s: every polled distance scales
    by s, the winding does not change."""
    return [0.0, 1.0, 0.0, -1.65 * s]


_NAN_PLANE = [0.3, 0.0, 0.2, -1.0]  # b == 0 normalizes to NaN


def _pool_scores(kp2, dims):
    """A seeded pool of 20,000 planes and, for one detection, each plane's
    votes, raw residual and winding; `ok` marks finite residuals with a
    winding well away from 0."""
    rng = np.random.RandomState(7)
    n = 20000
    pool = np.stack([rng.uniform(-1, 1, n),
                     rng.uniform(0.02, 1, n) * rng.choice([-1, 1], n),
                     rng.uniform(-1, 1, n),
                     rng.uniform(-20, 20, n)], axis=1)
    args = [torch.from_numpy(a) for a in _one(kp2, dims, pool)]
    rays = twin.rays_from_boxes(args[0], args[3])
    expected = twin.expected_distances(args[1], args[2])
    votes, res, wind, _ = twin.poll_scoreboard(
        rays, expected, twin.normalize_planes(args[4]))
    votes, res, wind = (t[0, 0].numpy() for t in (votes, res, wind))
    return pool, votes, res, wind, np.isfinite(res) & (np.abs(wind) > 1e-3)


def _winding_planes(kp2, dims):
    """From the pool, planes A (wrong winding), B (right winding, same vote
    count, larger raw residual below 100) and C (fewer votes)."""
    pool, votes, res, wind, ok = _pool_scores(kp2, dims)
    for level in range(6, 0, -1):
        a = np.flatnonzero(ok & (votes == level) & (wind < 0) & (res < 90))
        c = np.flatnonzero(ok & (votes < level))
        if not len(a) or not len(c):
            continue
        ia = a[np.argmin(res[a])]
        bb = np.flatnonzero(ok & (votes == level) & (wind > 0)
                            & (res > res[ia] + 1.0) & (res < 90))
        if len(bb):
            return pool[ia], pool[bb[0]], pool[c[0]]
    raise RuntimeError("no winding edge case in the plane pool")


def _tie_planes(kp2, dims):
    """From the pool, at the highest vote level that has all three: planes
    A (wrong winding, scores 100), C (fewer votes, scores 100) and F (right
    winding, raw residual above 100: loses to both, a filler)."""
    pool, votes, res, wind, ok = _pool_scores(kp2, dims)
    for level in range(6, 0, -1):
        a = np.flatnonzero(ok & (votes == level) & (wind < 0))
        c = np.flatnonzero(ok & (votes < level))
        f = np.flatnonzero(ok & (votes == level) & (wind > 0) & (res > 110)
                           & (res < 1e4))
        if len(a) and len(c) and len(f):
            return pool[a[0]], pool[c[0]], pool[f[0]]
    raise RuntimeError("no tie edge case in the plane pool")


def crafted_cases():
    """Edge cases of the fused reduction: [(name, args, expected index)],
    args in the order of fit_road_planes, expected index of the winning
    plane of detection 0 (None: only shapes and finiteness are checked)."""
    h, w, l = 1.5, 1.7, 4.2
    kp2, _ = scene(h, w, l)
    dims = (h, w, l)
    a, b, c = _winding_planes(kp2, dims)
    cases = [
        # a 1-vote plane with residual > 100 loses to a 0-vote plane (100)
        ("lower_votes_beat_residual_above_100",
         _one(kp2, (60.0, w, l), [_ground(40), _ground(0.01), _ground(0.02)]),
         1),
        # all planes on one level with residuals > 100: least residual wins
        ("top_level_above_100_without_lower",
         _one(kp2, dims, [_ground(50), _ground(40)]), 1),
        # identical best planes: the first index wins
        ("equal_residuals_first_index",
         _one(kp2, dims, [_ground(0.5), _ground(1), _ground(1)]), 1),
        # NaN residuals at the top level: the first NaN wins
        ("nan_at_top_level",
         _one(kp2, dims, [_ground(0.01), _NAN_PLANE, _NAN_PLANE]), 1),
        # NaN below the top level is gated to 100 and loses
        ("nan_below_top_level",
         _one(kp2, dims, [_NAN_PLANE, _ground(1)]), 1),
        # a top-level plane with the wrong winding scores 100 even though
        # its raw residual is the least
        ("wrong_winding_at_top_level", _one(kp2, dims, [c, a, b]), 2),
        # wrong winding (100) ties with a lower-vote plane (100): first wins
        ("wrong_winding_ties_lower_first", _one(kp2, dims, [a, c]), 0),
        ("lower_ties_wrong_winding_first", _one(kp2, dims, [c, a]), 0),
    ]
    # padded detection rows (boxes, dims = -1, orientation -1) must run
    boxes, dims_r, orients, P_inv, planes = random_case(
        np.random.RandomState(3), b=2, d=4, p=50)
    boxes[:, 2:] = -1.0
    dims_r[:, 2:] = -1.0
    orients[:, 2:] = -1
    cases.append(("padded_rows", (boxes, dims_r, orients, P_inv, planes),
                  None))
    return cases


def _straddle_edges():
    """The edges of crafted_cases as (name, dimensions, competing planes in
    order, filler, index of the winner among the competitors); the filler
    can never win against them."""
    h, w, l = 1.5, 1.7, 4.2
    kp2, _ = scene(h, w, l)
    dims = (h, w, l)
    a, b, c = _winding_planes(kp2, dims)
    ta, tc, tf = _tie_planes(kp2, dims)
    return kp2, [
        # 1 vote, residual > 100, loses to the first 0-vote plane (100);
        # the filler has 1 vote and a larger residual
        ("lower_votes_beat_residual_above_100", (60.0, w, l),
         [_ground(40), _ground(0.01), _ground(0.02)], _ground(40.3), 1),
        ("equal_residuals_first_index", dims, [_ground(1), _ground(1)],
         _ground(0.5), 0),
        ("nan_at_top_level", dims, [_ground(0.01), _NAN_PLANE, _NAN_PLANE],
         _ground(0.01), 1),
        ("nan_below_top_level", dims, [_NAN_PLANE, _ground(1)],
         _ground(0.5), 1),
        ("wrong_winding_at_top_level", dims, [c, a, b], c, 2),
        ("wrong_winding_ties_lower_first", dims, [ta, tc], tf, 0),
        ("lower_ties_wrong_winding_first", dims, [tc, ta], tf, 0),
    ]


def straddle_cases(p):
    """The edges of the fused reduction with the competing planes in
    different splits of a P-plane database: at index 0, on both sides of
    the first split boundary and last, among filler planes. The splits are
    as many as leave MIN_SPLIT_PLANES planes a split, the plan for one
    detection on a card that holds that many blocks at once. Returns
    [(name, args, expected index, splits)], args in the order of
    fit_road_planes."""
    from .polling_cuda import MIN_SPLIT_PLANES

    splits = -(-p // MIN_SPLIT_PLANES)
    edge = -(-p // splits)  # the first split boundary
    kp2, edges = _straddle_edges()
    placements = {2: {"boundary": (edge - 1, edge), "ends": (0, p - 1)},
                  3: {"first": (0, edge - 1, edge),
                      "last": (edge - 1, edge, p - 1)}}
    cases = []
    for name, dims, planes, filler, winner in edges:
        for where, at in placements[len(planes)].items():
            db = np.tile(np.asarray(filler, np.float32), (p, 1))
            db[list(at)] = planes
            cases.append((f"{name}@{where}/P{p}", _one(kp2, dims, db),
                          at[winner], splits))
    return cases
