"""Greedy-NMS inputs for holding the kernel against its plain version:
random candidate sets shaped like the detect call's and crafted edge cases.

The CPU tests run these through the JAX package's NMS and the plain
version; chip_smoke.py and the card tests run the same inputs through the
CUDA kernels and the plain version on the card. Each case is (boxes
(S, K, 4) float32, scores (S, K) float32 sorted descending per row with
-inf for invalid candidates, max_out, iou_threshold), numpy, made from
fixed seeds.
"""

from __future__ import annotations

import numpy as np

__all__ = ["crafted_cases", "random_case", "iou_f32"]


def iou_f32(a, b):
    """IoU of two boxes with ops/overlap.py's float32 operations, in order
    (a NaN coordinate gives NaN)."""
    f = np.float32
    a, b = np.asarray(a, f), np.asarray(b, f)
    with np.errstate(invalid="ignore", over="ignore"):
        iw = max(f(min(a[2], b[2]) - max(a[0], b[0])), f(0))
        ih = max(f(min(a[3], b[3]) - max(a[1], b[1])), f(0))
        area_a = f((a[2] - a[0]) * (a[3] - a[1]))
        area_b = f((b[2] - b[0]) * (b[3] - b[1]))
        inter = f(iw * ih)
        union = max(f(f(area_a + area_b) - inter), f(np.finfo(np.float64).eps))
        return f(inter / union)


def _sorted(scores):
    """Scores sorted descending along the last axis (a stable sort, as
    ops/filtering.py::_top_k)."""
    return np.take_along_axis(
        scores, np.argsort(-scores, axis=-1, kind="stable"), -1)


def random_case(rng, s=1, k=1024, n_valid=None, clusters=40, spread=20.0):
    """S sets of K candidates in clusters of overlapping boxes, as a
    detector's pre-NMS top-k gives them on a 416 x 1344 canvas; the first
    `n_valid` of each row (default all) are valid."""
    centres = rng.uniform([0, 0], [1344, 416], (s, clusters, 2))
    pick = rng.randint(0, clusters, (s, k))
    c = np.take_along_axis(centres, pick[..., None], 1)
    c = c + rng.normal(0, spread, (s, k, 2))
    wh = rng.uniform(20, 200, (s, k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = _sorted(rng.uniform(0.05, 1.0, (s, k)).astype(np.float32))
    if n_valid is not None:
        scores[:, n_valid:] = -np.inf
    return boxes, scores


def _pairs_at_threshold(thr):
    """Boxes [0, 0, a, 1] and [0, 0, x, 1] whose float32 IoU is the float32
    threshold, and two pairs whose IoU is the nearest float32 value either
    side that such pairs reach (an ulp or two away), each pair 10 apart
    along y (pairs do not meet; a height of 1 keeps every IoU exact)."""
    t = np.float32(thr)
    first = {}  # float32 IoU -> the first (a, x) that gives it
    for a in np.arange(1, 4, 0.125, dtype=np.float32):
        x = np.float32(t * a)
        for _ in range(64):
            x = np.nextafter(x, np.float32(-1))
        for _ in range(128):
            first.setdefault(iou_f32([0, 0, a, 1], [0, 0, x, 1]), (a, x))
            x = np.nextafter(x, np.float32(4))
        if t in first:
            break
    boxes = []
    for n, iou in enumerate((max(v for v in first if v < t), t,
                             min(v for v in first if v > t))):
        a, x = first[iou]
        y = np.float32(10 * n)
        boxes += [[0, y, a, y + 1], [0, y, x, y + 1]]
    return np.array(boxes, np.float32)


def crafted_cases():
    """[(name, boxes, scores, max_out, iou_threshold)]: equal scores, IoU
    at the threshold and an ulp either side, all rows invalid, K below
    max_out, K = 1, a suppression chain 16 deep, several stacked sets,
    and non-finite coordinates."""
    rng = np.random.RandomState(7)
    cases = []

    # many exact ties in score: rank order (the stable sort's) decides
    boxes, _ = random_case(rng, s=2, k=300, clusters=10)
    scores = np.round(rng.uniform(0.05, 1, (2, 300)) * 4) / 4
    cases.append(("equal_scores", boxes,
                  _sorted(scores.astype(np.float32)), 100, 0.5))

    # IoU exactly at the threshold (kept: the test is >) and an ulp of IoU
    # either side (kept, suppressed)
    for thr in (0.5, 0.3):
        pairs = _pairs_at_threshold(thr)
        scores = np.linspace(1.0, 0.5, len(pairs), dtype=np.float32)
        cases.append((f"iou_at_threshold_{thr}", pairs[None], scores[None],
                      100, thr))

    cases.append(("all_invalid", random_case(rng, s=2, k=64)[0],
                  np.full((2, 64), -np.inf, np.float32), 100, 0.5))
    boxes, scores = random_case(rng, s=2, k=20, clusters=3)
    cases.append(("k_below_max_out", boxes, scores, 100, 0.5))
    boxes, scores = random_case(rng, s=2, k=1)
    scores[1] = -np.inf
    cases.append(("k_one", boxes, scores, 100, 0.5))

    # box i shifted by i / 4: IoU 0.6 with its neighbour, 1/3 with the
    # next, so greedy NMS keeps every other box, 16 rounds of the fixpoint
    d = np.arange(32, dtype=np.float32) * np.float32(0.25)
    chain = np.stack([d, np.zeros_like(d), d + 1, np.ones_like(d)], -1)
    cases.append(("chain_16", chain[None],
                  np.linspace(1, 0.1, 32, dtype=np.float32)[None], 100, 0.5))

    # four sets (orientation_specific) of two images, stacked, with
    # different numbers of valid candidates
    boxes, scores = random_case(rng, s=8, k=256, clusters=8)
    for row, n in enumerate((256, 200, 17, 0, 256, 1, 100, 255)):
        scores[row, n:] = -np.inf
    cases.append(("stacked_sets", boxes, scores, 100, 0.5))

    # NaN and infinite coordinates: a NaN IoU suppresses nothing
    boxes, scores = random_case(rng, s=1, k=12, clusters=1, spread=2.0)
    boxes[0, 1] = [np.nan, 0, 10, 10]
    boxes[0, 3] = [-np.inf, 0, np.inf, 10]
    boxes[0, 4] = [-np.inf, 0, np.inf, 10]
    boxes[0, 6, 2] = np.inf
    cases.append(("non_finite", boxes, scores, 100, 0.5))

    # max_out smaller than the kept set
    boxes, scores = random_case(rng, s=2, k=512)
    cases.append(("max_out_5", boxes, scores, 5, 0.5))
    return cases
