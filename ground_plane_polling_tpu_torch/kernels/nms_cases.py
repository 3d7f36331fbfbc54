"""Greedy-NMS inputs for holding the kernel against its plain version:
random candidate sets shaped like the detect call's and crafted edge cases.

The CPU tests run the crafted cases through the JAX package's NMS and the
plain version; chip_smoke.py and the card tests run the same inputs, and
the larger ones of `large_cases`, through the CUDA kernel and the plain
versions on the card. Each case is (name, boxes (S, K, 4) float32, scores
(S, K) float32 sorted descending per row with -inf for invalid
candidates, max_out, iou_threshold), numpy, made from fixed seeds.
"""

from __future__ import annotations

import numpy as np

__all__ = ["clustered_case", "crafted_cases", "large_cases", "random_case",
           "iou_f32"]


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


def clustered_case(rng, s=1, k=1024, clusters=30):
    """S sets of K candidates, all valid, in `clusters` tight clusters of
    boxes 70-80 wide whose corners scatter by 2: each cluster keeps about
    one box, so greedy NMS keeps about `clusters` a set, fewer than a
    max_out of 100, and reaches every candidate."""
    centres = rng.uniform([0, 0], [1344, 416], (s, clusters, 2))
    corner = np.take_along_axis(
        centres, rng.randint(0, clusters, (s, k, 1)), 1) + rng.normal(
            0, 2, (s, k, 2))
    boxes = np.concatenate([corner, corner + rng.uniform(70, 80, (s, k, 2))],
                           -1).astype(np.float32)
    scores = _sorted(rng.uniform(0.05, 1.0, (s, k)).astype(np.float32))
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
    non-finite coordinates, and the kernel's word schedule (32 candidates
    a word): K = 33, 63 and 65, a chain 40 deep across words, max_out
    reached mid-word, the last valid candidate mid-word, a whole word
    suppressed by an earlier one, 12 stacked sets, and K = 1024 in tight
    clusters (about 30 kept, every word reached)."""
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

    # about 30 kept of 1024, all valid: every word reached
    boxes, scores = clustered_case(np.random.RandomState(10))
    cases.append(("clustered_k1024", boxes, scores, 100, 0.5))
    return cases + _word_cases(np.random.RandomState(8))


def _disjoint(n, y=0.0):
    """n unit-height boxes 2 apart along x from y: no two meet."""
    x = np.arange(n, dtype=np.float32) * 2
    return np.stack([x, np.full_like(x, y), x + 1, np.full_like(x, y + 1)],
                    -1)


def _word_cases(rng):
    """Cases on the edges of the kernel's words of 32 candidates."""
    cases = []
    for k in (33, 63, 65):
        boxes, scores = random_case(rng, s=2, k=k, clusters=4)
        scores[1, k - 2:] = -np.inf
        cases.append((f"k_{k}", boxes, scores, 100, 0.5))

    # 20 boxes apart, then chain_16's chain 80 long: every other link
    # kept, 40 deep, across words 0 to 3
    d = np.arange(80, dtype=np.float32) * np.float32(0.25)
    chain = np.stack([d, np.zeros_like(d), d + 1, np.ones_like(d)], -1)
    boxes = np.concatenate([_disjoint(20, y=5.0), chain])
    cases.append(("chain_40_across_words", boxes[None],
                  np.linspace(1, 0.1, 100, dtype=np.float32)[None], 100,
                  0.5))

    # the 37th kept candidate falls inside a word
    boxes, scores = random_case(rng, s=2, k=512)
    cases.append(("max_out_37", boxes, scores, 37, 0.5))

    boxes, scores = random_case(rng, s=2, k=256, clusters=12)
    scores[0, 77:] = -np.inf
    scores[1, 45:] = -np.inf
    cases.append(("last_valid_mid_word", boxes, scores, 100, 0.5))

    # word 1 repeats word 0's boxes (shuffled, nudged), so all of it is
    # suppressed; words 0 and 2 are kept whole
    first = _disjoint(32)
    again = first[rng.permutation(32)] + np.float32(0.01)
    boxes = np.concatenate([first, again, _disjoint(32, y=5.0)])
    cases.append(("word_suppressed_by_earlier_word", boxes[None],
                  np.linspace(1, 0.1, 96, dtype=np.float32)[None], 100,
                  0.5))

    boxes, scores = random_case(rng, s=12, k=256, clusters=8)
    for row, n in enumerate((256, 255, 224, 33, 32, 31, 1, 0, 100, 129,
                             250, 64)):
        scores[row, n:] = -np.inf
    cases.append(("stacked_12", boxes, scores, 100, 0.5))
    return cases


def large_cases():
    """Cases for the card only (no CPU test builds their K x K IoU matrix;
    hold them against the plain sequential loop, greedy_nms_serial): 48
    sets at the main path's K = 1024; K = 16,384, past the kernel's
    1,024-candidate stage, in tight clusters so that fewer than max_out
    are kept and every word is reached (and a second set valid to 5,000);
    and max_out 1,500 over K = 4,096 where each box comes twice, the copy
    after five others, so that kept candidates past the kernel's 896 in
    shared memory still suppress."""
    rng = np.random.RandomState(9)
    cases = []
    boxes, scores = random_case(rng, s=48, k=1024)
    cases.append(("sets_48", boxes, scores, 100, 0.5))

    boxes, scores = clustered_case(rng, s=2, k=16384)
    scores[1, 5000:] = -np.inf
    cases.append(("k_16384", boxes, scores, 100, 0.5))

    grid = _disjoint(2048)
    boxes = np.empty((4096, 4), np.float32)
    boxes[0::2] = grid
    boxes[1::2] = np.roll(grid, 5, axis=0) + np.float32(0.01)
    cases.append(("kept_past_shared_list", boxes[None],
                  np.linspace(1, 0.1, 4096, dtype=np.float32)[None], 1500,
                  0.5))
    return cases
