"""KITTI official-metric evaluation: AP_2D / AP_BEV / AP_3D / AOS.

Copy of ground_plane_polling_tpu/utils/eval3d.py: the numpy path, and its
C++ core (utils/eval3d_native.py) when that builds.

The reference repo computes only a VOC-style 2D mAP during training; the paper's
headline numbers (AP3D / AOS on the KITTI server, `README.md:3`) come from
the external KITTI C++ devkit (`evaluate_object_3d_offline.cpp`). A user of
the reference runs that devkit on the KITTI-format txt files that
`run_network.py` writes. This module is a faithful host-side
re-implementation of the devkit's semantics so the full AP3D/AOS loop runs
offline against any GT + result label directories:

  * difficulty gating  — Easy/Moderate/Hard via min 2D box height
    (40/25/25 px), max occlusion (0/1/2) and max truncation
    (0.15/0.30/0.50), exactly the devkit's `cleanData`;
  * neighbour classes  — Van counts as "ignored GT" for Car,
    Person_sitting for Pedestrian (matches neither TP nor FP);
  * DontCare regions   — unmatched detections whose 2D
    intersection/det-area with a DontCare box exceeds the class threshold
    are discarded from the FP count;
  * matching           — the devkit's two-pass protocol: a score-priority
    pass (compute_fp=False) collects TP scores for `getThresholds`
    (41 recall sample points), then an overlap-priority pass per score
    threshold accumulates tp/fp/fn/orientation-similarity;
  * overlaps           — 2D IoU for AP_2D/AOS; rotated-rectangle IoU in
    the ground (x, z) plane for AP_BEV; rotated intersection x vertical
    overlap for AP_3D (camera y points down, box origin at the bottom
    face like the KITTI labels);
  * min overlap        — 0.7 for Car, 0.5 for Pedestrian/Cyclist (all
    three metrics, the devkit's MIN_OVERLAP table);
  * AP                 — both the classic 11-point average (every 4th of
    the 41 samples) and the R40 revision (mean over samples 1..40), with
    the devkit's right-max precision envelope;
  * AOS                — (1 + cos(alpha_gt - alpha_det)) / 2 summed over
    2D TPs, normalised like precision (FPs contribute 0).

Everything is plain numpy on the host (evaluation is I/O + bookkeeping, not
a device workload); the rotated-rectangle intersection is an exact
Sutherland-Hodgman convex clip, property-tested against a Monte-Carlo
rasterisation oracle in tests/test_eval3d.py.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

__all__ = [
    "parse_label_file", "load_label_dir", "rotated_rect_corners",
    "polygon_area", "rect_intersection_area", "bev_overlap_matrix",
    "overlap_3d_matrix", "bbox_overlap_matrix", "evaluate_kitti_3d",
    "format_results",
]

# --- devkit constants (evaluate_object_3d_offline.cpp) ---------------------
N_SAMPLE_PTS = 41
MIN_HEIGHT = (40.0, 25.0, 25.0)          # px, per difficulty
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.30, 0.50)
DIFFICULTY_NAMES = ("easy", "moderate", "hard")
# min overlap per class (same for 2D / BEV / 3D in the devkit table)
MIN_OVERLAP = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}
# classes whose GT is "ignored" (neither TP nor FP) for a given eval class
NEIGHBOR_CLASSES = {"Car": ("Van",), "Pedestrian": ("Person_sitting",)}
_NO_DETECTION = -1


# --- KITTI label parsing ----------------------------------------------------

def parse_label_file(path: str) -> Dict[str, np.ndarray]:
    """Parse a KITTI label/result txt into a dict of arrays.

    Keys: type (object str array), truncated, occluded, alpha, bbox (N,4),
    dims (N,3 h/w/l), loc (N,3), ry, score (N; -inf when the file has no
    16th column, i.e. GT files).
    """
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            rows.append(parts)
    n = len(rows)
    out = {
        "type": np.array([r[0] for r in rows], dtype=object),
        "truncated": np.zeros(n), "occluded": np.zeros(n, np.int64),
        "alpha": np.zeros(n), "bbox": np.zeros((n, 4)),
        "dims": np.zeros((n, 3)), "loc": np.zeros((n, 3)),
        "ry": np.zeros(n), "score": np.full(n, -np.inf),
    }
    for i, r in enumerate(rows):
        vals = [float(v) for v in r[1:]]
        out["truncated"][i] = vals[0]
        out["occluded"][i] = int(vals[1])
        out["alpha"][i] = vals[2]
        out["bbox"][i] = vals[3:7]
        out["dims"][i] = vals[7:10]
        out["loc"][i] = vals[10:13]
        out["ry"][i] = vals[13]
        if len(vals) > 14:
            out["score"][i] = vals[14]
    return out


def load_label_dir(path: str, ids: Sequence[str] | None = None
                   ) -> List[Dict[str, np.ndarray]]:
    """Load every .txt in `path` (sorted), or the given stem ids.

    Missing det files for a listed id parse as empty (the devkit aborts;
    an empty result is the more useful behaviour offline)."""
    if ids is None:
        ids = sorted(os.path.splitext(f)[0] for f in os.listdir(path)
                     if f.endswith(".txt"))
    out = []
    for stem in ids:
        p = os.path.join(path, stem + ".txt")
        if os.path.exists(p):
            out.append(parse_label_file(p))
        else:
            out.append(parse_label_file(os.devnull))
    return out


# --- rotated-rectangle geometry --------------------------------------------

def rotated_rect_corners(loc_xz: np.ndarray, ry: np.ndarray,
                         lw: np.ndarray) -> np.ndarray:
    """(N,2),(N,),(N,2 l/w) -> (N,4,2) ground-plane corners, CCW.

    KITTI boxes: length along the object x axis, width along z, rotated by
    R_y = [[cos, sin], [-sin, cos]] acting on (x, z) (the y-rotation
    restricted to the ground plane)."""
    l2, w2 = lw[:, 0] / 2.0, lw[:, 1] / 2.0
    # CCW in (x, z): (+l,+w) -> (-l,+w) -> (-l,-w) -> (+l,-w)
    xs = np.stack([l2, -l2, -l2, l2], axis=1)
    zs = np.stack([w2, w2, -w2, -w2], axis=1)
    c, s = np.cos(ry)[:, None], np.sin(ry)[:, None]
    gx = c * xs + s * zs + loc_xz[:, 0:1]
    gz = -s * xs + c * zs + loc_xz[:, 1:2]
    return np.stack([gx, gz], axis=-1)


def _native():
    """The C++ core (utils/eval3d_native.py) or None. Lazy so importing
    this module never triggers a g++ build; GPP_EVAL3D_NATIVE=0 forces
    the pure-numpy path."""
    from . import eval3d_native

    return eval3d_native if eval3d_native.available() else None


def polygon_area(poly: np.ndarray) -> float:
    """Shoelace |area| of an (M,2) polygon."""
    n = len(poly)
    if n < 3:
        return 0.0
    s = 0.0
    for i in range(n):
        p, q = poly[i], poly[(i + 1) % n]
        s += p[0] * q[1] - q[0] * p[1]
    return 0.5 * abs(s)


def _clip_halfplane(poly: List[np.ndarray], a: np.ndarray,
                    b: np.ndarray) -> List[np.ndarray]:
    """Sutherland-Hodgman: keep the part of `poly` left of edge a->b."""
    out: List[np.ndarray] = []
    if not poly:
        return out
    d = b - a

    def side(p):
        return d[0] * (p[1] - a[1]) - d[1] * (p[0] - a[0])

    prev = poly[-1]
    sp = side(prev)
    for cur in poly:
        sc = side(cur)
        if sc >= 0:
            if sp < 0:
                t = sp / (sp - sc)
                out.append(prev + t * (cur - prev))
            out.append(cur)
        elif sp >= 0:
            t = sp / (sp - sc)
            out.append(prev + t * (cur - prev))
        prev, sp = cur, sc
    return out


def _ccw(corners: np.ndarray) -> np.ndarray:
    n = len(corners)
    signed = 0.0
    for i in range(n):
        p, q = corners[i], corners[(i + 1) % n]
        signed += p[0] * q[1] - q[0] * p[1]
    return corners if signed >= 0 else corners[::-1]


def rect_intersection_area(ca: np.ndarray, cb: np.ndarray) -> float:
    """Exact intersection area of two convex quads ((4,2) corners)."""
    ca, cb = _ccw(ca), _ccw(cb)
    poly = [cb[i] for i in range(len(cb))]
    for i in range(len(ca)):
        poly = _clip_halfplane(poly, ca[i], ca[(i + 1) % len(ca)])
        if not poly:
            return 0.0
    return polygon_area(np.asarray(poly))


def bev_overlap_matrix(det: Dict[str, np.ndarray],
                       gt: Dict[str, np.ndarray]) -> np.ndarray:
    """(n_det, n_gt) rotated IoU in the ground (x, z) plane."""
    nd, ng = len(det["ry"]), len(gt["ry"])
    out = np.zeros((nd, ng))
    if nd == 0 or ng == 0:
        return out
    native = _native()
    if native is not None:
        return native.bev_overlap(det, gt)
    cd = rotated_rect_corners(det["loc"][:, [0, 2]], det["ry"],
                              det["dims"][:, [2, 1]])   # dims h,w,l -> l,w
    cg = rotated_rect_corners(gt["loc"][:, [0, 2]], gt["ry"],
                              gt["dims"][:, [2, 1]])
    area_d = det["dims"][:, 2] * det["dims"][:, 1]
    area_g = gt["dims"][:, 2] * gt["dims"][:, 1]
    for i in range(nd):
        for j in range(ng):
            inter = rect_intersection_area(cd[i], cg[j])
            union = area_d[i] + area_g[j] - inter
            out[i, j] = inter / max(union, 1e-12)
    return out


def overlap_3d_matrix(det: Dict[str, np.ndarray],
                      gt: Dict[str, np.ndarray]) -> np.ndarray:
    """(n_det, n_gt) 3D IoU: rotated ground intersection x vertical overlap.

    KITTI camera y points DOWN and `loc` is the box bottom-face centre, so
    a box spans [y - h, y] and the vertical overlap of boxes a, b is
    min(y_a, y_b) - max(y_a - h_a, y_b - h_b), clamped at 0 (devkit
    box3DOverlap)."""
    nd, ng = len(det["ry"]), len(gt["ry"])
    out = np.zeros((nd, ng))
    if nd == 0 or ng == 0:
        return out
    native = _native()
    if native is not None:
        return native.overlap_3d(det, gt)
    cd = rotated_rect_corners(det["loc"][:, [0, 2]], det["ry"],
                              det["dims"][:, [2, 1]])
    cg = rotated_rect_corners(gt["loc"][:, [0, 2]], gt["ry"],
                              gt["dims"][:, [2, 1]])
    vol_d = np.prod(det["dims"], axis=1)
    vol_g = np.prod(gt["dims"], axis=1)
    for i in range(nd):
        y_di, h_di = det["loc"][i, 1], det["dims"][i, 0]
        for j in range(ng):
            y_gj, h_gj = gt["loc"][j, 1], gt["dims"][j, 0]
            dh = min(y_di, y_gj) - max(y_di - h_di, y_gj - h_gj)
            if dh <= 0:
                continue
            inter = rect_intersection_area(cd[i], cg[j]) * dh
            union = vol_d[i] + vol_g[j] - inter
            out[i, j] = inter / max(union, 1e-12)
    return out


def bbox_overlap_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray,
                        criterion: int = -1) -> np.ndarray:
    """(A,B) 2D overlap. criterion -1: IoU; 0: intersection / area_a
    (the devkit's DontCare check, a = detection)."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)))
    ax1, ay1, ax2, ay2 = [boxes_a[:, i:i + 1] for i in range(4)]
    bx1, by1, bx2, by2 = [boxes_b[None, :, i] for i in range(4)]
    iw = np.maximum(np.minimum(ax2, bx2) - np.maximum(ax1, bx1), 0.0)
    ih = np.maximum(np.minimum(ay2, by2) - np.maximum(ay1, by1), 0.0)
    inter = iw * ih
    area_a = (ax2 - ax1) * (ay2 - ay1)
    if criterion == 0:
        return inter / np.maximum(area_a, 1e-12)
    area_b = (bx2 - bx1) * (by2 - by1)
    return inter / np.maximum(area_a + area_b - inter, 1e-12)


# --- devkit eval protocol ---------------------------------------------------

def _clean_data(current_class: str, gt: Dict[str, np.ndarray],
                det: Dict[str, np.ndarray], difficulty: int):
    """devkit cleanData: per-image ignore flags + DontCare 2D boxes.

    Returns (ignored_gt (G,), dc_boxes (D,4), ignored_det (N,), n_valid_gt).
    Flag values: 0 = counted, 1 = ignored (no TP/FP effect), -1 = removed.
    """
    # class comparisons are case-insensitive like the devkit's strcasecmp
    cls_l = current_class.lower()
    neighbors = tuple(n.lower()
                      for n in NEIGHBOR_CLASSES.get(current_class, ()))
    ignored_gt = np.full(len(gt["type"]), -1, np.int64)
    n_valid = 0
    dc = []
    for i, t in enumerate(gt["type"]):
        t = t.lower()
        if t == "dontcare":
            dc.append(gt["bbox"][i])
        if t == cls_l:
            valid_class = 1
        elif t in neighbors:
            valid_class = 0
        else:
            valid_class = -1
        height = gt["bbox"][i, 3] - gt["bbox"][i, 1]
        ignore = (gt["occluded"][i] > MAX_OCCLUSION[difficulty]
                  or gt["truncated"][i] > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt[i] = 0
            n_valid += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt[i] = 1
    ignored_det = np.full(len(det["type"]), -1, np.int64)
    for j, t in enumerate(det["type"]):
        height = det["bbox"][j, 3] - det["bbox"][j, 1]
        if height < MIN_HEIGHT[difficulty]:
            ignored_det[j] = 1
        elif t.lower() == cls_l:
            ignored_det[j] = 0
    dc_boxes = (np.stack(dc) if dc
                else np.zeros((0, 4)))
    return ignored_gt, dc_boxes, ignored_det, n_valid


def _compute_statistics(overlap: np.ndarray, det: Dict[str, np.ndarray],
                        gt: Dict[str, np.ndarray], ignored_gt, dc_boxes,
                        ignored_det, min_overlap: float, compute_fp: bool,
                        compute_aos: bool, thresh: float):
    """devkit computeStatistics for one image at one score threshold.

    `overlap` is the precomputed (n_det, n_gt) matrix for the metric.
    Returns (tp, fp, fn, similarity_sum, tp_scores)."""
    n_det, n_gt = overlap.shape
    assigned = np.zeros(n_det, bool)
    ignored_threshold = np.zeros(n_det, bool)
    if compute_fp:
        ignored_threshold = det["score"] < thresh
    tp = fp = fn = 0
    tp_scores: List[float] = []
    deltas: List[float] = []
    for i in range(n_gt):
        if ignored_gt[i] == -1:
            continue
        det_idx = _NO_DETECTION
        valid_detection = -np.inf
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(n_det):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            ov = overlap[j, i]
            if not compute_fp:
                # score-priority pass: best-scored det above min overlap
                if ov > min_overlap and det["score"][j] > valid_detection:
                    det_idx = j
                    valid_detection = det["score"][j]
            else:
                if (ov > min_overlap
                        and (ov > max_overlap or assigned_ignored_det)
                        and ignored_det[j] == 0):
                    max_overlap = ov
                    det_idx = j
                    valid_detection = 1.0
                    assigned_ignored_det = False
                elif (ov > min_overlap and det_idx == _NO_DETECTION
                      and ignored_det[j] == 1):
                    det_idx = j
                    valid_detection = 1.0
                    assigned_ignored_det = True
        if det_idx == _NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif det_idx != _NO_DETECTION and (ignored_gt[i] == 1
                                           or ignored_det[det_idx] == 1):
            assigned[det_idx] = True
        elif det_idx != _NO_DETECTION:
            tp += 1
            tp_scores.append(float(det["score"][det_idx]))
            if compute_aos:
                deltas.append(float(gt["alpha"][i]
                                    - det["alpha"][det_idx]))
            assigned[det_idx] = True
    similarity = 0.0
    if compute_fp:
        for j in range(n_det):
            if not (assigned[j] or ignored_det[j] != 0
                    or ignored_threshold[j]):
                fp += 1
        # DontCare suppression: unmatched dets inside stuff regions are
        # removed from the FP count (2D intersection / det-area, devkit
        # criterion 0).
        if len(dc_boxes):
            dc_ov = bbox_overlap_matrix(det["bbox"], dc_boxes, criterion=0)
            for j in range(n_det):
                if (assigned[j] or ignored_det[j] != 0
                        or ignored_threshold[j] or ignored_det[j] == -1):
                    continue
                if np.any(dc_ov[j] > min_overlap):
                    assigned[j] = True
                    fp -= 1
        if compute_aos:
            # FPs contribute 0; each TP contributes (1+cos d)/2
            similarity = float(np.sum((1.0 + np.cos(deltas)) / 2.0))
    return tp, fp, fn, similarity, tp_scores


def _get_thresholds(scores: np.ndarray, n_gt: int) -> np.ndarray:
    """devkit getThresholds: score cut points at ~41 recall samples."""
    scores = np.sort(scores)[::-1]
    thresholds = []
    current_recall = 0.0
    for i, s in enumerate(scores):
        l_recall = (i + 1) / n_gt
        r_recall = (i + 2) / n_gt if i < len(scores) - 1 else l_recall
        if (((r_recall - current_recall) < (current_recall - l_recall))
                and i < len(scores) - 1):
            continue
        thresholds.append(s)
        current_recall += 1.0 / (N_SAMPLE_PTS - 1)
    return np.asarray(thresholds)


def _eval_class(gt_list, det_list, current_class: str, difficulty: int,
                metric: str, overlaps: List[np.ndarray],
                compute_aos: bool):
    """devkit eval_class for one (class, difficulty, metric).

    Returns (precision (41,), aos (41,)) sampled on the recall grid."""
    min_overlap = MIN_OVERLAP[current_class]
    cleaned = [_clean_data(current_class, gt, det, difficulty)
               for gt, det in zip(gt_list, det_list)]
    n_gt_total = sum(c[3] for c in cleaned)
    precision = np.zeros(N_SAMPLE_PTS)
    aos = np.zeros(N_SAMPLE_PTS)
    if n_gt_total == 0:
        return precision, aos, 0
    all_scores: List[float] = []
    for (gt, det, ov, (ig, dc, idet, _)) in zip(
            gt_list, det_list, overlaps, cleaned):
        _, _, _, _, scores = _compute_statistics(
            ov, det, gt, ig, dc, idet, min_overlap,
            compute_fp=False, compute_aos=False, thresh=0.0)
        all_scores.extend(scores)
    thresholds = _get_thresholds(np.asarray(all_scores), n_gt_total)
    native = _native()
    if native is not None and len(thresholds):
        # one native call per image accumulates every threshold at once
        T = len(thresholds)
        tp_a = np.zeros(T, np.int64)
        fp_a = np.zeros(T, np.int64)
        fn_a = np.zeros(T, np.int64)
        sim_a = np.zeros(T, np.float64)
        for (gt, det, ov, (ig, dc, idet, _)) in zip(
                gt_list, det_list, overlaps, cleaned):
            if ov.shape[0] > 4096:
                # exceeds the native per-image buffer: score this image
                # through the numpy path (identical semantics)
                for ti, t in enumerate(thresholds):
                    r = _compute_statistics(
                        ov, det, gt, ig, dc, idet, min_overlap,
                        compute_fp=True, compute_aos=compute_aos,
                        thresh=t)
                    tp_a[ti] += r[0]
                    fp_a[ti] += r[1]
                    fn_a[ti] += r[2]
                    sim_a[ti] += r[3]
                continue
            dc_ov = (bbox_overlap_matrix(det["bbox"], dc, criterion=0)
                     if len(dc) else np.zeros((len(det["ry"]), 0)))
            native.compute_stats(ov, det["score"], idet, ig, dc_ov,
                                 det["alpha"], gt["alpha"], compute_aos,
                                 min_overlap, thresholds,
                                 tp_a, fp_a, fn_a, sim_a)
        denom = tp_a + fp_a
        nz = denom > 0
        precision[:T][nz] = tp_a[nz] / denom[nz]
        aos[:T][nz] = sim_a[nz] / denom[nz]
    else:
        for ti, t in enumerate(thresholds):
            tp = fp = fn = 0
            sim = 0.0
            for (gt, det, ov, (ig, dc, idet, _)) in zip(
                    gt_list, det_list, overlaps, cleaned):
                r = _compute_statistics(ov, det, gt, ig, dc, idet,
                                        min_overlap, compute_fp=True,
                                        compute_aos=compute_aos, thresh=t)
                tp += r[0]
                fp += r[1]
                fn += r[2]
                sim += r[3]
            if tp + fp > 0:
                precision[ti] = tp / (tp + fp)
                aos[ti] = sim / (tp + fp)
    # right-max envelope (devkit post-pass)
    for i in range(N_SAMPLE_PTS - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
        aos[i] = max(aos[i], aos[i + 1])
    return precision, aos, n_gt_total


def _ap(curve: np.ndarray, mode: str) -> float:
    if mode == "11":
        return float(np.mean(curve[::4]))          # samples 0,4,...,40
    if mode == "40":
        return float(np.mean(curve[1:]))           # samples 1..40
    raise ValueError(f"unknown AP mode {mode!r} (use '11' or '40')")


def evaluate_kitti_3d(gt_list: List[Dict[str, np.ndarray]],
                      det_list: List[Dict[str, np.ndarray]],
                      classes: Sequence[str] = ("Car",),
                      metrics: Sequence[str] = ("bbox", "bev", "3d"),
                      ap_mode: str = "40",
                      compute_aos: bool = True) -> Dict:
    """Run the devkit protocol over parsed label lists.

    Returns {class: {metric: {difficulty_name: AP%}}} (+ "aos" under each
    class when compute_aos and "bbox" in metrics). APs are percentages.
    """
    if len(gt_list) != len(det_list):
        raise ValueError("gt and det lists must align per image")
    results: Dict = {}
    # overlap matrices are class/difficulty independent: compute once for
    # ALL classes (the rotated clipping dominates multi-class runs)
    ov_cache = {}
    for metric in metrics:
        if metric == "bbox":
            ovs = [bbox_overlap_matrix(d["bbox"], g["bbox"])
                   for d, g in zip(det_list, gt_list)]
        elif metric == "bev":
            ovs = [bev_overlap_matrix(d, g)
                   for d, g in zip(det_list, gt_list)]
        elif metric == "3d":
            ovs = [overlap_3d_matrix(d, g)
                   for d, g in zip(det_list, gt_list)]
        else:
            raise ValueError(f"unknown metric {metric!r}")
        ov_cache[metric] = ovs
    for cls in classes:
        results[cls] = {}
        for metric in metrics:
            results[cls][metric] = {}
            want_aos = compute_aos and metric == "bbox"
            if want_aos:
                results[cls]["aos"] = {}
            for diff in range(3):
                prec, aos, n_gt = _eval_class(
                    gt_list, det_list, cls, diff, metric,
                    ov_cache[metric], compute_aos=want_aos)
                name = DIFFICULTY_NAMES[diff]
                results[cls][metric][name] = (100.0 * _ap(prec, ap_mode)
                                              if n_gt else float("nan"))
                if want_aos:
                    results[cls]["aos"][name] = (100.0 * _ap(aos, ap_mode)
                                                 if n_gt else float("nan"))
    return results


def format_results(results: Dict) -> str:
    """Devkit-style printable table."""
    lines = []
    for cls, per_metric in results.items():
        for metric, per_diff in per_metric.items():
            vals = "  ".join(f"{per_diff[d]:6.2f}"
                             for d in DIFFICULTY_NAMES)
            lines.append(f"{cls:<12} {metric:<5} (E/M/H):  {vals}")
    return "\n".join(lines)
