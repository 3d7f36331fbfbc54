"""Validation-set evaluation: VOC-style AP per class-orientation bucket +
mean L1 keypoint/dimension errors (numpy copy of
ground_plane_polling_tpu/utils/eval.py).

Detections and annotations are bucketed into 4*num_classes (class,
orientation) slots, each bucket scored with greedy IoU-0.5 matching and the
py-faster-rcnn AP (precision envelope over the recall curve); matched pairs
contribute L1 errors of the 8 keypoint coordinates and (h, w, l).

The detector sweep itself is driven by the caller
(training/loop.py::evaluate_model); this module only needs numpy arrays.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["average_precision", "evaluate_detections"]


def average_precision(recall: np.ndarray, precision: np.ndarray) -> float:
    """Area under the monotone precision envelope (py-faster-rcnn style)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    changed = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[changed + 1] - mrec[changed])
                        * mpre[changed + 1]))


def _iou_row(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    iw = np.minimum(box[2], boxes[:, 2]) - np.maximum(box[0], boxes[:, 0])
    ih = np.minimum(box[3], boxes[:, 3]) - np.maximum(box[1], boxes[:, 1])
    iw, ih = np.maximum(iw, 0), np.maximum(ih, 0)
    inter = iw * ih
    union = ((box[2] - box[0]) * (box[3] - box[1])
             + (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
             - inter)
    return inter / np.maximum(union, np.finfo(np.float64).eps)


def evaluate_detections(
    detections: List[List[np.ndarray]],
    annotations: List[List[np.ndarray]],
    num_buckets: int,
    iou_threshold: float = 0.5,
):
    """Score bucketed detections against bucketed annotations.

    Args
      detections:  per image, per bucket arrays (K, 16): 12 box+keypoint
                   coords, 3 dims, score.
      annotations: per image, per bucket arrays (G, 15): 12 coords + 3 dims.
      num_buckets: 4 * num_classes.

    Returns (average_precisions {bucket: (ap, n_annotations)},
             keypoint_error, height_error, width_error, length_error).
    """
    average_precisions: Dict[int, Tuple[float, float]] = {}
    errors: List[np.ndarray] = []

    for bucket in range(num_buckets):
        tps, fps, scores = [], [], []
        n_ann = 0.0
        for det_img, ann_img in zip(detections, annotations):
            dets = det_img[bucket]
            anns = ann_img[bucket]
            n_ann += len(anns)
            matched = set()
            # Greedy matching is order-dependent: when two detections
            # overlap one annotation, the higher-scored one must claim it
            # (the reference sorts each image's detections by score before
            # matching, eval.py:103-111) — so sort here rather than
            # relying on the detector emitting score-sorted rows.
            if len(dets) > 1:
                dets = dets[np.argsort(-dets[:, 15])]
            for d in dets:
                scores.append(d[15])
                if len(anns) == 0:
                    fps.append(1.0)
                    tps.append(0.0)
                    continue
                ious = _iou_row(d[:4], anns[:, :4])
                j = int(np.argmax(ious))
                if ious[j] >= iou_threshold and j not in matched:
                    matched.add(j)
                    tps.append(1.0)
                    fps.append(0.0)
                    # keypoints (cols 4:12) + dims (cols 12:15)
                    errors.append(np.abs(d[4:15] - anns[j, 4:15]))
                else:
                    fps.append(1.0)
                    tps.append(0.0)
        if n_ann == 0:
            average_precisions[bucket] = (0.0, 0.0)
            continue
        order = np.argsort(-np.asarray(scores))
        tp = np.cumsum(np.asarray(tps)[order])
        fp = np.cumsum(np.asarray(fps)[order])
        recall = tp / n_ann
        precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        average_precisions[bucket] = (average_precision(recall, precision),
                                      n_ann)

    if errors:
        err = np.vstack(errors)
        keypoint_error = float(np.mean(err[:, :8]))
        height_error = float(np.mean(err[:, 8]))
        width_error = float(np.mean(err[:, 9]))
        length_error = float(np.mean(err[:, 10]))
    else:
        keypoint_error = height_error = width_error = length_error = 0.0
    return (average_precisions, keypoint_error, height_error, width_error,
            length_error)


def bucket_detections(boxes, dims, scores, labels, orientations,
                      num_classes: int):
    """Split one image's padded detection arrays into 4C bucket arrays of
    (K, 16) rows [12 coords, 3 dims, score] (reference eval.py:117-134)."""
    out = []
    valid = scores > -1
    for c in range(num_classes):
        for o in range(4):
            m = valid & (labels == c) & (orientations == o)
            rows = np.concatenate(
                [boxes[m], dims[m], scores[m][:, None]], axis=1)
            out.append(rows)
    return out


def bucket_annotations(annotations, num_classes: int):
    """Split (G, 17) annotations into 4C buckets of (G_i, 15) rows
    (reference eval.py:152-165)."""
    out = []
    for c in range(num_classes):
        for o in range(4):
            m = (annotations[:, 15] == c) & (annotations[:, 16] == o)
            out.append(annotations[m, :15])
    return out
