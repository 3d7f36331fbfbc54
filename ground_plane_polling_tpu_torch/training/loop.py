"""The validation sweep (port of `evaluate_model` of
ground_plane_polling_tpu/training/loop.py): per-bucket VOC AP, mean AP over
the buckets that hold annotations, and keypoint/h/w/l L1 errors. `fit`, the
training loop, is ROADMAP A14.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..inference import make_detect_fn
from ..utils.eval import (bucket_annotations, bucket_detections,
                          evaluate_detections)

__all__ = ["evaluate_model"]


def evaluate_model(model, loader, num_classes: int = 1,
                   score_threshold: float = 0.05, max_detections: int = 100,
                   iou_threshold: float = 0.5, mesh=None,
                   eval_batch: int = 1, int8_calib: int = 0,
                   **detect_kwargs):
    """Full validation sweep of `model` (models.GPPRetinaNet, placed on its
    device) over `loader.eval_inputs()` -> (mean_ap, errors dict,
    per-bucket APs).

    Images of one padded shape are grouped `eval_batch` at a time; a short
    last group is padded by repeating its last item, and the padding rows
    are discarded. One group stays in flight: the next group is dispatched
    before the previous one is read back. Results equal the batch-1 sweep.
    """
    if mesh is not None:
        raise NotImplementedError("mesh: data-parallel evaluation is "
                                  "ROADMAP A15")
    if int8_calib:
        raise NotImplementedError("int8_calib: int8 inference is ROADMAP A16")
    detect_fns = {}
    # device_preprocess defaults to the image dtype: uint8 images get the
    # cast and mean subtraction on the device, float images are taken as
    # already preprocessed; an explicit caller kwarg wins
    device_preprocess = detect_kwargs.pop("device_preprocess", None)

    def get_detect(shape, image_dtype):
        dp = device_preprocess
        if dp is None:
            dp = np.dtype(image_dtype) == np.uint8
            if not dp:
                warnings.warn(
                    "evaluate_model: float eval images are assumed to be "
                    "already preprocessed (device-side BGR-mean "
                    "subtraction disabled). If your loader yields RAW "
                    "float BGR images, pass device_preprocess=True.",
                    stacklevel=3)
        key = (shape, dp)
        if key not in detect_fns:
            detect_fns[key] = make_detect_fn(
                model, shape, num_classes=num_classes,
                score_threshold=score_threshold,
                max_detections=max_detections, device_preprocess=dp,
                **detect_kwargs)
        return detect_fns[key]

    group_size = max(int(eval_batch), 1)
    detections, annotations = [], []

    def dispatch(shape, items):
        n = len(items)
        items = items + [items[-1]] * (group_size - n)
        out = get_detect(shape, items[0]["image"].dtype)(
            torch.from_numpy(np.concatenate([it["image"] for it in items])),
            torch.from_numpy(np.concatenate([it["P_inv"] for it in items])),
            torch.from_numpy(np.concatenate([it["planes"] for it in items])))
        return n, items, out

    def finalize(flight):
        n, items, out = flight
        boxes, dims, scores, labels, orients = (
            t.cpu().numpy() for t in (out.boxes, out.dims, out.scores,
                                      out.labels, out.orientations))
        for j in range(n):
            scale = items[j]["scale"]
            detections.append(bucket_detections(
                boxes[j] / scale, dims[j], scores[j], labels[j], orients[j],
                num_classes))
            annotations.append(bucket_annotations(
                np.asarray(items[j]["annotations"]) /
                np.array([scale] * 12 + [1.0] * 5), num_classes))

    in_flight = None

    def process(shape, items):
        nonlocal in_flight
        dispatched = dispatch(shape, items)
        if in_flight is not None:
            finalize(in_flight)
        in_flight = dispatched

    pending = {}
    for item in loader.eval_inputs():
        shape = tuple(item["image"].shape[1:3])
        pending.setdefault(shape, []).append(item)
        if len(pending[shape]) == group_size:
            process(shape, pending.pop(shape))
    for shape, items in pending.items():
        process(shape, items)
    if in_flight is not None:
        finalize(in_flight)

    aps, kp_err, h_err, w_err, l_err = evaluate_detections(
        detections, annotations, 4 * num_classes, iou_threshold)
    present = [ap for ap, n in aps.values() if n > 0]
    mean_ap = float(np.mean(present)) if present else 0.0
    errors = {"keypoint_error": kp_err, "height_error": h_err,
              "width_error": w_err, "length_error": l_err}
    return mean_ap, errors, aps
