"""Faults planted under the detect call's timed path, to show that the
check fails them: the benchmark's own tests and `readings.py --faults`
name them; a run of the benchmark never does. Each fault builds the
program from a changed configuration (`cfg`), or alters the call's
outputs where they are produced (`wrap`), or both.

  * half_batch: the second half of each batch left out (no detections);
  * swap_position: batch position 1 given position 0's outputs;
  * nms_half: each frame keeps only the first half of its detections;
  * nms_threshold: the program's NMS suppresses at IoU 0.3, not 0.5;
  * scores: every score moved by a quarter of a logit;
  * box, dims: one detection's keypoints moved by two box widths, one
    detection's dimensions scaled by 1.5;
  * keypoint, plane, residual, pose: one detection's polled keypoint,
    chosen plane, residual or pose altered.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["Fault", "FAULTS"]


class Fault(NamedTuple):
    cfg: Optional[Callable] = None   # configuration -> the program's
    wrap: Optional[Callable] = None  # detect -> the broken detect


def _edit(out, fn):
    """The outputs `out` with fn(fields) applied to a clone of them."""
    fields = {k: (None if v is None else v.clone())
              for k, v in out._asdict().items()}
    fn(fields)
    return type(out)(**fields)


def _outputs(fn):
    """A fault that applies fn(fields, batch) to every call's outputs."""
    def wrap(detect):
        def broken(images, P_inv, planes):
            return _edit(detect(images, P_inv, planes),
                         lambda f: fn(f, len(images)))
        broken.release = getattr(detect, "release", None) or (lambda: None)
        return broken
    return Fault(wrap=wrap)


def _field(name, fn):
    return _outputs(lambda f, batch: fn(f[name]))


def _fill(fields, rows, cols=slice(None)):
    for v in fields.values():
        if v is not None:
            v[rows, cols] = -1


def _swap(fields, batch):
    if batch > 1:
        for v in fields.values():
            if v is not None:
                v[1] = v[0]


def _shift_logits(t):
    valid = t > 0
    t[valid] = torch.sigmoid(torch.logit(t[valid].double()) + 0.25).to(
        t.dtype)


FAULTS = {
    "half_batch": _outputs(lambda f, batch: _fill(f, slice(batch // 2,
                                                           None))),
    "swap_position": _outputs(_swap),
    "nms_half": _outputs(lambda f, batch: _fill(
        f, slice(None), slice(f["labels"].shape[1] // 2, None))),
    "nms_threshold": Fault(cfg=lambda cfg: {**cfg, "nms_threshold": 0.3}),
    "scores": _field("scores", _shift_logits),
    "box": _field("boxes", lambda t: t[:, 3, 4:].add_(
        2.0 * (t[:, 3, 2:3] - t[:, 3, 0:1]).abs())),
    "dims": _field("dims", lambda t: t[:, 5].mul_(1.5)),
    "keypoint": _field("keypoints", lambda t: t[:, 7, 1].mul_(1.5)),
    "plane": _field("keyplanes", lambda t: t[:, 9, 0, 3].add_(0.1)),
    "residual": _field("residuals", lambda t: t[:, 2].add_(0.05)),
    "pose": _field("angles", lambda t: t[:, 4].mul_(-1.0)),
}
