"""KITTI modified-label generation (the port's own copy of
ground_plane_polling_tpu/data/label_prep.py, numpy on the host; the
reference did this in MATLAB).

For every object in a raw KITTI label file:
  * project the 8 corners of the 3D box into the image with P2;
  * objects with any corner closer than 0.1 m in depth become DontCare with
    sentinel keypoints (-10000) but keep their original 2D box;
  * otherwise the orientation class is the quadrant of the observation
    angle alpha (in degrees):
      [0, 90)    -> 0, keypoints (l, m, r) = corners (2, 1, 0), top = 5
      [90, 180)  -> 1, (1, 0, 3), top = 4
      [-90, 0)   -> 2, (3, 2, 1), top = 6
      [-180,-90) -> 3, (0, 3, 2), top = 7          (0-based corner ids)
    and the 2D box becomes the amodal min/max of the projected corners.

Corner convention: x = [l/2, l/2, -l/2, -l/2]*2, y = [0 x4, -h x4],
z = [w/2, -w/2, -w/2, w/2]*2, rotated by yaw and translated by the object
centre (bottom-centre at t).

Output rows have 20 space-separated fields:
  type truncated occluded alpha x1 y1 x2 y2 xl yl xm ym xr yr xt yt h w l cls
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List

import numpy as np

from .kitti import read_calibration

__all__ = ["KittiObject", "read_raw_labels", "read_calibration",
           "box3d_corners", "project_points", "modified_label_row",
           "create_modified_labels"]

SENTINEL = -10000.0
MIN_DEPTH = 0.1

# keypoint corner selection per orientation class (0-based corner indices):
# (left, middle, right, top)
_KP_IDS = {
    0: (2, 1, 0, 5),
    1: (1, 0, 3, 4),
    2: (3, 2, 1, 6),
    3: (0, 3, 2, 7),
}


@dataclasses.dataclass
class KittiObject:
    type: str
    truncated: float
    occluded: int
    alpha: float
    box2d: np.ndarray  # (4,) x1 y1 x2 y2
    dims: np.ndarray   # (3,) h w l
    location: np.ndarray  # (3,) bottom-centre in camera coords
    yaw: float


def read_raw_labels(path: str) -> List[KittiObject]:
    """Parse a standard 15-field KITTI label file."""
    objects = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) < 15:
                continue
            objects.append(KittiObject(
                type=p[0],
                truncated=float(p[1]),
                occluded=int(float(p[2])),
                alpha=float(p[3]),
                box2d=np.array([float(x) for x in p[4:8]]),
                dims=np.array([float(p[8]), float(p[9]), float(p[10])]),
                location=np.array([float(p[11]), float(p[12]), float(p[13])]),
                yaw=float(p[14]),
            ))
    return objects


def box3d_corners(obj: KittiObject) -> np.ndarray:
    """(3, 8) camera-coordinate corners of the object's 3D box."""
    h, w, l = obj.dims
    x = np.array([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2])
    y = np.array([0.0, 0, 0, 0, -h, -h, -h, -h])
    z = np.array([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2])
    c, s = math.cos(obj.yaw), math.sin(obj.yaw)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return R @ np.stack([x, y, z]) + obj.location[:, None]


def project_points(pts3: np.ndarray, P: np.ndarray) -> np.ndarray:
    """(3, N) camera points -> (2, N) pixels."""
    hom = P @ np.vstack([pts3, np.ones((1, pts3.shape[1]))])
    return hom[:2] / hom[2:3]


def modified_label_row(obj: KittiObject, P: np.ndarray) -> str:
    """One 20-field output row for an object."""
    corners3 = box3d_corners(obj)
    behind = bool((corners3[2] < MIN_DEPTH).any())

    if behind:
        typ, trunc, occ, alpha = "DontCare", -1.0, -1, -10.0
        cls = -1
        kp = [SENTINEL] * 8
        x1, y1, x2, y2 = obj.box2d
    else:
        typ, trunc, occ, alpha = obj.type, obj.truncated, obj.occluded, obj.alpha
        a_deg = math.degrees(obj.alpha)
        if 0 <= a_deg < 90:
            cls = 0
        elif 90 <= a_deg < 180:
            cls = 1
        elif -90 <= a_deg < 0:
            cls = 2
        else:  # [-180, -90)
            cls = 3
        c2 = project_points(corners3, P)
        il, im, ir, it = _KP_IDS[cls]
        kp = [c2[0, il], c2[1, il], c2[0, im], c2[1, im],
              c2[0, ir], c2[1, ir], c2[0, it], c2[1, it]]
        x1, y1 = c2[0].min(), c2[1].min()
        x2, y2 = c2[0].max(), c2[1].max()

    h, w, l = obj.dims
    nums = [trunc, occ, alpha, x1, y1, x2, y2, *kp, h, w, l]
    body = " ".join(f"{v:.6f}" if isinstance(v, float) else str(v)
                    for v in nums)
    return f"{typ} {body} {cls}"


def create_modified_labels(label_dir: str, calib_dir: str, out_dir: str,
                           cam: int = 2) -> int:
    """Process every label file; returns the number of files written."""
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for fn in sorted(os.listdir(label_dir)):
        if not fn.endswith(".txt"):
            continue
        P = read_calibration(os.path.join(calib_dir, fn), cam)
        objects = read_raw_labels(os.path.join(label_dir, fn))
        rows = [modified_label_row(o, P) for o in objects]
        with open(os.path.join(out_dir, fn), "w") as f:
            f.write("\n".join(rows) + ("\n" if rows else ""))
        count += 1
    return count
