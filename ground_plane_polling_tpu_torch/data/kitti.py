"""KITTI host IO: images, calibration, the resize rule, the 20-field
modified labels and the prepared-split dataset (copies of
ground_plane_polling_tpu/data/kitti.py and the calibration reader of
label_prep.py)."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .planes import load_plane_database

__all__ = ["BGR_MEAN", "KITTI_CLASSES", "IGNORE_TYPES", "KittiDataset",
           "parse_modified_label", "read_image_bgr", "preprocess_image",
           "resize_scale", "read_calibration"]

# class name -> label id: Car and Van are one class, other types are
# skipped, DontCare and Misc are ignore regions
KITTI_CLASSES: Dict[str, int] = {
    "Car": 0,
    "Van": 0,
}
IGNORE_TYPES = ("DontCare", "Misc")

_LABEL_FIELDS = 20

# caffe-style BGR channel means
BGR_MEAN = np.array([103.939, 116.779, 123.68], dtype=np.float32)


def read_image_bgr(path: str) -> np.ndarray:
    """Read an image as uint8 BGR. PNGs decode through cv2 when it is
    installed (lossless, so bit-identical to PIL); everything else, and PNGs
    without cv2, through PIL."""
    if path.lower().endswith(".png"):
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            bgr = cv2.imread(path, cv2.IMREAD_COLOR)
            if bgr is not None:
                return bgr
    from PIL import Image

    rgb = np.asarray(Image.open(path).convert("RGB"))
    return rgb[:, :, ::-1].copy()


def preprocess_image(image: np.ndarray) -> np.ndarray:
    """Subtract the caffe BGR means (image must already be BGR)."""
    return image.astype(np.float32) - BGR_MEAN


def resize_scale(shape: Tuple[int, int], min_side: int = 800,
                 max_side: int = 1333) -> float:
    """Scale factor so min side == min_side, capped so max side <= max_side."""
    smallest, largest = min(shape[:2]), max(shape[:2])
    scale = min_side / smallest
    if largest * scale > max_side:
        scale = max_side / largest
    return scale


def read_calibration(path: str, cam: int = 2) -> np.ndarray:
    """Read the (3, 4) projection matrix for camera `cam` (default P2)."""
    with open(path) as f:
        for line in f:
            if line.startswith(f"P{cam}:"):
                vals = [float(x) for x in line.split(":", 1)[1].split()]
                return np.array(vals).reshape(3, 4)
    # devkit files without key prefixes: row index
    with open(path) as f:
        line = f.readlines()[cam]
    vals = [float(x) for x in line.split(":", 1)[-1].split()]
    return np.array(vals).reshape(3, 4)


def parse_modified_label(path: str):
    """Parse a 20-field modified label file.

    Returns (annotations (N, 17), ignore_boxes (M, 4)):
      annotations: x1 y1 x2 y2 xl yl xm ym xr yr xt yt h w l class orient.
    """
    anns, ignores = [], []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) != _LABEL_FIELDS:
                continue
            typ = p[0]
            vals = [float(x) for x in p[1:]]
            # fields after type: trunc occ alpha x1 y1 x2 y2 kp*8 h w l cls
            box = vals[3:7]
            if typ in IGNORE_TYPES:
                ignores.append(box)
                continue
            if typ not in KITTI_CLASSES:
                continue
            anns.append(box + vals[7:15] + vals[15:18]
                        + [KITTI_CLASSES[typ], vals[18]])
    anns = np.array(anns, np.float32).reshape(-1, 17)
    ignores = np.array(ignores, np.float32).reshape(-1, 4)
    return anns, ignores


class KittiDataset:
    """Indexable view over a prepared KITTI split directory.

    Layout (what the JAX package's prepare-data writes):
      base_dir/{subset}/images/*.png
      base_dir/{subset}/labels/*.txt   (20-field modified labels)
      base_dir/{subset}/calibs/*.txt
      base_dir/road_planes_database.mat
    """

    def __init__(self, base_dir: str, subset: str = "train",
                 classes: Optional[Dict[str, int]] = None,
                 plane_db_path: Optional[str] = None):
        self.base_dir = base_dir
        self.subset = subset
        self.classes = dict(classes or KITTI_CLASSES)

        image_dir = os.path.join(base_dir, subset, "images")
        # case-insensitive extensions, as prepare-data accepts them
        names = sorted(f for f in os.listdir(image_dir)
                       if f.lower().endswith((".png", ".jpg")))
        self.image_paths: List[str] = [
            os.path.join(image_dir, f) for f in names]
        label_dir = os.path.join(base_dir, subset, "labels")
        calib_dir = os.path.join(base_dir, subset, "calibs")
        stems = [os.path.splitext(f)[0] for f in names]
        self.label_paths = [os.path.join(label_dir, s + ".txt")
                            for s in stems]
        self.calib_paths = [os.path.join(calib_dir, s + ".txt")
                            for s in stems]

        db = plane_db_path or os.path.join(base_dir, "road_planes_database.mat")
        self.planes = (load_plane_database(db) if os.path.exists(db)
                       else np.zeros((0, 4), np.float32))

    def __len__(self) -> int:
        return len(self.image_paths)

    @property
    def num_classes(self) -> int:
        return max(self.classes.values()) + 1

    def load_image(self, i: int) -> np.ndarray:
        return read_image_bgr(self.image_paths[i])

    def load_annotations(self, i: int):
        return parse_modified_label(self.label_paths[i])

    def load_calibration(self, i: int) -> np.ndarray:
        return read_calibration(self.calib_paths[i])

    def aspect_ratio(self, i: int) -> float:
        from PIL import Image

        with Image.open(self.image_paths[i]) as im:
            return im.width / im.height
