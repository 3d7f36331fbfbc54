"""KITTI host IO: images, calibration and the resize rule (copies of the
functions of ground_plane_polling_tpu/data/kitti.py and label_prep.py that the
inference path uses)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["BGR_MEAN", "read_image_bgr", "preprocess_image", "resize_scale",
           "read_calibration"]

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
