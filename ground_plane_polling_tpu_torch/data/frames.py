"""Host frame preparation for inference (copy of the frame path of
ground_plane_polling_tpu/data/pipeline.py): read BGR, bilinear-resize to the
min/max side, pad into a uint8 canvas whose sides are multiples of 32, and
scale + invert the calibration. The detect function casts the canvas and
subtracts the means on the device.
"""

from __future__ import annotations

import numpy as np

from .kitti import read_calibration, read_image_bgr, resize_scale

__all__ = ["resize_uint8", "uint8_canvas", "prepare_network_frame"]


def resize_uint8(image: np.ndarray, scale: float) -> np.ndarray:
    """Bilinear resize of a uint8 image by a uniform factor, uint8 out.

    cv2.resize (INTER_LINEAR, the Keras reference's resize) when cv2 is
    installed, else PIL bilinear, as in the JAX package."""
    image = image.astype(np.uint8, copy=False)
    try:
        import cv2
    except ImportError:
        from PIL import Image

        h, w = image.shape[:2]
        out = Image.fromarray(image).resize(
            (int(round(w * scale)), int(round(h * scale))), Image.BILINEAR)
        return np.asarray(out)
    return cv2.resize(image, None, fx=scale, fy=scale)


def uint8_canvas(resized: np.ndarray, ph: int, pw: int) -> np.ndarray:
    """Pad a resized image into a (ph, pw, 3) uint8 canvas; float input is
    rounded and clipped first (a uint8 cast would wrap)."""
    canvas = np.zeros((ph, pw, 3), np.uint8)
    if resized.dtype == np.uint8:
        canvas[: resized.shape[0], : resized.shape[1]] = resized
    else:
        canvas[: resized.shape[0], : resized.shape[1]] = \
            np.rint(np.clip(resized, 0.0, 255.0)).astype(np.uint8)
    return canvas


def prepare_network_frame(image_path: str, calib_path: str,
                          min_side: int, max_side: int,
                          pad_multiple: int = 32) -> dict:
    """One frame: raw BGR, scale, padded uint8 canvas, P and P_inv of the
    scaled calibration (float32)."""
    raw = read_image_bgr(image_path)
    scale = resize_scale(raw.shape[:2], min_side, max_side)
    resized = resize_uint8(raw, scale)
    ph = int(np.ceil(resized.shape[0] / pad_multiple)) * pad_multiple
    pw = int(np.ceil(resized.shape[1] / pad_multiple)) * pad_multiple
    image = uint8_canvas(resized, ph, pw)
    P = read_calibration(calib_path)
    P_inv = np.linalg.pinv(np.diag([scale, scale, 1.0]) @ P)
    return {"raw": raw, "scale": scale, "image": image,
            "shape": (ph, pw), "P": P,
            "P_inv": P_inv.astype(np.float32)}
