"""Evaluation input pipeline (port of the eval mode of
ground_plane_polling_tpu/data/pipeline.py::KittiLoader).

Host side only: read BGR, resize by the min/max-side rule (cv2, else PIL;
`frames.resize_uint8`), pad into the image's padded-shape bucket as a uint8
canvas, and keep at most `max_annotations` annotations, scaled to it. The
detect function casts the canvas and subtracts the means on the device.
Grouping images of one bucket into batches is the caller's
(`training/loop.py::evaluate_model`).

Training batches (groups, ignore boxes, augmentation and target assignment
on the device) are ROADMAP A14; the native C++ loader is ROADMAP A10b.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from .frames import resize_uint8
from .kitti import KittiDataset, resize_scale

__all__ = ["KittiLoader"]


class KittiLoader:
    """Loader over a KittiDataset; `eval_inputs` yields per-image inference
    inputs."""

    def __init__(self, dataset: KittiDataset, image_min_side: int = 800,
                 image_max_side: int = 1333, pad_multiple: int = 32,
                 max_annotations: int = 32):
        from PIL import Image

        self.ds = dataset
        self.min_side = image_min_side
        self.max_side = image_max_side
        self.max_annotations = max_annotations

        # one padded shape per distinct (post-resize, pad-rounded) size
        self._bucket_shape = {}
        for i in range(len(dataset)):
            with Image.open(dataset.image_paths[i]) as im:
                hw = (im.height, im.width)
            scale = resize_scale(hw, image_min_side, image_max_side)
            self._bucket_shape[i] = tuple(
                int(np.ceil(s * scale / pad_multiple)) * pad_multiple
                for s in hw)

    def _load_padded(self, idx: int):
        """One frame: uint8 canvas of its bucket, its annotations scaled to
        it (at most max_annotations), and the scale."""
        anns, _ = self.ds.load_annotations(idx)
        h, w = self._bucket_shape[idx]
        image = self.ds.load_image(idx)
        scale = resize_scale(image.shape[:2], self.min_side, self.max_side)
        resized = resize_uint8(image, scale)
        padded = np.zeros((h, w, 3), np.uint8)
        padded[: resized.shape[0], : resized.shape[1]] = resized[:h, :w]
        anns = anns[:self.max_annotations].astype(np.float32)
        anns[:, :12] *= scale
        return padded, anns, scale

    def epoch(self, prefetch: int = 2):
        raise NotImplementedError(
            "training batches (augmentation, anchor targets): ROADMAP A14")

    def eval_inputs(self) -> Iterator[dict]:
        """Yield per-image inference inputs; `image` is the raw uint8 BGR
        canvas (1, H, W, 3) for a detect function with
        device_preprocess=True."""
        planes = self.ds.planes
        for i in range(len(self.ds)):
            padded, anns, scale = self._load_padded(i)
            P = self.ds.load_calibration(i)
            P_scaled = np.diag([scale, scale, 1.0]) @ P
            yield {
                "index": i,
                "scale": scale,
                "image": padded[None],
                "P_inv": np.linalg.pinv(P_scaled)[None].astype(np.float32),
                "planes": planes[None].astype(np.float32),
                "annotations": anns,
            }
