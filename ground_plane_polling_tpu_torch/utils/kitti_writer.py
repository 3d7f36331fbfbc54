"""KITTI-format result writing from recovered 6-DoF poses (numpy copy of
ground_plane_polling_tpu/utils/kitti_writer.py).

Reproduces the Keras reference's output math (bin/run_network.py:294-330):
  * rotate the canonical box corners by R (from the Rodrigues angle vector),
    translate by the location;
  * r_y = angles[1] wrapped via `% 2pi` then into [-pi, pi);
  * the reported 3D height is recomputed from the world-frame corner span,
    and the reported Y is the max corner Y (box bottom);
  * alpha = r_y + atan2(z, x) + 1.5pi, wrapped the same way;
  * 2D box clipped to the image.

Rows: type trunc occ alpha x1 y1 x2 y2 h w l X Y Z ry score with
trunc = occ = -1 like the reference.
"""

from __future__ import annotations

import numpy as np

from ..ops.pose import corners_from_pose, matrix_from_rodrigues_np

__all__ = ["wrap_angle", "kitti_rows", "write_kitti_file"]


def wrap_angle(a: float) -> float:
    """`a % 2pi`, then subtract 2pi if >= pi."""
    a = a % (2.0 * np.pi)
    if a >= np.pi:
        a -= 2.0 * np.pi
    return a


def kitti_rows(boxes, scores, locations, angles, dimensions, image_hw,
               class_name: str = "Car"):
    """Format detections as KITTI label lines.

    Args
      boxes:      (N, >=4) 2D boxes at raw-image scale.
      scores:     (N,)
      locations:  (N, 3) box bottom-centres (camera coords).
      angles:     (N, 3) Rodrigues rotation vectors.
      dimensions: (N, 3) (h, w, l).
      image_hw:   (height, width) of the raw image for box clipping.
    """
    # class_name: one string for every row (the reference's single-class
    # behaviour) or a per-detection sequence for multi-class models
    if isinstance(class_name, str):
        names = [class_name] * len(scores)
    else:
        names = list(class_name)
        if len(names) != len(scores):
            raise ValueError(
                f"class_name sequence length {len(names)} != "
                f"{len(scores)} detections")
    rows = []
    h_img, w_img = image_hw
    # all rotations in one vectorized numpy call
    Rs = matrix_from_rodrigues_np(np.asarray(angles)) if len(scores) else []
    for i in range(len(scores)):
        corners = corners_from_pose(dimensions[i], Rs[i], locations[i])

        r_y = wrap_angle(float(angles[i][1]))
        Y = float(np.max(corners[1]))
        h_out = Y - float(np.min(corners[1]))
        alpha = wrap_angle(
            r_y + np.arctan2(locations[i][2], locations[i][0]) + 1.5 * np.pi)

        rows.append(
            f"{names[i]} -1 -1 {alpha:.2f} "
            f"{max(boxes[i][0], 0.0):.2f} {max(boxes[i][1], 0.0):.2f} "
            f"{min(boxes[i][2], w_img):.2f} {min(boxes[i][3], h_img):.2f} "
            f"{h_out:.2f} {dimensions[i][1]:.2f} {dimensions[i][2]:.2f} "
            f"{locations[i][0]:.2f} {Y:.2f} {locations[i][2]:.2f} "
            f"{r_y:.2f} {scores[i]:.2f}"
        )
    return rows


def write_kitti_file(path, boxes, scores, locations, angles, dimensions,
                     image_hw, class_name: str = "Car"):
    rows = kitti_rows(boxes, scores, locations, angles, dimensions,
                      image_hw, class_name)
    with open(path, "w") as f:
        f.write("\n".join(rows) + ("\n" if rows else ""))
