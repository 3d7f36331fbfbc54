"""Headless visualization on PIL and numpy (port of
ground_plane_polling_tpu/utils/visualization.py, pixel for pixel): 2D
boxes, keypoint glyphs, dashed-edge 3D wireframes, annotations, anchors.

The Keras reference's drawing functions, on PIL ImageDraw so that they run
with no display and no OpenCV. Images are numpy BGR uint8 arrays
throughout; drawing works on a PIL copy and returns the numpy result. One
difference: `draw_box` orders a box's corners, so that a box with x2 < x1
or y2 < y1 (an untrained detector's) is drawn where the JAX package's
raises under PIL 9.5 and later.
"""

from __future__ import annotations

import numpy as np

from ..ops.pose import corners_from_pose, matrix_from_rodrigues_np
from .colors import label_color

__all__ = [
    "draw_box", "draw_boxes", "draw_caption", "draw_dashed_line",
    "draw_detections", "draw_detections_with_keypoints",
    "draw_3d_detections", "draw_3d_detections_from_pose",
    "draw_annotations", "draw_annotations_with_keypoints", "draw_anchors",
]

ORIENTATION_COLORS = [(0, 0, 255), (0, 255, 0), (255, 0, 0), (0, 255, 255)]


def _to_pil(image):
    from PIL import Image

    return Image.fromarray(image[:, :, ::-1])  # BGR -> RGB


def _from_pil(pil):
    return np.asarray(pil)[:, :, ::-1].copy()


def _rgb(bgr):
    return (bgr[2], bgr[1], bgr[0])


def draw_box(draw, box, color, thickness=2):
    # corners in order: an untrained detector can put x2 left of x1, and
    # PIL (9.5 on) refuses such a rectangle where older PIL drew it
    x1, x2 = sorted((float(box[0]), float(box[2])))
    y1, y2 = sorted((float(box[1]), float(box[3])))
    draw.rectangle([x1, y1, x2, y2], outline=_rgb(color), width=thickness)


def draw_caption(draw, box, caption, color=(0, 0, 0)):
    draw.text((box[0], max(box[1] - 12, 0)), caption, fill=_rgb(color))


def draw_dashed_line(draw, p1, p2, color, dash=8, thickness=1):
    p1, p2 = np.asarray(p1, float), np.asarray(p2, float)
    length = float(np.linalg.norm(p2 - p1))
    if length < 1e-6:
        return
    n = max(int(length / dash), 1)
    direction = (p2 - p1) / length
    for i in range(0, n + 1, 2):
        a = p1 + direction * min(i * dash, length)
        b = p1 + direction * min((i + 1) * dash, length)
        draw.line([tuple(a), tuple(b)], fill=_rgb(color), width=thickness)


def _keypoint_glyphs(draw, kp, color):
    """l = circle, m = triangle, r = square, t = cross."""
    xl, yl, xm, ym, xr, yr, xt, yt = [float(v) for v in kp]
    r = 4
    draw.ellipse([xl - r, yl - r, xl + r, yl + r], outline=_rgb(color), width=2)
    draw.polygon([(xm, ym - r), (xm - r, ym + r), (xm + r, ym + r)],
                 outline=_rgb(color))
    draw.rectangle([xr - r, yr - r, xr + r, yr + r], outline=_rgb(color),
                   width=2)
    draw.line([(xt - r, yt), (xt + r, yt)], fill=_rgb(color), width=2)
    draw.line([(xt, yt - r), (xt, yt + r)], fill=_rgb(color), width=2)


def draw_detections(image, boxes, scores, labels, orientations,
                    score_threshold=0.4, label_to_name=None):
    """Plain 2D detection boxes + captions (reference
    utils/visualization.py:65-86), coloured by orientation."""
    from PIL import ImageDraw

    pil = _to_pil(image)
    draw = ImageDraw.Draw(pil)
    for i in range(len(scores)):
        if scores[i] < score_threshold:
            continue
        color = ORIENTATION_COLORS[int(orientations[i]) % 4]
        draw_box(draw, boxes[i, :4], color)
        name = (label_to_name(int(labels[i])) if label_to_name
                else str(int(labels[i])))
        draw_caption(draw, boxes[i, :4], f"{name} {scores[i]:.2f}", color)
    return _from_pil(pil)


def draw_detections_with_keypoints(image, boxes, scores, labels, orientations,
                                   score_threshold=0.4, label_to_name=None):
    """2D boxes coloured by orientation + keypoint glyphs + score captions."""
    from PIL import ImageDraw

    pil = _to_pil(image)
    draw = ImageDraw.Draw(pil)
    for i in range(len(scores)):
        if scores[i] < score_threshold:
            continue
        color = ORIENTATION_COLORS[int(orientations[i]) % 4]
        draw_box(draw, boxes[i, :4], color)
        _keypoint_glyphs(draw, boxes[i, 4:12], color)
        name = (label_to_name(int(labels[i])) if label_to_name
                else str(int(labels[i])))
        draw_caption(draw, boxes[i, :4], f"{name} {scores[i]:.2f}", color)
    return _from_pil(pil)


# 3D box wireframe edges between the canonical 8 corners
_EDGES_BOTTOM = [(0, 1), (1, 2), (2, 3), (3, 0)]
_EDGES_TOP = [(4, 5), (5, 6), (6, 7), (7, 4)]
_EDGES_VERT = [(0, 4), (1, 5), (2, 6), (3, 7)]


def draw_3d_detections_from_pose(image, boxes2d, orientations, residuals,
                                 scores, labels, locations, angles,
                                 dimensions, P, score_threshold=0.4,
                                 label_to_name=None):
    """Project each recovered 3D box into the image and draw the wireframe;
    hidden-ish (far-side) edges are dashed, colour by orientation."""
    from PIL import ImageDraw

    pil = _to_pil(image)
    draw = ImageDraw.Draw(pil)
    # vectorized host-side rotations: never dispatch per-row device ops
    # from a drawing loop (see matrix_from_rodrigues_np)
    Rs = matrix_from_rodrigues_np(np.asarray(angles)) if len(scores) else []
    for i in range(len(scores)):
        if scores[i] < score_threshold:
            continue
        corners = corners_from_pose(dimensions[i], Rs[i], locations[i])
        if (corners[2] < 0.1).any():
            continue
        hom = P @ np.vstack([corners, np.ones((1, 8))])
        pts = (hom[:2] / hom[2:3]).T  # (8, 2)

        color = ORIENTATION_COLORS[int(orientations[i]) % 4]
        depth = corners[2]
        far = depth > np.median(depth)
        for a, b in _EDGES_BOTTOM + _EDGES_TOP + _EDGES_VERT:
            if far[a] and far[b]:
                draw_dashed_line(draw, pts[a], pts[b], color, thickness=1)
            else:
                draw.line([tuple(pts[a]), tuple(pts[b])], fill=_rgb(color),
                          width=2)
        caption_box = [pts[:, 0].min(), pts[:, 1].min(), 0, 0]
        draw_caption(draw, caption_box,
                     f"r={float(residuals[i]):.2f}", color)
    return _from_pil(pil)


def draw_3d_detections(image, boxes2d, keypoints3d, residuals, scores,
                       labels, orientations, P, score_threshold=0.4,
                       label_to_name=None):
    """3D wireframes reconstructed directly from the 4 polled 3D keypoints
    (the reference's draw_3d_detections, utils/visualization.py:152-278).

    X_l, X_m, X_r are three bottom corners (the fourth is the
    parallelogram completion X_l + X_r - X_m) and X_t sits above X_m, so
    the vertical edge vector is X_t - X_m.
    """
    from PIL import ImageDraw

    pil = _to_pil(image)
    draw = ImageDraw.Draw(pil)
    kp = np.asarray(keypoints3d).reshape(-1, 4, 3)
    for i in range(len(scores)):
        if scores[i] < score_threshold:
            continue
        X_l, X_m, X_r, X_t = kp[i]
        bottom = np.stack([X_m, X_l, X_l + X_r - X_m, X_r])
        up = X_t - X_m
        corners = np.concatenate([bottom, bottom + up], axis=0).T  # (3, 8)
        if (corners[2] < 0.1).any():
            continue
        hom = P @ np.vstack([corners, np.ones((1, 8))])
        pts = (hom[:2] / hom[2:3]).T

        color = ORIENTATION_COLORS[int(orientations[i]) % 4]
        depth = corners[2]
        far = depth > np.median(depth)
        for a, b in _EDGES_BOTTOM + _EDGES_TOP + _EDGES_VERT:
            if far[a] and far[b]:
                draw_dashed_line(draw, pts[a], pts[b], color, thickness=1)
            else:
                draw.line([tuple(pts[a]), tuple(pts[b])], fill=_rgb(color),
                          width=2)
        draw_caption(draw, [pts[:, 0].min(), pts[:, 1].min(), 0, 0],
                     f"r={float(residuals[i]):.2f}", color)
    return _from_pil(pil)


def draw_boxes(image, boxes, color, thickness=1):
    """Plain (N, 4) boxes in one color (reference
    utils/visualization.py:54-62)."""
    from PIL import ImageDraw

    pil = _to_pil(image)
    draw = ImageDraw.Draw(pil)
    for b in boxes:
        draw_box(draw, b[:4], color, thickness=thickness)
    return _from_pil(pil)


def draw_annotations(image, annotations, color=(255, 255, 255),
                     label_to_name=None):
    """Ground-truth boxes + captions, no keypoint glyphs (reference
    utils/visualization.py:391-410). `annotations` is (N, 17); caption is
    '<label>; <height>' like the reference's."""
    from PIL import ImageDraw

    pil = _to_pil(image)
    draw = ImageDraw.Draw(pil)
    for a in annotations:
        label = int(a[15])
        c = color if color is not None else label_color(label)
        name = label_to_name(label) if label_to_name else label
        draw_box(draw, a[:4], c)
        draw_caption(draw, a[:4], f"{name}; {a[13]}", c)
    return _from_pil(pil)


def draw_annotations_with_keypoints(image, annotations, label_to_name=None):
    """Ground-truth boxes + keypoints, coloured by orientation class."""
    from PIL import ImageDraw

    pil = _to_pil(image)
    draw = ImageDraw.Draw(pil)
    for a in annotations:
        color = ORIENTATION_COLORS[int(a[16]) % 4]
        draw_box(draw, a[:4], color)
        _keypoint_glyphs(draw, a[4:12], color)
    return _from_pil(pil)


def draw_anchors(image, anchors, labels8c):
    """Positive anchors coloured by their orientation slot (debug view,
    reference utils/visualization.py:440-455)."""
    from PIL import ImageDraw

    pil = _to_pil(image)
    draw = ImageDraw.Draw(pil)
    pos = np.where(labels8c.max(axis=1) == 1)[0]
    for i in pos:
        slot = int(np.argmax(labels8c[i]))
        orient = slot % 4
        draw_box(draw, anchors[i], ORIENTATION_COLORS[orient], thickness=1)
    return _from_pil(pil)
