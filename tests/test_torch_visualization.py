"""The port's drawing functions (utils/visualization.py, utils/colors.py)
against the JAX package's, pixel for pixel, on seeded images and
detections: boxes, keypoint glyphs, captions, dashed 3D wireframes from
poses and from polled keypoints, annotations and anchors. The port's
pose helpers (ops/pose.py) feed the wireframes, so they are held here too.
"""

import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.utils import colors as jax_colors
from ground_plane_polling_tpu.utils import visualization as jax_vis
from ground_plane_polling_tpu_torch.utils import colors, visualization as vis

torch.set_num_threads(2)

H, W, N = 120, 360, 9
# KITTI's P2 at this canvas scale
P = np.array([[240.0, 0.0, 180.0, 10.0], [0.0, 240.0, 55.0, 0.5],
              [0.0, 0.0, 1.0, 0.005]])


def _scene(seed):
    rng = np.random.RandomState(seed)
    image = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    x1, y1 = rng.uniform(-10, W - 40, N), rng.uniform(-5, H - 30, N)
    x2, y2 = x1 + rng.uniform(5, 80, N), y1 + rng.uniform(5, 50, N)
    kp = np.stack([rng.uniform(x1, x2), rng.uniform(y1, y2)] * 4, axis=1)
    boxes = np.concatenate([np.stack([x1, y1, x2, y2], 1), kp], 1)
    return {
        "image": image,
        "boxes": boxes.astype(np.float32),
        "scores": rng.uniform(0.0, 1.0, N).astype(np.float32),
        "labels": rng.randint(0, 3, N),
        "orientations": rng.randint(0, 4, N),
        "residuals": rng.uniform(0, 2, N).astype(np.float32),
        "locations": np.stack([rng.uniform(-8, 8, N), rng.uniform(1, 2, N),
                               rng.uniform(-1, 40, N)], 1),
        "angles": rng.normal(0, 1.0, (N, 3)),
        "dims": rng.uniform([1.3, 1.5, 3.0], [1.9, 1.9, 5.0], (N, 3)),
        "keypoints3d": np.concatenate(
            [rng.uniform(-6, 6, (N, 4, 1)), rng.uniform(0.5, 2, (N, 4, 1)),
             rng.uniform(-1, 30, (N, 4, 1))], axis=2).reshape(N, 12),
    }


def _pair(name, *args, **kwargs):
    got = getattr(vis, name)(*args, **kwargs)
    want = getattr(jax_vis, name)(*args, **kwargs)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


SEEDS = [0, 1, 2]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("threshold", [0.0, 0.4])
def test_2d_detections_equal_jax(seed, threshold):
    s = _scene(seed)
    for name in ("draw_detections", "draw_detections_with_keypoints"):
        out = _pair(name, s["image"], s["boxes"], s["scores"], s["labels"],
                    s["orientations"], score_threshold=threshold,
                    label_to_name=lambda l: f"class{l}")
        assert (out != s["image"]).any()  # something was drawn


@pytest.mark.parametrize("seed", SEEDS)
def test_3d_from_pose_equals_jax(seed):
    s = _scene(seed)
    out = _pair("draw_3d_detections_from_pose", s["image"], s["boxes"][:, :4],
                s["orientations"], s["residuals"], s["scores"], s["labels"],
                s["locations"], s["angles"], s["dims"], P,
                score_threshold=0.2)
    assert (out != s["image"]).any()


@pytest.mark.parametrize("seed", SEEDS)
def test_3d_from_keypoints_equals_jax(seed):
    s = _scene(seed)
    out = _pair("draw_3d_detections", s["image"], s["boxes"][:, :4],
                s["keypoints3d"], s["residuals"], s["scores"], s["labels"],
                s["orientations"], P, score_threshold=0.2)
    assert (out != s["image"]).any()


@pytest.mark.parametrize("seed", SEEDS)
def test_annotations_boxes_and_anchors_equal_jax(seed):
    s = _scene(seed)
    rng = np.random.RandomState(seed + 10)
    anns = np.zeros((N, 17), np.float32)
    anns[:, :12] = s["boxes"]
    anns[:, 13] = rng.uniform(1, 2, N)
    anns[:, 15] = rng.randint(0, 3, N)
    anns[:, 16] = s["orientations"]
    _pair("draw_annotations", s["image"], anns, label_to_name=str)
    _pair("draw_annotations", s["image"], anns, color=None)
    _pair("draw_annotations_with_keypoints", s["image"], anns)
    _pair("draw_boxes", s["image"], s["boxes"], (10, 200, 30), thickness=2)
    labels8c = (rng.uniform(0, 1, (N, 8)) > 0.8).astype(np.float32)
    _pair("draw_anchors", s["image"], s["boxes"][:, :4], labels8c)


def test_inverted_box_is_drawn_ordered():
    """A box with x2 < x1 and y2 < y1: the JAX package's draw_box raises
    under PIL 9.5 and later; the port draws the box of its ordered corners,
    as JAX draws that ordered box."""
    s = _scene(5)
    boxes = s["boxes"].copy()
    boxes[:, [0, 2]] = boxes[:, [2, 0]]
    boxes[::2, [1, 3]] = boxes[::2, [3, 1]]
    got = vis.draw_detections_with_keypoints(
        s["image"], boxes, s["scores"], s["labels"], s["orientations"],
        score_threshold=0.0)
    with pytest.raises(ValueError):
        jax_vis.draw_detections_with_keypoints(
            s["image"], boxes, s["scores"], s["labels"], s["orientations"],
            score_threshold=0.0)
    # drawn as JAX draws the ordered boxes; the captions sit at (x1, y1),
    # the first corner as given, in both
    from PIL import Image, ImageDraw

    pil = Image.fromarray(s["image"][:, :, ::-1])
    draw = ImageDraw.Draw(pil)
    for i in range(N):
        color = jax_vis.ORIENTATION_COLORS[int(s["orientations"][i]) % 4]
        b = boxes[i, :4]
        jax_vis.draw_box(draw, [min(b[0], b[2]), min(b[1], b[3]),
                                max(b[0], b[2]), max(b[1], b[3])], color)
        jax_vis._keypoint_glyphs(draw, boxes[i, 4:12], color)
        jax_vis.draw_caption(draw, b, f"{int(s['labels'][i])} "
                             f"{s['scores'][i]:.2f}", color)
    np.testing.assert_array_equal(got, np.asarray(pil)[:, :, ::-1])


def test_empty_detections_leave_the_image():
    s = _scene(0)
    out = _pair("draw_3d_detections_from_pose", s["image"],
                np.zeros((0, 4)), np.zeros(0), np.zeros(0), np.zeros(0),
                np.zeros(0), np.zeros((0, 3)), np.zeros((0, 3)),
                np.zeros((0, 3)), P)
    np.testing.assert_array_equal(out, s["image"])


def test_colors_equal_jax():
    assert colors.COLORS == jax_colors.COLORS and len(colors.COLORS) == 80
    for label in (-1, 0, 7, 79, 80):
        assert colors.label_color(label) == jax_colors.label_color(label)


def test_composite_equals_jax_composite():
    """run_network's composite: 2D boxes and keypoints above the 3D boxes
    of the poses, 2H x W, from one frame's detections."""
    s = _scene(4)
    rows = []
    for m in (vis, jax_vis):
        top = m.draw_detections_with_keypoints(
            s["image"].copy(), s["boxes"], s["scores"], s["labels"],
            s["orientations"], score_threshold=0.4)
        bottom = m.draw_3d_detections_from_pose(
            s["image"].copy(), s["boxes"][:, :4], s["orientations"],
            s["residuals"], s["scores"], s["labels"], s["locations"],
            s["angles"], s["dims"], P, score_threshold=0.4)
        rows.append(np.vstack([top, bottom]))
    assert rows[0].shape == (2 * H, W, 3)
    np.testing.assert_array_equal(rows[0], rows[1])
