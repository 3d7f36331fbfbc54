"""The port's host-side IO against the JAX package's: image reading and
resizing, frame preparation, calibration, the plane database and the KITTI
writer must give identical results (same code paths on the same host
libraries)."""

import os

import numpy as np
import pytest
from PIL import Image

from ground_plane_polling_tpu.data import pipeline as jax_pipeline
from ground_plane_polling_tpu.data.kitti import (read_image_bgr as
                                                 jax_read_image,
                                                 resize_scale as
                                                 jax_resize_scale)
from ground_plane_polling_tpu.data.label_prep import (read_calibration as
                                                      jax_read_calibration)
from ground_plane_polling_tpu.data.planes import (load_plane_database as
                                                  jax_load_planes)
from ground_plane_polling_tpu.utils.kitti_writer import (kitti_rows as
                                                         jax_kitti_rows)
from ground_plane_polling_tpu_torch.data import frames, kitti, planes
from ground_plane_polling_tpu_torch.utils.kitti_writer import kitti_rows

from .fixtures import make_synthetic_kitti


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    return make_synthetic_kitti(str(tmp_path_factory.mktemp("kitti")),
                                n_images=2)


@pytest.mark.parametrize("ext", [".png", ".jpg"])
def test_read_image_bgr_equal(tmp_path, ext):
    rgb = np.random.RandomState(0).randint(0, 256, (37, 53, 3)).astype(
        np.uint8)
    path = str(tmp_path / f"x{ext}")
    Image.fromarray(rgb).save(path)
    got = kitti.read_image_bgr(path)
    np.testing.assert_array_equal(got, jax_read_image(path))
    if ext == ".png":  # lossless: the pixels come back, channels reversed
        np.testing.assert_array_equal(got, rgb[:, :, ::-1])


@pytest.mark.parametrize("scale", [0.5, 0.37, 1.0, 1.073])
def test_resize_uint8_equal(scale):
    img = np.random.RandomState(1).randint(0, 256, (75, 124, 3)).astype(
        np.uint8)
    got = frames.resize_uint8(img, scale)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(
        got, jax_pipeline._resize_image_uint8(img, scale))


def test_resize_scale_equal():
    for shape in ((375, 1242), (128, 416), (800, 600)):
        for lo, hi in ((800, 1333), (64, 224), (96, 320)):
            assert kitti.resize_scale(shape, lo, hi) == jax_resize_scale(
                shape, lo, hi)


def test_prepare_network_frame_equal(kitti_root):
    img_dir = os.path.join(kitti_root, "train", "images")
    cal_dir = os.path.join(kitti_root, "train", "calibs")
    name = sorted(os.listdir(img_dir))[0]
    args = (os.path.join(img_dir, name),
            os.path.join(cal_dir, name.replace(".png", ".txt")), 64, 224)
    got = frames.prepare_network_frame(*args)
    want = jax_pipeline.prepare_network_frame(*args)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
    assert got["image"].dtype == np.uint8 and got["image"].shape == (64, 224,
                                                                      3)


def test_uint8_canvas_rounds_and_clips():
    resized = np.array([[[-3.0, 12.4, 300.0]]], np.float32)
    got = frames.uint8_canvas(resized, 2, 3)
    np.testing.assert_array_equal(
        got, jax_pipeline.uint8_canvas(resized, 2, 3))
    assert got[0, 0].tolist() == [0, 12, 255]


def test_read_calibration_equal(kitti_root, tmp_path):
    cal_dir = os.path.join(kitti_root, "train", "calibs")
    path = os.path.join(cal_dir, sorted(os.listdir(cal_dir))[0])
    np.testing.assert_array_equal(kitti.read_calibration(path),
                                  jax_read_calibration(path))
    # devkit files without key prefixes are read by row index
    bare = tmp_path / "bare.txt"
    bare.write_text("\n".join(" ".join(str(float(i * 12 + j))
                                       for j in range(12))
                              for i in range(4)) + "\n")
    np.testing.assert_array_equal(kitti.read_calibration(str(bare)),
                                  jax_read_calibration(str(bare)))


def test_plane_database_equal(kitti_root, tmp_path):
    path = os.path.join(kitti_root, "road_planes_database.mat")
    got = planes.load_plane_database(path)
    np.testing.assert_array_equal(got, jax_load_planes(path))
    again = str(tmp_path / "again.mat")
    planes.save_plane_database(again, got)
    np.testing.assert_array_equal(jax_load_planes(again), got)
    bad = str(tmp_path / "bad.mat")
    planes.save_plane_database(bad, np.zeros((3, 5)))
    with pytest.raises(ValueError, match="N, 4"):
        planes.load_plane_database(bad)


def test_kitti_rows_equal():
    rng = np.random.RandomState(2)
    n = 12
    boxes = rng.uniform(-20, 1300, (n, 12))
    scores = rng.uniform(0, 1, n)
    locations = rng.uniform([-10, 1, 5], [10, 2, 60], (n, 3))
    angles = rng.normal(0, 1.5, (n, 3))
    dims = rng.uniform([1.3, 1.5, 3.5], [1.8, 2.0, 4.8], (n, 3))
    names = ["Car", "Van"] * (n // 2)
    for cls in ("Car", names):
        assert (kitti_rows(boxes, scores, locations, angles, dims,
                           (375, 1242), cls)
                == jax_kitti_rows(boxes, scores, locations, angles, dims,
                                  (375, 1242), cls))
