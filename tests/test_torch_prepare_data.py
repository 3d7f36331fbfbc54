"""The port's data preparation (data/label_prep.py, data/prepare_split.py,
bin/prepare_data.py) against the JAX package's, on the host: the same raw
KITTI tree through both CLIs gives the same output tree, byte for byte,
and the label rows of random objects are the same strings."""

import filecmp
import math
import os

import numpy as np
import pytest

from ground_plane_polling_tpu.bin.prepare_data import main as jax_prepare
from ground_plane_polling_tpu.data import label_prep as jax_label_prep
from ground_plane_polling_tpu.data import prepare_split as jax_split
from ground_plane_polling_tpu_torch.bin.prepare_data import main as prepare
from ground_plane_polling_tpu_torch.data import label_prep, prepare_split

from .fixtures import P2, make_synthetic_kitti


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    """make_synthetic_kitti's raw labels and calibrations with its images
    under image_2 and a devkit mapping in which image i is line 4 - i:
    images 1 and 3 come from a validation drive (2011_09_26, id <= 15),
    0 and 2 from a training one."""
    tmp = tmp_path_factory.mktemp("prep")
    root = make_synthetic_kitti(str(tmp / "kitti"), n_images=4)
    images = tmp / "image_2"
    images.mkdir()
    for subset in ("train", "val"):
        d = os.path.join(root, subset, "images")
        for name in os.listdir(d):
            os.link(os.path.join(d, name), images / name)
    mapping = tmp / "devkit" / "mapping"
    mapping.mkdir(parents=True)
    lines, rand = [], []
    for i in range(4):
        drive = "0001" if i % 2 == 0 else "0093"
        lines.append(f"2011_09_26 2011_09_26_drive_{drive}_sync "
                     f"{7 * i:010d}")
        rand.append(str(4 - i))  # image i is line 4 - i of the mapping
    (mapping / "train_mapping.txt").write_text("\n".join(lines) + "\n")
    (mapping / "train_rand.txt").write_text(",".join(rand))
    return {"--label-dir": os.path.join(root, "_raw_labels"),
            "--calib-dir": os.path.join(root, "_raw_calibs"),
            "--image-dir": str(images), "--devkit-dir": str(tmp / "devkit"),
            "--plane-db": os.path.join(root, "road_planes_database.mat")}


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            out[os.path.relpath(path, root)] = path
    return out


@pytest.mark.parametrize("links", ["copies", "symlinks"])
def test_prepare_data_cli_matches_jax(raw_tree, tmp_path, links):
    argv = [a for k, v in raw_tree.items() for a in (k, v)]
    extra = ["--no-symlinks"] if links == "copies" else []
    want_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_prepare(argv + ["--output-dir", want_dir] + extra)
    counts = prepare(argv + ["--output-dir", got_dir] + extra)
    assert counts == {"train": 2, "val": 2}
    want, got = _tree(want_dir), _tree(got_dir)
    assert sorted(got) == sorted(want)
    assert "val/labels/000000000_000003.txt" in got
    assert "train/calibs/000000021_000000.txt" in got
    for rel in want:
        assert os.path.islink(got[rel]) == os.path.islink(want[rel]), rel
        if os.path.islink(want[rel]):
            assert os.readlink(got[rel]).replace(got_dir, want_dir) == \
                os.readlink(want[rel]), rel
        assert filecmp.cmp(got[rel], want[rel], shallow=False), rel


def test_modified_label_rows_match_jax():
    """Random objects in every alpha quadrant, some behind the camera:
    the same 20-field strings."""
    rng = np.random.RandomState(0)
    for _ in range(200):
        obj = dict(
            type=str(rng.choice(["Car", "Van", "Pedestrian"])),
            truncated=float(rng.uniform(0, 1)), occluded=int(rng.randint(3)),
            alpha=float(rng.uniform(-math.pi, math.pi)),
            box2d=rng.uniform(0, 1000, 4), dims=rng.uniform(0.5, 5, 3),
            location=np.array([rng.uniform(-20, 20), rng.uniform(1, 2),
                               rng.uniform(-3, 60)]),
            yaw=float(rng.uniform(-math.pi, math.pi)))
        want = jax_label_prep.modified_label_row(
            jax_label_prep.KittiObject(**obj), P2)
        got = label_prep.modified_label_row(label_prep.KittiObject(**obj),
                                            P2)
        assert got == want


def test_video_mapping_and_split_rule_match_jax(raw_tree):
    devkit = raw_tree["--devkit-dir"]
    got = prepare_split.image_to_video_mapping(devkit)
    assert got == jax_split.image_to_video_mapping(devkit)
    assert got[0] == ("2011_09_26_0093", 21)
    for name in ("2011_09_26_0015", "2011_09_26_0016", "2011_09_28_0001"):
        assert prepare_split._is_val_video(name) == \
            jax_split._is_val_video(name)
    with pytest.raises(ValueError):
        prepare_split._is_val_video("drive_0001")


def test_read_calibration_is_the_loaders(raw_tree):
    """label_prep reads calibrations with data/kitti.py's reader."""
    from ground_plane_polling_tpu_torch.data import kitti

    assert label_prep.read_calibration is kitti.read_calibration
    path = os.path.join(raw_tree["--calib-dir"], "000000.txt")
    np.testing.assert_array_equal(label_prep.read_calibration(path),
                                  jax_label_prep.read_calibration(path))
