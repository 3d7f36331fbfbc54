"""The port's dataset debug viewer (bin/debug.py) against the JAX package's.

Without --random-transform both CLIs draw the same annotations (and, with
--anchors, the positive anchors of the same targets) on the same frames:
their PNGs are equal pixel for pixel, also after the training resize
(--resize, cv2 in both). With --random-transform the two draw from
different generators (the port: a torch.Generator seeded with 0, as its
bin/train), so the port is held to its own contract: the same PNGs on a
second run, each frame's annotations transformed (the drawing differs from
the untransformed one) and their box centres inside the canvas.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from ground_plane_polling_tpu.bin.debug import main as jax_debug
from ground_plane_polling_tpu_torch.bin import debug
from ground_plane_polling_tpu_torch.utils import visualization

from .fixtures import make_synthetic_kitti

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_kitti(str(tmp_path_factory.mktemp("kitti")),
                                n_images=3)


def _pngs(directory):
    return {n: np.asarray(Image.open(os.path.join(directory, n)))
            for n in sorted(os.listdir(directory))}


@pytest.mark.parametrize("flags", [[], ["--anchors"], ["--anchors",
                                                        "--resize"]],
                         ids=["annotations", "anchors", "anchors_resize"])
def test_pngs_equal_jax(root, tmp_path, flags):
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    debug.main(["--out", ours, *flags, "kitti", root])
    jax_debug(["--out", theirs, *flags, "kitti", root])
    got, want = _pngs(ours), _pngs(theirs)
    assert sorted(got) == sorted(want) == ["000000.png", "000001.png"]
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_random_transform_is_seeded_and_stays_on_the_canvas(root, tmp_path,
                                                            monkeypatch):
    seen = []
    real = visualization.draw_annotations_with_keypoints

    def spy(canvas, anns, *args, **kwargs):
        seen.append((canvas.shape[:2], np.array(anns)))
        return real(canvas, anns, *args, **kwargs)

    monkeypatch.setattr(visualization, "draw_annotations_with_keypoints",
                        spy)
    runs = []
    for name in ("a", "b"):
        out = str(tmp_path / name)
        debug.main(["--out", out, "--anchors", "--random-transform",
                    "kitti", root])
        runs.append(_pngs(out))
    plain = str(tmp_path / "plain")
    debug.main(["--out", plain, "--anchors", "kitti", root])
    assert sorted(runs[0]) == sorted(runs[1]) == ["000000.png", "000001.png"]
    for name, png in runs[0].items():
        np.testing.assert_array_equal(runs[1][name], png, err_msg=name)
        assert (png != _pngs(plain)[name]).any(), name
    assert len(seen) == 6
    for (h, w), anns in seen:
        assert len(anns) > 0
        cx, cy = (anns[:, 0] + anns[:, 2]) / 2, (anns[:, 1] + anns[:, 3]) / 2
        assert ((0 <= cx) & (cx < w) & (0 <= cy) & (cy < h)).all(), anns
