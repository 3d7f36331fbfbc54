"""Both run_network CLIs on the synthetic KITTI fixture with one .npz (a JAX
ResNet-50 init whose classification out kernel is redrawn from N(0, 0.05)
with a zero bias, so detections pass 0.05) and its .json sidecar, float32,
64x224 canvas.

The KITTI txts must have equal row counts and types; the 2D box and score
fields agree to +-0.01 (the txt's 2-decimal rounding); the 3D fields use the
conditioning-aware tolerance of tests/test_e2e.py (untrained weights give
near-horizon rays, which back-project far away): |a - b| <= 0.5 + 2e-3 |b|
plus the rounding, and angles 2e-2 plus the rounding, modulo 2 pi.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from ground_plane_polling_tpu.bin.run_network import main as jax_run_network
from ground_plane_polling_tpu.models import build_detector
from ground_plane_polling_tpu.training.checkpoint import export_params
from ground_plane_polling_tpu_torch.bin.run_network import main as run_network

from .fixtures import make_synthetic_kitti

torch.set_num_threads(2)

ROUND = 0.01 + 1e-6  # one unit of the txt's last printed digit


@pytest.fixture(scope="module")
def cli_outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    root = make_synthetic_kitti(str(tmp / "kitti"), n_images=3)
    model = build_detector("resnet50")
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 64, 64, 3), jnp.float32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    out = variables["params"]["classification"]["cls_out"]
    out["kernel"] = np.random.RandomState(0).normal(
        0, 0.05, out["kernel"].shape).astype(np.float32)
    out["bias"] = np.zeros_like(out["bias"])
    weights = str(tmp / "model.npz")
    export_params(weights, variables)
    with open(weights + ".json", "w") as f:
        json.dump({"backbone": "resnet50", "num_classes": 1}, f)

    common = [weights, os.path.join(root, "train", "images"),
              os.path.join(root, "train", "calibs"),
              os.path.join(root, "road_planes_database.mat")]
    flags = ["--kitti", "--no-bf16", "--image-min-side", "64",
             "--image-max-side", "224"]
    runs = {"jax": (jax_run_network, []),
            "torch_b1": (run_network, ["--device", "cpu"]),
            "torch_b2": (run_network, ["--device", "cpu", "--batch", "2"])}
    outputs = {}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    try:
        for name, (fn, extra) in runs.items():
            odir = str(tmp / name)
            fn(common + [odir] + flags + extra)
            base = os.path.join(odir, "model", "outputs")
            outputs[name] = {
                n: (open(os.path.join(base, "kitti", n)).read().splitlines(),
                    scipy.io.loadmat(os.path.join(
                        base, "full", n.replace(".txt", ".mat"))))
                for n in sorted(os.listdir(os.path.join(base, "kitti")))}
    finally:  # --no-bf16 turns TF32 off process-wide
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    return outputs


def _fields(rows):
    return [r.split() for r in rows]


def test_same_frames_rows_and_types(cli_outputs):
    ref = cli_outputs["jax"]
    assert sorted(ref) == ["000000.txt", "000001.txt"]
    for name in ("torch_b1", "torch_b2"):
        assert sorted(cli_outputs[name]) == sorted(ref)
        for fn, (rows, _) in ref.items():
            got = cli_outputs[name][fn][0]
            assert len(rows) > 0
            assert len(got) == len(rows), (name, fn)
            assert [r[0] for r in _fields(got)] == [r[0] for r in
                                                    _fields(rows)]


def test_2d_boxes_and_scores_agree(cli_outputs):
    for fn, (rows, _) in cli_outputs["jax"].items():
        want = np.array([r[4:8] + r[15:16] for r in _fields(rows)], float)
        got = np.array([r[4:8] + r[15:16] for r in
                        _fields(cli_outputs["torch_b1"][fn][0])], float)
        np.testing.assert_allclose(got, want, rtol=0, atol=ROUND,
                                   err_msg=fn)


def _angle_gap(a, b):
    return np.abs((a - b + np.pi) % (2 * np.pi) - np.pi)


def test_3d_fields_agree(cli_outputs):
    for fn, (rows, _) in cli_outputs["jax"].items():
        want = np.array([r[8:15] + r[3:4] for r in _fields(rows)], float)
        got = np.array([r[8:15] + r[3:4] for r in
                        _fields(cli_outputs["torch_b1"][fn][0])], float)
        # h w l X Y Z: metres; ry, alpha: radians
        lin = np.abs(got[:, :6] - want[:, :6])
        assert (lin <= 0.5 + 2e-3 * np.abs(want[:, :6]) + ROUND).all(), fn
        assert (_angle_gap(got[:, 6:], want[:, 6:]) <= 2e-2 + ROUND).all(), fn


def test_mat_outputs_agree(cli_outputs):
    """The .mat dumps carry the unrounded values: labels equal, scores and
    2D boxes / keypoints tight, 3D fields conditioning-aware."""
    for fn, (_, want) in cli_outputs["jax"].items():
        got = cli_outputs["torch_b1"][fn][1]
        np.testing.assert_array_equal(got["labels"], want["labels"])
        for key, atol, rtol in (("scores", 1e-5, 0), ("boxes", 2e-3, 0),
                                ("keypoints", 2e-3, 0),
                                ("keyplanes", 1e-5, 1e-5),
                                ("residuals", 1e-3, 0), ("angles", 2e-2, 0),
                                ("keypoints3d", 0.5, 2e-3),
                                ("locations", 0.5, 2e-3),
                                ("dimensions", 0.5, 2e-3)):
            np.testing.assert_allclose(got[key], want[key], atol=atol,
                                       rtol=rtol, err_msg=f"{fn} {key}")


def test_port_batch_2_matches_batch_1(cli_outputs):
    """--batch 2 (one full bucket) writes what --batch 1 writes, within the
    tolerances of tests/test_e2e.py's batched-CLI test (batched convs sum
    in another order)."""
    for fn, (rows, m1) in cli_outputs["torch_b1"].items():
        rows2, m2 = cli_outputs["torch_b2"][fn]
        assert len(rows2) == len(rows), fn
        np.testing.assert_array_equal(m2["labels"], m1["labels"])
        np.testing.assert_allclose(m2["scores"], m1["scores"], atol=1e-6,
                                   rtol=0)
        for key, atol, rtol in (("boxes", 2e-3, 0), ("keypoints", 2e-3, 0),
                                ("residuals", 1e-3, 0), ("angles", 2e-2, 0),
                                ("keypoints3d", 0.5, 2e-3),
                                ("locations", 0.5, 2e-3),
                                ("dimensions", 0.5, 2e-3)):
            np.testing.assert_allclose(m2[key], m1[key], atol=atol,
                                       rtol=rtol, err_msg=f"{fn} {key}")


@pytest.mark.parametrize("flag,item", [("--int8", "A16"),
                                       ("--fuse-towers", "A11"),
                                       ("--save-images", "A10")])
def test_unported_flags_raise(tmp_path, flag, item):
    with pytest.raises(NotImplementedError, match=item):
        run_network(["m.npz", str(tmp_path), str(tmp_path), "p.mat",
                     str(tmp_path), flag])


def test_h5_weights_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="A10"):
        run_network(["m.h5", str(tmp_path), str(tmp_path), "p.mat",
                     str(tmp_path)])
