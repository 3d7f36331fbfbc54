"""The port's convert_model (.npz -> .npz + .json) against the JAX package's:
the sidecar describes the weights (num_classes from the head widths, the
backbone and filter flags from the input's sidecar unless a flag is given,
a contradicting --num-classes raises), and the arrays pass through
unchanged, so the JAX package loads the converted file with equal outputs.

Inputs are small: a shrunk two-class detector (one block per ResNet stage,
64-channel FPN) exported by the port. Outputs of the JAX model on the
converted file and of the port model agree at test_torch_model.py's
rtol 1e-4 / atol 1e-4, the atol scaled by the largest output magnitude.
"""

import functools
import json

import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.bin.convert_model import main as jax_convert
from ground_plane_polling_tpu.models.resnet import ResNetBackbone as JaxResNet
from ground_plane_polling_tpu.models.retinanet import (
    GPPRetinaNet as JaxRetinaNet)
from ground_plane_polling_tpu.training.checkpoint import import_params
from ground_plane_polling_tpu_torch.bin.convert_model import main as convert
from ground_plane_polling_tpu_torch.models import (GPPRetinaNet,
                                                   export_jax_params,
                                                   init_detector,
                                                   load_weights)
from ground_plane_polling_tpu_torch.models.resnet import ResNetBackbone

torch.set_num_threads(2)

SHRUNK = (1, 1, 1, 1)
FEATURES = 64


def _torch_model(num_classes=2, fuse_cls_dim=False):
    return GPPRetinaNet(ResNetBackbone(SHRUNK), num_classes=num_classes,
                        feature_size=FEATURES, fuse_cls_dim=fuse_cls_dim)


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """A two-class shrunk export with a sidecar that names another
    backbone and a stale num_classes, and turns NMS off."""
    model = init_detector(_torch_model(), 0)
    with torch.no_grad():
        out = model.classification.cls_out
        out.weight.copy_(torch.randn(out.weight.shape,
                                     generator=torch.Generator()
                                     .manual_seed(0)) * 0.05)
    path = str(tmp_path_factory.mktemp("convert") / "src.npz")
    np.savez(path, **export_jax_params(model))
    with open(path + ".json", "w") as f:
        json.dump({"backbone": "resnet101", "num_classes": 1, "nms": False,
                   "orientation_specific_filter": True}, f)
    return path


def _sidecar(path):
    with open(path + ".json") as f:
        return json.load(f)


def test_sidecar_describes_the_weights(src, tmp_path):
    dst = str(tmp_path / "dst.npz")
    convert([src, dst])
    assert _sidecar(dst) == {
        "backbone": "resnet101",            # from the input sidecar
        "num_classes": 2,                   # weights outrank the stale 1
        "nms": False,                       # input sidecar kept
        "class_specific_filter": True,      # default
        "orientation_specific_filter": True,
    }


def test_flags_outrank_the_input_sidecar(src, tmp_path):
    dst = str(tmp_path / "dst.npz")
    convert([src, dst, "--nms", "--backbone", "resnet50",
             "--no-orientation-specific-filter",
             "--no-class-specific-filter", "--num-classes", "2"])
    assert _sidecar(dst) == {"backbone": "resnet50", "num_classes": 2,
                             "nms": True, "class_specific_filter": False,
                             "orientation_specific_filter": False}


def test_contradicting_num_classes_raises(src, tmp_path):
    with pytest.raises(ValueError, match="contradicts"):
        convert([src, str(tmp_path / "bad.npz"), "--num-classes", "3"])


@pytest.mark.parametrize("flags", [[], ["--no-nms"],
                                   ["--num-classes", "2",
                                    "--orientation-specific-filter"]],
                         ids=["defaults", "no_nms", "explicit"])
def test_output_equals_jax_convert(src, tmp_path, flags):
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    convert([src, ours] + flags)
    jax_convert([src, theirs] + flags)
    assert _sidecar(ours) == _sidecar(theirs)
    with np.load(ours) as a, np.load(theirs) as b, np.load(src) as s:
        assert sorted(a.files) == sorted(b.files) == sorted(s.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            np.testing.assert_array_equal(a[key], s[key], err_msg=key)


def test_converted_weights_load_into_jax_with_equal_outputs(src, tmp_path):
    dst = str(tmp_path / "dst.npz")
    convert([src, dst])
    images = np.random.RandomState(0).uniform(
        -128, 128, (1, 96, 128, 3)).astype(np.float32)
    jax_model = JaxRetinaNet(
        backbone_fn=functools.partial(JaxResNet, stage_sizes=SHRUNK,
                                      name="backbone"),
        num_classes=_sidecar(dst)["num_classes"], feature_size=FEATURES)
    want = jax_model.apply(import_params(dst), images)
    model = load_weights(_torch_model(_sidecar(dst)["num_classes"]),
                         dst).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(images).permute(0, 3, 1, 2))
    for key in ("regression", "regression_dim", "classification"):
        w = np.asarray(want[key])
        assert tuple(got[key].shape) == w.shape, key
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(w).max()),
                                   err_msg=key)


def test_fused_export_is_refused(tmp_path):
    """A fused-towers export has no classification head to infer the class
    count from."""
    path = str(tmp_path / "fused.npz")
    np.savez(path, **export_jax_params(
        init_detector(_torch_model(fuse_cls_dim=True), 0)))
    with pytest.raises(ValueError, match="cls_out"):
        convert([path, str(tmp_path / "out.npz")])


@pytest.mark.parametrize("argv,item", [
    (["in.h5", "out.npz"], "A10b"), (["in.npz", "out.h5"], "A10b"),
    (["snapshots/step_00000004", "out.npz"],
     r"JAX package's convert_model "
     r"\(ground_plane_polling_tpu/bin/convert_model\.py\) turns one into "
     r"an \.npz: convert_model snapshots/step_00000004 out\.npz;")],
    ids=["h5_in", "h5_out", "checkpoint_dir"])
def test_unported_routes_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        convert(argv)
