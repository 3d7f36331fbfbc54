"""The whole inference slice in the port against the JAX package:
make_detect_fn(with_pose=True, device_preprocess=True) on the same shrunk
weights, uint8 images, P_inv and a 10-plane database, in float32; and a
stub-model scene whose raw head outputs decode to a known 3D box, where the
port must recover the true plane, keypoints and pose.

Tolerances: labels and orientations exact; scores 1e-5, boxes 1e-3 px and
the polled 3D fields rtol 1e-4 / atol 1e-3 (float32 trunks in two
frameworks; the observed gaps are about 50x smaller).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.inference import make_detect_fn as jax_detect_fn
from ground_plane_polling_tpu.ops.polling import normalize_planes
from ground_plane_polling_tpu_torch import inference
from ground_plane_polling_tpu_torch.models import load_weights

from .test_inference_pipeline import IMG, _build_scene_outputs, _planes
from .test_polling import P_INV
from .test_torch_model import (randomized_variables, shrunk_jax_model,
                               shrunk_torch_model)

torch.set_num_threads(2)

CANVAS = (96, 160)


def run_both(weights_dir):
    """(JAX outputs, port outputs) as dicts of numpy arrays."""
    from ground_plane_polling_tpu.training.checkpoint import export_params

    jax_model = shrunk_jax_model()
    variables = randomized_variables(jax_model, seed=1)
    path = str(weights_dir / "shrunk.npz")
    export_params(path, variables)
    model = load_weights(shrunk_torch_model(), path).eval()
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, *CANVAS, 3)).astype(np.uint8)
    P_inv = np.tile(P_INV[None], (2, 1, 1)).astype(np.float32)
    planes = np.stack([rng.uniform(-0.05, 0.05, 10), np.ones(10),
                       rng.uniform(-0.05, 0.05, 10),
                       rng.uniform(-2.2, -1.2, 10)], axis=1)
    planes = np.tile(planes[None], (2, 1, 1)).astype(np.float32)
    want = jax_detect_fn(jax_model, CANVAS, with_pose=True,
                         device_preprocess=True)(
        variables, jnp.asarray(images), jnp.asarray(P_inv),
        jnp.asarray(planes))
    got = inference.make_detect_fn(model, CANVAS, with_pose=True,
                                   device_preprocess=True)(
        images, P_inv, planes)
    return ({k: np.asarray(v) for k, v in want._asdict().items()},
            {k: v.numpy() for k, v in got._asdict().items()})


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("w"))


def test_detect_has_detections(both):
    want, got = both
    n_valid = (want["scores"] > 0).sum(axis=1)
    assert (n_valid > 0).all(), n_valid
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key


@pytest.mark.parametrize("key", ["labels", "orientations"])
def test_detect_discrete_fields_equal(both, key):
    want, got = both
    np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("key,rtol,atol", [
    ("scores", 0, 1e-5), ("boxes", 1e-5, 1e-3), ("dims", 1e-5, 1e-4),
    ("keyplanes", 1e-5, 1e-5), ("residuals", 1e-3, 1e-3),
    ("keypoints", 1e-4, 1e-3), ("locations", 1e-4, 1e-3),
    ("pose_dims", 1e-4, 1e-3), ("angles", 0, 1e-3)])
def test_detect_fields_match_jax(both, key, rtol, atol):
    want, got = both
    valid = want["scores"] > 0
    np.testing.assert_allclose(got[key][valid], want[key][valid], rtol=rtol,
                               atol=atol, err_msg=key)


class _StubModel(torch.nn.Module):
    """Returns crafted raw head outputs, whatever the image."""

    def __init__(self, outputs):
        super().__init__()
        self.outputs = {k: torch.from_numpy(np.array(v))
                        for k, v in outputs.items()}

    def forward(self, images):
        return self.outputs


def test_stub_scene_recovers_plane_keypoints_and_pose():
    outputs, gt12, dims_true, orientation, pts3 = _build_scene_outputs()
    detect = inference.make_detect_fn(_StubModel(outputs), IMG, with_pose=True,
                                      device="cpu")
    planes = _planes()
    out = detect(np.zeros((1, *IMG, 3), np.float32),
                 P_INV[None].astype(np.float32), planes[None])
    scores = out.scores[0].numpy()
    assert (scores > 0.9).sum() == 1 and scores[0] > 0.9
    np.testing.assert_allclose(out.boxes[0, 0].numpy(), gt12, rtol=1e-3,
                               atol=0.25)
    np.testing.assert_allclose(out.dims[0, 0].numpy(), dims_true, rtol=1e-4)
    assert int(out.orientations[0, 0]) == orientation
    np.testing.assert_allclose(out.keyplanes[0, 0, 0].numpy(),
                               np.asarray(normalize_planes(planes[1])),
                               atol=1e-5)
    np.testing.assert_allclose(out.keypoints[0, 0].numpy(), pts3, rtol=0.02,
                               atol=0.05)
    assert float(out.residuals[0, 0]) < 0.1
    want_loc = (pts3[1] + pts3[2]) / 2 - np.array([0, 0, dims_true[1] / 2])
    np.testing.assert_allclose(out.locations[0, 0].numpy(), want_loc,
                               rtol=0.05, atol=0.08)
    # orientation 1 on a level plane: the rotation is (near) identity
    np.testing.assert_allclose(out.angles[0, 0].numpy(), np.zeros(3),
                               atol=0.05)
    assert (scores[1:] == -1).all()
    assert (out.boxes[0, 1:].numpy() == -1).all()


@pytest.mark.parametrize("kwargs,error,match", [
    ({"shard_spatial": True, "fused_decode": False}, ValueError,
     "shard_spatial requires a mesh"),
    ({"mesh": "data", "shard_spatial": True}, TypeError,
     "mesh must come from data_parallel_mesh"),
    ({"mesh": "data"}, TypeError, "mesh must come from data_parallel_mesh")])
def test_detect_fn_unported_options_raise(kwargs, error, match):
    """Every option of JAX's make_detect_fn is ported (the unfused decode,
    tests/test_torch_unfused_decode.py; shard_spatial,
    tests/test_torch_spatial.py); what is refused is a mesh that is
    missing where shard_spatial needs one (as JAX refuses it) or is not a
    data_parallel_mesh."""
    with pytest.raises(error, match=match):
        inference.make_detect_fn(shrunk_torch_model(), CANVAS, device="cpu",
                                 **kwargs)


def test_gpp_detector_detect_image(tmp_path):
    """GPPDetector on one raw frame: resize, pad, rescaled calibration and
    boxes mapped back to raw pixels, as the JAX package's GPPDetector."""
    from ground_plane_polling_tpu.inference import GPPDetector as JaxDetector

    jax_det = JaxDetector(backbone="resnet50")
    jax_det.model = shrunk_jax_model()
    jax_det.variables = randomized_variables(jax_det.model, seed=2)
    from ground_plane_polling_tpu.training.checkpoint import export_params

    path = str(tmp_path / "w.npz")
    export_params(path, jax_det.variables)
    det = inference.GPPDetector(device="cpu")
    det.model = load_weights(shrunk_torch_model(), path).eval()
    det.ready = True
    rng = np.random.RandomState(3)
    raw = rng.randint(0, 256, (75, 250, 3)).astype(np.uint8)
    P = np.array([[200.0, 0, 125, 1.0], [0, 200.0, 37, 0.1], [0, 0, 1, 0.002]])
    planes = np.array([[0.0, 1.0, 0.0, -1.65], [0.01, 1.0, 0.0, -1.5]])
    kw = dict(min_side=96, max_side=320, score_threshold=0.05)
    want = jax_det.detect_image(raw, P, planes, **kw)
    got = det.detect_image(raw, P, planes, **kw)
    assert set(got) == set(want)
    assert len(want["scores"]) > 0
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("kwargs", [{}, {"device": "cuda"},
                                    {"device": "cuda:0"}])
def test_gpp_detector_defaults_to_the_card(monkeypatch, kwargs):
    """GPPDetector runs on the card unless asked for the CPU: without CUDA
    it raises rather than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference.GPPDetector(**kwargs)
    assert inference.GPPDetector(device="cpu").device == torch.device("cpu")
