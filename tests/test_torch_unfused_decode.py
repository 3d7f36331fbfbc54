"""The port's unfused decode (`make_detect_fn(fused_decode=False)`:
`decode_predictions`, then `filter_detections_batch` over every anchor)
against the JAX package's, and against the port's own fused path.

Tolerances:
  * decode_predictions: boxes within 1e-4 px and rtol 1e-6, dims within
    1e-6 (float32 decode arithmetic in two frameworks);
  * filter_detections_batch on the same decoded arrays: every field equal
    (the filter gathers, it computes nothing but IoUs and ranks);
  * greedy_nms against greedy_nms_serial: equal;
  * make_detect_fn on `tiny` against JAX's: labels and orientations
    equal, scores 1e-5, boxes rtol 1e-5 / atol 1e-3 px, the polled and
    pose fields those of tests/test_torch_detect.py (float32 trunks in two
    frameworks);
  * unfused against fused in the port: JAX's own bound between its two
    paths (tests/test_fused_filter.py): scores rtol 1e-6, boxes rtol 1e-4
    / atol 1e-3, dims rtol 1e-4 / atol 1e-4, labels and orientations
    equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.inference import (
    decode_predictions as jax_decode, make_detect_fn as jax_detect_fn)
from ground_plane_polling_tpu.models import build_detector as jax_build
from ground_plane_polling_tpu.ops.filtering import (
    filter_detections_batch as jax_filter_batch)
from ground_plane_polling_tpu.training.checkpoint import _flatten
from ground_plane_polling_tpu_torch import inference
from ground_plane_polling_tpu_torch.models import build_detector, load_state
from ground_plane_polling_tpu_torch.ops import anchors
from ground_plane_polling_tpu_torch.ops.filtering import (
    filter_detections, filter_detections_batch, greedy_nms,
    greedy_nms_serial)

from .test_polling import P_INV

torch.set_num_threads(2)

IMAGE = (128, 160)
MODES = [(cs, os_) for cs in (True, False) for os_ in (False, True)]
DETECT_CANVAS = (64, 128)
# the polled and pose fields: tests/test_torch_detect.py's tolerances
DETECT_TOLS = [("scores", 0, 1e-5), ("boxes", 1e-5, 1e-3),
               ("dims", 1e-5, 1e-4), ("keyplanes", 1e-5, 1e-5),
               ("residuals", 1e-3, 1e-3), ("keypoints", 1e-4, 1e-3),
               ("locations", 1e-4, 1e-3), ("pose_dims", 1e-4, 1e-3),
               ("angles", 0, 1e-3)]


def _raw(num_classes, seed=0, batch=2, quantize=None, strong=None):
    """Raw head outputs for IMAGE (deltas, dims, sigmoid scores); with
    `strong`, the scores are small except at `strong` anchors per image;
    with `quantize`, scores lie on a grid of that many steps (ties)."""
    rng = np.random.RandomState(seed)
    n = anchors.anchors_for_shape(IMAGE).shape[0]
    deltas = rng.normal(0, 0.5, (batch, n, 12)).astype(np.float32)
    dims = rng.normal(0, 1, (batch, n, 3 * num_classes)).astype(np.float32)
    cls = rng.uniform(0, 1, (batch, n, 8 * num_classes))
    if strong is not None:
        cls *= 0.04
        for b in range(batch):
            cls[b, rng.choice(n, strong, replace=False)] += 0.5
    if quantize:
        cls = np.round(cls * quantize) / quantize
    return {"regression": deltas, "regression_dim": dims,
            "classification": cls.astype(np.float32)}


def _decoded(raw, num_classes):
    """JAX's decode of every anchor, as numpy."""
    boxes, dims = jax_decode(raw, jnp.asarray(
        anchors.anchors_for_shape(IMAGE)), num_classes)
    return np.asarray(boxes), np.asarray(dims)


@pytest.mark.parametrize("num_classes,quantize", [(1, None), (2, None),
                                                  (1, 4)],
                         ids=["c1", "c2", "c1_tied_rows"])
def test_decode_predictions_matches_jax(num_classes, quantize):
    """Both sign halves occur; on a 4-step grid whole rows tie, and the
    first index of the argmax picks the side."""
    raw = _raw(num_classes, seed=3, quantize=quantize)
    want_boxes, want_dims = _decoded(raw, num_classes)
    got_boxes, got_dims = inference.decode_predictions(
        {k: torch.from_numpy(v) for k, v in raw.items()},
        torch.from_numpy(anchors.anchors_for_shape(IMAGE)), num_classes)
    assert got_boxes.shape == want_boxes.shape
    np.testing.assert_allclose(got_boxes.numpy(), want_boxes, rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(got_dims.numpy(), want_dims, rtol=0,
                               atol=1e-6)


def test_decode_predictions_refuses_wrong_width():
    raw = {k: torch.from_numpy(v) for k, v in _raw(2).items()}
    with pytest.raises(ValueError, match=r"classification width 16 != "
                       r"8\*num_classes \(8\) — wrong num_classes"):
        inference.decode_predictions(
            raw, torch.from_numpy(anchors.anchors_for_shape(IMAGE)), 1)


def _compare_filter(raw, num_classes, **kw):
    """The port's filter_detections_batch against JAX's on the same
    decoded boxes and dims: every field equal."""
    boxes, dims = _decoded(raw, num_classes)
    cls = raw["classification"]
    kw = dict(kw, num_classes=num_classes)
    want = jax_filter_batch(jnp.asarray(boxes), jnp.asarray(dims),
                            jnp.asarray(cls), **kw)
    got = filter_detections_batch(torch.from_numpy(boxes),
                                  torch.from_numpy(dims),
                                  torch.from_numpy(cls), **kw)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    return got


@pytest.mark.parametrize("nms", [True, False], ids=["nms", "no_nms"])
@pytest.mark.parametrize("class_specific,orientation_specific", MODES)
@pytest.mark.parametrize("num_classes", [1, 2])
def test_filter_batch_modes_match_jax(num_classes, class_specific,
                                      orientation_specific, nms):
    got = _compare_filter(_raw(num_classes, seed=1), num_classes,
                          class_specific=class_specific,
                          orientation_specific=orientation_specific,
                          nms=nms, pre_nms_top_k=256)
    assert (got.scores.numpy() > 0).all()  # enough candidates for all 100


@pytest.mark.parametrize("nms", [True, False], ids=["nms", "no_nms"])
def test_filter_batch_short_pool_matches_jax(nms):
    """A pool shorter than max_detections (one set of 16 candidates, or
    few above the threshold) is padded with -inf rows, output as -1."""
    got = _compare_filter(_raw(1, seed=4, strong=30), 1, nms=nms,
                          pre_nms_top_k=16)
    scores = got.scores.numpy()
    assert (scores[:, :16] > 0).any() and (scores[:, 16:] == -1).all()
    assert (got.labels.numpy()[:, 16:] == -1).all()


def test_filter_batch_score_ties_match_jax():
    """Scores on a coarse grid tie massively: the pre-NMS and pooled
    top-k break ties by the lower index, as lax.top_k does."""
    _compare_filter(_raw(2, seed=2, quantize=8), 2, pre_nms_top_k=300,
                    orientation_specific=True)


def test_filter_detections_is_one_image_of_the_batch():
    raw = _raw(1, seed=5)
    boxes, dims = (torch.from_numpy(a) for a in _decoded(raw, 1))
    cls = torch.from_numpy(raw["classification"])
    batch = filter_detections_batch(boxes, dims, cls, pre_nms_top_k=128)
    for b in range(2):
        one = filter_detections(boxes[b], dims[b], cls[b], pre_nms_top_k=128)
        for name in one._fields:
            assert torch.equal(getattr(one, name), getattr(batch, name)[b])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_nms_matches_serial_reference(seed):
    """The fixpoint NMS against the sequential loop on clustered boxes
    (long suppression chains), tied scores and -inf (invalid) rows."""
    rng = np.random.RandomState(seed)
    b, k = 3, 200
    centres = rng.uniform(0, 300, (b, 12, 2))[:, rng.randint(0, 12, k)]
    centres = centres + rng.normal(0, 6, (b, k, 2))
    half = rng.uniform(8, 30, (b, k, 2))
    boxes = np.concatenate([centres - half, centres + half], axis=-1)
    scores = np.round(rng.uniform(0, 1, (b, k)) * 20) / 20
    scores[rng.uniform(size=(b, k)) < 0.2] = -np.inf
    scores = -np.sort(-scores, axis=1)
    args = (torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(scores.astype(np.float32)), 50, 0.5)
    got, want = greedy_nms(*args), greedy_nms_serial(*args)
    for g, w, name in zip(got, want, ("idx", "valid", "score")):
        assert torch.equal(g, w), name
    assert got[1].sum() > 20  # chains ran, and most slots hold a box


# --- make_detect_fn on tiny ------------------------------------------------

def _tiny_weights(num_classes, seed=0):
    """JAX variables of the tiny detector (FPN 64) with a random
    classification out kernel (detections above 0.05), and the port's
    model carrying the same weights."""
    jax_model = jax_build("tiny", num_classes=num_classes)
    jax_model = jax_model.clone(feature_size=64)
    variables = jax.jit(jax_model.init)(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, *DETECT_CANVAS, 3), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    out = params["classification"]["cls_out"]
    out["kernel"] = np.random.RandomState(seed).normal(
        0, 0.05, out["kernel"].shape).astype(np.float32)
    variables = {"params": params,
                 "frozen": variables.get("frozen", {})}
    model = build_detector("tiny", num_classes, feature_size=64)
    load_state(model, _flatten(variables))
    return jax_model, variables, model.eval()


def _detect_inputs(b=2, n_planes=10, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (b, *DETECT_CANVAS, 3)).astype(np.uint8)
    P_inv = np.tile(P_INV[None], (b, 1, 1)).astype(np.float32)
    planes = np.stack([rng.uniform(-0.05, 0.05, n_planes),
                       np.ones(n_planes),
                       rng.uniform(-0.05, 0.05, n_planes),
                       rng.uniform(-2.2, -1.2, n_planes)], axis=1)
    planes = np.tile(planes[None], (b, 1, 1)).astype(np.float32)
    return images, P_inv, planes


@functools.lru_cache(maxsize=None)
def _tiny_c2():
    return _tiny_weights(2)


def _port_detect(model, **kw):
    images, P_inv, planes = _detect_inputs()
    out = inference.make_detect_fn(model, DETECT_CANVAS, num_classes=2,
                                   with_pose=True, device_preprocess=True,
                                   device="cpu", **kw)(images, P_inv, planes)
    return {k: v.numpy() for k, v in out._asdict().items()}


@pytest.mark.parametrize("class_specific,orientation_specific", MODES)
def test_unfused_detect_matches_jax(class_specific, orientation_specific):
    """make_detect_fn(fused_decode=False) on tiny (two classes), pose on,
    against JAX's unfused detect function on the same weights."""
    jax_model, variables, model = _tiny_c2()
    kw = dict(class_specific=class_specific,
              orientation_specific=orientation_specific)
    images, P_inv, planes = _detect_inputs()
    want = jax_detect_fn(jax_model, DETECT_CANVAS, num_classes=2,
                         with_pose=True, device_preprocess=True,
                         fused_decode=False, **kw)(
        variables, jnp.asarray(images), jnp.asarray(P_inv),
        jnp.asarray(planes))
    want = {k: np.asarray(v) for k, v in want._asdict().items()}
    got = _port_detect(model, fused_decode=False, **kw)
    assert set(got) == set(want)
    valid = want["scores"] > 0
    assert valid.sum(axis=1).min() > 0, valid.sum(axis=1)
    for key in ("labels", "orientations"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key, rtol, atol in DETECT_TOLS:
        np.testing.assert_allclose(got[key][valid], want[key][valid],
                                   rtol=rtol, atol=atol, err_msg=key)


@pytest.mark.parametrize("class_specific,orientation_specific", MODES)
def test_unfused_detect_equals_fused(class_specific, orientation_specific):
    _, _, model = _tiny_c2()
    kw = dict(class_specific=class_specific,
              orientation_specific=orientation_specific)
    fused = _port_detect(model, **kw)
    unfused = _port_detect(model, fused_decode=False, **kw)
    assert (fused["scores"] > 0).any(axis=1).all()
    for key in ("labels", "orientations"):
        np.testing.assert_array_equal(unfused[key], fused[key], err_msg=key)
    np.testing.assert_allclose(unfused["scores"], fused["scores"], rtol=1e-6)
    np.testing.assert_allclose(unfused["boxes"], fused["boxes"], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(unfused["dims"], fused["dims"], rtol=1e-4,
                               atol=1e-4)
