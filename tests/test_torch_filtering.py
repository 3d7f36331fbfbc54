"""The port's fused filter (threshold, pre-NMS top-k, candidate decode,
greedy NMS, top-k) against the JAX package's
`filter_detections_fused_batch` on the same raw head outputs. Labels and
orientations must be equal; boxes, dims and scores agree within 1e-6
(float32 decode arithmetic in two frameworks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.ops.filtering import (
    _greedy_nms_serial, filter_detections_fused_batch as jax_filter)
from ground_plane_polling_tpu_torch.ops import anchors
from ground_plane_polling_tpu_torch.ops.filtering import (
    filter_detections_fused_batch, greedy_nms)

torch.set_num_threads(2)

IMAGE = (128, 160)


def _raw(num_classes, seed=0, batch=2, quantize=None, n_high=None):
    """Raw head outputs for IMAGE: deltas, dims and sigmoid scores; with
    `n_high`, all scores are below 0.05 except at n_high random anchors."""
    rng = np.random.RandomState(seed)
    anc = anchors.anchors_for_shape(IMAGE)
    n = anc.shape[0]
    deltas = rng.normal(0, 0.5, (batch, n, 12)).astype(np.float32)
    dims = rng.normal(0, 1, (batch, n, 3 * num_classes)).astype(np.float32)
    cls = rng.uniform(0, 1, (batch, n, 8 * num_classes))
    if n_high is not None:
        high = rng.choice(n, n_high, replace=False)
        cls[:, :, :] *= 0.04
        cls[:, high] += 0.5
    if quantize:  # coarse scores: many exact ties
        cls = np.round(cls * quantize) / quantize
    return anc, deltas, dims, cls.astype(np.float32)


def _compare(args, **kw):
    want = jax_filter(*args, **kw)
    got = filter_detections_fused_batch(
        *[torch.from_numpy(a) for a in args], **kw)
    for name in ("labels", "orientations"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("boxes", "dims", "scores"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    return got


MODES = [(cs, os_) for cs in (True, False) for os_ in (False, True)]


@pytest.mark.parametrize("class_specific,orientation_specific", MODES)
@pytest.mark.parametrize("num_classes", [1, 2])
def test_filter_modes_match_jax(num_classes, class_specific,
                                orientation_specific):
    got = _compare(_raw(num_classes), num_classes=num_classes,
                   class_specific=class_specific,
                   orientation_specific=orientation_specific,
                   pre_nms_top_k=256)
    assert (got.scores.numpy() > 0).all()  # enough candidates for all 100


@pytest.mark.parametrize("num_classes", [1, 2])
def test_filter_without_nms_matches_jax(num_classes):
    _compare(_raw(num_classes, seed=1), num_classes=num_classes, nms=False,
             pre_nms_top_k=64, orientation_specific=True)


def test_filter_score_ties_match_jax():
    """Scores on a coarse grid tie massively; lax.top_k breaks ties by the
    lower index and the port's stable sort must do the same."""
    _compare(_raw(1, seed=2, quantize=8), num_classes=1, pre_nms_top_k=300)


def test_filter_fewer_candidates_than_max_detections():
    """Only a few anchors pass the threshold: the tail is padded with -1."""
    args = _raw(2, seed=3, n_high=12)
    got = _compare(args, num_classes=2, score_threshold=0.05,
                   class_specific=False)
    n_valid = (got.scores.numpy() > 0).sum(axis=1)
    assert (n_valid > 0).all() and (n_valid < 100).all(), n_valid
    assert (got.boxes.numpy()[got.scores.numpy() < 0] == -1).all()
    assert (got.labels.numpy()[got.scores.numpy() < 0] == -1).all()


def test_filter_pre_nms_top_k_larger_than_anchors():
    anc, deltas, dims, cls = _raw(1, seed=4)
    _compare((anc[:60], deltas[:, :60], dims[:, :60], cls[:, :60]),
             num_classes=1, pre_nms_top_k=1024)


def test_greedy_nms_matches_serial_oracle():
    """The fixpoint NMS keeps exactly what sequential greedy NMS keeps."""
    rng = np.random.RandomState(5)
    k = 200
    xy = rng.uniform(0, 60, (k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (k, 2))], 1)
    scores = np.sort(rng.uniform(0, 1, k))[::-1].copy()
    scores[150:] = -np.inf  # invalid tail
    boxes, scores = boxes.astype(np.float32), scores.astype(np.float32)
    idx, valid, sc = greedy_nms(torch.from_numpy(boxes)[None],
                                torch.from_numpy(scores)[None], 40, 0.5)
    ridx, rvalid, rsc = _greedy_nms_serial(jnp.asarray(boxes),
                                           jnp.asarray(scores), 40, 0.5)
    rvalid = np.asarray(rvalid)
    np.testing.assert_array_equal(valid[0].numpy(), rvalid)
    np.testing.assert_array_equal(idx[0].numpy()[rvalid],
                                  np.asarray(ridx)[rvalid])
    np.testing.assert_array_equal(sc[0].numpy()[rvalid],
                                  np.asarray(rsc)[rvalid])


def test_filter_rejects_wrong_num_classes():
    with pytest.raises(ValueError, match="8\\*num_classes"):
        filter_detections_fused_batch(
            *[torch.from_numpy(a) for a in _raw(1)], num_classes=2)
