"""The port's anchor targets (ops/targets.py, ops/box_coder.py encode) and
the device half of the input pipeline (data/pipeline.py::prepare_batch,
without augmentation) against the JAX package's on the same seeded numpy
inputs. Labels, anchor states and masks must be equal; the 12 regression
targets and the dimension targets within atol 1e-5 (float32 division by the
anchor sizes, then by the std, in another order of operations)."""

import jax
import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.data.pipeline import _device_prepare
from ground_plane_polling_tpu.ops import box_coder as jax_box_coder
from ground_plane_polling_tpu.ops.targets import anchor_targets as jax_targets
from ground_plane_polling_tpu_torch.data.pipeline import prepare_batch
from ground_plane_polling_tpu_torch.ops import anchors as anchor_ops
from ground_plane_polling_tpu_torch.ops import box_coder
from ground_plane_polling_tpu_torch.ops.targets import (anchor_targets,
                                                        batched_anchor_targets)

torch.set_num_threads(2)

SHAPE = (64, 224)
ATOL = 1e-5


def _annotations(rng, n_real, g, num_classes=1, shape=SHAPE):
    """(g, 17) padded annotations with n_real boxes of 16-60 px inside the
    canvas, keypoints inside their box, and their mask."""
    ann = np.zeros((g, 17), np.float32)
    h, w = shape
    for i in range(n_real):
        bw, bh = rng.uniform(16, 60), rng.uniform(16, min(60, h - 2))
        x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
        x2, y2 = x1 + bw, y1 + bh
        kx = rng.uniform(x1, x2, 4)
        ky = rng.uniform(y1, y2, 4)
        ann[i, :4] = [x1, y1, x2, y2]
        ann[i, 4:12] = np.stack([kx, ky], 1).ravel()
        ann[i, 12:15] = rng.uniform([1.3, 1.5, 3.5], [1.9, 2.0, 5.0])
        ann[i, 15] = rng.randint(num_classes)
        ann[i, 16] = rng.randint(4)
    return ann, np.arange(g) < n_real


def _ignores(rng, n_real, m, shape=SHAPE):
    ig = np.zeros((m, 4), np.float32)
    h, w = shape
    for i in range(n_real):
        x1, y1 = rng.uniform(0, w - 30), rng.uniform(0, h - 20)
        ig[i] = [x1, y1, x1 + rng.uniform(10, 30), y1 + rng.uniform(8, 20)]
    return ig, np.arange(m) < n_real


def _jax(anchors, ann, am, ig, im, c):
    out = jax_targets(anchors, ann, am, ig, im, num_classes=c)
    return {k: np.asarray(v) for k, v in out.items()}


def _port(anchors, ann, am, ig, im, c):
    out = anchor_targets(*(torch.from_numpy(np.asarray(a)) for a in
                           (anchors, ann, am, ig, im)), num_classes=c)
    return {k: v.numpy() for k, v in out.items()}


def _assert_targets_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == want[key].dtype, key
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["regression"][..., 12],
                                  want["regression"][..., 12])
    np.testing.assert_array_equal(got["regression_dim"][..., 3],
                                  want["regression_dim"][..., 3])
    np.testing.assert_allclose(got["regression"][..., :12],
                               want["regression"][..., :12], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got["regression_dim"][..., :3],
                               want["regression_dim"][..., :3], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_annotations_and_ignores_match_jax(seed):
    rng = np.random.RandomState(seed)
    anchors = anchor_ops.anchors_for_shape(SHAPE)
    ann, am = _annotations(rng, 4, 6)
    ig, im = _ignores(rng, 2, 3)
    want = _jax(anchors, ann, am, ig, im, 1)
    # every state occurs: positives, negatives, ignored
    states = set(np.unique(want["regression"][:, 12]).tolist())
    assert states == {-1.0, 0.0, 1.0}
    _assert_targets_equal(_port(anchors, ann, am, ig, im, 1), want)


def test_zero_annotations_match_jax():
    """No annotation: every anchor takes the zero row, targets are
    encode(anchor, 0), and all anchors are negatives or ignored."""
    rng = np.random.RandomState(3)
    anchors = anchor_ops.anchors_for_shape(SHAPE)
    ann, am = np.zeros((5, 17), np.float32), np.zeros(5, bool)
    ig, im = _ignores(rng, 1, 2)
    got = _port(anchors, ann, am, ig, im, 1)
    _assert_targets_equal(got, _jax(anchors, ann, am, ig, im, 1))
    assert set(np.unique(got["regression"][:, 12]).tolist()) == {-1.0, 0.0}
    want12, _ = box_coder.encode_boxes(torch.from_numpy(anchors),
                                       torch.zeros(len(anchors), 12))
    np.testing.assert_allclose(got["regression"][:, :12], want12.numpy(),
                               rtol=0, atol=ATOL)


def test_two_classes_match_jax():
    rng = np.random.RandomState(4)
    anchors = anchor_ops.anchors_for_shape(SHAPE)
    ann, am = _annotations(rng, 5, 7, num_classes=2)
    ann[0, 15], ann[1, 15] = 0, 1
    ig, im = _ignores(rng, 1, 2)
    got = _port(anchors, ann, am, ig, im, 2)
    assert got["labels"].shape == (len(anchors), 16)
    assert got["regression_dim"].shape == (2 * len(anchors), 4)
    _assert_targets_equal(got, _jax(anchors, ann, am, ig, im, 2))


def test_on_centre_xm_gives_half_in_both_sign_halves():
    """An annotation equal to an anchor box with xm exactly on its centre:
    sign (0 + 1) / 2 = 0.5, so both label halves of that anchor carry 0.5."""
    anchors = anchor_ops.anchors_for_shape(SHAPE)
    k = 1000
    a = anchors[k]
    ann, am = np.zeros((3, 17), np.float32), np.arange(3) < 1
    ann[0, :4] = a
    cx = (a[0] + a[2]) / np.float32(2.0)
    ann[0, 4:12] = [a[0], a[3], cx, a[3], a[2], a[3], a[0] + 1.0, a[1]]
    ann[0, 12:15] = [1.5, 1.6, 4.0]
    ann[0, 16] = 2
    ig, im = np.zeros((1, 4), np.float32), np.zeros(1, bool)
    got = _port(anchors, ann, am, ig, im, 1)
    _assert_targets_equal(got, _jax(anchors, ann, am, ig, im, 1))
    np.testing.assert_array_equal(got["labels"][k], [0, 0, 0.5, 0,
                                                     0, 0, 0.5, 0])
    _, sign = jax_box_coder.encode_boxes(anchors[k], ann[0, :12])
    assert float(sign) == 0.5


def test_encode_matches_jax():
    rng = np.random.RandomState(5)
    anchors = anchor_ops.anchors_for_shape(SHAPE)[::7]
    gt = rng.uniform(-20, 240, (len(anchors), 12)).astype(np.float32)
    t, s = box_coder.encode_boxes(torch.from_numpy(anchors),
                                  torch.from_numpy(gt))
    jt, js = jax_box_coder.encode_boxes(anchors, gt)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    dims = rng.uniform(1, 5, (9, 6)).astype(np.float32)
    mean, std = np.tile(box_coder.DIM_MEAN, 2), np.tile(box_coder.DIM_STD, 2)
    np.testing.assert_allclose(
        box_coder.encode_dims(torch.from_numpy(dims), mean, std).numpy(),
        np.asarray(jax_box_coder.encode_dims(dims, mean, std)), rtol=0,
        atol=ATOL)


def test_batched_equals_per_image():
    rng = np.random.RandomState(6)
    anchors = torch.from_numpy(anchor_ops.anchors_for_shape(SHAPE))
    per = [(_annotations(rng, n, 4), _ignores(rng, 1, 2)) for n in (3, 0)]
    batched = batched_anchor_targets(
        anchors, *(torch.from_numpy(np.stack(x)) for x in
                   ([p[0][0] for p in per], [p[0][1] for p in per],
                    [p[1][0] for p in per], [p[1][1] for p in per])))
    for i, ((ann, am), (ig, im)) in enumerate(per):
        one = anchor_targets(anchors, *(torch.from_numpy(x) for x in
                                        (ann, am, ig, im)))
        for key in one:
            assert torch.equal(batched[key][i], one[key]), key


def test_prepare_batch_filler_rows_match_jax():
    """The device half of the pipeline without augmentation: cast, mean
    subtraction and targets, with a short last group's filler row forced
    to state -1 in all three targets."""
    rng = np.random.RandomState(7)
    b = 2
    images = rng.randint(0, 256, (b, *SHAPE, 3)).astype(np.uint8)
    anns, ams = zip(*(_annotations(rng, 3, 5) for _ in range(b)))
    igs, ims = zip(*(_ignores(rng, 1, 2) for _ in range(b)))
    raw = {"images": images, "annotations": np.stack(anns),
           "ann_mask": np.stack(ams), "ignores": np.stack(igs),
           "ignore_mask": np.stack(ims), "valid": np.array([True, False]),
           "sizes": np.tile(np.asarray(SHAPE, np.float32), (b, 1))}
    want = _device_prepare(
        jax.random.PRNGKey(0), raw["images"], raw["annotations"],
        raw["ann_mask"], raw["ignores"], raw["ignore_mask"], raw["valid"],
        raw["sizes"], num_classes=1, do_augment=False, config=None,
        image_shape=SHAPE)
    got = prepare_batch({k: torch.from_numpy(v) for k, v in raw.items()},
                        num_classes=1, augment=False, device="cpu")
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    np.testing.assert_array_equal(got["image"], want["image"])
    _assert_targets_equal({k: got[k] for k in ("labels", "regression",
                                               "regression_dim")},
                          {k: want[k] for k in ("labels", "regression",
                                                "regression_dim")})
    assert (got["labels"][1] == -1).all()
    assert (got["regression"][1, :, 12] == -1).all()
    assert (got["regression_dim"][1, :, 3] == -1).all()
    assert (got["regression"][0, :, 12] == 1).any()
