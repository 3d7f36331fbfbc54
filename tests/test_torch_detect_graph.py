"""The pieces of the port's captured detect call that the CPU can check,
against the JAX package on numpy-seeded inputs:

  * greedy NMS (the plain version, which kernels.nms_cuda takes on CPU
    tensors and holds its CUDA kernels against on the card) against JAX's
    `_greedy_nms` and `_greedy_nms_serial` on the crafted cases of
    kernels/nms_cases.py and at the main path's shapes: every slot equal
    (index, valid, score);
  * the filter's candidate sets going through one NMS call, stacked on the
    batch axis, with the JAX filter's detections (the filter tests' own
    tolerances, 1e-6);
  * the pose solve's closed-form nearest rotation against the SVD's
    U @ Vh: within atol 1e-5 of JAX where the frame is well conditioned,
    with R of det < 0, and within a bound from the conditioning where the
    frame is nearly singular (x nearly parallel to y); padded detections'
    rows equal JAX's;
  * make_detect_fn on the CPU: eager, `detect.eager` is the call itself,
    and both equal JAX's detect call within test_torch_detect.py's
    tolerances; no torch.linalg.svd on the path.

The captured call itself needs a card (tests/test_torch_gpu.py,
chip_smoke.py phase 13)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.inference import make_detect_fn as jax_detect_fn
from ground_plane_polling_tpu.ops.filtering import (
    _greedy_nms as jax_greedy_nms, _greedy_nms_serial as jax_greedy_serial,
    filter_detections_fused_batch as jax_filter)
from ground_plane_polling_tpu.ops.overlap import iou_matrix as jax_iou
from ground_plane_polling_tpu.ops.pose import solve_pose as jax_solve_pose
from ground_plane_polling_tpu_torch import inference
from ground_plane_polling_tpu_torch.kernels import nms_cases, nms_cuda
from ground_plane_polling_tpu_torch.models import load_weights
from ground_plane_polling_tpu_torch.ops import filtering, overlap
from ground_plane_polling_tpu_torch.ops.pose import (nearest_orthogonal,
                                                     rodrigues_from_matrix,
                                                     solve_pose)

from .test_polling import P_INV
from .test_torch_filtering import _raw
from .test_torch_model import (randomized_variables, shrunk_jax_model,
                               shrunk_torch_model)
from .test_torch_ops import _pose_case, _rot

torch.set_num_threads(2)

CASES = {c[0]: c[1:] for c in nms_cases.crafted_cases()}
F32_EPS = float(np.finfo(np.float32).eps)


def _jax_rows(fn, boxes, scores, max_out, thr):
    """JAX's single-set NMS over each row, stacked as numpy."""
    rows = [fn(jnp.asarray(b), jnp.asarray(s), max_out, thr)
            for b, s in zip(boxes, scores)]
    return [np.stack([np.asarray(r[i]) for r in rows]) for i in range(3)]


def _assert_nms_equal(got, want, label):
    for name, g, w in zip(("idx", "valid", "score"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{label} {name}")


def _port_nms(boxes, scores, max_out, thr):
    return [t.numpy() for t in nms_cuda.greedy_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), max_out, thr)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_greedy_nms_crafted_cases_match_jax(name):
    """Every slot of the port's NMS (the CPU path of the kernel's wrapper)
    equals JAX's fixpoint and JAX's serial loop, exactly."""
    boxes, scores, max_out, thr = CASES[name]
    got = _port_nms(boxes, scores, max_out, thr)
    _assert_nms_equal(got, _jax_rows(jax_greedy_nms, boxes, scores, max_out,
                                     thr), f"{name} fixpoint")
    _assert_nms_equal(got, _jax_rows(jax_greedy_serial, boxes, scores,
                                     max_out, thr), f"{name} serial")


@pytest.mark.parametrize("thr", [0.5, 0.3])
def test_iou_at_threshold_is_kept_and_an_ulp_above_is_not(thr):
    """The crafted pairs: IoU an ulp below and exactly at the threshold
    keep both boxes (the test is >), an ulp above drops the second; the
    port's IoU and JAX's equal the float32 emulation bit for bit."""
    boxes, scores, max_out, _ = CASES[f"iou_at_threshold_{thr}"]
    pairs = boxes[0].reshape(3, 2, 4)
    t = np.float32(thr)
    ious = [nms_cases.iou_f32(a, b) for a, b in pairs]
    assert ious[0] < t and ious[1] == t and ious[2] > t, ious
    for a, b in pairs:
        port = overlap.iou_matrix(torch.from_numpy(a[None]),
                                  torch.from_numpy(b[None])).item()
        want = np.asarray(jax_iou(a[None], b[None]))[0, 0]
        assert np.float32(port) == want == nms_cases.iou_f32(a, b)
    idx, valid, _ = _port_nms(boxes, scores, max_out, thr)
    assert idx[0][valid[0]].tolist() == [0, 1, 2, 3, 4]


def test_chain_needs_sixteen_rounds():
    """The suppression chain keeps every other box, which the fixpoint
    reaches only after one round per link."""
    boxes, scores, max_out, thr = CASES["chain_16"]
    idx, valid, _ = _port_nms(boxes, scores, max_out, thr)
    assert idx[0][valid[0]].tolist() == list(range(0, 32, 2))


@pytest.mark.parametrize("b", [1, 4])
def test_greedy_nms_main_path_shapes_match_jax(b):
    """K 1024 candidates in clusters, max_out 100, threshold 0.5: the main
    path's shapes at b1 and b4."""
    boxes, scores = nms_cases.random_case(np.random.RandomState(b), s=b,
                                          k=1024, n_valid=900)
    got = _port_nms(boxes, scores, 100, 0.5)
    assert got[1].sum(axis=1).min() > 10  # the clusters keep several
    _assert_nms_equal(got, _jax_rows(jax_greedy_nms, boxes, scores, 100,
                                     0.5), f"b{b}")


@pytest.mark.parametrize("class_specific", [True, False])
def test_filter_stacks_candidate_sets_into_one_nms_call(monkeypatch,
                                                        class_specific):
    """Two classes, orientation-specific: 8 (or 4) candidate sets a batch
    of 2 go through one NMS call of 16 (or 8) rows, and the detections
    equal the JAX filter's (labels and orientations exact, the rest
    within 1e-6, as tests/test_torch_filtering.py holds them)."""
    calls = []
    plain = nms_cuda.greedy_nms

    def counted(boxes4, scores, max_out, thr):
        calls.append(tuple(scores.shape))
        return plain(boxes4, scores, max_out, thr)

    monkeypatch.setattr(nms_cuda, "greedy_nms", counted)
    args = _raw(2, seed=3)
    kw = dict(num_classes=2, class_specific=class_specific,
              orientation_specific=True, pre_nms_top_k=128)
    got = filtering.filter_detections_fused_batch(
        *[torch.from_numpy(a) for a in args], **kw)
    sets = 8 if class_specific else 4
    assert calls == [(2 * sets, 128)]
    want = jax_filter(*args, **kw)
    for name in ("labels", "orientations"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    for name in ("boxes", "dims", "scores"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def _unit(a):
    return a / np.linalg.norm(a)


def _frames(rng, n, delta=None, flip=False):
    """n frames [x, y, +-(x cross y)] of unit x, y (float64): random, or at
    angle `delta` between x and y."""
    out = []
    for _ in range(n):
        x = _unit(rng.normal(size=3))
        if delta is None:
            y = _unit(rng.normal(size=3))
        else:
            p = _unit(np.cross(x, rng.normal(size=3)))
            y = np.cos(delta) * x + np.sin(delta) * p
        out.append(np.stack([x, y, (-1 if flip else 1) * np.cross(x, y)],
                            -1))
    return np.stack(out)


def _polar(R):
    U, _, Vt = np.linalg.svd(R)
    return U @ Vt


@pytest.mark.parametrize("flip", [False, True], ids=["det_pos", "det_neg"])
def test_nearest_orthogonal_matches_svd(flip):
    """Random frames, and frames with z = -(x cross y) (det R < 0, whose
    U @ Vh is a reflection): the closed form and JAX's float32 SVD within
    atol 1e-5 of each other and of the float64 SVD."""
    R = _frames(np.random.RandomState(11), 200, flip=flip)
    R32 = R.astype(np.float32)
    got = nearest_orthogonal(torch.from_numpy(R32)).numpy()
    U, _, Vt = jnp.linalg.svd(jnp.asarray(R32))
    jax_q = np.asarray(U @ Vt)
    np.testing.assert_allclose(got, jax_q, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, _polar(R), atol=1e-5, rtol=0)
    assert (np.sign(np.linalg.det(got)) == (-1 if flip else 1)).all()


@pytest.mark.parametrize("delta", [1e-2, 1e-3])
def test_nearest_orthogonal_nearly_singular(delta):
    """x and y at angle delta: R's two smallest singular values are about
    delta, so a float32 solve moves U @ Vh by up to about eps / delta.
    Both the closed form and JAX's SVD are held to the float64 U @ Vh
    within 4 eps / delta + 1e-6 (the closed form measured within about
    0.3 eps / delta, JAX's SVD 0.8 eps / delta)."""
    R = _frames(np.random.RandomState(12), 100, delta=delta)
    R32 = R.astype(np.float32)
    want = _polar(R)
    bound = 4 * F32_EPS / delta + 1e-6
    got = nearest_orthogonal(torch.from_numpy(R32)).numpy()
    U, _, Vt = jnp.linalg.svd(jnp.asarray(R32))
    for name, q in (("port", got), ("jax", np.asarray(U @ Vt))):
        err = np.abs(q - want).max()
        assert err <= bound, (name, err, bound)


@pytest.mark.parametrize("delta", [2e-3, 1e-2])
def test_solve_pose_nearly_singular_frame(delta):
    """Keypoints whose measured edge runs nearly along the height (x at
    `delta` rad of y), rotations 0.3 to 2.5 rad (away from pi, where the
    angle itself is float32-limited; test_torch_ops.py covers that):
    locations and dimensions within 1e-5 of JAX's, and the angles of both
    solves held to the Rodrigues vector of the float64 U @ Vh of the same
    keypoints' frame. The frame's axes come from differences of keypoints
    about |X_m| / h = 8 times larger than the box, so they carry about
    8 eps of rounding, which the nearest rotation amplifies by up to about
    1 / delta: the bound is 64 eps / delta + 1e-5 (both solves measured
    within 31 eps / delta)."""
    rng = np.random.RandomState(13)
    kps, orients = [], []
    for o in range(4):
        for _ in range(25):
            R0 = _rot(rng.normal(size=3), rng.uniform(0.3, 2.5))
            x = R0[:, 0]
            y = np.cos(delta) * x + np.sin(delta) * R0[:, 1]
            kps.append(_pose_case(np.stack([x, y, np.cross(x, y)], -1), o,
                                  rng))
            orients.append(o)
    kps = np.stack(kps)
    orients = np.array(orients, np.int32)
    dims = rng.uniform([1.3, 1.5, 3.5], [1.8, 2.0, 4.8],
                       (len(kps), 3)).astype(np.float32)
    want = jax_solve_pose(kps, orients, dims)
    got = solve_pose(torch.from_numpy(kps), torch.from_numpy(orients),
                     torch.from_numpy(dims))
    for field in ("locations", "dimensions"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   atol=1e-5, rtol=0, err_msg=field)
    # the float64 frame of the same float32 keypoints, and its U @ Vh
    k64 = kps.astype(np.float64)
    X_l, X_m, X_r, X_t = (k64[:, i] for i in range(4))
    X_sel = np.where(np.isin(orients, (1, 2))[:, None], X_r, X_l)
    s_x = np.array([1.0, 1.0, -1.0, -1.0])[orients][:, None]
    y = (X_m - X_t) / np.linalg.norm(X_m - X_t, axis=1, keepdims=True)
    x = s_x * (X_m - X_sel) / np.linalg.norm(X_m - X_sel, axis=1,
                                             keepdims=True)
    truth = rodrigues_from_matrix(torch.from_numpy(
        _polar(np.stack([x, y, np.cross(x, y)], -1)))).numpy()
    bound = 64 * F32_EPS / delta + 1e-5
    for name, vecs in (("port", got.angles.numpy()),
                       ("jax", np.asarray(want.angles))):
        err = np.abs(vecs - truth).max()
        assert err <= bound, (name, err, bound)


def _detect_both(weights_dir):
    """(JAX outputs, port eager-call outputs, port detect.eager outputs,
    the port's detect function) as dicts of numpy arrays, on
    test_torch_detect.py's shrunk weights and inputs, at score threshold
    0.25."""
    from ground_plane_polling_tpu.training.checkpoint import export_params

    from .test_torch_detect import CANVAS

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
    # a threshold that leaves some of the 100 slots of each image padded
    kw = dict(with_pose=True, device_preprocess=True, score_threshold=0.25)
    want = jax_detect_fn(jax_model, CANVAS, **kw)(
        variables, jnp.asarray(images), jnp.asarray(P_inv),
        jnp.asarray(planes))
    detect = inference.make_detect_fn(model, CANVAS, **kw)
    outs = [{k: v.numpy() for k, v in fn(images, P_inv, planes)._asdict()
             .items()} for fn in (detect, detect.eager)]
    return ({k: np.asarray(v) for k, v in want._asdict().items()},
            *outs, detect)


@pytest.fixture(scope="module")
def detected(tmp_path_factory):
    return _detect_both(tmp_path_factory.mktemp("w"))


def test_cpu_detect_is_eager(detected):
    """On the CPU make_detect_fn returns the eager call, and detect.eager
    is that call: both give the same outputs, bit for bit."""
    _, got, eager, detect = detected
    assert not isinstance(detect, inference.CapturedDetect)
    assert detect.eager is detect
    assert set(got) == set(eager)
    for key in got:
        np.testing.assert_array_equal(got[key], eager[key], err_msg=key)


@pytest.mark.parametrize("key,rtol,atol", [
    ("scores", 0, 1e-5), ("boxes", 1e-5, 1e-3), ("dims", 1e-5, 1e-4),
    ("keyplanes", 1e-5, 1e-5), ("residuals", 1e-3, 1e-3),
    ("keypoints", 1e-4, 1e-3), ("locations", 1e-4, 1e-3),
    ("pose_dims", 1e-4, 1e-3), ("angles", 0, 1e-3)])
def test_cpu_detect_eager_matches_jax(detected, key, rtol, atol):
    """detect.eager's valid rows against JAX's detect call, with
    test_torch_detect.py's tolerances."""
    want, _, eager, _ = detected
    valid = want["scores"] > 0
    assert valid.any()
    np.testing.assert_array_equal(eager["labels"], want["labels"])
    np.testing.assert_allclose(eager[key][valid], want[key][valid],
                               rtol=rtol, atol=atol, err_msg=key)


@pytest.mark.parametrize("key", ["angles", "pose_dims"])
def test_cpu_detect_padded_rows_pose_matches_jax(detected, key):
    """The padded detections' rows (label -1), whose frame is degenerate
    (all four keypoints one point): their angles and refined dimensions
    equal JAX's within atol 1e-5. (Their locations are the polled
    keypoint, which the polling of a padded row need not pick as JAX's
    does; the solve itself is held below on the same keypoints.)"""
    want, got, _, _ = detected
    padded = want["labels"] == -1
    assert padded.any() and (~padded).any()
    np.testing.assert_array_equal(got["labels"] == -1, padded)
    np.testing.assert_allclose(got[key][padded], want[key][padded],
                               atol=1e-5, rtol=0, err_msg=key)


def test_solve_pose_padded_rows_match_jax(detected):
    """solve_pose on JAX's outputs for the padded rows (keypoints,
    orientations -1 clamped to 0 as the detect call does, dims -1): every
    pose field within atol 1e-5 of JAX's solve."""
    want = detected[0]
    padded = want["labels"] == -1
    kps = want["keypoints"][padded]
    orients = np.clip(want["orientations"][padded], 0, None)
    dims = want["dims"][padded]
    jax_out = jax_solve_pose(kps, orients, dims)
    got = solve_pose(torch.from_numpy(kps), torch.from_numpy(orients),
                     torch.from_numpy(dims))
    for field, g, w in zip(got._fields, got, jax_out):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=field)


def test_detect_path_has_no_svd(monkeypatch):
    """The detect call, pose on, runs with torch.linalg.svd removed: the
    pose solve no longer takes it (on a card it synchronizes with the
    host)."""
    def refuse(*args, **kwargs):
        raise AssertionError("torch.linalg.svd on the detect path")

    monkeypatch.setattr(torch.linalg, "svd", refuse)
    kps = np.stack([_pose_case(_rot((0.2, 1.0, -0.1), 0.7), o,
                               np.random.RandomState(o)) for o in range(4)])
    out = solve_pose(torch.from_numpy(kps), torch.arange(4),
                     torch.ones(4, 3))
    assert torch.isfinite(out.angles).all()
    from .test_torch_detect import CANVAS

    detect = inference.make_detect_fn(shrunk_torch_model().eval(), CANVAS,
                                      with_pose=True, device="cpu")
    rng = np.random.RandomState(0)
    out = detect(rng.uniform(-100, 100, (1, *CANVAS, 3)).astype(np.float32),
                 P_INV[None].astype(np.float32),
                 np.array([[[0.0, 1.0, 0.0, -1.65]]], np.float32))
    assert out.angles.shape == (1, 100, 3)
