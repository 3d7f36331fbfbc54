"""Polling in the PyTorch port against the JAX package: the plain twin
(ops/polling.py) against `fit_road_planes` and against the Pallas kernel in
interpret mode, on random detections and on crafted edge cases of the fused
arg-min. On the card the same cases run through the CUDA kernel
(tests/test_torch_gpu.py and chip_smoke.py).

Tolerances are those of tests/test_polling_pallas.py: residuals 1e-4,
keyplanes rtol 1e-5 / atol 1e-6, keypoints 1e-3.
"""

import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.kernels.polling_pallas import (
    fit_road_planes_pallas)
from ground_plane_polling_tpu.ops.polling import (
    fit_road_planes as jax_fit, normalize_planes as jax_normalize)
from ground_plane_polling_tpu_torch.kernels import polling_cases
from ground_plane_polling_tpu_torch.kernels import polling_cuda
from ground_plane_polling_tpu_torch.ops import polling as twin

from .test_polling import P_INV, _scene
from .test_polling_pallas import _random_case

torch.set_num_threads(2)


def _torch_fit(args, fn=twin.fit_road_planes, device="cpu"):
    out = fn(*[torch.from_numpy(np.asarray(a)).to(device) for a in args])
    return [np.asarray(t.cpu()) for t in out]


def _assert_poll_close(got, ref):
    kp, kpl, res = got
    np.testing.assert_allclose(res, np.asarray(ref.residuals), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(kpl, np.asarray(ref.keyplanes), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(kp, np.asarray(ref.keypoints), rtol=1e-3,
                               atol=1e-3)


def test_case_helpers_match_the_jax_tests():
    """The port's case generator draws exactly what the JAX tests draw."""
    np.testing.assert_allclose(polling_cases.P_INV, P_INV)
    np.testing.assert_allclose(polling_cases.scene()[0], _scene()[0])
    ours = polling_cases.random_case(np.random.RandomState(5), 2, 6, 9)
    theirs = _random_case(np.random.RandomState(5), 2, 6, 9)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("b,d,p", [(2, 16, 40), (1, 5, 13), (4, 12, 40),
                                   (2, 33, 600)])
def test_twin_matches_jax(b, d, p):
    args = _random_case(np.random.RandomState(b * 1000 + d + p), b, d, p)
    got = _torch_fit(args)
    _assert_poll_close(got, jax_fit(*args))
    _assert_poll_close(got, fit_road_planes_pallas(*args))


def test_twin_normalize_planes():
    raw = np.array([[0.0, 2.0, 0.0, -3.3], [0.0, -4.0, 0.0, 6.6],
                    [0.1, 0.5, -0.2, 1.2]], np.float32)
    np.testing.assert_allclose(
        twin.normalize_planes(torch.from_numpy(raw)).numpy(),
        np.asarray(jax_normalize(raw)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", polling_cases.crafted_cases(),
                         ids=lambda c: c[0])
def test_twin_crafted_edge_cases(case):
    """Edge cases of the vote-gated arg-min (ties at 100, residuals above
    100, NaN, wrong winding): the twin, fit_road_planes and the Pallas
    kernel agree, and pick the plane the case was built for."""
    name, args, want = case
    got = _torch_fit(args)
    ref = jax_fit(*args)
    if want is None:  # padded rows: only the real rows are compared
        _assert_poll_close([g[:, :2] for g in got],
                           type(ref)(*[np.asarray(r)[:, :2] for r in ref]))
        assert all(g.shape[:2] == args[0].shape[:2] for g in got)
        return
    _assert_poll_close(got, ref)
    _assert_poll_close(got, fit_road_planes_pallas(*args))
    want_plane = np.asarray(jax_normalize(args[4][0, want]))
    np.testing.assert_allclose(got[1][0, 0, 0], want_plane, rtol=1e-6,
                               atol=1e-7)


def test_wrapper_uses_twin_on_cpu_without_launching():
    args = _random_case(np.random.RandomState(1), 1, 4, 7)
    before = polling_cuda.LAUNCHES
    got = _torch_fit(args, fn=polling_cuda.fit_road_planes)
    assert polling_cuda.LAUNCHES == before
    _assert_poll_close(got, jax_fit(*args))


@pytest.mark.parametrize("bad", ["float64_expected", "planes_width_3",
                                 "rays_width_2", "float16_boxes",
                                 "float_orientations", "empty_database",
                                 "cpu_tensors"])
def test_kernel_launch_checks_inputs_before_building(bad):
    """The launch path refuses what the kernel does not take, before it
    builds or launches anything: dimensions (whence the expected
    distances) in float64, planes 3 wide, boxes (whence the rays) 2 wide,
    float16 boxes, float orientations, an empty plane database, and
    tensors off the card."""
    args = dict(boxes=torch.zeros(2, 3, 12), dimensions=torch.zeros(2, 3, 3),
                orientations=torch.zeros(2, 3, dtype=torch.int32),
                P_inv=torch.zeros(2, 4, 3), planes=torch.zeros(2, 5, 4))
    match = {"float64_expected": "takes", "planes_width_3": "shapes",
             "rays_width_2": "shapes", "float16_boxes": "takes",
             "float_orientations": "takes", "empty_database": "empty",
             "cpu_tensors": "CUDA device"}[bad]
    if bad == "float64_expected":
        args["dimensions"] = args["dimensions"].double()
    elif bad == "planes_width_3":
        args["planes"] = args["planes"][..., :3]
    elif bad == "rays_width_2":
        args["boxes"] = args["boxes"][..., :2]
    elif bad == "float16_boxes":
        args["boxes"] = args["boxes"].half()
    elif bad == "float_orientations":
        args["orientations"] = args["orientations"].float()
    elif bad == "empty_database":
        args["planes"] = args["planes"][:, :0]
    before = polling_cuda.LAUNCHES
    with pytest.raises(ValueError, match=match):
        polling_cuda._launch(**args)
    assert polling_cuda.LAUNCHES == before


# the kernel's 8 detections per block, 4 resident blocks on each of an
# H100's 132 SMs
@pytest.mark.parametrize("b,d,p,warps,wave,want", [
    (1, 100, 21634, 8, 132 * 4, 40),   # one wave at b1
    (4, 100, 21634, 8, 132 * 4, 10),   # one wave at b4
    (1, 1, 4099, 8, 132 * 4, 33),      # capped at 128 planes a split
    (1, 3, 5, 8, 132 * 4, 1),          # fewer planes than a split holds
    (64, 100, 21634, 8, 132 * 4, 1),   # more groups than a wave
    (2, 0, 10, 8, 132 * 4, 1),         # no detections
    (1, 100, 21634, 4, 132 * 8, 42),   # 4 detections a block, 8 per SM
])
def test_plan_splits(b, d, p, warps, wave, want):
    s = polling_cuda.plan_splits(b, d, p, warps, wave)
    assert s == want
    groups = b * -(-d // warps)
    assert s == 1 or groups * s <= wave
    if (b, d, p) == (1, 100, 21634):  # at least two blocks per SM
        assert groups * s >= 2 * 132


def test_wrapper_refuses_mixed_devices():
    args = [torch.from_numpy(a) for a in _random_case(
        np.random.RandomState(2), 1, 2, 3)]
    args[4] = args[4].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        polling_cuda.fit_road_planes(*args)


STRADDLE = polling_cases.straddle_cases(4099) + polling_cases.straddle_cases(
    21634)


@pytest.mark.parametrize("case", STRADDLE, ids=lambda c: c[0])
def test_twin_straddle_cases(case):
    """The crafted edges with the competing planes at index 0, on both
    sides of a split boundary and last, among fillers: the twin,
    fit_road_planes and the Pallas kernel agree and pick the plane the
    case was built for."""
    name, args, want, _ = case
    got = _torch_fit(args)
    _assert_poll_close(got, jax_fit(*args))
    _assert_poll_close(got, fit_road_planes_pallas(*args))
    want_plane = np.asarray(jax_normalize(args[4][0, want]))
    np.testing.assert_allclose(got[1][0, 0, 0], want_plane, rtol=1e-6,
                               atol=1e-7)


# A numpy model of the kernel's state algebra (csrc/polling.cu: PollState,
# add_plane, merge and the final pick), run over random splits of the plane
# axis, lanes that stride over each split, and random merge orders.
NONE = 2**31 - 1
KEY100 = int(np.float32(100.0).view(np.uint32)) + 1


def _key(res):
    return 0 if np.isnan(res) else int(np.float32(res).view(np.uint32)) + 1


def _empty():
    return [-1, 2**32 - 1, NONE, NONE, NONE]  # level, key, best, first, low


def _add_plane(s, level, res, idx):
    key = _key(res)
    if level > s[0]:
        s[:] = [level, key, idx, idx, min(s[4], s[3])]
    elif level == s[0]:
        if key < s[1]:
            s[1], s[2] = key, idx
    else:
        s[4] = min(s[4], idx)


def _merge(a, b):
    if b[0] > a[0]:
        low = min(a[4], a[3], b[4])
        a[:] = b
        a[4] = low
    elif b[0] == a[0]:
        if (b[1], b[2]) < (a[1], a[2]):
            a[1], a[2] = b[1], b[2]
        a[3], a[4] = min(a[3], b[3]), min(a[4], b[4])
    else:
        a[4] = min(a[4], b[3], b[4])


def _pick(s):
    key, best = s[1], s[2]
    if s[4] != NONE and (KEY100, s[4]) < (key, best):
        key, best = KEY100, s[4]
    res = np.nan if key == 0 else float(np.uint32(key - 1).view(np.float32))
    return best, res


def _model_pick(votes, res, rng, splits):
    """The kernel's winner of one row: `splits` splits of the plane axis cut
    at random points, 32 lanes striding over each split, lanes and splits
    merged in random orders."""
    p = len(votes)
    cuts = np.sort(rng.randint(0, p + 1, splits - 1))
    bounds = np.concatenate([[0], cuts, [p]])
    states = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        lanes = [_empty() for _ in range(32)]
        for i in range(lo, hi):
            _add_plane(lanes[(i - lo) % 32], int(votes[i]), res[i], i)
        states += lanes
    rng.shuffle(states)
    while len(states) > 1:  # a random tree of merges
        i = rng.randint(len(states) - 1)
        _merge(states[i], states.pop(i + 1))
    return _pick(states[0])


def _model_cases():
    cases = [(f"random{shape}", _random_case(np.random.RandomState(sum(shape)),
                                            *shape))
             for shape in ((2, 16, 40), (1, 5, 13), (3, 7, 300))]
    cases += [(name, args) for name, args, _ in polling_cases.crafted_cases()]
    cases += [(name, args) for name, args, _, _ in
              polling_cases.straddle_cases(4099)]
    return cases


@pytest.mark.parametrize("case", _model_cases(), ids=lambda c: c[0])
def test_state_algebra_matches_twin_argmin(case):
    """Over random split points and merge orders, the state algebra picks
    the plane and residual of the twin's vote-gated arg-min on every row."""
    _, args = case
    t = [torch.from_numpy(np.asarray(a)) for a in args]
    votes, res, wind, _ = twin.poll_scoreboard(
        twin.rays_from_boxes(t[0], t[3]), twin.expected_distances(t[1], t[2]),
        twin.normalize_planes(t[4]))
    res = torch.where(wind < 0.0, twin.DISQUALIFIED_RESIDUAL, res)
    out = twin.fit_road_planes(*t)
    gated = torch.where(votes < votes.amax(-1, keepdim=True),
                        twin.DISQUALIFIED_RESIDUAL, res)
    best = torch.argmin(gated, dim=-1).numpy()
    votes, res = votes.numpy(), res.numpy()
    rng = np.random.RandomState(0)
    p = votes.shape[-1]
    for bi, di in np.ndindex(votes.shape[:2]):
        for splits in (1, 2, min(p, 7), min(p, 33)):
            idx, r = _model_pick(votes[bi, di], res[bi, di], rng, splits)
            assert idx == best[bi, di], (bi, di, splits)
            np.testing.assert_array_equal(np.float32(r) / np.float32(6),
                                          out.residuals[bi, di].numpy())
