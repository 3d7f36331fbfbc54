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
                                 "rays_width_2"])
def test_kernel_launch_checks_inputs_before_building(bad):
    """The launch path refuses what the kernel does not take, before it
    builds or launches anything."""
    rays, expected, planes = (torch.zeros(2, 3, 4, 3), torch.zeros(2, 3, 6),
                              torch.zeros(2, 5, 4))
    if bad == "float64_expected":
        expected = expected.double()
    elif bad == "planes_width_3":
        planes = planes[..., :3]
    else:
        rays = rays[..., :2]
    before = polling_cuda.LAUNCHES
    with pytest.raises(ValueError, match="polling"):
        polling_cuda._launch(rays, expected, planes)
    assert polling_cuda.LAUNCHES == before


def test_wrapper_refuses_mixed_devices():
    args = [torch.from_numpy(a) for a in _random_case(
        np.random.RandomState(2), 1, 2, 3)]
    args[4] = args[4].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        polling_cuda.fit_road_planes(*args)
