"""The PyTorch port's CUDA kernels on the card, against their plain PyTorch
versions. Every test here needs a CUDA device (`gpu` marker) and skips
without one. The file imports nothing of JAX, so it also runs where JAX is
not installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q

Tolerances are those of the CPU polling tests: residuals 1e-4, keyplanes
rtol 1e-5 / atol 1e-6, keypoints 1e-3.
"""

import numpy as np
import pytest
import torch

from ground_plane_polling_tpu_torch.kernels import polling_cases
from ground_plane_polling_tpu_torch.kernels import polling_cuda
from ground_plane_polling_tpu_torch.ops import polling as twin


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fit(fn, args, device):
    out = fn(*[torch.from_numpy(np.asarray(a)).to(device) for a in args])
    return [t.cpu().numpy() for t in out]


def _assert_poll_close(got, ref):
    for g, r, rtol, atol in zip(got, ref, (1e-3, 1e-5, 1e-4),
                                (1e-3, 1e-6, 1e-4)):
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 100, 1024), (2, 5, 13),
                                   (4, 100, 4000)])
def test_polling_kernel_matches_twin(cuda, shape):
    args = polling_cases.random_case(np.random.RandomState(0), *shape)
    before = polling_cuda.LAUNCHES
    got = _fit(polling_cuda.fit_road_planes, args, cuda)
    assert polling_cuda.LAUNCHES == before + 1
    _assert_poll_close(got, _fit(twin.fit_road_planes, args, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("case", polling_cases.crafted_cases(),
                         ids=lambda c: c[0])
def test_polling_kernel_crafted_edge_cases(cuda, case):
    name, args, want = case
    got = _fit(polling_cuda.fit_road_planes, args, cuda)
    ref = _fit(twin.fit_road_planes, args, "cpu")
    rows = slice(None) if want is not None else slice(0, 2)
    _assert_poll_close([g[:, rows] for g in got], [r[:, rows] for r in ref])


@pytest.mark.gpu
def test_polling_kernel_refuses_empty_database(cuda):
    args = polling_cases.random_case(np.random.RandomState(0), 1, 3, 2)
    args = args[:4] + (args[4][:, :0],)
    with pytest.raises(ValueError, match="empty"):
        _fit(polling_cuda.fit_road_planes, args, cuda)
