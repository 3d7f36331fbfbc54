"""The PyTorch port on the card: its CUDA kernels against their plain
PyTorch versions, fused against split heads, and serve --once against the
same run on the CPU. Every test here needs a CUDA device (`gpu` marker)
and skips without one. The file imports nothing of JAX, so it also runs
where JAX is not installed:

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
@pytest.mark.parametrize("shape", [
    (1, 100, 1024), (2, 5, 13), (4, 100, 4000),
    (1, 100, 21634),  # the main path's b1
    (2, 9, 1000),     # P not a multiple of the 1,024-plane tile
    (1, 4, 1),        # one plane
    (1, 7, 300),      # D not a multiple of the 8 detections of a block
    (3, 10, 700),     # B = 3
])
def test_polling_kernel_matches_twin(cuda, shape):
    args = polling_cases.random_case(np.random.RandomState(0), *shape)
    before = polling_cuda.LAUNCHES
    got = _fit(polling_cuda.fit_road_planes, args, cuda)
    assert polling_cuda.LAUNCHES == before + 1
    _assert_poll_close(got, _fit(twin.fit_road_planes, args, cuda))


def _tensors(args, device):
    return [torch.from_numpy(np.asarray(a)).to(device) for a in args]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,splits", [
    ((2, 6, 5), 8), ((2, 6, 5), 40),    # splits that hold no plane
    ((1, 5, 2500), 1), ((1, 5, 2500), 2),  # several tiles, the last ragged
])
def test_polling_kernel_forced_splits(cuda, shape, splits):
    """Empty splits merge as empty states; a split longer than a tile
    walks its tiles in order."""
    args = _tensors(polling_cases.random_case(np.random.RandomState(1),
                                              *shape), cuda)
    got = polling_cuda._launch(*args, splits=splits)
    _assert_poll_close([g.cpu().numpy() for g in got],
                       [r.cpu().numpy() for r in twin.fit_road_planes(*args)])


@pytest.mark.gpu
def test_polling_kernel_widens_bf16_and_int64(cuda):
    """bf16 boxes, dimensions, P_inv and planes and int64 orientations are
    widened in the kernel: the twin on the same values in float32."""
    args = _tensors(polling_cases.random_case(np.random.RandomState(2),
                                              2, 20, 500), cuda)
    narrow = [args[0].bfloat16(), args[1].bfloat16(), args[2].long(),
              args[3].bfloat16(), args[4].bfloat16()]
    wide = [narrow[0].float(), narrow[1].float(), args[2],
            narrow[3].float(), narrow[4].float()]
    got = polling_cuda.fit_road_planes(*narrow)
    assert all(g.dtype == torch.float32 for g in got)
    _assert_poll_close([g.cpu().numpy() for g in got],
                       [r.cpu().numpy() for r in twin.fit_road_planes(*wide)])


@pytest.mark.gpu
def test_polling_kernel_without_detections_does_not_launch(cuda):
    args = _tensors(polling_cases.random_case(np.random.RandomState(0),
                                              2, 3, 10), cuda)
    args = [args[0][:, :0], args[1][:, :0], args[2][:, :0], args[3], args[4]]
    before = polling_cuda.LAUNCHES
    got = polling_cuda.fit_road_planes(*args)
    assert polling_cuda.LAUNCHES == before
    assert [tuple(g.shape) for g in got] == [(2, 0, 4, 3), (2, 0, 1, 4),
                                             (2, 0)]


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


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case", polling_cases.straddle_cases(4099)
    + polling_cases.straddle_cases(21634), ids=lambda c: c[0])
def test_polling_kernel_straddle_cases(cuda, case):
    """The competing planes in different splits: with the splits the case
    was built for, and with the wrapper's own plan."""
    name, args, want, splits = case
    ref = _fit(twin.fit_road_planes, args, "cpu")
    t = _tensors(args, cuda)
    for got in (polling_cuda._launch(*t, splits=splits),
                polling_cuda.fit_road_planes(*t)):
        _assert_poll_close([g.cpu().numpy() for g in got], ref)


@pytest.fixture
def tf32_off():
    """float32 means float32 on the card; the flags are restored after."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def _seeded_detector(fuse_cls_dim=False, cls_std=0.05):
    """ResNet-50, FPN 512, seeded init with the classification out kernel
    redrawn from N(0, cls_std), so that detections pass 0.05."""
    from ground_plane_polling_tpu_torch.models import (build_detector,
                                                       init_detector)

    model = init_detector(build_detector("resnet50"), 0)
    out = model.classification.cls_out
    with torch.no_grad():
        out.weight.copy_(torch.randn(out.weight.shape,
                                     generator=torch.Generator()
                                     .manual_seed(0)) * cls_std)
        out.bias.zero_()
    if fuse_cls_dim:
        from ground_plane_polling_tpu_torch.models import fuse_detector_params

        fused = build_detector("resnet50", fuse_cls_dim=True)
        fused.load_state_dict(fuse_detector_params(model.state_dict()))
        return fused
    return model


@pytest.mark.gpu
def test_fused_heads_match_split_on_the_card(cuda, tf32_off):
    """Fused and split heads on the card in float32, TF32 off: rtol 1e-3,
    atol 1e-3 of the largest magnitude (chip_smoke's card-vs-CPU
    tolerance; the wider fused convolution sums in another order)."""
    from ground_plane_polling_tpu_torch.inference import place_model

    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -128, 128, (2, 3, 128, 416)).astype(np.float32)).to(cuda)
    outs = []
    for fuse in (False, True):
        net = place_model(_seeded_detector(fuse), cuda)
        with torch.inference_mode():
            outs.append({k: v.cpu().numpy() for k, v in net(x).items()})
    for key, ref in outs[0].items():
        np.testing.assert_allclose(outs[1][key], ref, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(ref).max()),
                                   err_msg=key)


@pytest.mark.gpu
def test_serve_once_on_the_card(cuda, tmp_path, tf32_off):
    """serve --once on the card writes one KITTI txt per frame, and they
    hold the CPU run's rows: types equal, 2D boxes and scores within the
    txt's rounding plus 1e-2 (card and CPU sum convolutions in another
    order)."""
    import contextlib
    import io
    import json

    from PIL import Image

    from ground_plane_polling_tpu_torch.bin import serve
    from ground_plane_polling_tpu_torch.data.planes import save_plane_database
    from ground_plane_polling_tpu_torch.models import export_jax_params

    rng = np.random.RandomState(0)
    img, cal = tmp_path / "img", tmp_path / "cal"
    img.mkdir()
    cal.mkdir()
    P2 = np.array([[200.0, 0.0, 208.0, 1.2], [0.0, 200.0, 64.0, 0.1],
                   [0.0, 0.0, 1.0, 0.002]])
    calib = "".join(f"P{i}: " + " ".join(
        f"{v:.12e}" for v in (P2 if i == 2 else np.zeros((3, 4))).ravel())
        + "\n" for i in range(4))
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (128, 416, 3)).astype(
            np.uint8)).save(img / f"{i:06d}.png")
        (cal / f"{i:06d}.txt").write_text(calib)
    planes = str(tmp_path / "planes.mat")
    save_plane_database(planes, np.array([[0.0, 1.0, 0.0, -1.65],
                                          [0.01, 1.0, 0.0, -1.5]]))
    weights = str(tmp_path / "model.npz")
    # N(0, 0.01): scores well apart, so card and CPU rank rows alike
    np.savez(weights, **export_jax_params(_seeded_detector(cls_std=0.01)))
    with open(weights + ".json", "w") as f:
        json.dump({"backbone": "resnet50", "num_classes": 1}, f)
    rows = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / device
        with contextlib.redirect_stdout(io.StringIO()):
            n = serve.main([weights, str(img), str(cal), planes, str(out),
                            "--once", "--no-bf16", "--device", device,
                            "--image-min-side", "64", "--image-max-side",
                            "224"])
        assert n == 3
        rows[device] = {p.name: [r.split() for r in
                                 p.read_text().splitlines()]
                        for p in sorted(out.iterdir())}
    assert sorted(rows["cuda"]) == [f"{i:06d}.txt" for i in range(3)]
    for name, want in rows["cpu"].items():
        got = rows["cuda"][name]
        assert len(got) == len(want) > 0, name
        assert [r[0] for r in got] == [r[0] for r in want]
        g = np.array([r[4:8] + r[15:16] for r in got], float)
        w = np.array([r[4:8] + r[15:16] for r in want], float)
        np.testing.assert_allclose(g, w, rtol=0, atol=0.02, err_msg=name)
