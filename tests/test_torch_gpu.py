"""The PyTorch port on the card: its CUDA kernels against their plain
PyTorch versions, fused against split heads, serve --once and one train
step against the same run on the CPU. Every test here needs a CUDA device
(`gpu` marker) and skips without one. The file imports nothing of JAX, so
it also runs where JAX is not installed:

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


def _raw_train_batch(b=2, shape=(64, 224)):
    """A raw training batch as KittiLoader(raw_batches=True) yields it,
    two boxes an image, on the CPU."""
    rng = np.random.RandomState(0)
    ann = np.zeros((b, 4, 17), np.float32)
    ann[:, :2, :4] = [[20, 10, 80, 50], [120, 8, 190, 60]]
    ann[:, :2, 4:12] = rng.uniform(20, 60, (b, 2, 8))
    ann[:, :2, 12:15] = [1.5, 1.6, 4.0]
    return {"images": torch.from_numpy(rng.randint(0, 256, (b, *shape, 3))
                                       .astype(np.uint8)),
            "annotations": torch.from_numpy(ann),
            "ann_mask": torch.tensor([[True, True, False, False]] * b),
            "ignores": torch.zeros(b, 1, 4), "ignore_mask":
            torch.zeros(b, 1, dtype=torch.bool),
            "valid": torch.ones(b, dtype=torch.bool),
            "sizes": torch.tensor([shape] * b, dtype=torch.float32)}


def _shrunk_train_model(device):
    """Seeded detector, one block per ResNet stage and FPN 64, with the
    classification out kernel redrawn N(0, 0.05)."""
    from ground_plane_polling_tpu_torch.models import (GPPRetinaNet,
                                                       init_detector)
    from ground_plane_polling_tpu_torch.models.resnet import ResNetBackbone

    model = init_detector(GPPRetinaNet(ResNetBackbone((1, 1, 1, 1)),
                                       feature_size=64), 0)
    with torch.no_grad():
        model.classification.cls_out.weight.normal_(
            0.0, 0.05, generator=torch.Generator().manual_seed(0))
    return model.to(device)


@pytest.mark.gpu
def test_train_step_on_the_card_matches_cpu(cuda, tf32_off):
    """One float32 train step of a shrunk detector (one block per ResNet
    stage, FPN 64) from the same weights and batch on the card and on the
    CPU: loss terms within rtol 1e-4, each post-clip gradient within 1e-3
    of its tensor's norm (convolutions summed in another order)."""
    from ground_plane_polling_tpu_torch.data.pipeline import prepare_batch
    from ground_plane_polling_tpu_torch.training.train import (
        create_train_state, make_optimizer, make_train_step)

    batch = prepare_batch(_raw_train_batch(), num_classes=1, augment=False,
                          device="cpu")
    runs = []
    for device in (cuda, torch.device("cpu")):
        model = _shrunk_train_model(device)
        state = create_train_state(model, make_optimizer(model))
        state, m = make_train_step()(state, {k: v.to(device)
                                             for k, v in batch.items()})
        runs.append(({k: float(v) for k, v in m.items()},
                     {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (got, got_g), (want, want_g) = runs
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-4), k
    for k, g in want_g.items():
        gap = float((got_g[k] - g).abs().max())
        assert gap <= 1e-3 * float(g.norm()), (k, gap)


@pytest.mark.gpu
def test_fused_train_step_makes_no_host_sync(cuda):
    """A bf16 fused train step (upload of a pinned raw batch, augmentation,
    targets, losses, clip, Adam) never waits for the card: under
    torch.cuda's sync debug mode "error" a synchronizing operation would
    raise. The first step, which copies the constants to the card, runs
    before."""
    from ground_plane_polling_tpu_torch.data.augment import draw_augmentation
    from ground_plane_polling_tpu_torch.training.train import (
        create_train_state, make_fused_train_step, make_optimizer)

    raw = _raw_train_batch()
    raw.update(draw_augmentation(torch.Generator().manual_seed(0),
                                 raw["sizes"]))
    raw = {k: v.pin_memory() for k, v in raw.items()}
    model = _shrunk_train_model(cuda).to(memory_format=torch.channels_last)
    state = create_train_state(model, make_optimizer(model))
    step = make_fused_train_step(num_classes=1, augment=True, bf16=True)
    state, _ = step(state, raw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, raw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.step == 2
    assert torch.isfinite(metrics["loss"]).item()


# --- int8 convolution (csrc/int8_conv.cu) ---------------------------------

# (kernel, stride, ((top, bottom), (left, right)), batch, cin, cout, h, w):
# the detector's conv kinds, tile edges in M, N and K, and the stem's
# byte-wise path (Cin 3)
INT8_CONV_CASES = {
    "1x1_s1": (1, 1, ((0, 0), (0, 0)), 2, 64, 256, 13, 21),
    "1x1_s2_proj": (1, 2, ((0, 0), (0, 0)), 1, 256, 512, 26, 84),
    "3x3_p1": (3, 1, ((1, 1), (1, 1)), 2, 128, 128, 13, 42),
    "3x3_s2_same_asym": (3, 2, ((1, 1), (0, 1)), 1, 512, 512, 13, 42),
    "3x3_s2_same_even": (3, 2, ((0, 1), (0, 1)), 1, 64, 64, 8, 14),
    "stem_7x7_s2_p3": (7, 2, ((3, 3), (3, 3)), 2, 3, 64, 52, 168),
    "box_out_144": (3, 1, ((1, 1), (1, 1)), 1, 512, 144, 7, 21),
    "cls_out_96": (3, 1, ((1, 1), (1, 1)), 1, 256, 96, 7, 21),
    "dim_out_36": (3, 1, ((1, 1), (1, 1)), 1, 128, 36, 7, 21),
    "k48_m1": (1, 1, ((0, 0), (0, 0)), 1, 48, 8, 1, 1),
    # P6: K = 18,432 split across the card
    "p6_3x3_s2_same_2048": (3, 2, ((1, 1), (0, 1)), 1, 2048, 512, 13, 42),
    "p7_tower_4x11": (3, 1, ((1, 1), (1, 1)), 1, 512, 512, 4, 11),
    "layer1_3x3_n64": (3, 1, ((1, 1), (1, 1)), 2, 64, 64, 52, 84),
    "odd_cout_37": (3, 1, ((1, 1), (1, 1)), 1, 32, 37, 5, 9),
}


def _int8_operands(case, device):
    from ground_plane_polling_tpu_torch.ops import int8_conv

    k, s, pad, b, cin, cout, h, w = INT8_CONV_CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    x = torch.from_numpy(rng.normal(0, 3, (b, cin, h, w)).astype(
        np.float32)).to(device)
    wt = torch.from_numpy(rng.normal(0, 0.1, (cout, cin, k, k)).astype(
        np.float32)).to(device)
    s_x = float(np.float32(x.abs().max().item() / 127.0 * 0.8))
    w8, s_w = int8_conv.quantize_weight(wt)
    return (x, s_x, w8.contiguous(memory_format=torch.channels_last), s_w,
            torch.from_numpy(rng.normal(0, 1, cout).astype(np.float32))
            .to(device), s, pad)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["channels_last", "nchw", "strided",
                                    "channels_last_c3", "unaligned"])
def test_int8_quantize_matches_plain(cuda, dtype, layout):
    """The quantize kernel equals the plain version bit for bit, on the
    card and on the CPU, with half-way values (k + 1/2) s that must round
    to even and values past +-127 s that must clamp: dense channels-last
    inputs (the vector path; with C 3 its count is not a multiple of 8, so
    a tail remains) and every other layout (the general path)."""
    from ground_plane_polling_tpu_torch.kernels import int8_conv_cuda
    from ground_plane_polling_tpu_torch.ops import int8_conv

    rng = np.random.RandomState(3)
    s = 0.0371
    channels = 3 if layout == "channels_last_c3" else 48
    x = rng.normal(0, 40 * s, (2, channels, 9, 13)).astype(np.float32)
    x.reshape(-1)[:200] = (np.arange(-100, 100) + 0.5) * np.float32(s)
    x.reshape(-1)[200:210] = 300 * s
    t = torch.from_numpy(x).to(cuda, getattr(torch, dtype))
    if layout.startswith("channels_last"):
        t = t.contiguous(memory_format=torch.channels_last)
    elif layout == "strided":
        t = t[:, ::2]
    elif layout == "unaligned":  # dense channels-last, not 16-byte aligned
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)[1:]
        t = flat.view(2, 9, 13, channels).copy_(
            t.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    before = int8_conv_cuda.QUANTIZE_LAUNCHES
    got = int8_conv_cuda.quantize(t, s)
    assert int8_conv_cuda.QUANTIZE_LAUNCHES == before + 1
    assert got.dtype == torch.int8 and got.shape == t.shape
    assert got.permute(0, 2, 3, 1).is_contiguous()
    want = int8_conv.quantize_activation(t, s)
    assert torch.equal(got.cpu(), want.cpu())
    assert torch.equal(got.cpu(), int8_conv.quantize_activation(t.cpu(), s))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(INT8_CONV_CASES))
def test_int8_conv_matches_plain(cuda, case):
    """The conv kernel: int32 accumulators equal to the plain float64 conv,
    float32 and bf16 outputs (with and without bias) bit for bit equal to
    the plain dequantize and bias add, on the card."""
    from ground_plane_polling_tpu_torch.kernels import int8_conv_cuda
    from ground_plane_polling_tpu_torch.ops import int8_conv

    x, s_x, w8, s_w, bias, stride, pad = _int8_operands(case, cuda)
    x8 = int8_conv_cuda.quantize(x, s_x)
    before = int8_conv_cuda.CONV_LAUNCHES
    acc = int8_conv_cuda.conv2d_accumulate(x8, w8, stride, pad)
    want_acc = int8_conv.conv2d_int8(x8, w8, stride, pad)
    assert torch.equal(acc.cpu(), want_acc.cpu())
    for dtype in (torch.float32, torch.bfloat16):
        for b in (None, bias.to(dtype)):
            got = int8_conv_cuda.conv2d(x8, w8, s_x, s_w, b, stride, pad,
                                        dtype)
            assert got.dtype == dtype and got.permute(0, 2, 3,
                                                      1).is_contiguous()
            want = int8_conv.int8_conv2d(x8, w8, s_x, s_w, b, stride, pad,
                                         dtype)
            assert torch.equal(got.cpu(), want.cpu()), (dtype, b is None)
    assert int8_conv_cuda.CONV_LAUNCHES == before + 5


@pytest.mark.gpu
def test_int8_forward_on_the_card_matches_cpu(cuda, tf32_off):
    """A shrunk detector's int8 forward on the card against the same on
    the CPU, on one set of scales (calibrated on the CPU; an ulp of a scale
    moves roundings): every operation between the int8 convs is correctly
    rounded on both, so the heads agree to 1e-6 of their largest magnitude
    (the sigmoid's exp differs). One launch of each kernel per site."""
    from ground_plane_polling_tpu_torch.inference import place_model
    from ground_plane_polling_tpu_torch.kernels import int8_conv_cuda
    from ground_plane_polling_tpu_torch.models import (GPPRetinaNet,
                                                       init_detector)
    from ground_plane_polling_tpu_torch.models import quantize
    from ground_plane_polling_tpu_torch.models.resnet import ResNetBackbone

    model = init_detector(GPPRetinaNet(ResNetBackbone((1, 1, 1, 1)),
                                       feature_size=64), 0)
    x = torch.from_numpy(np.random.RandomState(4).uniform(
        -128, 128, (2, 3, 64, 224)).astype(np.float32))
    cpu = place_model(model, "cpu")
    scales = quantize.collect_scales(cpu, [x])
    with torch.inference_mode():
        want = quantize.quantize_apply(cpu, scales)(x)
        card = place_model(model, cuda)
        before = (int8_conv_cuda.QUANTIZE_LAUNCHES,
                  int8_conv_cuda.CONV_LAUNCHES)
        got = quantize.quantize_apply(card, scales)(x.to(cuda))
    assert (int8_conv_cuda.QUANTIZE_LAUNCHES - before[0],
            int8_conv_cuda.CONV_LAUNCHES - before[1]) == (100, 100)
    for key, ref in want.items():
        np.testing.assert_allclose(got[key].cpu().numpy(), ref.numpy(),
                                   rtol=0, atol=1e-6 * float(ref.abs().max()),
                                   err_msg=key)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", ["1", "2", "most"])
@pytest.mark.parametrize("tile", [f"{bm}x{bn}" for bm, bn in
                                  ((64, 48), (64, 64), (64, 96), (64, 128),
                                   (64, 144), (128, 48), (128, 64),
                                   (128, 96), (128, 128), (128, 144))])
def test_int8_conv_forced_plans(cuda, tile, splits):
    """Every compiled tile with 1, 2 and the most splits of K the planner
    allows: the int32 accumulators and the bf16 output with bias equal the
    plain versions bit for bit (edges ragged in M and in N for every
    width), and the split counters are back at 0 after the launch."""
    from ground_plane_polling_tpu_torch.kernels import int8_conv_cuda as ic
    from ground_plane_polling_tpu_torch.ops import int8_conv

    bm, bn = map(int, tile.split("x"))
    assert (bm, bn) in ic.TILES
    rng = np.random.RandomState(bm + bn)
    x8 = torch.from_numpy(rng.randint(-127, 128, (1, 7, 21, 256)).astype(
        np.int8)).to(cuda).permute(0, 3, 1, 2)
    w8 = torch.from_numpy(rng.randint(-127, 128, (200, 3, 3, 256)).astype(
        np.int8)).to(cuda).permute(0, 3, 1, 2)
    s_w = torch.from_numpy(rng.uniform(1e-4, 1e-2, 200).astype(
        np.float32)).to(cuda)
    bias = torch.from_numpy(rng.normal(0, 1, 200).astype(np.float32)).to(
        cuda, torch.bfloat16)
    pad = ((1, 1), (1, 1))
    steps = -(-w8[0].numel() // ic.K_STEP)
    count = {"1": 1, "2": 2, "most": ic.split_counts(steps)[-1]}[splits]
    plan = (bm, bn, count)
    acc = ic._launch(x8, w8, 0.0, None, None, 1, pad, torch.int32,
                     plan=plan)
    assert torch.equal(acc.cpu(), int8_conv.conv2d_int8(x8, w8, 1, pad)
                       .cpu())
    y = ic._launch(x8, w8, 0.0173, s_w, bias, 1, pad, torch.bfloat16,
                   plan=plan)
    want = int8_conv.int8_conv2d(x8, w8, 0.0173, s_w, bias, 1, pad,
                                 torch.bfloat16)
    assert torch.equal(y.cpu(), want.cpu())
    torch.cuda.synchronize()
    for _, counters in ic._workspaces.values():
        assert int(counters.abs().sum()) == 0


@pytest.mark.gpu
def test_int8_conv_split_launches_in_a_row_agree(cuda):
    """Two split launches in a row on one stream, without a synchronize
    between them, reuse the workspace and its counters: both equal the
    plain conv, and the counters are left at 0."""
    from ground_plane_polling_tpu_torch.kernels import int8_conv_cuda as ic
    from ground_plane_polling_tpu_torch.ops import int8_conv

    x, s_x, w8, s_w, bias, stride, pad = _int8_operands(
        "p6_3x3_s2_same_2048", cuda)
    x8 = ic.quantize(x, s_x)
    plan = ic.conv_plan(x8, w8, stride, pad)
    assert plan[2] > 1, plan
    first = ic.conv2d_accumulate(x8, w8, stride, pad)
    second = ic.conv2d_accumulate(x8, w8, stride, pad)
    want = int8_conv.conv2d_int8(x8, w8, stride, pad)
    assert torch.equal(first.cpu(), want.cpu())
    assert torch.equal(second.cpu(), want.cpu())
    stream = torch._C._cuda_getCurrentRawStream(x8.device.index)
    _, counters = ic._workspaces[(x8.device.index, stream)]
    assert int(counters.abs().sum()) == 0
