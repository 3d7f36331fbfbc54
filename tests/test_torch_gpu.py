"""The PyTorch port on the card: its CUDA kernels against their plain
PyTorch versions, fused against split heads, serve --once, one train
step against the same run on the CPU, the DDP step on a 1-rank NCCL group
against the plain step, --remat, the captured train step against its
eager step, and the captured mesh paths on the 1-rank NCCL group (the DDP
step, the data-parallel and width-split detect calls) against their eager
forms, their graphs released and captured anew, with a gloo group on the
card kept eager. Every test here needs a
CUDA device
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


# --- data parallel and remat ------------------------------------------------

@pytest.fixture(scope="module")
def nccl_mesh():
    """A 1-rank NCCL process group on the card (the machine shows one card
    to a run, and NCCL refuses two ranks on one device), torn down after
    the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import datetime
    import socket

    import torch.distributed as dist

    from ground_plane_polling_tpu_torch.parallel import data_parallel_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield data_parallel_mesh()
    finally:
        dist.destroy_process_group()


def _step_runs(device, batch, meshes, remat=False):
    """One float32 step of the shrunk detector from the same weights per
    mesh (None: the plain step): loss terms and post-clip gradients."""
    from ground_plane_polling_tpu_torch.training.train import (
        create_train_state, make_optimizer, make_train_step)

    runs = []
    for mesh in meshes:
        model = _shrunk_train_model(device)
        model.backbone.remat = remat
        state = create_train_state(model, make_optimizer(model))
        state, m = make_train_step(mesh=mesh)(state, batch)
        runs.append(({k: float(v) for k, v in m.items()},
                     {n: p.grad.cpu() for n, p in model.named_parameters()}))
    return runs


def _assert_same_step(got, want):
    (terms, grads), (want_terms, want_grads) = got, want
    for k, v in want_terms.items():
        assert terms[k] == pytest.approx(v, rel=1e-4), k
    for k, g in want_grads.items():
        gap = float((grads[k] - g).abs().max())
        assert gap <= 1e-3 * float(g.norm()), (k, gap)


@pytest.mark.gpu
def test_one_rank_nccl_step_matches_plain_step(nccl_mesh, tf32_off):
    """The DDP step over a 1-rank NCCL group (global normalizers through
    one all-reduce, gradients reduced in backward) against the plain step:
    test_train_step_on_the_card_matches_cpu's tolerances."""
    from ground_plane_polling_tpu_torch.data.pipeline import prepare_batch

    batch = prepare_batch(_raw_train_batch(), num_classes=1, augment=False,
                          device=nccl_mesh.device)
    ddp, plain = _step_runs(nccl_mesh.device, batch, (nccl_mesh, None))
    _assert_same_step(ddp, plain)


@pytest.mark.gpu
def test_one_rank_nccl_fused_step_makes_no_host_sync(nccl_mesh):
    """The DDP-wrapped bf16 fused step never waits for the card: the
    normalizers' all-reduce is enqueued on the stream."""
    from ground_plane_polling_tpu_torch.data.augment import draw_augmentation
    from ground_plane_polling_tpu_torch.training.train import (
        create_train_state, make_fused_train_step, make_optimizer)

    raw = _raw_train_batch()
    raw.update(draw_augmentation(torch.Generator().manual_seed(0),
                                 raw["sizes"]))
    raw = {k: v.pin_memory() for k, v in raw.items()}
    model = _shrunk_train_model(nccl_mesh.device).to(
        memory_format=torch.channels_last)
    state = create_train_state(model, make_optimizer(model))
    step = make_fused_train_step(num_classes=1, augment=True, bf16=True,
                                 mesh=nccl_mesh)
    for _ in range(2):  # constants to the card; DDP's bucket rebuild
        state, _ = step(state, raw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, raw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.step == 3
    assert torch.isfinite(metrics["loss"]).item()


@pytest.mark.gpu
def test_remat_on_the_card(cuda, tf32_off):
    """--remat recomputes the blocks in backward and changes no number:
    float32 terms and gradients as without it."""
    from ground_plane_polling_tpu_torch.data.pipeline import prepare_batch

    batch = prepare_batch(_raw_train_batch(), num_classes=1, augment=False,
                          device=cuda)
    remat, = _step_runs(cuda, batch, (None,), remat=True)
    plain, = _step_runs(cuda, batch, (None,))
    _assert_same_step(remat, plain)


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


# --- int8 depthwise convolution (csrc/int8_depthwise.cu) ------------------

def _dw_operands(device, c, b, h, w, seed):
    """(x float32 in channels-last memory, s_x, w8, s_w, bias) of a
    depthwise site; s_x clamps the largest |x| at 127, and x holds values
    at, and one float32 step beside, half-integer multiples of s_x (x / s_x
    rounds half to even there; the kernel's fast quantize must hand them
    to the IEEE division)."""
    from ground_plane_polling_tpu_torch.ops import int8_conv

    rng = np.random.RandomState(seed)
    x = rng.normal(0, 3, (b, c, h, w)).astype(np.float32)
    s_x = np.float32(np.abs(x).max() / 127.0 * 0.8)
    half = ((rng.randint(-140, 140, x.size // 4) + 0.5) * s_x).astype(
        np.float32)
    half[1::3] = np.nextafter(half[1::3], np.float32(np.inf))
    half[2::3] = np.nextafter(half[2::3], np.float32(-np.inf))
    x.reshape(-1)[:half.size] = half
    x = torch.from_numpy(x).to(device).contiguous(
        memory_format=torch.channels_last)
    wt = torch.from_numpy(rng.normal(0, 0.3, (c, 1, 3, 3)).astype(
        np.float32)).to(device)
    w8, s_w = int8_conv.quantize_weight(wt)
    bias = torch.from_numpy(rng.normal(0, 1, c).astype(np.float32)).to(
        device)
    return x, float(s_x), w8, s_w, bias


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("channels", [8, 24, 32, 1024, 3])
def test_int8_depthwise_matches_plain(cuda, channels, stride):
    """The depthwise kernel against the plain grouped float64 conv: int32
    accumulators exactly, float32 and bf16 outputs (with and without bias)
    bit for bit, from the int8 x and (quantized in the kernel) from the
    float x, at odd and even sizes with Flax SAME padding, at b1 and b4;
    C 3 takes the element-wise loads. Each call launches once."""
    from ground_plane_polling_tpu_torch.kernels import (int8_conv_cuda,
                                                        int8_depthwise_cuda)
    from ground_plane_polling_tpu_torch.models.resnet import same_padding
    from ground_plane_polling_tpu_torch.ops import int8_conv

    for b, h, w in ((1, 13, 42), (4, 9, 13), (1, 8, 14), (4, 26, 84)):
        x, s_x, w8, s_w, bias = _dw_operands(cuda, channels, b, h, w,
                                             channels + h)
        x8 = int8_conv_cuda.quantize(x, s_x)
        pad = same_padding(h, w, 3, stride)
        before = int8_depthwise_cuda.DEPTHWISE_LAUNCHES
        acc = int8_depthwise_cuda.depthwise2d_accumulate(x8, w8, stride, pad)
        assert torch.equal(acc.cpu(), int8_conv.conv2d_int8(
            x8.cpu(), w8.cpu(), stride, pad))
        for dtype in (torch.float32, torch.bfloat16):
            for bb in (None, bias.to(dtype)):
                xd = x.to(dtype)  # bf16 rounds x before its quantize
                for got, want in (
                        (int8_depthwise_cuda.depthwise2d(
                            x8, w8, s_x, s_w, bb, stride, pad, dtype),
                         int8_conv.int8_conv2d(x8, w8, s_x, s_w, bb, stride,
                                               pad, dtype)),
                        (int8_depthwise_cuda.quantize_depthwise2d(
                            xd, s_x, w8, s_w, bb, stride, pad, dtype),
                         int8_conv.quantize_int8_conv2d(
                             xd, s_x, w8, s_w, bb, stride, pad, dtype))):
                    assert got.dtype == dtype
                    assert got.permute(0, 2, 3, 1).is_contiguous()
                    assert torch.equal(got.cpu(), want.cpu()), (b, h, w,
                                                                dtype)
        assert int8_depthwise_cuda.DEPTHWISE_LAUNCHES == before + 9


def _dw_plans(c, stride):
    """Every tile the rule can pick on C channels at either stride, at its
    TC and at the most channels a block takes (C 136: a partial tile,
    element-wise loads), with the rule's block and with one row of
    threads."""
    from ground_plane_polling_tpu_torch.kernels import int8_depthwise_cuda

    dw = int8_depthwise_cuda
    plans = []
    for tc in (dw.channel_tile(c), dw.MAX_CHANNELS):
        for th, tw in dw.PIXEL_TILES[1] + dw.PIXEL_TILES[2]:
            sw = 8 if tw % 8 == 0 else 4
            if dw.smem_bytes(th, tw, tc, stride, 4) <= dw.MAX_SMEM:
                for ny in {dw.block_rows(th, tw, tc, sw, stride), 1}:
                    plans.append((th, tw, tc, sw, ny))
    return plans


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("channels", [136, 3])
def test_int8_depthwise_every_plan_matches_plain(cuda, channels, stride):
    """Every tile the rule can pick, forced: the fused kernel from float32
    and bf16 x, with and without bias, and the int8-input accumulators
    equal the plain versions bit for bit, on a map whose edges are ragged
    for every tile; C 136 takes tiles of 8 channels (8-channel loads) and
    of 32 (a partial tile, element-wise loads), C 3 element-wise loads."""
    from ground_plane_polling_tpu_torch.kernels import int8_depthwise_cuda
    from ground_plane_polling_tpu_torch.models.resnet import same_padding
    from ground_plane_polling_tpu_torch.ops import int8_conv

    x, s_x, w8, s_w, bias = _dw_operands(cuda, channels, 2, 19, 37,
                                         channels + stride)
    pad = same_padding(19, 37, 3, stride)
    x8 = int8_conv.quantize_activation(x, s_x).contiguous(
        memory_format=torch.channels_last)
    for plan in _dw_plans(channels, stride):
        acc = int8_depthwise_cuda._launch(x8, 0.0, w8, None, None, stride,
                                          pad, torch.int32, plan=plan)
        assert torch.equal(acc.cpu(), int8_conv.conv2d_int8(
            x8.cpu(), w8.cpu(), stride, pad)), plan
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            for bb in (None, bias.to(dtype)):
                got = int8_depthwise_cuda._launch(xd, s_x, w8, s_w, bb,
                                                  stride, pad, dtype,
                                                  plan=plan)
                want = int8_conv.quantize_int8_conv2d(xd, s_x, w8, s_w, bb,
                                                      stride, pad, dtype)
                assert torch.equal(got.cpu(), want.cpu()), (plan, dtype)


@pytest.mark.gpu
def test_int8_depthwise_raises_on_bad_inputs(cuda):
    """Wrong dtype, layout, alignment, scales or weight shape raise before
    a launch: the count of launches is where it was. A launch that the
    card refuses (a block of 2,048 threads) raises."""
    from ground_plane_polling_tpu_torch.kernels import (int8_conv_cuda,
                                                        int8_depthwise_cuda)

    x, s_x, w8, s_w, bias = _dw_operands(cuda, 16, 1, 9, 13, 0)
    x8 = int8_conv_cuda.quantize(x, s_x)
    pad = ((1, 1), (1, 1))
    before = int8_depthwise_cuda.DEPTHWISE_LAUNCHES

    def unaligned(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)[1:]
        return flat.view(1, 9, 13, 16).copy_(
            t.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

    bad = {
        "float input": (x8.float(), w8, s_w, None),
        "nchw input": (x8.contiguous(), w8, s_w, None),
        "unaligned input": (unaligned(x8), w8, s_w, None),
        "grouped, not depthwise": (x8, w8.repeat(1, 2, 1, 1), s_w, None),
        "more outputs than channels": (x8, w8.repeat(2, 1, 1, 1), s_w,
                                       None),
        "5x5 kernel": (x8, torch.zeros(16, 1, 5, 5, dtype=torch.int8,
                                       device=cuda), s_w, None),
        "float64 scales": (x8, w8, s_w.double(), None),
        "bias of another dtype": (x8, w8, s_w, bias.double()),
        "cpu weight": (x8, w8.cpu(), s_w, None),
    }
    for what, (xx, w, s, b) in bad.items():
        with pytest.raises(ValueError):
            int8_depthwise_cuda.depthwise2d(xx, w, s_x, s, b, 1, pad,
                                            torch.float32)
            pytest.fail(what)
    fused_bad = {
        "int8 input": (x8, s_x, s_w),
        "nchw input": (x.contiguous(), s_x, s_w),
        "unaligned input": (unaligned(x), s_x, s_w),
        "s_w of another length": (x, s_x, s_w[:8]),
        "s_w of another dtype": (x, s_x, s_w.double()),
        "no activation scale": (x, 0.0, s_w),
        "stride 3": (x, s_x, s_w),
    }
    for what, (xx, sx, s) in fused_bad.items():
        with pytest.raises(ValueError):
            int8_depthwise_cuda.quantize_depthwise2d(
                xx, sx, w8, s, None, 3 if what == "stride 3" else 1, pad,
                torch.float32)
            pytest.fail(what)
    assert int8_depthwise_cuda.DEPTHWISE_LAUNCHES == before
    with pytest.raises(RuntimeError, match="launch failed"):
        int8_depthwise_cuda._launch(x, s_x, w8, s_w, None, 1, pad,
                                    torch.float32, plan=(8, 16, 128, 8, 16))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_int8_mobilenet_forward_on_the_card_matches_cpu(cuda, tf32_off):
    """A MobileNet trunk (alpha 0.25) in float32 under int8 on the card
    against the CPU on one set of scales: the 13 depthwise sites launch the
    fused depthwise kernel once each and no quantize kernel (the 14 other
    sites one each), and C3, C4, C5 agree within 1e-5 of max|CPU| (the
    float ops between the int8 convs: frozen BN, ReLU6)."""
    from ground_plane_polling_tpu_torch.kernels import (int8_conv_cuda,
                                                        int8_depthwise_cuda)
    from ground_plane_polling_tpu_torch.models import quantize as tq
    from ground_plane_polling_tpu_torch.models.mobilenet import (
        MobileNetBackbone)

    torch.manual_seed(0)
    cpu = MobileNetBackbone(0.25).eval()
    card = MobileNetBackbone(0.25).eval()
    card.load_state_dict(cpu.state_dict())
    card = card.to(cuda).to(memory_format=torch.channels_last)
    x = torch.randn(2, 3, 72, 232) * 50
    scales = tq.collect_scales(cpu, [x])
    with torch.inference_mode():
        want = tq.quantize_apply(cpu, scales)(x)
        before = (int8_depthwise_cuda.DEPTHWISE_LAUNCHES,
                  int8_conv_cuda.QUANTIZE_LAUNCHES)
        got = tq.quantize_apply(card, scales)(x.to(cuda))
        torch.cuda.synchronize()
    assert (int8_depthwise_cuda.DEPTHWISE_LAUNCHES - before[0],
            int8_conv_cuda.QUANTIZE_LAUNCHES - before[1]) == (13, 14)
    for g, w in zip(got, want):
        err = float((g.cpu() - w).abs().max() / w.abs().max())
        assert err <= 1e-5, err


@pytest.mark.gpu
def test_int8_mobilenet_detector_launches(cuda):
    """The int8 forward of a MobileNet detector (alpha 0.25, FPN 64, split
    heads, bf16) launches 13 depthwise, 97 quantize and 97 conv kernels:
    the depthwise sites quantize inside their own launch."""
    from ground_plane_polling_tpu_torch.inference import place_model
    from ground_plane_polling_tpu_torch.kernels import (int8_conv_cuda,
                                                        int8_depthwise_cuda)
    from ground_plane_polling_tpu_torch.models import GPPRetinaNet
    from ground_plane_polling_tpu_torch.models import quantize as tq
    from ground_plane_polling_tpu_torch.models.mobilenet import (
        MobileNetBackbone)

    torch.manual_seed(0)
    net = MobileNetBackbone(0.25)
    model = place_model(GPPRetinaNet(net, backbone_channels=net.channels,
                                     feature_size=64), cuda, torch.bfloat16)
    x = (torch.randn(1, 3, 64, 224) * 50).to(cuda)
    with torch.inference_mode():
        scales = tq.collect_scales(model, [x])
        assert scales.shape == (110,)
        before = (int8_depthwise_cuda.DEPTHWISE_LAUNCHES,
                  int8_conv_cuda.QUANTIZE_LAUNCHES,
                  int8_conv_cuda.CONV_LAUNCHES)
        out = tq.quantize_apply(model, scales)(x)
        torch.cuda.synchronize()
    assert (int8_depthwise_cuda.DEPTHWISE_LAUNCHES - before[0],
            int8_conv_cuda.QUANTIZE_LAUNCHES - before[1],
            int8_conv_cuda.CONV_LAUNCHES - before[2]) == (13, 97, 97)
    assert all(bool(torch.isfinite(v.float()).all()) for v in out.values())


def _detect_args(b, canvas, device, seed=0):
    rng = np.random.RandomState(seed)
    P = np.array([[721.5, 0.0, 609.6, 44.9], [0.0, 721.5, 172.9, 0.2],
                  [0.0, 0.0, 1.0, 0.003]])
    planes = polling_cases.random_case(rng, b, 1, 1000)[-1]
    return (torch.from_numpy(rng.randint(0, 256, (b, *canvas, 3)).astype(
                np.uint8)).to(device),
            torch.from_numpy(np.tile(np.linalg.pinv(P)[None], (b, 1, 1))
                             .astype(np.float32)).to(device),
            torch.from_numpy(np.asarray(planes, np.float32)).to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("orientation_specific", [False, True])
def test_unfused_decode_equals_fused_on_the_card(cuda, tf32_off,
                                                 orientation_specific):
    """make_detect_fn(fused_decode=False) against the fused default on the
    same model and images, float32 at 128x416 with pose: labels and
    orientations equal, scores rtol 1e-6, boxes rtol 1e-4 / atol 1e-3,
    dims 1e-4 (JAX's own bound between its two paths); one polling
    launch a call."""
    from ground_plane_polling_tpu_torch.inference import (make_detect_fn,
                                                          place_model)

    model = place_model(_seeded_detector(), cuda)
    args = _detect_args(2, (128, 416), cuda)
    outs = []
    for fused in (True, False):
        detect = make_detect_fn(model, (128, 416), with_pose=True,
                                device_preprocess=True, fused_decode=fused,
                                orientation_specific=orientation_specific)
        before = polling_cuda.LAUNCHES
        out = detect(*args)
        assert polling_cuda.LAUNCHES == before + 1
        outs.append({k: v.cpu().numpy() for k, v in out._asdict().items()})
    want, got = outs
    assert (want["scores"] > 0).any(axis=1).all()
    for key in ("labels", "orientations"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-6)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got["dims"], want["dims"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [False, True], ids=["split", "fused"])
def test_packed_heads_match_unpacked_on_the_card(cuda, tf32_off, fuse):
    """build_detector(pack_levels=True) against the unpacked model on the
    card, float32 with TF32 off: rtol 1e-3, atol 1e-3 of the largest
    magnitude (as fused against split: a conv over the canvas may sum in
    another order than the per-level convs); the canvas stays
    channels-last."""
    from ground_plane_polling_tpu_torch.inference import place_model
    from ground_plane_polling_tpu_torch.models import build_detector
    from ground_plane_polling_tpu_torch.models import retinanet

    base = _seeded_detector(fuse)
    packed = build_detector("resnet50", fuse_cls_dim=fuse, pack_levels=True)
    packed.load_state_dict(base.state_dict())
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -128, 128, (2, 3, 128, 416)).astype(np.float32)).to(cuda)
    canvases = []
    pack_tail = retinanet._pack_tail

    def spy(features, gap=1):
        out = pack_tail(features, gap)
        canvases.append(out[0])
        return out

    outs = []
    retinanet._pack_tail = spy
    try:
        for net in (base, packed):
            net = place_model(net, cuda)
            with torch.inference_mode():
                outs.append({k: v.cpu().numpy() for k, v in net(x).items()})
    finally:
        retinanet._pack_tail = pack_tail
    assert len(canvases) == 1
    assert canvases[0].is_contiguous(memory_format=torch.channels_last)
    for key, ref in outs[0].items():
        np.testing.assert_allclose(outs[1][key], ref, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(ref).max()),
                                   err_msg=key)


def _nms_inputs(case, device):
    _, boxes, scores, max_out, thr = case
    return (torch.from_numpy(boxes).to(device),
            torch.from_numpy(scores).to(device), max_out, thr)


def _nms_cases():
    from ground_plane_polling_tpu_torch.kernels import nms_cases

    rng = np.random.RandomState(3)
    main = [(f"main_b{b}", *nms_cases.random_case(rng, s=b, k=1024,
                                                  n_valid=900), 100, 0.5)
            for b in (1, 4)]
    return nms_cases.crafted_cases() + main


@pytest.mark.gpu
@pytest.mark.parametrize("case", _nms_cases(), ids=lambda c: c[0])
def test_nms_kernel_matches_plain(cuda, case):
    """The NMS kernel against the plain fixpoint on the card, on the
    crafted cases and at the main path's shapes (K 1024, max_out 100, b1
    and b4): index, valid and score equal in every slot; one launch."""
    from ground_plane_polling_tpu_torch.kernels import nms_cuda
    from ground_plane_polling_tpu_torch.ops import filtering

    args = _nms_inputs(case, cuda)
    before = nms_cuda.NMS_LAUNCHES
    got = nms_cuda.greedy_nms(*args)
    assert nms_cuda.NMS_LAUNCHES == before + 1
    want = filtering.greedy_nms(*args)
    for name, g, w in zip(("idx", "valid", "score"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(),
                                      err_msg=f"{case[0]} {name}")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sets_48", "k_16384",
                                  "kept_past_shared_list"])
def test_nms_kernel_large_cases_match_serial(cuda, name):
    """The NMS kernel against the plain sequential loop on the card: 48
    sets at K 1024, K 16,384 (past the kernel's shared-memory stage, every
    word reached) and max_out 1,500 (kept candidates past the kernel's
    shared list): every slot equal."""
    from ground_plane_polling_tpu_torch.kernels import nms_cases, nms_cuda
    from ground_plane_polling_tpu_torch.ops import filtering

    case, = [c for c in nms_cases.large_cases() if c[0] == name]
    args = _nms_inputs(case, cuda)
    got = nms_cuda.greedy_nms(*args)
    want = filtering.greedy_nms_serial(*args)
    for label, g, w in zip(("idx", "valid", "score"), got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(),
                                      err_msg=f"{name} {label}")


@pytest.mark.gpu
def test_nms_call_is_one_kernel_and_allocates_only_its_outputs(cuda):
    """One NMS call on the card runs one device kernel, and the memory it
    allocates is its three outputs (no bitmask, no scratch)."""
    from torch.profiler import ProfilerActivity, profile

    from ground_plane_polling_tpu_torch.kernels import nms_cases, nms_cuda

    boxes, scores = nms_cases.random_case(np.random.RandomState(5), s=4)
    args = (torch.from_numpy(boxes).to(cuda),
            torch.from_numpy(scores).to(cuda), 100, 0.5)
    nms_cuda.greedy_nms(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a trace may lose its first device events: a spin kernel goes
        # first and is left out
        torch.cuda._sleep(1000)
        out = nms_cuda.greedy_nms(*args)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "spin_kernel" not in e.name]
    assert len(kernels) == 1 and "nms_kernel" in kernels[0], kernels
    outputs = sum(t.numel() * t.element_size() for t in out)
    # the caching allocator rounds each block up to 512 bytes
    assert torch.cuda.max_memory_allocated() - base <= outputs + 3 * 512


def _captured_detector(cuda, b=2, canvas=(128, 416), **kw):
    from ground_plane_polling_tpu_torch.inference import (CapturedDetect,
                                                          make_detect_fn,
                                                          place_model)

    model = place_model(_seeded_detector(), cuda)
    detect = make_detect_fn(model, canvas, with_pose=True,
                            device_preprocess=True, **kw)
    assert isinstance(detect, CapturedDetect)
    return detect, _detect_args(b, canvas, cuda)


def _numpy(out):
    return {k: v.cpu().numpy() for k, v in out._asdict().items()
            if v is not None}


@pytest.mark.gpu
def test_captured_detect_equals_eager(cuda, tf32_off):
    """The captured call against detect.eager on the same inputs, float32
    at 128x416, pose on: every field equal (the same kernels in the same
    order); each replay adds one polling and one NMS launch."""
    from ground_plane_polling_tpu_torch.kernels import nms_cuda

    detect, args = _captured_detector(cuda)
    want = _numpy(detect.eager(*args))
    assert (want["scores"] > 0).any()
    got = _numpy(detect(*args))
    before = polling_cuda.LAUNCHES, nms_cuda.NMS_LAUNCHES
    again = _numpy(detect(*args))
    assert (polling_cuda.LAUNCHES, nms_cuda.NMS_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert len(detect.graphs) == 1
    for out in (got, again):
        for key in want:
            np.testing.assert_array_equal(out[key], want[key], err_msg=key)


@pytest.mark.gpu
def test_captured_replay_makes_no_host_sync(cuda):
    """A replay (inputs already on the card) runs under torch.cuda's sync
    debug mode "error": no operation of the call synchronizes."""
    detect, args = _captured_detector(cuda)
    detect(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = detect(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.scores.shape == (2, 100)


@pytest.mark.gpu
def test_capture_of_a_syncing_model_raises(cuda):
    """A model whose forward calls .item() cannot be captured: the first
    call raises instead of carrying on eagerly, and keeps no graph."""
    from ground_plane_polling_tpu_torch.inference import make_detect_fn

    class Syncing(torch.nn.Module):
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, x):
            out = self.net(x)
            out["classification"].max().item()
            return out

    model = Syncing(_seeded_detector()).to(cuda).eval()
    detect = make_detect_fn(model, (128, 416), with_pose=True,
                            device_preprocess=True)
    args = _detect_args(1, (128, 416), cuda)
    with pytest.raises(RuntimeError):
        detect(*args)
    assert not detect.graphs
    torch.cuda.synchronize()
    assert detect.eager(*args).scores.shape == (1, 100)


@pytest.mark.gpu
def test_captured_calls_in_flight_keep_their_outputs(cuda):
    """The serve pattern: the next batch is dispatched before the last one
    is read. Each call's outputs stay its own: two different batches in a
    row, read after both, equal their eager outputs."""
    detect, args_a = _captured_detector(cuda)
    args_b = _detect_args(2, (128, 416), cuda, seed=1)
    want = [_numpy(detect.eager(*a)) for a in (args_a, args_b)]
    detect(*args_a)  # captures
    outs = [detect(*args_a), detect(*args_b)]
    for got, ref in zip(outs, want):
        got = _numpy(got)
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert not np.array_equal(want[0]["boxes"], want[1]["boxes"])


def _detect_pair(cuda, monkeypatch, b=2, canvas=(128, 416)):
    """Two captured calls of one model, the first built and captured with
    GPP_TRACE unset, the second with GPP_TRACE=1; each has captured its
    graph."""
    from ground_plane_polling_tpu_torch.inference import (make_detect_fn,
                                                          place_model)

    model = place_model(_seeded_detector(), cuda)
    args = _detect_args(b, canvas, cuda)
    pair = []
    for switch in (None, "1"):
        if switch is None:
            monkeypatch.delenv("GPP_TRACE", raising=False)
        else:
            monkeypatch.setenv("GPP_TRACE", switch)
        detect = make_detect_fn(model, canvas, with_pose=True,
                                device_preprocess=True)
        detect(*args)
        pair.append(detect)
    return pair, args


@pytest.mark.gpu
def test_stage_stamps_in_the_captured_call(cuda, tf32_off, monkeypatch):
    """With GPP_TRACE=1 the captured call stamps its stages inside the
    graph: its outputs equal the unstamped graph's bit for bit; the ring's
    counter advances by one a replay, two calls in flight included, with
    no host sync in a replay; every stage reads above 0 ms and the stages
    of the calls sum to no more than their wall time."""
    import time

    from ground_plane_polling_tpu_torch.utils import profiling

    (plain, stamped), args = _detect_pair(cuda, monkeypatch)
    want = _numpy(plain(*args))
    ring = profiling._rings[torch.cuda.current_device()]
    torch.cuda.synchronize()
    before = int(ring[-1])
    start = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [stamped(*args), stamped(*args)]  # the second in flight
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3
    assert int(ring[-1]) == before + 2
    for out in outs:
        got = _numpy(out)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ms = profiling.stage_ms(cuda, last=2)
    assert ms.shape == (2, 4) and (ms > 0).all(), ms
    assert ms.sum() <= wall_ms, (ms, wall_ms)


@pytest.mark.gpu
def test_stamps_are_five_kernels_of_the_graph_and_none_without_the_switch(
        cuda, monkeypatch, tmp_path):
    """The graphs' nodes (cudaGraphDebugDotPrint): captured with GPP_TRACE
    unset, no stamp kernel; with GPP_TRACE=1, the same nodes and five
    stamp kernels more."""
    real = torch.cuda.CUDAGraph

    def debugged():
        graph = real(keep_graph=True)
        graph.enable_debug_mode()
        return graph

    monkeypatch.setattr(torch.cuda, "CUDAGraph", debugged)
    pair, _ = _detect_pair(cuda, monkeypatch, b=1)
    counts = []
    for i, detect in enumerate(pair):
        (g,) = detect.graphs.values()
        path = tmp_path / f"graph{i}.dot"
        g.graph.debug_dump(str(path))
        dot = path.read_text()
        # a node's label opens with its kind; a kernel's names its function
        counts.append((dot.count('label="{'), dot.count('label="{KERNEL'),
                       dot.count("gpp_stage_stamp")))
    (n0, k0, s0), (n1, k1, s1) = counts
    assert s0 == 0 and s1 == 5, counts
    assert (n1 - n0, k1 - k0) == (5, 5), counts


@pytest.mark.gpu
def test_spans_stay_off_the_device_timeline(cuda, monkeypatch):
    """Under torch.profiler a replayed call's spans are host ranges
    (gpp.detect holding inputs, copy_in, replay and copy_out), and no
    device event bears a gpp. name: the device trace holds the call's
    kernels and copies alone."""
    from torch.profiler import ProfilerActivity, profile

    (plain, _), args = _detect_pair(cuda, monkeypatch, b=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        plain(*args)
        torch.cuda.synchronize()
    cuda_type = torch.autograd.DeviceType.CUDA
    host = {e.name for e in prof.events() if e.device_type != cuda_type}
    device = {e.name for e in prof.events() if e.device_type == cuda_type}
    assert {"gpp.detect", "gpp.detect.inputs", "gpp.detect.copy_in",
            "gpp.detect.replay", "gpp.detect.copy_out"} <= host
    assert not any(n.startswith("gpp.") for n in device), device


# --- the captured train step (training/train.py, CapturedTrainStep) -------

@pytest.fixture
def deterministic(cuda):
    """cuDNN's deterministic algorithms, restored after: two runs of the
    same step then sum in the same order."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = was


def _raw_train_batches(n, shape=(64, 224)):
    """n raw batches of _raw_train_batch with augmentation drawn from seeds
    0..n-1, pinned as the loader pins them."""
    from ground_plane_polling_tpu_torch.data.augment import draw_augmentation

    batches = []
    for seed in range(n):
        raw = _raw_train_batch(shape=shape)
        raw.update(draw_augmentation(torch.Generator().manual_seed(seed),
                                     raw["sizes"]))
        batches.append({k: v.pin_memory() for k, v in raw.items()})
    return batches


def _train_states(cuda, n=2, freeze=False, remat=False, model=None):
    """n train states from the same seeded shrunk detector (channels-last,
    as bin/train places it)."""
    from ground_plane_polling_tpu_torch.training.train import (
        create_train_state, make_optimizer)

    states = []
    for _ in range(n):
        net = (model or _shrunk_train_model)(cuda).to(
            memory_format=torch.channels_last)
        net.backbone.remat = remat
        states.append(create_train_state(
            net, make_optimizer(net, 1e-3, freeze_backbone=freeze)))
    return states


def _captured_fused_step(bf16):
    from ground_plane_polling_tpu_torch.training.train import (
        CapturedTrainStep, make_fused_train_step)

    step = make_fused_train_step(num_classes=1, augment=True, bf16=bf16)
    assert isinstance(step, CapturedTrainStep) and step.eager is not step
    return step


def _assert_same_train_state(a, b):
    """Parameters, Adam's moments and step counts, bit for bit."""
    assert a.step == b.step
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()[
        "state"]
    assert sa.keys() == sb.keys()
    for i, s in sa.items():
        for k, v in s.items():
            assert torch.equal(v, sb[i][k]), (i, k)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16,freeze,remat", [
    (False, False, False), (True, False, False), (True, True, True)],
    ids=["float32", "bf16", "bf16_freeze_remat"])
def test_captured_train_step_equals_eager(cuda, tf32_off, deterministic,
                                          bf16, freeze, remat):
    """Three fused steps captured (a warm-up step and capture, then two
    replays) and three of step.eager from the same weights on the same
    batches: metrics, parameters, Adam's moments and step counts bit for
    bit (the same kernels in the same order)."""
    captured, eager = _train_states(cuda, freeze=freeze, remat=remat)
    step = _captured_fused_step(bf16)
    for raw in _raw_train_batches(3):
        captured, got = step(captured, raw)
        eager, want = step.eager(eager, raw)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        for (n, p), q in zip(captured.model.named_parameters(),
                             eager.model.parameters()):
            assert (p.grad is None) == (q.grad is None), n
            assert p.grad is None or torch.equal(p.grad, q.grad), n
    assert len(step.graphs) == 1 and captured.step == 3
    _assert_same_train_state(captured, eager)


@pytest.mark.gpu
def test_captured_train_step_replay_makes_no_host_sync(cuda):
    """A replay of the bf16 fused step (the pinned batch copied in, the
    graph, the metrics copied out) runs under torch.cuda's sync debug mode
    "error": nothing in it waits for the card."""
    state, = _train_states(cuda, n=1)
    step = _captured_fused_step(True)
    raw = _raw_train_batches(1)[0]
    state, _ = step(state, raw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, raw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.step == 2
    assert torch.isfinite(metrics["loss"]).item()


@pytest.mark.gpu
def test_captured_train_step_sees_lr_and_restore(cuda, tf32_off,
                                                 deterministic, tmp_path):
    """After the capture, an lr change and a restore_checkpoint reach the
    graph: the captured state stays bit-equal to an eager state given the
    same lr change and the same checkpoint."""
    from ground_plane_polling_tpu_torch.training.checkpoint import (
        restore_checkpoint, save_checkpoint)

    captured, eager = _train_states(cuda)
    step = _captured_fused_step(False)
    batches = _raw_train_batches(4)
    captured, _ = step(captured, batches[0])
    eager, _ = step.eager(eager, batches[0])
    path = save_checkpoint(str(tmp_path / "ckpt"), eager)
    captured.lr = eager.lr = 2.5e-4
    for raw in batches[1:3]:
        captured, _ = step(captured, raw)
        eager, _ = step.eager(eager, raw)
    _assert_same_train_state(captured, eager)
    captured = restore_checkpoint(path, captured)
    eager = restore_checkpoint(path, eager)
    # the lr as the float32 tensor holds it
    assert captured.step == 1 and captured.lr == float(np.float32(1e-3))
    for raw in batches[2:]:
        captured, _ = step(captured, raw)
        eager, _ = step.eager(eager, raw)
    assert len(step.graphs) == 1
    _assert_same_train_state(captured, eager)


@pytest.mark.gpu
def test_captured_train_step_second_shape(cuda, tf32_off, deterministic):
    """A batch of another canvas shape captures a second graph; the first
    graph still replays its shape as the eager step runs it."""
    captured, eager = _train_states(cuda)
    step = _captured_fused_step(False)
    small, large = (_raw_train_batches(2, shape) for shape in
                    ((64, 224), (96, 256)))
    for raw in (small[0], large[0], small[1], large[1]):
        captured, got = step(captured, raw)
        eager, want = step.eager(eager, raw)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert len(step.graphs) == 2 and captured.step == 4
    _assert_same_train_state(captured, eager)


@pytest.mark.gpu
def test_capture_of_a_syncing_train_step_raises(cuda):
    """A model whose forward calls .item() cannot be captured: each first
    call raises after its warm-up step instead of carrying on eagerly, and
    keeps no graph; the card stays usable."""
    class Syncing(torch.nn.Module):
        def __init__(self, net):
            super().__init__()
            self.net = net
            self.backbone = net.backbone

        def forward(self, x):
            out = self.net(x)
            out["classification"].max().item()
            return out

    state, = _train_states(cuda, n=1,
                           model=lambda d: Syncing(_shrunk_train_model(d)))
    step = _captured_fused_step(False)
    raw = _raw_train_batches(1)[0]
    for calls in (1, 2):
        with pytest.raises(RuntimeError):
            step(state, raw)
        assert not step.graphs and state.step == calls
    torch.cuda.synchronize()
    state, metrics = step.eager(state, raw)
    assert state.step == 3 and torch.isfinite(metrics["loss"]).item()


# --- the captured mesh paths (CapturedTrainStep, CapturedDetect with a mesh)

def _captured_ddp_step(mesh, bf16):
    from ground_plane_polling_tpu_torch.training.train import (
        CapturedTrainStep, make_fused_train_step)

    step = make_fused_train_step(num_classes=1, augment=True, bf16=bf16,
                                 mesh=mesh)
    assert isinstance(step, CapturedTrainStep) and step.eager is not step
    return step


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_captured_ddp_step_equals_eager(nccl_mesh, tf32_off, deterministic,
                                        bf16):
    """The DDP step over the 1-rank NCCL group, captured, against
    step.eager from the same weights on the same batches: DDP_WARMUP eager
    steps on the side stream (the last followed by the capture), then
    three replays; metrics and every .grad bit for bit at each step, and
    the parameters, Adam's moments and step counts after."""
    from ground_plane_polling_tpu_torch.training.train import DDP_WARMUP

    captured, eager = _train_states(nccl_mesh.device)
    step = _captured_ddp_step(nccl_mesh, bf16)
    for i, raw in enumerate(_raw_train_batches(DDP_WARMUP + 3)):
        captured, got = step(captured, raw)
        eager, want = step.eager(eager, raw)
        assert len(step.graphs) == (i + 1 >= DDP_WARMUP), i
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
        for (n, p), q in zip(captured.model.named_parameters(),
                             eager.model.parameters()):
            assert (p.grad is None) == (q.grad is None), n
            assert p.grad is None or torch.equal(p.grad, q.grad), (i, n)
    assert captured.step == DDP_WARMUP + 3
    _assert_same_train_state(captured, eager)


@pytest.mark.gpu
def test_captured_ddp_replay_makes_no_host_sync(nccl_mesh):
    """A replay of the captured DDP bf16 step (its all-reduces inside the
    graph) under torch.cuda's sync debug mode "error"."""
    from ground_plane_polling_tpu_torch.training.train import DDP_WARMUP

    state, = _train_states(nccl_mesh.device, n=1)
    step = _captured_ddp_step(nccl_mesh, True)
    raw = _raw_train_batches(1)[0]
    for _ in range(DDP_WARMUP):
        state, _ = step(state, raw)
    assert len(step.graphs) == 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, raw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.step == DDP_WARMUP + 1
    assert torch.isfinite(metrics["loss"]).item()


@pytest.mark.gpu
def test_captured_ddp_step_sees_lr_and_restore(nccl_mesh, tf32_off,
                                               deterministic, tmp_path):
    """After the capture of the DDP step, an lr change and a
    restore_checkpoint reach the graph; a batch of a second canvas shape
    takes one eager step and a second capture. The captured state stays
    bit-equal to an eager state given the same."""
    from ground_plane_polling_tpu_torch.training.checkpoint import (
        restore_checkpoint, save_checkpoint)
    from ground_plane_polling_tpu_torch.training.train import DDP_WARMUP

    captured, eager = _train_states(nccl_mesh.device)
    step = _captured_ddp_step(nccl_mesh, False)
    batches = _raw_train_batches(DDP_WARMUP + 3)
    path = None
    for raw in batches[:DDP_WARMUP + 1]:
        captured, _ = step(captured, raw)
        eager, _ = step.eager(eager, raw)
        if eager.step == 2:
            path = save_checkpoint(str(tmp_path / "ckpt"), eager)
    assert len(step.graphs) == 1
    captured.lr = eager.lr = 2.5e-4
    for raw in batches[DDP_WARMUP + 1:]:
        captured, _ = step(captured, raw)
        eager, _ = step.eager(eager, raw)
    _assert_same_train_state(captured, eager)
    captured = restore_checkpoint(path, captured)
    eager = restore_checkpoint(path, eager)
    assert captured.step == 2
    other = _raw_train_batches(2, (96, 256))
    for raw in (batches[0], other[0], other[1], batches[1]):
        captured, got = step(captured, raw)
        eager, want = step.eager(eager, raw)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert len(step.graphs) == 2
    _assert_same_train_state(captured, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("shard_spatial", [False, True],
                         ids=["data_parallel", "shard_spatial"])
def test_captured_mesh_detect_equals_eager(nccl_mesh, tf32_off,
                                           shard_spatial):
    """make_detect_fn(mesh=...) over the 1-rank NCCL group is captured, its
    collectives inside the graph: float32 at 128x416, pose on, every field
    equal to detect.eager's; each replay adds one polling and one NMS
    launch and makes no host sync; detect.spatial holds the capture's
    conv windows."""
    from ground_plane_polling_tpu_torch.inference import (CapturedDetect,
                                                          make_detect_fn,
                                                          place_model)
    from ground_plane_polling_tpu_torch.kernels import nms_cuda

    model = place_model(_seeded_detector(), nccl_mesh.device)
    detect = make_detect_fn(model, (128, 416), with_pose=True,
                            device_preprocess=True, mesh=nccl_mesh,
                            shard_spatial=shard_spatial)
    assert isinstance(detect, CapturedDetect) and detect.eager is not detect
    args = _detect_args(2, (128, 416), nccl_mesh.device)
    want = _numpy(detect.eager(*args))
    assert (want["scores"] > 0).any()
    got = _numpy(detect(*args))
    before = polling_cuda.LAUNCHES, nms_cuda.NMS_LAUNCHES
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = detect(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (polling_cuda.LAUNCHES, nms_cuda.NMS_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert len(detect.graphs) == 1
    for out in (got, _numpy(again)):
        for key in want:
            np.testing.assert_array_equal(out[key], want[key], err_msg=key)
    assert (detect.spatial is not None) is shard_spatial
    if shard_spatial:
        assert detect.spatial.last.windows


@pytest.mark.gpu
def test_gloo_mesh_on_the_card_stays_eager(nccl_mesh):
    """A gloo group on the card (as two ranks sharing one card use): the
    train steps and the detect calls stay eager, and the eager call runs
    its gloo collective."""
    import torch.distributed as dist

    from ground_plane_polling_tpu_torch.inference import (make_detect_fn,
                                                          place_model)
    from ground_plane_polling_tpu_torch.parallel import data_parallel_mesh
    from ground_plane_polling_tpu_torch.training.train import (
        make_fused_train_step, make_sharded_train_step, make_train_step)

    group = dist.new_group(backend="gloo")
    try:
        mesh = data_parallel_mesh(group=group)
        assert mesh.device.type == "cuda"
        for step in (make_train_step(mesh=mesh),
                     make_sharded_train_step(mesh),
                     make_fused_train_step(num_classes=1, mesh=mesh)):
            assert step.eager is step
        model = place_model(_seeded_detector(), mesh.device)
        args = _detect_args(2, (128, 416), mesh.device)
        for shard_spatial in (False, True):
            detect = make_detect_fn(model, (128, 416), with_pose=True,
                                    device_preprocess=True, mesh=mesh,
                                    shard_spatial=shard_spatial)
            assert detect.eager is detect
            assert detect(*args).scores.shape == (2, 100)
    finally:
        dist.destroy_process_group(group)


@pytest.mark.gpu
def test_released_mesh_paths_capture_anew(nccl_mesh, tf32_off,
                                          deterministic):
    """release() of the captured DDP step and of the captured data-parallel
    detect call frees their graphs; the next call captures anew (the step
    with one eager step first, as a new signature) and stays bit-equal to
    the eager state and call."""
    from ground_plane_polling_tpu_torch.inference import (make_detect_fn,
                                                          place_model)
    from ground_plane_polling_tpu_torch.training.train import DDP_WARMUP

    captured, eager = _train_states(nccl_mesh.device)
    step = _captured_ddp_step(nccl_mesh, False)
    batches = _raw_train_batches(DDP_WARMUP + 2)
    for i, raw in enumerate(batches):
        if i == DDP_WARMUP:
            assert len(step.graphs) == 1
            step.release()
            assert not step.graphs
        captured, _ = step(captured, raw)
        eager, _ = step.eager(eager, raw)
    assert len(step.graphs) == 1
    _assert_same_train_state(captured, eager)

    model = place_model(_seeded_detector(), nccl_mesh.device)
    detect = make_detect_fn(model, (128, 416), with_pose=True,
                            device_preprocess=True, mesh=nccl_mesh)
    args = _detect_args(2, (128, 416), nccl_mesh.device)
    want = _numpy(detect.eager(*args))
    detect(*args)
    detect.release()
    assert not detect.graphs
    got = _numpy(detect(*args))
    assert len(detect.graphs) == 1
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
