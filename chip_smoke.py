#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ground_plane_polling_tpu_torch) on one
CUDA card: the quickest proof that the port builds, agrees with its plain
PyTorch versions and runs its main path end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  0. environment: a CUDA card, its name and power limit; build the polling
     kernel from csrc/ and print the build time and nvcc's register report;
  1. the polling kernel against its twin on the card, at (B, D, P) =
     (1, 100, 1024), (4, 100, 21634), (2, 5, 13) and on the crafted edge
     cases; timed at (4, 100, 21634) with CUDA events;
  2. the main path at full width: ResNet-50, FPN 512, seeded weights, bf16,
     a 416x1344 canvas, 21,634 synthetic planes, pose on, at batch 1 and 4;
     then float32 with TF32 off at 128x416, card against CPU;
  3. the run_network CLI on 4 synthetic 375x1242 frames at --batch 1 and
     --batch 4 (float32, TF32 off): one KITTI txt per frame, equal outputs;
  4. serve: --once --no-bf16 --batch-size 2 over phase 3's frames, whose
     txts must hold phase 3's --batch 1 txts; then bf16 at full width over
     256 frames at --batch-size 2 and 4, with serve's own img/s (the cold
     first round apart) and p50/p95 batch latency over all batches; then
     what the one batch in flight buys over serial read-back;
  5. fused towers: split and fused heads at 416x1344 in float32 with TF32
     off, then the bf16 detect call timed split and fused at b1 and b4,
     and the bf16 forward alone with CUDA events;
  6. evaluate on a 4-frame prepared split written here (labels from the
     detections): --eval-batch 1, --eval-batch 4 and --fuse-towers give
     equal mAP and errors.
Phases 4-6 each drive their path with the polling kernel's launch count
set to 0 and fail if the kernel was not launched.

Prints the kernel table as one JSON line, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
CANVAS = (416, 1344)
N_PLANES = 21634
# tolerances of the polling comparison (the CPU tests' own)
RES_TOL = 1e-4
PLANE_RTOL, PLANE_ATOL = 1e-5, 1e-6
KP_TOL = 1e-3
# KITTI P2 of the synthetic frames (a 1242 x 375 camera)
P2 = np.array([[721.5, 0.0, 609.6, 44.9],
               [0.0, 721.5, 172.9, 0.2],
               [0.0, 0.0, 1.0, 0.003]])


def log(msg):
    print(msg, flush=True)


def synthetic_planes(rng, n):
    """Road planes drawn like bench.py's synthetic database."""
    return np.stack([rng.uniform(-0.05, 0.05, n), np.ones(n),
                     rng.uniform(-0.05, 0.05, n),
                     rng.uniform(-2.5, -1.0, n)], axis=1).astype(np.float32)


def cuda_ms(fn, calls=25, warmup=5):
    """Median milliseconds of one call of fn(), CUDA events around each of
    `calls` calls, after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def compare_poll(got, ref, label):
    """Kernel vs twin: residuals, keyplanes, keypoints within the stated
    tolerances; where the winning plane differs, both residuals must lie
    within RES_TOL (a near tie). Returns the max abs error of the rows that
    agree on the plane."""
    kp, kpl, res = (np.asarray(t.float().cpu()) for t in got)
    rkp, rkpl, rres = (np.asarray(t.float().cpu()) for t in ref)
    same = np.isclose(kpl, rkpl, rtol=PLANE_RTOL, atol=PLANE_ATOL,
                      equal_nan=True).all(axis=(-2, -1))
    n_diff = int((~same).sum())
    np.testing.assert_allclose(res, rres, rtol=RES_TOL, atol=RES_TOL,
                               err_msg=f"{label} residuals")
    np.testing.assert_allclose(kp[same], rkp[same], rtol=KP_TOL, atol=KP_TOL,
                               err_msg=f"{label} keypoints")
    err = 0.0
    for a, b in ((res, rres), (kpl, rkpl), (kp, rkp)):
        a, b = a[same], b[same]
        diff = np.where(np.isnan(a) & np.isnan(b), 0.0, np.abs(a - b))
        err = max(err, float(diff.max()) if diff.size else 0.0)
    log(f"  {label}: max |kernel - twin| {err:.3e}, rows on another plane "
        f"(near ties) {n_diff} of {same.size}")
    return err


def phase1_kernel(torch, polling_cuda, twin, polling_cases):
    log("phase 1: polling kernel against its twin on the card")
    dev = torch.device("cuda")

    def run(args):
        t = [torch.from_numpy(np.asarray(a)).to(dev) for a in args]
        got = polling_cuda.fit_road_planes(*t)
        ref = twin.fit_road_planes(*t)
        torch.cuda.synchronize()
        return got, ref, t

    result = {}
    for shape in ((1, 100, 1024), (4, 100, 21634), (2, 5, 13)):
        args = polling_cases.random_case(np.random.RandomState(SEED), *shape)
        got, ref, t = run(args)
        err = compare_poll(got, ref, f"random {shape}")
        if shape == (4, 100, 21634):
            result["max_abs_err"] = err
            result["ms"] = cuda_ms(lambda: polling_cuda.fit_road_planes(*t))
            result["plain_ms"] = cuda_ms(lambda: twin.fit_road_planes(*t))
            inputs = (twin.rays_from_boxes(t[0], t[3]),
                      twin.expected_distances(t[1], t[2]),
                      twin.normalize_planes(t[4]))
            launch_ms = cuda_ms(lambda: polling_cuda._launch(*inputs))
            log(f"  (4, 100, 21634): kernel wrapper {result['ms']:.4f} ms, "
                f"twin {result['plain_ms']:.4f} ms, kernel launch alone "
                f"(inputs prepared) {launch_ms:.4f} ms; median of 25 calls, "
                "CUDA events around each, after 5 warm-up calls")
    for name, args, want in polling_cases.crafted_cases():
        got, ref, _ = run(args)
        if want is None:  # padded rows: real rows compared, all rows finite
            got, ref = [g[:, :2] for g in got], [r[:, :2] for r in ref]
        compare_poll(got, ref, f"crafted {name}")
    return result


def full_width_model(torch, seed, cls_std=0.05):
    """ResNet-50 detector, FPN 512, seeded init, and the classification out
    kernel redrawn from N(0, cls_std) with a zero bias so that random
    weights give detections above the 0.05 threshold."""
    from ground_plane_polling_tpu_torch.models import (build_detector,
                                                       init_detector)

    model = init_detector(build_detector("resnet50"), seed)
    out = model.classification.cls_out
    w = np.random.RandomState(seed).normal(0.0, cls_std, out.weight.shape)
    with torch.no_grad():
        out.weight.copy_(torch.from_numpy(w.astype(np.float32)))
        out.bias.zero_()
    return model


def phase2_main_path(torch, polling_cuda):
    from ground_plane_polling_tpu_torch.inference import (make_detect_fn,
                                                          place_model)

    log("phase 2: main path, ResNet-50 bf16, canvas 416x1344, "
        f"{N_PLANES} planes, pose on")
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)
    model = place_model(full_width_model(torch, SEED), dev, torch.bfloat16)
    planes = synthetic_planes(rng, N_PLANES)
    P_inv = np.linalg.pinv(P2).astype(np.float32)
    runs = {}
    for b in (1, 4):
        detect = make_detect_fn(model, CANVAS, with_pose=True,
                                device_preprocess=True, device=dev)
        images = torch.from_numpy(
            rng.randint(0, 256, (b, *CANVAS, 3)).astype(np.uint8)).to(dev)
        P_inv_b = torch.from_numpy(np.tile(P_inv[None], (b, 1, 1))).to(dev)
        planes_b = torch.from_numpy(np.tile(planes[None], (b, 1, 1))).to(dev)
        for _ in range(3):  # warm-up: cuDNN plans, allocator
            detect(images, P_inv_b, planes_b)
        torch.cuda.synchronize()
        runs[b] = (detect, images, P_inv_b, planes_b)

    polling_cuda.LAUNCHES = 0  # count only the main path's own launches
    timings = {}
    n_iter = 10
    for b, (detect, images, P_inv_b, planes_b) in runs.items():
        t0 = time.perf_counter()
        for _ in range(n_iter):
            out = detect(images, P_inv_b, planes_b)
        torch.cuda.synchronize()
        timings[b] = (time.perf_counter() - t0) / n_iter
        m = 100
        assert out.boxes.shape == (b, m, 12) and out.dims.shape == (b, m, 3)
        assert out.keypoints.shape == (b, m, 4, 3)
        assert out.keyplanes.shape == (b, m, 1, 4)
        for f in ("scores", "labels", "orientations", "residuals"):
            assert getattr(out, f).shape == (b, m), f
        for f in ("locations", "angles", "pose_dims"):
            assert getattr(out, f).shape == (b, m, 3), f
        scores = out.scores.float().cpu().numpy()
        assert np.isfinite(scores).all(), "non-finite scores"
        n_valid = (scores > 0).sum(axis=1)
        assert (n_valid >= 1).all(), f"no detection at b{b}: {n_valid}"
        log(f"  b{b}: {timings[b] * 1e3:.3f} ms per call, "
            f"{b / timings[b]:.2f} img/s (host clock over {n_iter} calls, "
            f"synchronized), valid detections per image {n_valid.tolist()}")
    launches = polling_cuda.LAUNCHES
    assert launches == 2 * n_iter, f"polling kernel launched {launches} times"
    log(f"  polling kernel launches in the main path: {launches}")

    log("phase 2b: float32, TF32 off, canvas 128x416: card against CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = rng.randint(0, 256, (1, 128, 416, 3)).astype(np.float32) - np.array(
        [103.939, 116.779, 123.68], np.float32)
    x = torch.from_numpy(x).permute(0, 3, 1, 2)
    heads = {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        net = place_model(full_width_model(torch, SEED), device,
                          torch.float32)
        with torch.inference_mode():
            heads[name] = {k: v.cpu().numpy() for k, v in
                           net(x.to(device)).items()}
    for k, ref in heads["cpu"].items():
        got = heads["cuda"][k]
        atol = 1e-3 * float(np.abs(ref).max())
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=atol,
                                   err_msg=f"f32 head {k}")
        log(f"  {k}: max |card - cpu| {np.abs(got - ref).max():.3e} "
            f"(rtol 1e-3, atol 1e-3 * max|cpu| = {atol:.3e})")
    return launches, timings


def phase3_cli(torch, tmp):
    from PIL import Image

    from ground_plane_polling_tpu_torch.bin import run_network
    from ground_plane_polling_tpu_torch.data.planes import save_plane_database
    from ground_plane_polling_tpu_torch.models import export_jax_params
    import scipy.io

    log("phase 3: run_network --kitti, 4 frames 375x1242, batch 1 and 4")
    rng = np.random.RandomState(SEED + 1)
    img_dir, cal_dir = os.path.join(tmp, "images"), os.path.join(tmp, "calibs")
    os.makedirs(img_dir)
    os.makedirs(cal_dir)
    calib = "".join(
        f"P{i}: " + " ".join(f"{v:.12e}" for v in
                             (P2 if i == 2 else np.zeros((3, 4))).ravel())
        + "\n" for i in range(4))
    base = rng.randint(0, 256, (375, 1242, 3)).astype(np.uint8)
    for i in range(4):
        frame = np.roll(base, 97 * i, axis=1) if i else base
        Image.fromarray(frame).save(os.path.join(img_dir, f"{i:06d}.png"))
        with open(os.path.join(cal_dir, f"{i:06d}.txt"), "w") as f:
            f.write(calib)
    planes_path = os.path.join(tmp, "planes.mat")
    save_plane_database(planes_path, synthetic_planes(rng, N_PLANES))
    weights = os.path.join(tmp, "model.npz")
    np.savez(weights, **export_jax_params(full_width_model(torch, SEED)))
    with open(weights + ".json", "w") as f:
        json.dump({"backbone": "resnet50", "num_classes": 1}, f)

    mats = {}
    for b in (1, 4):
        out = os.path.join(tmp, f"out_b{b}")
        t0 = time.perf_counter()
        run_network.main([weights, img_dir, cal_dir, planes_path, out,
                          "--kitti", "--no-bf16", "--batch", str(b),
                          "--device", "cuda"])
        log(f"  --batch {b}: {time.perf_counter() - t0:.2f} s wall "
            "(weights load, frame IO and first-call set-up included)")
        kdir = os.path.join(out, "model", "outputs", "kitti")
        mdir = os.path.join(out, "model", "outputs", "full")
        names = sorted(os.listdir(kdir))
        assert names == [f"{i:06d}.txt" for i in range(4)], names
        mats[b] = {}
        for n in names:
            rows = open(os.path.join(kdir, n)).read().splitlines()
            mats[b][n] = (rows, scipy.io.loadmat(
                os.path.join(mdir, n.replace(".txt", ".mat"))))
    for n, (rows1, m1) in mats[1].items():
        rows4, m4 = mats[4][n]
        assert len(rows1) == len(rows4) > 0, (n, len(rows1), len(rows4))
        assert [r.split()[0] for r in rows1] == [r.split()[0] for r in rows4]
        np.testing.assert_array_equal(m1["labels"], m4["labels"])
        np.testing.assert_allclose(m1["scores"], m4["scores"], atol=1e-6,
                                   rtol=0, err_msg=f"{n} scores")
        for key, atol, rtol in (("boxes", 2e-3, 0), ("keypoints", 2e-3, 0),
                                ("residuals", 1e-3, 0), ("angles", 2e-2, 0),
                                ("keypoints3d", 0.5, 2e-3),
                                ("locations", 0.5, 2e-3),
                                ("dimensions", 0.5, 2e-3)):
            np.testing.assert_allclose(m1[key], m4[key], atol=atol, rtol=rtol,
                                       err_msg=f"{n} {key}")
        log(f"  {n}: {len(rows1)} rows, batch 1 == batch 4 within the "
            "tolerances")
    return {"images": img_dir, "calibs": cal_dir, "planes": planes_path,
            "weights": weights, "base": base,
            "kitti_b1": os.path.join(tmp, "out_b1", "model", "outputs",
                                     "kitti")}


TXT_ROUND = 0.01 + 1e-6  # one unit of the KITTI txt's last printed digit
SERVE_FRAMES = 256  # frames per serve run of phase 4b


def _txt_rows(directory):
    return {n: [r.split() for r in
                open(os.path.join(directory, n)).read().splitlines()]
            for n in sorted(os.listdir(directory))}


def compare_txts(got_dir, want_dir, label):
    """KITTI txts against a reference run, with phase 3's tolerances carried
    to the txt fields: types equal; 2D box and score within the txt's
    rounding; w, l, X, Z within 0.5 + 2e-3 |b|; ry and alpha within 2e-2
    (mod 2 pi); the height and Y, which the writer recomputes from the
    rotated corners, also within the 2e-2 angle gap times the box's
    h + w + l. Each plus the rounding."""
    got, want = _txt_rows(got_dir), _txt_rows(want_dir)
    assert sorted(got) == sorted(want), (label, sorted(got), sorted(want))
    for name, rows in want.items():
        assert len(got[name]) == len(rows) > 0, (label, name)
        assert [r[0] for r in got[name]] == [r[0] for r in rows], name
        g = np.array([r[1:] for r in got[name]], float)
        w = np.array([r[1:] for r in rows], float)
        # after the type: trunc occ alpha x1 y1 x2 y2 h w l X Y Z ry score
        np.testing.assert_allclose(g[:, [3, 4, 5, 6, 14]],
                                   w[:, [3, 4, 5, 6, 14]], rtol=0,
                                   atol=TXT_ROUND,
                                   err_msg=f"{label} {name} 2D, score")
        tol = 0.5 + 2e-3 * np.abs(w[:, 7:13]) + TXT_ROUND
        tol[:, [0, 4]] += 2e-2 * np.abs(w[:, 7:10]).sum(axis=1)[:, None]
        gap = np.abs(g[:, 7:13] - w[:, 7:13])
        assert (gap <= tol).all(), (label, name, float((gap - tol).max()))
        ang = np.abs((g[:, [2, 13]] - w[:, [2, 13]] + np.pi) % (2 * np.pi)
                     - np.pi)
        assert (ang <= 2e-2 + TXT_ROUND).all(), (label, name,
                                                 float(ang.max()))
    log(f"  {label}: {len(want)} txts, {sum(map(len, want.values()))} rows "
        "equal within the tolerances")


def write_frames(tmp, name, frames):
    """Frames as PNGs with the P2 calibration; returns (image dir, calib
    dir)."""
    from PIL import Image

    img_dir, cal_dir = (os.path.join(tmp, name, d) for d in ("images",
                                                             "calibs"))
    os.makedirs(img_dir)
    os.makedirs(cal_dir)
    calib = "".join(
        f"P{i}: " + " ".join(f"{v:.12e}" for v in
                             (P2 if i == 2 else np.zeros((3, 4))).ravel())
        + "\n" for i in range(4))
    for i, frame in enumerate(frames):
        Image.fromarray(frame).save(os.path.join(img_dir, f"{i:06d}.png"))
        with open(os.path.join(cal_dir, f"{i:06d}.txt"), "w") as f:
            f.write(calib)
    return img_dir, cal_dir


def run_serve(serve, polling_cuda, argv):
    """serve.main with the polling kernel's count set to 0 just before;
    returns (images served, kernel launches, serve's stdout lines). Logs
    serve's first round and its final line."""
    polling_cuda.LAUNCHES = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        total = serve.main(argv)
    launches = polling_cuda.LAUNCHES
    lines = buf.getvalue().splitlines()
    for line in lines[:1] + lines[-1:]:
        log(f"    serve: {line}")
    assert launches > 0, "serve did not launch the polling kernel"
    return total, launches, lines


def serve_figures(lines):
    """serve's own figures from its stdout: the first (cold) round's img/s,
    the median img/s of the later rounds, the whole window's img/s (decode
    and first-call set-up included) and the batch latency p50 / p95 over
    all batches."""
    import re

    rounds = [float(re.search(r"\(([\d.]+) img/s\)", ln).group(1))
              for ln in lines if ln.startswith("served ")]
    done = re.match(r"done: (\d+) images in ([\d.]+)s; batch latency p50 "
                    r"(\d+) ms / p95 (\d+) ms \(n=(\d+)\)", lines[-1])
    n, sec, p50, p95, n_lat = done.groups()
    return {"rounds": len(rounds), "cold": rounds[0],
            "warm_median": float(np.median(rounds[1:])),
            "window": int(n) / float(sec), "p50": int(p50), "p95": int(p95),
            "n_batches": int(n_lat)}


def phase4_serve(torch, polling_cuda, tmp, cli):
    from ground_plane_polling_tpu_torch.bin import serve

    t_phase = time.perf_counter()
    log("phase 4: serve --once --no-bf16 --batch-size 2 over phase 3's "
        "frames, against phase 3's --batch 1 txts")
    out = os.path.join(tmp, "serve_f32")
    total, launches, _ = run_serve(serve, polling_cuda, [
        cli["weights"], cli["images"], cli["calibs"], cli["planes"], out,
        "--once", "--no-bf16", "--batch-size", "2", "--device", "cuda"])
    assert total == 4, total
    log(f"  polling kernel launches: {launches} (2 batches of 2)")
    compare_txts(out, cli["kitti_b1"], "serve b2 vs run_network b1")

    log("phase 4b: serve bf16, ResNet-50, FPN 512, "
        f"{SERVE_FRAMES} frames 375x1242, {N_PLANES} planes, --batch-size 2 "
        "and 4")
    rng = np.random.RandomState(SEED + 4)
    frames = [np.roll(cli["base"], int(rng.randint(1, 1242)), axis=1)
              for _ in range(16)]
    img_dir, cal_dir = write_frames(tmp, "frames_serve", frames)
    # the 16 distinct frames under SERVE_FRAMES stems: every stem is still
    # listed, decoded, detected and written on its own
    for i in range(16, SERVE_FRAMES):
        for d, ext in ((img_dir, ".png"), (cal_dir, ".txt")):
            os.link(os.path.join(d, f"{i % 16:06d}{ext}"),
                    os.path.join(d, f"{i:06d}{ext}"))
    stats = []
    for run, b in enumerate((2, 4, 4, 2)):  # in turns: the spread shows
        out = os.path.join(tmp, f"serve_bf16_{run}")
        t0 = time.perf_counter()
        total, launches, lines = run_serve(serve, polling_cuda, [
            cli["weights"], img_dir, cal_dir, cli["planes"], out, "--once",
            "--batch-size", str(b), "--device", "cuda"])
        wall = time.perf_counter() - t0
        assert total == SERVE_FRAMES, total
        assert launches == SERVE_FRAMES // b, launches
        assert len(os.listdir(out)) == SERVE_FRAMES
        fig = serve_figures(lines)
        assert fig["n_batches"] == SERVE_FRAMES // b, fig
        stats.append((b, fig))
        log(f"  --batch-size {b}: {fig['rounds']} rounds; img/s cold first "
            f"round {fig['cold']}, later rounds median "
            f"{fig['warm_median']}, whole window {fig['window']:.2f} (decode "
            f"and set-up included); batch latency p50 {fig['p50']} ms / p95 "
            f"{fig['p95']} ms over all {fig['n_batches']} batches; "
            f"{wall:.2f} s wall with weights load, {launches} polling "
            "launches")
    overlap = phase4c_overlap(torch, polling_cuda, cli)
    log(f"  phase 4 wall: {time.perf_counter() - t_phase:.2f} s")
    return stats, overlap


def phase4c_overlap(torch, polling_cuda, cli, n_batches=8, b=2):
    """How much serve's one-batch-in-flight order buys: n_batches bf16
    detect calls at b2 with each read back at once (serial), or read back
    after the next batch is dispatched (serve's order). The filter's NMS
    reads a flag back once per round, so a dispatch returns only after
    the trunk and the filter have run on the card."""
    from ground_plane_polling_tpu_torch.inference import (make_detect_fn,
                                                          place_model)

    log(f"phase 4c: one batch in flight against serial, bf16 b{b}, "
        f"{n_batches} batches")
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 7)
    model = place_model(full_width_model(torch, SEED), dev, torch.bfloat16)
    detect = make_detect_fn(model, CANVAS, with_pose=True,
                            device_preprocess=True, device=dev)
    images = [torch.from_numpy(rng.randint(0, 256, (b, *CANVAS, 3)).astype(
        np.uint8)).to(dev) for _ in range(n_batches)]
    P_inv = torch.from_numpy(np.tile(np.linalg.pinv(P2).astype(
        np.float32)[None], (b, 1, 1))).to(dev)
    planes = torch.from_numpy(np.tile(synthetic_planes(
        rng, N_PLANES)[None], (b, 1, 1))).to(dev)

    def fetch(out):
        return {k: v.cpu() for k, v in out._asdict().items()
                if v is not None}

    def serial():
        for im in images:
            fetch(detect(im, P_inv, planes))

    def in_flight():
        pending = None
        for im in images:
            out = detect(im, P_inv, planes)
            if pending is not None:
                fetch(pending)
            pending = out
        fetch(pending)

    dispatch = []
    for im in images:  # warm-up, and the host time of one dispatch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = detect(im, P_inv, planes)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        dispatch.append((t1 - t0, time.perf_counter() - t0))
    polling_cuda.LAUNCHES = 0
    result = {}
    for name, fn in (("serial", serial), ("in_flight", in_flight),
                     ("in_flight_2", in_flight), ("serial_2", serial)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        result[name] = (time.perf_counter() - t0) / n_batches
    assert polling_cuda.LAUNCHES == 4 * n_batches, polling_cuda.LAUNCHES
    d = np.median(np.asarray(dispatch), axis=0)
    log(f"  one detect call: returns after {d[0] * 1e3:.3f} ms, done after "
        f"{d[1] * 1e3:.3f} ms (median of {n_batches}, synchronized)")
    log("  ms per batch, serial / in flight / in flight / serial: "
        + " / ".join(f"{v * 1e3:.3f}" for v in result.values())
        + " (host clock, read-back included, run in that order)")
    return result


def timed_detect(torch, detect, args, n_iter=10):
    """Seconds per call: host clock over n_iter synchronized calls, after 3
    warm-up calls (phase 2's method)."""
    for _ in range(3):
        detect(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = detect(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n_iter, out


def phase5_fused(torch, polling_cuda):
    from ground_plane_polling_tpu_torch.inference import (make_detect_fn,
                                                          place_model)
    from ground_plane_polling_tpu_torch.models import (build_detector,
                                                       fuse_detector_params)

    t_phase = time.perf_counter()
    log("phase 5: fused towers, float32 with TF32 off at "
        f"{CANVAS[0]}x{CANVAS[1]}: split against fused heads")
    dev = torch.device("cuda")
    split = full_width_model(torch, SEED)
    fused = build_detector("resnet50", fuse_cls_dim=True)
    fused.load_state_dict(fuse_detector_params(split.state_dict()))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(SEED + 5)
    x = torch.from_numpy(rng.uniform(-128, 128, (1, 3, *CANVAS)).astype(
        np.float32)).to(dev)
    heads = {}
    for name, net in (("split", split), ("fused", fused)):
        net = place_model(net, dev, torch.float32)
        with torch.inference_mode():
            heads[name] = {k: v.cpu().numpy() for k, v in net(x).items()}
    for k, ref in heads["split"].items():
        got = heads["fused"][k]
        atol = 1e-3 * float(np.abs(ref).max())
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=atol,
                                   err_msg=f"fused head {k}")
        log(f"  {k}: max |fused - split| {np.abs(got - ref).max():.3e} "
            f"(rtol 1e-3, atol 1e-3 * max|split| = {atol:.3e})")

    log("phase 5b: bf16 detect call, split and fused, b1 and b4, timed in "
        "turns split, fused, fused, split")
    planes = synthetic_planes(rng, N_PLANES)
    P_inv = np.linalg.pinv(P2).astype(np.float32)
    nets = {name: place_model(net, dev, torch.bfloat16)
            for name, net in (("split", split), ("fused", fused))}
    timings = {}
    for b in (1, 4):
        args = (torch.from_numpy(rng.randint(
                    0, 256, (b, *CANVAS, 3)).astype(np.uint8)).to(dev),
                torch.from_numpy(np.tile(P_inv[None], (b, 1, 1))).to(dev),
                torch.from_numpy(np.tile(planes[None], (b, 1, 1))).to(dev))
        for name in ("split", "fused", "fused", "split"):
            detect = make_detect_fn(nets[name], CANVAS, with_pose=True,
                                    device_preprocess=True, device=dev)
            polling_cuda.LAUNCHES = 0
            sec, out = timed_detect(torch, detect, args, n_iter=20)
            assert polling_cuda.LAUNCHES == 23, polling_cuda.LAUNCHES
            scores = out.scores.float().cpu().numpy()
            assert np.isfinite(scores).all() and (scores > 0).any(1).all()
            timings.setdefault((name, b), []).append(sec)
            log(f"  {name} b{b}: {sec * 1e3:.3f} ms per call, "
                f"{b / sec:.2f} img/s (host clock over 20 calls, "
                "synchronized, after 3 warm-up calls)")

    log("phase 5c: bf16 trunk and heads alone (the network's forward, no "
        "filter or polling), split and fused, b1 and b4, CUDA events, in "
        "turns split, fused, fused, split")
    for b in (1, 4):
        x = torch.from_numpy(rng.uniform(-128, 128, (b, *CANVAS, 3)).astype(
            np.float32)).to(dev).permute(0, 3, 1, 2)
        ms = []
        with torch.inference_mode():
            for name in ("split", "fused", "fused", "split"):
                ms.append(cuda_ms(lambda net=nets[name]: net(x)))
                timings.setdefault((name, b, "forward"), []).append(ms[-1])
        log(f"  b{b} forward ms, split / fused / fused / split: "
            + " / ".join(f"{m:.4f}" for m in ms)
            + " (median of 25 calls, CUDA events around each, after 5 "
            "warm-up calls)")
    log(f"  phase 5 wall: {time.perf_counter() - t_phase:.2f} s")
    return timings


LABEL_RANKS = (0, 1, 3, 6, 10, 15)


def phase6_evaluate(torch, polling_cuda, tmp, cli):
    """A 4-frame prepared split (images, calibs, 20-field labels from the
    detections of ranks LABEL_RANKS, a 21,634-plane database), evaluated
    at full width on the card three ways."""
    from ground_plane_polling_tpu_torch.bin import evaluate
    from ground_plane_polling_tpu_torch.data.kitti import KittiDataset
    from ground_plane_polling_tpu_torch.data.pipeline import KittiLoader
    from ground_plane_polling_tpu_torch.data.planes import save_plane_database
    from ground_plane_polling_tpu_torch.inference import (make_detect_fn,
                                                          place_model)
    from ground_plane_polling_tpu_torch.models import export_jax_params

    t_phase = time.perf_counter()
    log("phase 6: evaluate at full width on a 4-frame prepared split, "
        "--eval-batch 1, --eval-batch 4, --fuse-towers")
    dev = torch.device("cuda")
    base = os.path.join(tmp, "kitti")
    rng = np.random.RandomState(SEED + 6)
    frames = [np.roll(cli["base"], int(rng.randint(1, 1242)), axis=1)
              for _ in range(4)]
    img_dir, cal_dir = write_frames(os.path.join(base), "val", frames)
    os.makedirs(os.path.join(base, "val", "labels"))
    save_plane_database(os.path.join(base, "road_planes_database.mat"),
                        synthetic_planes(rng, N_PLANES))
    # N(0, 0.01): scores well apart, so that AP does not hang on the order
    # of near-equal scores
    model = full_width_model(torch, SEED, cls_std=0.01)
    weights = os.path.join(tmp, "eval_model.npz")
    np.savez(weights, **export_jax_params(model))
    with open(weights + ".json", "w") as f:
        json.dump({"backbone": "resnet50", "num_classes": 1}, f)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = place_model(model, dev, torch.float32)
    ds = KittiDataset(base, "val")
    for i in range(len(ds)):
        open(ds.label_paths[i], "w").close()
    for item in KittiLoader(ds).eval_inputs():
        detect = make_detect_fn(net, item["image"].shape[1:3],
                                device_preprocess=True, device=dev)
        out = detect(item["image"], item["P_inv"], item["planes"])
        boxes = out.boxes[0].cpu().numpy() / item["scale"]
        dims = out.dims[0].cpu().numpy()
        orients = out.orientations[0].cpu().numpy()
        rows = ["Car 0.00 0 0.00 " + " ".join(
            f"{v:.2f}" for v in (*boxes[r], *dims[r])) + f" {orients[r]}"
            for r in LABEL_RANKS]
        with open(ds.label_paths[item["index"]], "w") as f:
            f.write("\n".join(rows) + "\n")
    del net

    results = {}
    for name, extra in (("b1", ["--eval-batch", "1"]),
                        ("b4", ["--eval-batch", "4"]),
                        ("fused", ["--fuse-towers"])):
        polling_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mean_ap, errors = evaluate.main([weights, base, "--device",
                                             "cuda"] + extra)
        launches = polling_cuda.LAUNCHES
        assert launches > 0, "evaluate did not launch the polling kernel"
        results[name] = (mean_ap, errors)
        log(f"  {name}: {time.perf_counter() - t0:.2f} s wall, "
            f"{launches} polling launches; {buf.getvalue().splitlines()[-1]}")
    mean_ap, errors = results["b1"]
    assert 0.0 < mean_ap <= 1.0, mean_ap
    for name in ("b4", "fused"):
        other_ap, other_errors = results[name]
        assert abs(other_ap - mean_ap) <= 1e-6, (name, other_ap, mean_ap)
        for k, v in errors.items():
            assert abs(other_errors[k] - v) <= 1e-4, (name, k)
    log("  --eval-batch 1 == --eval-batch 4 == --fuse-towers (mAP within "
        "1e-6, L1 errors within 1e-4)")
    log(f"  phase 6 wall: {time.perf_counter() - t_phase:.2f} s")
    return results


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ground_plane_polling_tpu_torch.kernels import (polling_cases,
                                                        polling_cuda)
    from ground_plane_polling_tpu_torch.ops import polling as twin

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"phase 0: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    lib = polling_cuda.build()
    log(f"  built {lib.name} in {time.perf_counter() - t0:.2f} s")
    log("  " + lib.with_suffix(".log").read_text().strip().replace(
        "\n", "\n  "))

    kernel = phase1_kernel(torch, polling_cuda, twin, polling_cases)
    launches, _ = phase2_main_path(torch, polling_cuda)
    with tempfile.TemporaryDirectory() as tmp:
        cli = phase3_cli(torch, tmp)
        phase4_serve(torch, polling_cuda, tmp, cli)
        phase5_fused(torch, polling_cuda)
        phase6_evaluate(torch, polling_cuda, tmp, cli)

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "ground_plane_polling",
        "route": "cuda",
        "source": "ground_plane_polling_tpu_torch/csrc/polling.cu",
        "replaces": "ground_plane_polling_tpu/kernels/polling_pallas.py:43",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
