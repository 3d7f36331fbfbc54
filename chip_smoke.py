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
     --batch 4 (float32, TF32 off): one KITTI txt per frame, equal outputs.

Prints the kernel table as one JSON line, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""

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


def full_width_model(torch, seed):
    """ResNet-50 detector, FPN 512, seeded init, and the classification out
    kernel redrawn from N(0, 0.05) with a zero bias so that random weights
    give detections above the 0.05 threshold."""
    from ground_plane_polling_tpu_torch.models import (build_detector,
                                                       init_detector)

    model = init_detector(build_detector("resnet50"), seed)
    out = model.classification.cls_out
    w = np.random.RandomState(seed).normal(0.0, 0.05, out.weight.shape)
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
        phase3_cli(torch, tmp)

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
