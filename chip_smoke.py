#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ground_plane_polling_tpu_torch) on one
CUDA card: the quickest proof that the port builds, agrees with its plain
PyTorch versions and runs its main path end to end.

    python3 chip_smoke.py [--against ROOT]

Phases (any failure exits non-zero before the last line):
  0. environment: a CUDA card, its name and power limit; build the polling
     and int8 kernels from csrc/ (one nvcc for each source, at once) and
     print the build times and nvcc's register reports; count the
     warpgroup MMAs (IGMMA) in each instance of the int8 conv kernel's
     SASS, which must not be 0;
  1. the polling kernel against its twin on the card, at (B, D, P) =
     (1, 100, 1024), (1, 100, 21634), (4, 100, 21634), (2, 5, 13), on the
     crafted edge cases, and on the same edges with the competing planes
     in different splits of the plane axis (P 4,099 and 21,634, with the
     splits the cases were built for); the whole call timed at
     (1, 100, 21634) and (4, 100, 21634) with CUDA events beside its
     bound, with its launches per call;
  2. the main path at full width: ResNet-50, FPN 512, seeded weights, bf16,
     a 416x1344 canvas, 21,634 synthetic planes, pose on, at batch 1 and 4;
     then float32 with TF32 off at 128x416, card against CPU;
  3. the run_network CLI on 4 synthetic 375x1242 frames at --batch 1 and
     --batch 4 (float32, TF32 off): one KITTI txt per frame, equal outputs;
     the same two runs with the twin in the kernel's place give the gap
     between the batch sizes that bounds the kernel's at far 3D keypoints;
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
     equal mAP and errors;
  7. training on a prepared split of 375x1242 frames with random boxes:
     (a) the train step at full width (ResNet-50, FPN 512, bf16 autocast,
     augmentation, fused prepare, batch 2, 416x1344), 20 steps timed with
     CUDA events after 3 warm-up steps, with img/s, peak memory, FLOPs a
     step and finite loss terms, and no host-device synchronization in a
     step (torch.cuda's sync debug mode); (b) 30 steps on one fixed batch, whose
     loss must fall; (c) one float32 step of a shrunk model on the card
     and on the CPU: loss terms within rtol 1e-4, each post-clip gradient
     within 1e-3 of its tensor's norm; (d) bin/train for one epoch of 4
     steps with the validation sweep, then --snapshot auto carries the
     step count on.
  8. int8 (models/quantize.py, csrc/int8_conv.cu), ResNet-50 bf16 at
     416x1344, calibrated on 8 canvases: (a) at every distinct conv shape
     of the b1 forward and the P3 box tower at b4, the quantize kernel and
     the conv kernel against their plain versions (int8 and bf16 outputs
     bit for bit, int32 accumulators exactly) and timed beside their bound,
     the bf16 cuDNN conv and, at 1x1 stride 1, torch._int_mm, with the
     conv's plan (tile, splits, blocks), TOP/s and share of the bound;
     with --against ROOT, the int8 kernels of the checkout ROOT (for
     example the parent commit unpacked with git archive into the
     gitignored _parent_tree/) timed in turns with this tree's at every
     shape (ROOT, this, this, ROOT; each tree through its own wrapper,
     outputs equal); (b) the int8
     detect call at b1 and b4 (136 launches of each kernel and 1 polling
     launch a call; 111 with fused towers) timed in turns against bf16,
     its detections against bf16's, and a float32 int8 forward, card
     against CPU on one set of scales; (c) run_network, serve and evaluate
     with --int8, each launching the conv kernel.
Phases 4-8 each drive their path with the launch counts set to 0 and fail
if a kernel of the path was not launched.

Prints the kernel table as one JSON line, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""

import collections
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
# Where a keypoint's ray grazes its plane, X = r w / (r . n) moves by
# |X|^2 delta / (|w| |r|) for a rounding delta in r . n, so a point far
# away moves between batch 1 and batch 4 (whose boxes differ in the last
# bits) by more than phase 3's 0.5 + 2e-3 |X|, with the twin in the
# kernel's place as with the kernel. Phase 3 measures the twin's gap at
# each 3D keypoint and holds the kernel's to the larger of that bound and
# this multiple of it: the kernel's r . n carries its own rounding (FMA,
# rsqrtf) beside the rounding of the boxes, at most about as much again.
TWIN_GAP_MULTIPLE = 2.0
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


# Operations of the kernel's formulation (csrc/polling.cu), one for each
# add, multiply, compare, division and square root. Per (detection, plane)
# pair: 3 intersections (15 + 3 divisions + 9), the top point by
# perp = n |d_t|^2 - d_t (d_t . n) (5 + 7 + 6), the winding (7 + 1
# compare), |X_m - X_t| = |t| less its expected value (1), 5 distances
# less theirs (50), the votes (6 compares + 5 adds), the residual sum (5)
# and the arg-min state (3 compares): 123, of them 9 on the MUFU pipe (4
# reciprocals of the divisions, 5 square roots). Per plane: the sign flip
# and the scale to a unit normal, 16 with 1 reciprocal square root. Per
# detection: rays (68), expected distances (44), |d_t|^2 and d_t . d_m
# (10), the winner's plane (16), keypoints (45) and residual (1): 184,
# with 8 MUFU.
POLL_OPS = {"pair": 123, "plane": 16, "detection": 184}
POLL_MUFU = {"pair": 9, "plane": 1, "detection": 8}
# NVIDIA H100 SXM: f32 outside the tensor cores, HBM3 (NVIDIA's data
# sheet), and the MUFU pipe: 16 results a clock per SM (CUDA C++
# Programming Guide, arithmetic throughput for compute capability 9.0)
# on 132 SMs at the 1,980 MHz at which 67 TFLOP/s is stated
PEAK_F32_OPS = 67e12
PEAK_MUFU_OPS = 16 * 132 * 1.98e9
PEAK_BYTES = 3.35e12


def poll_bound_ms(t):
    """Least time of the polling call on these inputs (boxes, dimensions,
    orientations, P_inv, planes): the largest of its f32 operations at the
    f32 peak, its MUFU operations at the MUFU rate and its bytes (each
    input read once, each output written once) at the memory rate.
    Returns (ms, "operations" or "bytes", the limit by name)."""
    b, d, p = t[0].shape[0], t[0].shape[1], t[4].shape[1]
    count = {"pair": b * d * p, "plane": b * p, "detection": b * d}
    ops = sum(POLL_OPS[k] * n for k, n in count.items())
    mufu = sum(POLL_MUFU[k] * n for k, n in count.items())
    nbytes = sum(x.numel() * x.element_size() for x in t) + 4 * b * d * 17
    ms = {"f32 operations": ops / PEAK_F32_OPS * 1e3,
          "MUFU operations": mufu / PEAK_MUFU_OPS * 1e3,
          "bytes": nbytes / PEAK_BYTES * 1e3}
    limit = max(ms, key=ms.get)
    return ms[limit], ("bytes" if limit == "bytes" else "operations"), limit


def phase1_kernel(torch, polling_cuda, twin, polling_cases):
    log("phase 1: polling kernel against its twin on the card")
    dev = torch.device("cuda")

    def tensors(args):
        return [torch.from_numpy(np.asarray(a)).to(dev) for a in args]

    def run(args, splits=None):
        t = tensors(args)
        got = (polling_cuda._launch(*t, splits=splits) if splits
               else polling_cuda.fit_road_planes(*t))
        ref = twin.fit_road_planes(*t)
        torch.cuda.synchronize()
        return got, ref, t

    result = {}
    for shape in ((1, 100, 1024), (1, 100, 21634), (4, 100, 21634),
                  (2, 5, 13)):
        args = polling_cases.random_case(np.random.RandomState(SEED), *shape)
        got, ref, t = run(args)
        err = compare_poll(got, ref, f"random {shape}")
        if shape[2] != N_PLANES:
            continue
        before = polling_cuda.LAUNCHES
        polling_cuda.fit_road_planes(*t)
        per_call = polling_cuda.LAUNCHES - before
        ms = cuda_ms(lambda: polling_cuda.fit_road_planes(*t))
        bound, bound_by, limit = poll_bound_ms(t)
        b = shape[0]
        result[f"ms_b{b}"] = ms
        log(f"  {shape}: whole fit_road_planes call {ms:.4f} ms (median of "
            f"25 calls, CUDA events around each, after 5 warm-up calls), "
            f"{per_call} launch per call; bound {bound:.4f} ms by {limit}, "
            f"{bound / ms:.1%} of it reached")
        if b == 4:
            result.update(max_abs_err=err, ms=ms, bound_ms=bound,
                          bound_by=bound_by)
            result["plain_ms"] = cuda_ms(lambda: twin.fit_road_planes(*t))
            log(f"  {shape}: twin {result['plain_ms']:.4f} ms")
    for name, args, want in polling_cases.crafted_cases():
        got, ref, _ = run(args)
        if want is None:  # padded rows: real rows compared, all rows finite
            got, ref = [g[:, :2] for g in got], [r[:, :2] for r in ref]
        compare_poll(got, ref, f"crafted {name}")
    for p in (4099, N_PLANES):
        for name, args, want, splits in polling_cases.straddle_cases(p):
            got, ref, _ = run(args, splits)
            compare_poll(got, ref, f"straddle {name}")
            assert np.allclose(got.keyplanes.cpu(), ref.keyplanes.cpu(),
                               rtol=PLANE_RTOL, atol=PLANE_ATOL,
                               equal_nan=True), name
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
    per_call = launches / (len(runs) * n_iter)
    assert launches == 2 * n_iter, f"polling kernel launched {launches} times"
    log(f"  polling kernel launches in the main path: {launches}, "
        f"{per_call:g} per detect call")

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
    return launches, per_call, timings


def phase3_cli(torch, polling_cuda, twin, tmp):
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

    def run(b, name):
        out = os.path.join(tmp, f"out_{name}b{b}")
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
        return {n: (open(os.path.join(kdir, n)).read().splitlines(),
                    scipy.io.loadmat(os.path.join(mdir, n.replace(".txt",
                                                                  ".mat"))))
                for n in names}

    mats = {b: run(b, "") for b in (1, 4)}
    # the same two runs with the twin in the kernel's place: its gap
    # between batch 1 and 4 at each 3D keypoint
    log("  again with the twin in the polling kernel's place")
    kernel_fit = polling_cuda.fit_road_planes
    polling_cuda.fit_road_planes = twin.fit_road_planes
    try:
        twin_mats = {b: run(b, "twin_") for b in (1, 4)}
    finally:
        polling_cuda.fit_road_planes = kernel_fit
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
            if key != "keypoints3d":
                np.testing.assert_allclose(m1[key], m4[key], atol=atol,
                                           rtol=rtol, err_msg=f"{n} {key}")
                continue
            t1, t4 = (twin_mats[b][n][1][key] for b in (1, 4))
            assert t1.shape == t4.shape == m1[key].shape, (n, t1.shape)
            bound = atol + rtol * np.abs(m4[key])
            twin_gap = np.nan_to_num(np.abs(t1 - t4))
            gap = np.abs(m1[key] - m4[key])
            ok = (np.isnan(m1[key]) & np.isnan(m4[key])) | (
                gap <= np.maximum(bound, TWIN_GAP_MULTIPLE * twin_gap))
            assert ok.all(), (n, key, np.argwhere(~ok)[:4].tolist(),
                              gap[~ok][:4], twin_gap[~ok][:4])
            beyond = [(g > bound) & ~np.isnan(g) for g in (gap, twin_gap)]
            log(f"  {n} keypoints3d: beyond 0.5 + 2e-3 |X| at "
                f"{int(beyond[0].sum())} coordinates with the kernel, "
                f"{int(beyond[1].sum())} with the twin; largest gap "
                f"{np.nanmax(gap):.4g} m with the kernel, "
                f"{twin_gap.max():.4g} m with the twin")
        log(f"  {n}: {len(rows1)} rows, batch 1 == batch 4 within the "
            "tolerances, 3D keypoints within the larger of 0.5 + 2e-3 |X| "
            f"and {TWIN_GAP_MULTIPLE:g}x the twin's gap")
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


TRAIN_BATCH = 2
TRAIN_SIDES = (800, 1333)  # --image-min-side, --image-max-side: 416x1344
TRAIN_WARMUP, TRAIN_TIMED = 3, 20
LEARN_STEPS, LEARN_LR = 30, 1e-4
SHRUNK_STAGES, SHRUNK_FPN = (1, 1, 1, 1), 64


def write_train_split(tmp, cli, n_train=8, n_val=2):
    """A prepared KITTI split (train/ and val/) of 375x1242 frames with 3-5
    boxes each (random 20-field labels, as prepare-data writes them) and a
    21,634-plane database; returns its root."""
    from ground_plane_polling_tpu_torch.data.planes import save_plane_database

    root = os.path.join(tmp, "kitti_train")
    rng = np.random.RandomState(SEED + 8)
    for subset, n in (("train", n_train), ("val", n_val)):
        frames = [np.roll(cli["base"], int(rng.randint(1, 1242)), axis=1)
                  for _ in range(n)]
        write_frames(root, subset, frames)
        label_dir = os.path.join(root, subset, "labels")
        os.makedirs(label_dir)
        for i in range(n):
            rows = []
            for _ in range(rng.randint(3, 6)):
                w, h = rng.uniform(60, 300), rng.uniform(40, 150)
                x1, y1 = rng.uniform(0, 1242 - w), rng.uniform(100, 375 - h)
                kx = rng.uniform(x1, x1 + w, 4)
                ky = rng.uniform(y1, y1 + h, 4)
                kp = np.stack([kx, ky], 1).ravel()
                dims = rng.uniform([1.4, 1.5, 3.5], [1.8, 1.9, 4.8])
                rows.append("Car 0.00 0 0.00 " + " ".join(
                    f"{v:.2f}" for v in (x1, y1, x1 + w, y1 + h, *kp, *dims))
                    + f" {rng.randint(4)}")
            with open(os.path.join(label_dir, f"{i:06d}.txt"), "w") as f:
                f.write("\n".join(rows) + "\n")
    save_plane_database(os.path.join(root, "road_planes_database.mat"),
                        synthetic_planes(rng, N_PLANES))
    return root


def train_model(torch, dev, stages=None, features=512, cls_std=None):
    """Seeded detector (ResNet-50 and FPN 512 unless shrunk), float32
    parameters on `dev`, channels-last on the card."""
    from ground_plane_polling_tpu_torch.models import (GPPRetinaNet,
                                                       build_detector,
                                                       init_detector)
    from ground_plane_polling_tpu_torch.models.resnet import ResNetBackbone

    model = (build_detector("resnet50") if stages is None else GPPRetinaNet(
        ResNetBackbone(stages), feature_size=features))
    init_detector(model, SEED)
    if cls_std is not None:  # gradients through the classification tower
        out = model.classification.cls_out
        w = np.random.RandomState(SEED).normal(0.0, cls_std, out.weight.shape)
        with torch.no_grad():
            out.weight.copy_(torch.from_numpy(w.astype(np.float32)))
    model = model.to(dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def host_syncs(torch, fn):
    """fn()'s result and, for each synchronizing CUDA operation it made,
    the file:line of the Python code that called it."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                 if "called a synchronizing" in str(w.message)]


def phase7_train(torch, polling_cuda, tmp, cli, smi):
    from torch.utils.flop_counter import FlopCounterMode

    from ground_plane_polling_tpu_torch.data.kitti import KittiDataset
    from ground_plane_polling_tpu_torch.data.pipeline import KittiLoader
    from ground_plane_polling_tpu_torch.training.train import (
        create_train_state, make_fused_train_step, make_optimizer,
        make_train_step)

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    root = write_train_split(tmp, cli)
    log("phase 7a: train step, ResNet-50, FPN 512, one class, seeded, bf16 "
        f"autocast, augmentation, fused prepare, batch {TRAIN_BATCH}, "
        f"375x1242 frames on a {CANVAS[0]}x{CANVAS[1]} canvas")
    sides = dict(image_min_side=TRAIN_SIDES[0], image_max_side=TRAIN_SIDES[1])
    loader = KittiLoader(KittiDataset(root, "train"), batch_size=TRAIN_BATCH,
                         augment=True, raw_batches=True, seed=SEED,
                         device=dev, **sides)
    assert loader.image_shape == CANVAS, loader.image_shape
    n = TRAIN_WARMUP + TRAIN_TIMED
    t0 = time.perf_counter()
    batches = []
    while len(batches) < n:  # host loading apart from the step's time
        batches += list(loader.epoch(prefetch=0))[:n - len(batches)]
    host_ms = (time.perf_counter() - t0) / n * 1e3
    model = train_model(torch, dev)
    state = create_train_state(model, make_optimizer(model, 1e-5))
    step = make_fused_train_step(loader=loader, bf16=True)
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as flops:  # a warm-up step
        state, _ = step(state, batches[0])
    for raw in batches[1:TRAIN_WARMUP - 1]:
        state, _ = step(state, raw)
    # the last warm-up step under torch.cuda's sync debug mode: where the
    # host waits for the card inside a step (a copy from pageable memory, a
    # read-back), it cannot queue ahead of the card
    torch.cuda.synchronize()
    (state, _), syncs = host_syncs(
        torch, lambda: step(state, batches[TRAIN_WARMUP - 1]))
    torch.cuda.synchronize()
    assert not syncs, f"the train step waits for the card at {syncs}"
    events, metrics = [], []
    t0 = time.perf_counter()
    for raw in batches[TRAIN_WARMUP:]:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, raw)
        stop.record()
        events.append((start, stop))
        metrics.append(m)
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    ms = np.array([a.elapsed_time(b) for a, b in events])
    peak = torch.cuda.max_memory_allocated()
    terms = {k: torch.stack([m[k] for m in metrics]).float().cpu().numpy()
             for k in metrics[0]}
    for k, v in terms.items():
        assert np.isfinite(v).all(), (k, v)
    assert state.step == n
    med, p90 = float(np.median(ms)), float(np.percentile(ms, 90))
    step_flops = flops.get_total_flops()
    result = {"median_ms": med, "p90_ms": p90, "host_syncs": len(syncs),
              "img_s": TRAIN_BATCH / med * 1e3,
              "window_img_s": TRAIN_BATCH * TRAIN_TIMED / window,
              "peak_gib": peak / 2**30, "host_ms_per_batch": host_ms,
              "step_tflop": step_flops / 1e12}
    log(f"  {smi}: step median {med:.3f} ms, p90 {p90:.3f} ms (CUDA events "
        f"around each of {TRAIN_TIMED} steps after {TRAIN_WARMUP} warm-up "
        f"steps), {result['img_s']:.2f} img/s at the median, "
        f"{result['window_img_s']:.2f} img/s over the window (host clock, "
        f"synchronized); peak memory {result['peak_gib']:.3f} GiB "
        "(max_memory_allocated)")
    log(f"  {smi}: {result['step_tflop']:.4f} TFLOP a step (FlopCounterMode: "
        "convolutions and matmuls, forward and backward), "
        f"{step_flops / (med * 1e-3) / 989e12:.1%} of 989 TFLOP/s bf16 at "
        "the median step; host loading (decode, resize, pad, draw) "
        f"{host_ms:.1f} ms a batch, not in the step")
    log(f"  host-device synchronizations in a step: {len(syncs)} "
        "(torch.cuda.set_sync_debug_mode('warn') over one warm-up step)"
        + "".join(f"; {n} at {where}" for where, n in
                  sorted(collections.Counter(syncs).items())))
    log("  loss terms over the timed steps, first / last: " + ", ".join(
        f"{k} {v[0]:.5g} / {v[-1]:.5g}" for k, v in terms.items()))
    # where the step's time goes: device work against the step's time
    from torch.profiler import ProfilerActivity, profile

    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for raw in batches[-n_prof:]:
            state, _ = step(state, raw)
        torch.cuda.synchronize()
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in on_device) / 1e3 / n_prof
    result.update(device_busy_ms=busy_ms,
                  kernels_per_step=len(on_device) / n_prof)
    log(f"  device busy {busy_ms:.3f} ms a step (kernels and copies, "
        f"torch.profiler over {n_prof} steps), {busy_ms / med:.1%} of the "
        f"median step; {len(on_device) / n_prof:.0f} kernels and copies a "
        "step")
    del state, model, step, batches

    log(f"phase 7b: learning check, {LEARN_STEPS} steps on one fixed batch, "
        f"no augmentation, bf16, lr {LEARN_LR:g}")
    fixed = next(iter(KittiLoader(
        KittiDataset(root, "train"), batch_size=TRAIN_BATCH,
        raw_batches=True, shuffle=False, device=dev,
        **sides).epoch(prefetch=0)))
    model = train_model(torch, dev)
    state = create_train_state(model, make_optimizer(model, LEARN_LR))
    step = make_fused_train_step(num_classes=1, augment=False, bf16=True)
    losses = []
    for _ in range(LEARN_STEPS):
        state, m = step(state, fixed)
        losses.append(m["loss"])
    losses = torch.stack(losses).float().cpu().numpy()
    assert np.isfinite(losses).all(), losses
    assert losses[-5:].min() < losses[0], losses
    log(f"  loss {losses[0]:.5g} -> {losses[-1]:.5g} (smallest of the last "
        f"five {losses[-5:].min():.5g}); every 5th: "
        + " ".join(f"{v:.4g}" for v in losses[::5]))
    del state, model, step

    log("phase 7c: one float32 step, TF32 off, card against CPU: ResNet "
        f"stages {SHRUNK_STAGES}, FPN {SHRUNK_FPN}, 64x224, batch "
        f"{TRAIN_BATCH}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = next(iter(KittiLoader(
        KittiDataset(root, "train"), batch_size=TRAIN_BATCH,
        image_min_side=64, image_max_side=224, shuffle=False,
        device="cpu").epoch(prefetch=0)))
    assert tuple(small["image"].shape[1:3]) == (64, 224)
    runs = {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model = train_model(torch, device, SHRUNK_STAGES, SHRUNK_FPN,
                            cls_std=0.05)
        state = create_train_state(model, make_optimizer(model, 1e-5))
        state, m = make_train_step()(state, {k: v.to(device)
                                              for k, v in small.items()})
        runs[name] = ({k: float(v) for k, v in m.items()},
                      {n_: p.grad.cpu() for n_, p in
                       model.named_parameters()})
    (got, got_g), (want, want_g) = runs["cuda"], runs["cpu"]
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4 * abs(v), (k, got[k], v)
    worst = 0.0
    for k, g in want_g.items():
        norm = float(g.norm())
        gap = float((got_g[k] - g).abs().max())
        assert gap <= 1e-3 * norm, (k, gap, norm)
        worst = max(worst, gap / norm if norm else 0.0)
    log("  loss terms card / CPU: " + ", ".join(
        f"{k} {got[k]:.7g} / {v:.7g}" for k, v in want.items())
        + " (rtol 1e-4)")
    log(f"  post-clip gradients: largest |card - CPU| over the tensor's norm "
        f"{worst:.3e} over {len(want_g)} tensors (bound 1e-3)")

    log("phase 7d: bin/train on the split, bf16, augmentation: 1 epoch of 4 "
        "steps with the validation sweep, then --snapshot auto")
    from ground_plane_polling_tpu_torch.bin import train as train_cli
    from ground_plane_polling_tpu_torch.training.checkpoint import (
        latest_checkpoint)

    snaps = os.path.join(tmp, "snapshots")
    common = ["--batch-size", str(TRAIN_BATCH), "--epochs", "1", "--steps",
              "4", "--bf16", "--random-transform", "--device", "cuda",
              "--snapshot-path", snaps, "--log-path",
              os.path.join(tmp, "train_log.jsonl"), "--image-min-side",
              str(TRAIN_SIDES[0]), "--image-max-side", str(TRAIN_SIDES[1])]
    polling_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = train_cli.main(common + ["kitti", root])
    launches = polling_cuda.LAUNCHES
    record = buf.getvalue().strip().splitlines()[-1]
    assert launches > 0, "the validation sweep did not launch the kernel"
    assert state.step == 4, state.step
    ckpt = latest_checkpoint(snaps)
    assert ckpt and ckpt.endswith("step_00000004.pt"), ckpt
    log(f"  epoch: {time.perf_counter() - t0:.2f} s wall (init, 4 steps, "
        f"validation, checkpoint), {launches} polling launches in the "
        f"validation sweep; {record}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        state = train_cli.main(common + ["--snapshot", "auto",
                                         "--no-evaluation", "kitti", root])
    assert state.step == 8, state.step
    ckpt = latest_checkpoint(snaps)
    assert ckpt.endswith("step_00000008.pt"), ckpt
    log(f"  --snapshot auto: resumed at step 4, ended at step {state.step}, "
        f"{os.path.basename(ckpt)} written ({time.perf_counter() - t0:.2f} "
        "s wall)")
    log(f"  phase 7 wall: {time.perf_counter() - t_phase:.2f} s")
    return result


INT8_CALIB = 8  # canvases the int8 calibration of phase 8 takes
PEAK_INT8_OPS = 1979e12  # NVIDIA H100 SXM, dense int8 tensor cores
INT8_SITES = {False: 136, True: 111}  # conv sites: split, fused towers
# int8 against float detections: JAX's own int8 test bound on scores
# (ground_plane_polling_tpu's tests/test_quantize.py)
INT8_SCORE_TOL = 5e-3


def int8_conv_bound(x_shape, w_shape, out_shape, out_bytes):
    """{"operations": ms, "bytes": ms} of one int8 conv: 2 M N K int8
    operations at the int8 peak, and its bytes (the int8 input, the int8
    weights, the scales and bias, the output) at the memory rate; its
    least time is the larger."""
    b, cin, h, w = x_shape
    cout, _, kh, kw = w_shape
    m = b * out_shape[2] * out_shape[3]
    ops = 2 * m * cout * cin * kh * kw
    nbytes = (b * cin * h * w + cout * cin * kh * kw + cout * (4 + out_bytes)
              + m * cout * out_bytes)
    return {"operations": ops / PEAK_INT8_OPS * 1e3,
            "bytes": nbytes / PEAK_BYTES * 1e3}


def int8_site_inputs(torch, tq, model, scales, images, keep=None):
    """Run the int8 forward of `model` on `images` and return, per distinct
    conv shape (input shape, weight shape, stride, padding), a real input
    of that shape, its site's scale, the conv and how many sites have the
    shape; `keep` selects keys."""
    qm = tq.quantize_apply(model, scales)
    sites = {}

    def record(site, conv, x):
        pad = tq.conv_padding(conv, x)
        key = (tuple(x.shape), tuple(conv.weight.shape), conv.stride[0], pad)
        if keep is None or keep(key):
            entry = sites.setdefault(key, {"x": x, "s_x": float(scales[site]),
                                           "conv": conv, "n": 0,
                                           "weight": qm.int8_weight(conv)})
            entry["n"] += 1
        return qm._conv(site, conv, x)

    with torch.inference_mode(), tq._intercept(model, record):
        model(images)
    return sites


def device_kernels(torch, fn, reps=5, tries=3):
    """[(kernel name, device ms)] of `reps` calls of fn(), from
    torch.profiler, each duration divided by `reps`. On the card's machine
    a trace may lose device events, its first above all: a spin kernel
    goes first and is left out, and a trace without device events is
    taken again, up to `tries` times (then [] with a warning)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [(e.name, e.time_range.elapsed_us() / 1e3 / reps)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "spin_kernel" not in e.name]
        if kernels:
            return kernels
    log(f"  warning: {tries} traces of {reps} calls without device events")
    return []


# a spinning kernel of about 1 ms on the H100, long enough for the host to
# queue the calls that device_ms times behind it
SPIN_CYCLES = 2_000_000


def device_ms(torch, fn, reps=5, repeats=3):
    """Device milliseconds of one call of fn(): CUDA events around `reps`
    calls queued behind a spinning kernel, so that the card runs them back
    to back however long the host takes to queue them (the card's own
    launch gaps count, about a microsecond a kernel); the least of
    `repeats` such runs, after a warm-up call. Used where torch.profiler
    traces lose events."""
    fn()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / reps)
    return best


def int8_kind(name):
    """"conv", "quantize" or "other": which int8 kernel a device event
    is."""
    if "::conv_kernel<" in name:
        return "conv"
    if "::quantize_kernel(" in name or "::quantize_dense_kernel<" in name:
        return "quantize"
    return "other"


def split_int8_kernels(kernels):
    """Device ms of the int8 conv kernel, the quantize kernel and all other
    kernels in a device_kernels list."""
    out = {"conv": 0.0, "quantize": 0.0, "other": 0.0}
    for name, ms in kernels:
        out[int8_kind(name)] += ms
    return out


def int8_turns(torch, trees, x, s_x, w8, s_w, bias, stride, pad):
    """Device ms of the quantize and conv kernels of each tree's wrapper
    on one site's inputs, in turns (the other tree, this, this, the other;
    device_ms over 5 calls each): {tree: [(quantize, conv), ...]}. Every
    tree's int8 and bf16 outputs must equal this tree's."""
    outs, times = {}, {name: [] for name in trees}
    for name in ("other", "this", "this", "other"):
        ic = trees[name]
        if name not in outs:
            x8 = ic.quantize(x, s_x)
            outs[name] = (x8, ic.conv2d(x8, w8, s_x, s_w, bias, stride, pad,
                                        x.dtype))
        x8 = outs[name][0]
        times[name].append((
            device_ms(torch, lambda: ic.quantize(x, s_x)),
            device_ms(torch, lambda: ic.conv2d(x8, w8, s_x, s_w, bias,
                                               stride, pad, x.dtype))))
    for got, want in zip(outs["other"], outs["this"]):
        assert torch.equal(got, want)
    return times


def phase8a_kernels(torch, int8_conv_cuda, sites, label, other=None):
    """Each distinct conv shape: the quantize kernel against its plain
    version (bit for bit), the conv kernel's int32 accumulators (exactly)
    and bf16 output with bias (bit for bit) against theirs, and device
    times (device_ms): quantize, conv, the bf16 cuDNN conv of the float
    path and, for 1x1 stride-1 shapes,
    torch._int_mm (which must give the same accumulators); the plain
    versions are timed with CUDA events (median of 10 calls). Logs the
    conv's plan (tile, splits, blocks), its TOP/s and share of the bound.
    With `other` (another checkout's int8_conv_cuda), both trees' kernels
    are also timed in turns. Returns per-shape rows."""
    import torch.nn.functional as F

    from ground_plane_polling_tpu_torch.ops import int8_conv as plain

    rows = []
    for key, e in sites.items():
        x_shape, w_shape, stride, pad = key
        x, s_x, conv = e["x"], e["s_x"], e["conv"]
        with torch.inference_mode():
            w8, s_w = e["weight"]
            bias = conv.bias
            x8 = int8_conv_cuda.quantize(x, s_x)
            x8_ref = plain.quantize_activation(x, s_x)
            acc = int8_conv_cuda.conv2d_accumulate(x8, w8, stride, pad)
            acc_ref = plain.conv2d_int8(x8, w8, stride, pad)
            y = int8_conv_cuda.conv2d(x8, w8, s_x, s_w, bias, stride, pad,
                                      x.dtype)
            y_ref = plain.int8_conv2d(x8, w8, s_x, s_w, bias, stride, pad,
                                      x.dtype)
            errs = {name: float((got.double() - want.double()).abs().max())
                    for name, got, want in (("quantize", x8, x8_ref),
                                            ("acc", acc, acc_ref),
                                            ("conv", y, y_ref))}
            # bit for bit: int8 and int32 exactly, bf16 outputs too
            assert errs == {"quantize": 0.0, "acc": 0.0, "conv": 0.0}, \
                (key, errs)
            (top, bottom), (left, right) = pad
            xp = F.pad(x, (left, right, top, bottom))

            dev = {
                "quantize": device_ms(
                    torch, lambda: int8_conv_cuda.quantize(x, s_x)),
                "conv": device_ms(torch, lambda: int8_conv_cuda.conv2d(
                    x8, w8, s_x, s_w, bias, stride, pad, x.dtype)),
                "cudnn": device_ms(
                    torch, lambda: F.conv2d(xp, conv.weight, bias, stride))}
            bm, bn, splits = int8_conv_cuda.conv_plan(x8, w8, stride, pad)
            m = y.shape[0] * y.shape[2] * y.shape[3]
            row = {
                "key": key, "n": e["n"], "quantize_ms": dev["quantize"],
                "quantize_err": errs["quantize"],
                "conv_err": max(errs["acc"], errs["conv"]),
                "conv_ms": dev["conv"], "cudnn_ms": dev["cudnn"],
                "quantize_plain_ms": cuda_ms(
                    lambda: plain.quantize_activation(x, s_x), 10, 3),
                "conv_plain_ms": cuda_ms(lambda: plain.int8_conv2d(
                    x8, w8, s_x, s_w, bias, stride, pad, x.dtype), 10, 3),
                "int_mm_ms": None,
                "quantize_bound_ms": x.numel() * (x.element_size() + 1)
                / PEAK_BYTES * 1e3,
                "plan": (bm, bn, splits),
                "blocks": -(-m // bm) * -(-w_shape[0] // bn) * splits,
                "tera_ops": 2 * m * w8.numel() / dev["conv"] / 1e9,
            }
            bound = int8_conv_bound(x_shape, w_shape, y.shape,
                                    y.element_size())
            row["conv_bound_by"] = max(bound, key=bound.get)
            row["conv_bound_ms"] = bound[row["conv_bound_by"]]
            row["conv_ops_ms"] = bound["operations"]
            row["conv_bytes_ms"] = bound["bytes"]
            if w_shape[2:] == (1, 1) and stride == 1:
                a = x8.permute(0, 2, 3, 1).reshape(-1, w_shape[1])
                b = w8.reshape(w_shape[0], w_shape[1]).t()
                mm = torch._int_mm(a, b)
                assert torch.equal(mm, acc.permute(0, 2, 3, 1).reshape(
                    mm.shape)), key
                row["int_mm_ms"] = device_ms(
                    torch, lambda: torch._int_mm(a, b))
            if other is not None:
                row["turns"] = int8_turns(
                    torch, {"this": int8_conv_cuda, "other": other}, x, s_x,
                    w8, s_w, bias, stride, pad)
        rows.append(row)
        log(f"  {label} x{tuple(x_shape)} w{tuple(w_shape)} s{stride} "
            f"pad{pad} x{e['n']}: device ms quantize "
            f"{row['quantize_ms']:.4f} (bound {row['quantize_bound_ms']:.4f})"
            f", conv {row['conv_ms']:.4f} (bound {row['conv_bound_ms']:.4f} "
            f"by {row['conv_bound_by']}, "
            f"{row['conv_bound_ms'] / row['conv_ms']:.1%} of it; "
            f"{row['tera_ops']:.1f} TOP/s; tile {bm}x{bn}, {splits} "
            f"split(s), {row['blocks']} blocks), cuDNN bf16 "
            f"{row['cudnn_ms']:.4f}"
            + (f", _int_mm {row['int_mm_ms']:.4f}" if row["int_mm_ms"]
               else "") + f"; plain (events) {row['quantize_plain_ms']:.4f}"
            f" + {row['conv_plain_ms']:.4f}")
        if other is not None:
            t = row["turns"]
            log("    in turns, quantize / conv device ms, other tree: "
                + ", ".join(f"{q:.4f} / {c:.4f}" for q, c in t["other"])
                + "; this tree: "
                + ", ".join(f"{q:.4f} / {c:.4f}" for q, c in t["this"]))
    return rows


def turns_summary(rows):
    """Per b1 forward (each shape times its sites), the sums of each
    tree's quantize and conv times over its two turns, and the shapes at
    which this tree's conv is faster in both of its turns than the other
    tree's in both of its."""
    out = {}
    for tree in ("other", "this"):
        for i, kind in enumerate(("quantize", "conv")):
            out[f"{tree}_{kind}_ms"] = [
                sum(r["turns"][tree][j][i] * r["n"] for r in rows)
                for j in range(2)]
    out["conv_faster_shapes"] = sum(
        max(c for _, c in r["turns"]["this"])
        < min(c for _, c in r["turns"]["other"]) for r in rows)
    out["shapes"] = len(rows)
    return out


def phase8_int8(torch, polling_cuda, int8_conv_cuda, tmp, cli, other=None):
    """int8: (a) kernels against plain versions at every distinct conv
    shape of the full-width b1 forward and the P3 box tower at b4, with
    times; (b) the int8 detect call at b1 and b4 (launch counts, timed in
    turns against bf16, detections against bf16's), fused towers, and card
    against CPU in float32; (c) run_network, serve and evaluate --int8."""
    from ground_plane_polling_tpu_torch.bin import evaluate, run_network, serve
    from ground_plane_polling_tpu_torch.data.kitti import BGR_MEAN
    from ground_plane_polling_tpu_torch.inference import (make_detect_fn,
                                                          place_model)
    from ground_plane_polling_tpu_torch.models import (build_detector,
                                                       fuse_detector_params)
    from ground_plane_polling_tpu_torch.models import quantize as tq

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 9)
    split = full_width_model(torch, SEED)
    model = place_model(split, dev, torch.bfloat16)
    canvases = [torch.from_numpy(rng.randint(0, 256, (1, *CANVAS, 3)).astype(
        np.uint8)).to(dev) for _ in range(INT8_CALIB)]
    t0 = time.perf_counter()
    scales = tq.collect_scales_uint8(model, canvases)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    assert scales.shape == (INT8_SITES[False],) and (scales > 0).all()
    log(f"phase 8: int8, ResNet-50 bf16 at {CANVAS[0]}x{CANVAS[1]}, "
        f"calibrated (absmax) on {INT8_CALIB} canvases in {calib_s:.2f} s, "
        f"{len(scales)} sites")

    log("phase 8a: int8 kernels against their plain versions, every "
        "distinct conv shape at b1 and the P3 box tower at b4 (device "
        "times: CUDA events around 5 calls queued behind a spinning "
        "kernel, the least of 3)")
    slots, sms = int8_conv_cuda.card_slots(dev)
    log(f"  conv tiles (BM, BN): blocks per SM on {sms} SMs (occupancy "
        "API): " + ", ".join(f"{t} {n // sms}" for t, n in slots.items()))
    mean = torch.as_tensor(BGR_MEAN, device=dev)

    def net_input(b):
        im = torch.from_numpy(rng.randint(0, 256, (b, *CANVAS, 3)).astype(
            np.uint8)).to(dev)
        return (im.float() - mean).permute(0, 3, 1, 2)

    sites = int8_site_inputs(torch, tq, model, scales, net_input(1))
    assert sum(e["n"] for e in sites.values()) == INT8_SITES[False]
    p3 = (CANVAS[0] // 8, CANVAS[1] // 8)
    box_b4 = int8_site_inputs(
        torch, tq, model, scales, net_input(4),
        keep=lambda k: k[0] == (4, 512, *p3) and k[1] == (512, 512, 3, 3))
    rows = phase8a_kernels(torch, int8_conv_cuda, sites, "b1", other)
    rows_b4 = phase8a_kernels(torch, int8_conv_cuda, box_b4, "b4", other)
    per_call = {k: sum(r[k] * r["n"] for r in rows) for k in (
        "quantize_ms", "quantize_plain_ms", "quantize_bound_ms", "conv_ms",
        "conv_plain_ms", "conv_bound_ms", "conv_ops_ms", "conv_bytes_ms",
        "cudnn_ms")}
    one_by_one = [r for r in rows if r["int_mm_ms"] is not None]
    per_call["int_mm_1x1_ms"] = sum(r["int_mm_ms"] * r["n"]
                                    for r in one_by_one)
    per_call["conv_1x1_ms"] = sum(r["conv_ms"] * r["n"] for r in one_by_one)
    for kind in ("quantize_err", "conv_err"):
        per_call[kind] = max(r[kind] for r in rows + rows_b4)
    per_call["conv_bound_by"] = ("operations" if per_call["conv_ops_ms"]
                                 >= per_call["conv_bytes_ms"] else "bytes")
    log(f"  {len(rows)} distinct shapes; per b1 forward (each shape times "
        f"its sites), device ms: quantize {per_call['quantize_ms']:.4f} "
        f"(bound {per_call['quantize_bound_ms']:.4f}); conv "
        f"{per_call['conv_ms']:.4f} (bound {per_call['conv_bound_ms']:.4f}: "
        f"operations {per_call['conv_ops_ms']:.4f}, bytes "
        f"{per_call['conv_bytes_ms']:.4f}), cuDNN bf16 "
        f"{per_call['cudnn_ms']:.4f}; 1x1 stride-1 sites: conv "
        f"{per_call['conv_1x1_ms']:.4f}, torch._int_mm "
        f"{per_call['int_mm_1x1_ms']:.4f}; plain versions (CUDA events, "
        f"host time included) {per_call['quantize_plain_ms']:.4f} + "
        f"{per_call['conv_plain_ms']:.4f}")
    per_call["split_sites"] = sum(r["n"] for r in rows if r["plan"][2] > 1)
    per_call["tera_ops"] = (per_call["conv_ops_ms"] * PEAK_INT8_OPS / 1e12
                            / per_call["conv_ms"])
    log(f"  conv per b1 forward: {per_call['tera_ops']:.1f} TOP/s, "
        f"{per_call['conv_bound_ms'] / per_call['conv_ms']:.1%} of the "
        f"bound; {per_call['split_sites']} of {INT8_SITES[False]} sites "
        "split K; quantize "
        f"{per_call['quantize_bound_ms'] / per_call['quantize_ms']:.1%} of "
        "its bound")
    if other is not None:
        per_call["turns"] = turns_summary(rows)
        per_call["turns_b4"] = turns_summary(rows_b4)
        t = per_call["turns"]
        log("  in turns with the other tree, per b1 forward (device ms, "
            "other / this / this / other): quantize "
            f"{t['other_quantize_ms'][0]:.4f} / {t['this_quantize_ms'][0]:.4f}"
            f" / {t['this_quantize_ms'][1]:.4f} / "
            f"{t['other_quantize_ms'][1]:.4f}; conv "
            f"{t['other_conv_ms'][0]:.4f} / {t['this_conv_ms'][0]:.4f} / "
            f"{t['this_conv_ms'][1]:.4f} / {t['other_conv_ms'][1]:.4f}; "
            f"this conv faster at {t['conv_faster_shapes']} of "
            f"{t['shapes']} shapes (both turns)")

    log("phase 8b: the int8 detect call, b1 and b4, bf16, "
        f"{N_PLANES} planes, timed in turns bf16, int8, int8, bf16")
    planes = synthetic_planes(rng, N_PLANES)
    P_inv = np.linalg.pinv(P2).astype(np.float32)
    timings, launches = {}, {"quantize": 0, "conv": 0, "calls": 0}
    for b in (1, 4):
        args = (torch.from_numpy(rng.randint(
                    0, 256, (b, *CANVAS, 3)).astype(np.uint8)).to(dev),
                torch.from_numpy(np.tile(P_inv[None], (b, 1, 1))).to(dev),
                torch.from_numpy(np.tile(planes[None], (b, 1, 1))).to(dev))
        fns = {name: make_detect_fn(model, CANVAS, with_pose=True,
                                    device_preprocess=True, device=dev,
                                    quant_scales=q)
               for name, q in (("bf16", None), ("int8", scales))}
        outs = {}
        for name in ("bf16", "int8", "int8", "bf16"):
            int8_conv_cuda.QUANTIZE_LAUNCHES = 0
            int8_conv_cuda.CONV_LAUNCHES = 0
            polling_cuda.LAUNCHES = 0
            sec, outs[name] = timed_detect(torch, fns[name], args, n_iter=10)
            calls = 13  # 3 warm-up and 10 timed calls
            assert polling_cuda.LAUNCHES == calls, polling_cuda.LAUNCHES
            want = INT8_SITES[False] * calls if name == "int8" else 0
            assert int8_conv_cuda.CONV_LAUNCHES == want, \
                int8_conv_cuda.CONV_LAUNCHES
            assert int8_conv_cuda.QUANTIZE_LAUNCHES == want
            if name == "int8":
                launches["quantize"] += int8_conv_cuda.QUANTIZE_LAUNCHES
                launches["conv"] += int8_conv_cuda.CONV_LAUNCHES
                launches["calls"] += calls
            timings.setdefault((name, b), []).append(sec)
            log(f"  {name} b{b}: {sec * 1e3:.3f} ms per call, "
                f"{b / sec:.2f} img/s (host clock over 10 calls, "
                "synchronized, after 3 warm-up calls); per call "
                f"{int8_conv_cuda.CONV_LAUNCHES // calls} conv and "
                f"{int8_conv_cuda.QUANTIZE_LAUNCHES // calls} quantize "
                f"launches, {polling_cuda.LAUNCHES // calls} polling")
        sf, sq = (outs[n].scores.float().cpu().numpy() for n in ("bf16",
                                                                 "int8"))
        assert np.isfinite(sq).all()
        assert ((sq > 0).sum(1) == (sf > 0).sum(1)).all(), (sq > 0).sum(1)
        gap = float(np.abs(sq - sf).max())
        assert gap <= INT8_SCORE_TOL, gap
        log(f"  b{b} int8 against bf16 detections: counts "
            f"{(sq > 0).sum(1).tolist()} equal, max |score gap| {gap:.3e} "
            f"(bound {INT8_SCORE_TOL:g})")
        with torch.inference_mode():
            x = (args[0].float() - mean).permute(0, 3, 1, 2)
            qm = tq.quantize_apply(model, scales)
            fwd = [cuda_ms(lambda f=f: f(x), 10, 3) for f in (
                model, qm, qm, model)]
            heads = {"bf16": model(x), "int8": qm(x)}
            busy = {name: split_int8_kernels(device_kernels(
                torch, lambda f=f: f(x), 3)) for name, f in (
                    ("bf16", model), ("int8", qm))}
        timings[("forward", b)] = fwd
        timings[("busy", b)] = busy
        log(f"  b{b} forward alone, bf16 / int8 / int8 / bf16: "
            + " / ".join(f"{m:.4f}" for m in fwd) + " ms (median of 10, "
            "CUDA events, after 3); device busy per forward (torch.profiler "
            f"over 3): bf16 {sum(busy['bf16'].values()):.4f} ms, int8 "
            f"{sum(busy['int8'].values()):.4f} ms = conv "
            f"{busy['int8']['conv']:.4f} + quantize "
            f"{busy['int8']['quantize']:.4f} + other "
            f"{busy['int8']['other']:.4f}")
        # the int8 error of this model (not of the port, which equals the
        # CPU's int8 forward in phase 8b'): logged, not bounded
        errs = {k: float((heads["int8"][k].float() - r.float()).abs().max()
                         / r.float().abs().max())
                for k, r in heads["bf16"].items()}
        timings[("head_err", b)] = errs
        log(f"  b{b} int8 error, max |int8 - bf16| / max|bf16| of the "
            "heads: " + ", ".join(f"{k} {v:.4f}" for k, v in errs.items()))

    fused = build_detector("resnet50", fuse_cls_dim=True)
    fused.load_state_dict(fuse_detector_params(split.state_dict()))
    fused = place_model(fused, dev, torch.bfloat16)
    fused_scales = tq.collect_scales_uint8(fused, canvases)
    assert fused_scales.shape == (INT8_SITES[True],)
    detect = make_detect_fn(fused, CANVAS, with_pose=True,
                            device_preprocess=True, device=dev,
                            quant_scales=fused_scales)
    int8_conv_cuda.CONV_LAUNCHES = 0
    polling_cuda.LAUNCHES = 0
    with torch.inference_mode():
        out = detect(*[a[:1] for a in args])
    torch.cuda.synchronize()
    assert int8_conv_cuda.CONV_LAUNCHES == INT8_SITES[True]
    assert polling_cuda.LAUNCHES == 1
    assert np.isfinite(out.scores.float().cpu().numpy()).all()
    log(f"  fused towers: {int8_conv_cuda.CONV_LAUNCHES} conv launches, 1 "
        "polling launch per int8 detect call")

    log("phase 8b': float32 int8 forward, TF32 off, 128x416: card against "
        "CPU on the CPU's calibration (one set of scales)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(rng.randint(0, 256, (1, 128, 416, 3)).astype(
        np.float32) - BGR_MEAN).permute(0, 3, 1, 2)
    cpu_net = place_model(full_width_model(torch, SEED), "cpu")
    card_net = place_model(full_width_model(torch, SEED), dev)
    small_scales = tq.collect_scales(cpu_net, [x])
    heads = {}
    with torch.inference_mode():
        heads["cpu"] = tq.quantize_apply(cpu_net, small_scales)(x)
        heads["cuda"] = {k: v.cpu() for k, v in tq.quantize_apply(
            card_net, small_scales)(x.to(dev)).items()}
    card_err = 0.0
    for k, ref in heads["cpu"].items():
        err = float((heads["cuda"][k] - ref).abs().max() / ref.abs().max())
        assert err <= 1e-5, (k, err)
        card_err = max(card_err, err)
        log(f"  {k}: max |card - cpu| / max|cpu| {err:.3e} (bound 1e-5)")
    del cpu_net, card_net

    log("phase 8c: run_network, serve and evaluate with --int8 on the card")
    cli_runs = {}
    eval_base = os.path.join(tmp, "kitti")
    for name, fn, argv in (
            ("run_network", run_network.main,
             [cli["weights"], cli["images"], cli["calibs"], cli["planes"],
              os.path.join(tmp, "int8_rn"), "--kitti", "--int8", "2"]),
            ("serve", serve.main,
             [cli["weights"], cli["images"], cli["calibs"], cli["planes"],
              os.path.join(tmp, "int8_serve"), "--once", "--int8", "2",
              "--batch-size", "2"]),
            ("evaluate", evaluate.main,
             [os.path.join(tmp, "eval_model.npz"), eval_base, "--int8",
              "2"])):
        int8_conv_cuda.CONV_LAUNCHES = 0
        polling_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = fn(argv + ["--device", "cuda"])
        conv_n, poll_n = int8_conv_cuda.CONV_LAUNCHES, polling_cuda.LAUNCHES
        assert conv_n > 0 and poll_n > 0, (name, conv_n, poll_n)
        assert conv_n % INT8_SITES[False] == 0, (name, conv_n)
        cli_runs[name] = (conv_n, poll_n)
        lines = buf.getvalue().splitlines()
        log(f"  {name}: {time.perf_counter() - t0:.2f} s wall, {conv_n} "
            f"int8 conv launches, {poll_n} polling; {lines[-1]}")
        if name == "serve":
            assert lines[0] == "int8: calibrated on 2 images", lines[0]
            assert result == 4
        if name == "evaluate":
            assert 0.0 <= result[0] <= 1.0
    log(f"  phase 8 wall: {time.perf_counter() - t_phase:.2f} s")
    return {"per_call": per_call, "rows_b4": rows_b4, "launches": launches,
            "timings": timings, "card_err": card_err, "cli": cli_runs}


def load_int8_tree(root, alias):
    """kernels.int8_conv_cuda of the package in checkout `root`, imported
    under the top-level name `alias` (it builds into that checkout)."""
    import importlib
    import importlib.util
    from pathlib import Path

    pkg = Path(root).resolve() / "ground_plane_polling_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{alias}.kernels.int8_conv_cuda")


def sass_counts(lib, opcode, function):
    """{function name: SASS lines naming `opcode`} of the functions of
    library `lib` whose name holds `function`, from cuobjdump -sass."""
    from pathlib import Path

    from ground_plane_polling_tpu_torch.kernels.nvcc_build import nvcc

    sass = subprocess.run(
        [str(Path(nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
        capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if function in name:
                counts[name] = 0
        elif name in counts and opcode in line:
            counts[name] += 1
    return counts


def main(argv=None):
    import argparse

    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--against", default=None, metavar="ROOT",
                   help="another checkout (for example the parent commit "
                   "unpacked with git archive into the gitignored "
                   "_parent_tree/): phase 8a also times its int8 kernels "
                   "in turns with this tree's at every shape")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    from ground_plane_polling_tpu_torch.kernels import (int8_conv_cuda,
                                                        polling_cases,
                                                        polling_cuda)
    from ground_plane_polling_tpu_torch.ops import polling as twin

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"phase 0: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    t_start = time.perf_counter()

    def timed_build(module):
        t0 = time.perf_counter()
        return module.build(), time.perf_counter() - t0

    modules = [polling_cuda, int8_conv_cuda]
    other = None
    if args.against:
        other = load_int8_tree(args.against, "gpp_against")
        modules.append(other)
    # one nvcc for each source, started together
    with ThreadPoolExecutor(len(modules)) as pool:
        builds = list(pool.map(timed_build, modules))
    for lib, sec in builds:
        log(f"  built {lib} in {sec:.2f} s (in parallel)")
        log("  " + lib.with_suffix(".log").read_text().strip().replace(
            "\n", "\n  "))
    # the conv kernel runs on warpgroup MMAs: IGMMA in each instance's SASS
    igmma = sass_counts(builds[1][0], "IGMMA", "conv_kernel")
    log("  IGMMA instructions in the int8 conv kernel's SASS: "
        + ", ".join(f"{v} in {k}" for k, v in sorted(igmma.items())))
    assert igmma and all(v > 0 for v in igmma.values()), igmma

    kernel = phase1_kernel(torch, polling_cuda, twin, polling_cases)
    launches, per_call, _ = phase2_main_path(torch, polling_cuda)
    with tempfile.TemporaryDirectory() as tmp:
        cli = phase3_cli(torch, polling_cuda, twin, tmp)
        phase4_serve(torch, polling_cuda, tmp, cli)
        phase5_fused(torch, polling_cuda)
        phase6_evaluate(torch, polling_cuda, tmp, cli)
        phase7_train(torch, polling_cuda, tmp, cli, smi)
        int8 = phase8_int8(torch, polling_cuda, int8_conv_cuda, tmp, cli,
                           other)
    log(f"chip_smoke total: {time.perf_counter() - t_start:.2f} s after "
        "phase 0's device query")
    pc = int8["per_call"]

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
        "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"],
        "library_ms": None,  # no one PyTorch call computes this function
        "launches_per_call": per_call,
        "ms_b1": kernel["ms_b1"],
        "ms_b4": kernel["ms_b4"],
    }, {
        "name": "int8_quantize",
        "route": "cuda",
        "source": "ground_plane_polling_tpu_torch/csrc/int8_conv.cu",
        "replaces": "ground_plane_polling_tpu/models/quantize.py:222",
        "launches": int8["launches"]["quantize"],
        "max_abs_err": pc["quantize_err"],
        # per b1 int8 forward: the sum over its 136 sites
        "ms": pc["quantize_ms"],
        "plain_ms": pc["quantize_plain_ms"],
        "bound_ms": pc["quantize_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no one PyTorch call rounds x / s to int8 so
        "launches_per_call": INT8_SITES[False],
    }, {
        "name": "int8_conv",
        "route": "cuda",
        "source": "ground_plane_polling_tpu_torch/csrc/int8_conv.cu",
        "replaces": "ground_plane_polling_tpu/models/quantize.py:236",
        "launches": int8["launches"]["conv"],
        "max_abs_err": pc["conv_err"],
        "ms": pc["conv_ms"],
        "plain_ms": pc["conv_plain_ms"],
        "bound_ms": pc["conv_bound_ms"],
        "bound_by": pc["conv_bound_by"],
        # the bf16 cuDNN convolutions of the float path, same shapes
        "library_ms": pc["cudnn_ms"],
        "launches_per_call": INT8_SITES[False],
        "int_mm_1x1_ms": pc["int_mm_1x1_ms"],
        "conv_1x1_ms": pc["conv_1x1_ms"],
        "box_tower_p3_b4": {k: int8["rows_b4"][0][k] for k in (
            "conv_ms", "conv_plain_ms", "conv_bound_ms", "cudnn_ms")},
        "tera_ops": pc["tera_ops"],
        "split_sites": pc["split_sites"],
        "sass_igmma": sum(igmma.values()),
        "against": pc.get("turns"),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
