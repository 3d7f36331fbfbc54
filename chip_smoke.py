#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ground_plane_polling_tpu_torch) on one
CUDA card: the quickest proof that the port builds, agrees with its plain
PyTorch versions and runs its main path end to end.

    python3 chip_smoke.py [--against ROOT]

Phases (any failure exits non-zero before the last line):
  0. environment: a CUDA card, its name and power limit; build the polling,
     int8, depthwise and NMS kernels from csrc/ (one nvcc for each source,
     at once) and print the build times and nvcc's register reports; count the
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
     augmentation, fused prepare, batch 2, 416x1344), captured (one CUDA
     graph, training.train.CapturedTrainStep) against step.eager in turns
     (eager / captured / captured / eager), 20 steps of each timed with
     CUDA events after 3 warm-up steps, with img/s, peak memory, FLOPs a
     step (on step.eager), device ms, idle share, host API calls and
     device operations a step, finite loss terms, no host-device
     synchronization in a step (torch.cuda's sync debug mode), and the
     captured step fed by the loader's producer thread as fit feeds it;
     (a') from one copied state, 5 fused bf16 steps captured and eagerly
     under deterministic cuDNN, equal bit for bit (or within the gap
     between two eager runs), then after the capture an lr change, a
     restore_checkpoint and a second canvas shape (a second graph), each
     followed by equal steps; (b) 30 steps on one fixed batch, whose
     loss must fall; (c) one float32 step of a shrunk model on the card
     and on the CPU: loss terms within rtol 1e-4, each post-clip gradient
     within 1e-3 of its tensor's norm; (d) bin/train for one epoch of 4
     steps with the validation sweep, through the captured step (one
     capture, four calls), then --snapshot auto carries the step count
     on.
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
  9. data parallel and --remat at phase 7's full width (ResNet-50, FPN 512,
     416x1344, b2, augmentation): (a) a 1-rank NCCL group: the DDP fused
     bf16 step captured (11 eager DDP steps on the side stream, the last
     followed by the capture; training.train.CapturedTrainStep) against
     step.eager and phase 7a's captured plain step, 20 steps each in
     blocks eager / captured / plain / plain / captured / eager (CUDA
     events), the capture's peak memory, no host sync in a replay (nor in
     an eager DDP step), device busy, idle share, NCCL's device ms and
     host API calls a step (profiler), and one float32 step (TF32 off)
     whose gradients equal the plain step's; (a') as 7a', captured
     against eager bit for bit from one copied state over the 11 warm-up
     steps and 3 replays, then an lr change, a restore and a second
     canvas shape; (d) on the same group, the captured mesh detect calls
     (data parallel at b1 and b4, shard_spatial at b1, bf16; the outputs'
     all-gather or the width split's exchanges inside the graph) against
     detect.eager as 13b holds the plain call; (b) two rank processes on
     the one card over gloo (NCCL refuses two ranks on one device), each
     launched with a timeout and joined, whose step and detect call must
     stay eager (gloo cannot be captured): the f32 and
     bf16 steps on one row each of the global b2 batch against the single
     process's b2 step, bin/train --data-parallel --tensorboard-dir (only
     rank 0 writes; both log one mAP; the checkpoint resumes in one
     process) and bin/evaluate --data-parallel, float and --int8 2, equal
     to one process's, with the kernels' launches counted on each rank;
     (c) the captured bf16 step with and without --remat: the peak memory
     of its first call, step time in turns, and equal float32 gradients.
 10. the other backbone families (tiny, VGG, DenseNet, MobileNet): (a)
     tiny, vgg16, densenet121 and mobilenet224_1.0 at full width (FPN 512,
     seeded, bf16, 416x1344, 21,634 planes) at b1 and b4, one polling
     launch a call and at least one detection; (b) every name of the
     registry, float32 with TF32 off at 128x416, card against CPU (VGG and
     DenseNet at a shrunk depth); (c) int8 on mobilenet224_1.0 at full
     width: the depthwise kernel (csrc/int8_depthwise.cu), fed the float
     site input (the fused quantize) and the int8 one, against its plain
     version bit for bit at every depthwise shape at b1 and b4, timed
     beside its bound, the unfused pair (the quantize kernel, then the
     int8-input depthwise), cuDNN's bf16 grouped conv and the launch
     floor (with --against, the other tree's depthwise kernel in turns),
     13 depthwise and 97 quantize launches a call, the int8 call timed in
     turns with bf16 at b1 and b4; (d) run_network
     --backbone mobilenet224_1.0 --int8 2 and --backbone densenet121 on
     phase 3's frames and bin/train --backbone vgg16 on phase 7's split,
     each a process of its own with a timeout.
 11. the host-side extras: (a) g++'s version, whether png.h and jpeglib.h
     are found, h5py's version; the native loader and the eval3d core
     (built with g++ in phase 0, beside the nvcc builds; the phase fails if
     the headers are there and the loader does not build); the loader
     that phase 7d's bin/train took; phase 3's frames decoded by the
     native loader equal to PIL's, the native canvases of phase 7's split
     within one count of cv2's, and host ms per b2 training batch at
     416x1344, native against cv2 in turns; (b) evaluate_3d on phase 3's
     txts with the C++ core and with numpy, equal, both wall times; (c)
     phase 3's weights as a Keras .h5 (the port's exporter) through
     run_network and serve (phase 3's txts within its tolerances) and
     convert_model back to equal arrays, where h5py is installed; (d)
     run_network --save-images on phase 3's frames, bf16: one 2H x W
     composite a frame, the polling kernel launched; (e) bin/debug
     --anchors --resize --random-transform on phase 7's split: one PNG a
     frame.
 12. the last three options of the detect API, ResNet-50 at full width
     (FPN 512, seeded, 416x1344, 21,634 planes): (a) fused_decode=False
     against the fused decode in bf16 at b1 and b4, equal detections
     within phase 3's tolerances, timed in turns; (b) pack_levels: the
     raw heads packed against unpacked in float32 (TF32 off) at b1, split
     and fused, conv sites and kernels a forward, the bf16 call in turns
     at b1 and b4, and int8 packed with its own calibration (91 conv and
     quantize launches a call; the conv kernel against its plain version
     at every shape of the tail canvas, bit for bit); (c) shard_spatial:
     two rank processes on the one card over gloo, whose call stays eager
     (with --dp-cards N, N over NCCL, captured, and timed against its
     eager call in turns; --phase 12c: only this phase), each with a
     timeout and joined: the b1 float32 call
     against one process, each rank's widest conv input against its slab
     plus halo, and bf16 timed against one process.
 13. the detect call as CUDA graphs (inference.CapturedDetect), ResNet-50
     FPN 512 at 416x1344, 21,634 planes, pose on: (a) the NMS kernel
     (csrc/nms.cu) against greedy_nms, the plain fixpoint, bit for bit on
     the real candidates of a b4 bf16 call (and its first image), on 12
     and 48 random sets at K 1024, 4 with 200 of 1024 valid and one in
     30 tight clusters (every candidate reached), timed beside the bound,
     the launch floor and the plain version; the crafted cases of
     kernels/nms_cases.py, and its large cases against greedy_nms_serial;
     with --against ROOT, ROOT's NMS kernel in turns (ROOT, this, this,
     ROOT), the large cases too, and the device kernels of one call of
     each;
     (b) the captured call against detect.eager in
     bf16 and int8 at b1 and b4: labels and orientations equal, the float
     fields' gaps (0 unless the eager call itself does not repeat), no
     host sync in a replay (torch.cuda's sync debug mode), one polling and
     one NMS launch a replay (136 of each int8 kernel), the host's API
     calls and the device's operations a call (with --against, also of
     the call captured with ROOT's NMS kernel), ms a call in turns eager /
     captured / captured / eager, and the card's idle share of the call;
     (c) the captures and calls of phases 3 and 4 (run_network and serve,
     whose txts those phases hold), which must have gone through the
     captured call.
Every detect call and every train step on the card above is a captured
call, but for `step.eager` and `detect.eager` and the gloo ranks of phases
9b and 12c, which stay eager (gloo's collectives cannot be captured); with
--dp-cards N the ranks of 9b and 12c run the captured paths over NCCL, the
DDP step timed against its eager step in turns. Phases 4-13 each drive their path with the
launch counts set to 0 and fail if a kernel of the path was not launched;
a captured call counts the launches it replays.

Prints the kernel table as one JSON line, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""

import collections
import contextlib
import copy
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
# frozen-BN sites of a ResNet-50 forward (the stem and 3 a block), each a
# launch of csrc/frozen_bn.cu
BN_SITES = 49
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


def full_width_model(torch, seed, cls_std=0.05, backbone="resnet50",
                     model=None):
    """The detector of `backbone` (ResNet-50 by default; or `model`, built
    by the caller), FPN 512, seeded init, and the classification out
    kernel redrawn from N(0, cls_std) with a zero bias so that random
    weights give detections above the 0.05 threshold."""
    from ground_plane_polling_tpu_torch.models import (build_detector,
                                                       init_detector)

    model = init_detector(model or build_detector(backbone), seed)
    out = model.classification.cls_out
    w = np.random.RandomState(seed).normal(0.0, cls_std, out.weight.shape)
    with torch.no_grad():
        out.weight.copy_(torch.from_numpy(w.astype(np.float32)))
        out.bias.zero_()
    return model


def phase1b_frozen_bn(torch, frozen_bn_cuda):
    """The frozen-BN kernel (csrc/frozen_bn.cu) at every site shape of
    ResNet-50's trunk at 416x1344 (tools/frozen_bn_bench.py's SITES), b1
    and b4, bf16 and float32, seeded non-identity BN (scales in
    [-0.5, 1.5), some negative; shifts N(0, 0.25)): the wrapper bit for
    bit against frozen_bn_cuda.plain, one launch a site. Then each bf16
    site alone against the plain passes and its byte bound at 3.35 TB/s
    (the tool's `time_site`: CUDA graphs of 20 launches, cold over twice
    the L2), summed over the 49 sites of a forward."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "frozen_bn_bench", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools", "frozen_bn_bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    assert sum(site[-1] for site in bench.SITES) == BN_SITES, bench.SITES

    log("phase 1b: the frozen-BN kernel against the plain passes at every "
        f"site shape of ResNet-50's trunk at {CANVAS[0]}x{CANVAS[1]}, b1 and "
        "b4, bf16 and float32, non-identity BN; then timed per site")
    dev = torch.device("cuda")
    zero_launches()
    checks, worst = 0, 0.0
    for b in bench.BATCHES:
        for dtype in (torch.bfloat16, torch.float32):
            for c, h, w, variant, _ in bench.SITES:
                gen = torch.Generator().manual_seed(SEED + 1 + c * h + b)

                def vec(scale, offset):
                    return (torch.rand(c, generator=gen) * scale
                            + offset).to(dtype).to(dev)

                def fmap():
                    return torch.randn(b, c, h, w, generator=gen).to(
                        dtype).to(dev).contiguous(
                        memory_format=torch.channels_last)

                proj = variant == "projected"
                args = (fmap(), vec(2.0, -0.5), vec(0.5, -0.25), True,
                        None if variant == "relu" else fmap(),
                        vec(2.0, -0.5) if proj else None,
                        vec(0.5, -0.25) if proj else None)
                got = frozen_bn_cuda.frozen_bn_act(*args)
                want = frozen_bn_cuda.plain(*args).contiguous(
                    memory_format=torch.channels_last)
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                assert got.is_contiguous(memory_format=torch.channels_last)
                assert torch.equal(got.view(bits), want.view(bits)), (
                    b, dtype, c, h, w, variant)
                worst = max(worst, float(
                    (got.float() - want.float()).abs().max()))
                checks += 1
    launched = zero_launches()["BN_ACT_LAUNCHES"]
    assert launched == checks, (launched, checks)
    log(f"  {checks} sites bit for bit (max |kernel - plain| {worst:g}), "
        f"{launched} launches, one a site")
    result = {"checks": checks, "launches": launched, "max_abs_err": worst}
    for b in bench.BATCHES:
        sums = dict.fromkeys(("kernel_ms_cold", "kernel_ms_warm",
                              "plain_ms_cold", "plain_ms_warm", "bound_ms"),
                             0.0)
        for c, h, w, variant, n in bench.SITES:
            out = bench.time_site(b, c, h, w, variant, dev)
            assert out["equal"], (b, c, h, w, variant)
            for k in sums:
                sums[k] += n * out[k]
        sums["share"] = sums["bound_ms"] / sums["kernel_ms_cold"]
        result[f"b{b}"] = sums
        log(f"  b{b}, a forward's {BN_SITES} sites: kernel "
            f"{sums['kernel_ms_cold']:.4f} ms cold, "
            f"{sums['kernel_ms_warm']:.4f} warm; plain passes "
            f"{sums['plain_ms_cold']:.4f} / {sums['plain_ms_warm']:.4f}; "
            f"bound {sums['bound_ms']:.4f} ms (bytes at 3.35 TB/s, "
            f"{100 * sums['share']:.1f}% reached)")
    zero_launches()
    return result


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

    zero_launches()  # count only the main path's own launches
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
    counts = zero_launches()
    launches = counts["LAUNCHES"]
    per_call = launches / (len(runs) * n_iter)
    assert launches == 2 * n_iter, f"polling kernel launched {launches} times"
    assert counts["NMS_LAUNCHES"] == 2 * n_iter, counts
    assert counts["BN_ACT_LAUNCHES"] == BN_SITES * 2 * n_iter, counts
    log(f"  kernel launches in the main path (captured calls): polling "
        f"{launches}, NMS {counts['NMS_LAUNCHES']}, {per_call:g} of each per "
        f"detect call; frozen BN {counts['BN_ACT_LAUNCHES']}, "
        f"{counts['BN_ACT_LAUNCHES'] // (2 * n_iter)} a call")

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
    return counts, per_call, timings


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
EQUAL_STEPS = 5  # phase 7a': captured against eager, bit for bit
EQUAL_SIDES = (608, 1024)  # phase 7a''s second canvas: 320x1024
TURNS = ("eager", "captured", "captured", "eager")  # blocks, phase 7a
LOADER_PACED_STEPS = 12  # phase 7a: the captured step fed by the loader
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


def train_model(torch, dev, stages=None, features=512, cls_std=None,
                remat=False):
    """Seeded detector (ResNet-50 and FPN 512 unless shrunk; `remat`
    recomputes its blocks in the backward pass), float32 parameters on
    `dev`, channels-last on the card."""
    from ground_plane_polling_tpu_torch.models import (GPPRetinaNet,
                                                       build_detector,
                                                       init_detector)
    from ground_plane_polling_tpu_torch.models.resnet import ResNetBackbone

    model = (build_detector("resnet50", remat=remat) if stages is None
             else GPPRetinaNet(ResNetBackbone(stages), feature_size=features))
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


def state_gaps(torch, a, b):
    """{kind: largest |a - b|} of two train states' parameters ("param"),
    Adam's moments ("exp_avg", "exp_avg_sq") and step counts ("step"),
    and "step_count": the difference of their step counters."""
    def arrays(state):
        names = {id(p): n for n, p in state.model.named_parameters()}
        out = {("param", n): p.detach()
               for n, p in state.model.named_parameters()}
        for p, s in state.optimizer.state.items():
            out.update({(k, names[id(p)]): t for k, t in s.items()})
        return out

    got, want = arrays(a), arrays(b)
    assert got.keys() == want.keys()
    gaps = {"step_count": abs(a.step - b.step)}
    for (kind, name), t in got.items():
        gap = float((t.float() - want[kind, name].float()).abs().max())
        gaps[kind] = max(gaps.get(kind, 0.0), gap)
    return gaps


def phase7a_equal(torch, loader, batches, dev, root, mesh=None, warmup=0,
                  steps=EQUAL_STEPS, label="7a'"):
    """From one copied state, `steps` fused bf16 steps captured and eagerly
    on the same batches under deterministic cuDNN (and a second eager run:
    the gap between two eager runs), then after the capture an lr change,
    a restore_checkpoint and a batch of a second canvas shape, each
    followed by steps that must keep the captured state equal to the eager
    one. With a `mesh`, the DDP step, after `warmup` steps (DDP's eager
    warm-up, the last followed by the capture)."""
    from ground_plane_polling_tpu_torch.data.kitti import KittiDataset
    from ground_plane_polling_tpu_torch.data.pipeline import KittiLoader
    from ground_plane_polling_tpu_torch.training.checkpoint import (
        restore_checkpoint, save_checkpoint)
    from ground_plane_polling_tpu_torch.training.train import (
        create_train_state, make_fused_train_step, make_optimizer)

    log(f"phase {label}: captured against eager from one copied state: "
        + (f"{warmup} DDP steps (eager on both sides: DDP's warm-up, the "
           "last followed by the capture), then " if warmup else "")
        + f"{steps} fused bf16 steps at b{TRAIN_BATCH} under "
        "deterministic cuDNN, then after the capture an lr change, a "
        "restore_checkpoint and a second canvas shape")
    other = KittiLoader(KittiDataset(root, "train"), batch_size=TRAIN_BATCH,
                        augment=True, raw_batches=True, seed=SEED,
                        device=dev, mesh=mesh, image_min_side=EQUAL_SIDES[0],
                        image_max_side=EQUAL_SIDES[1])
    assert other.image_shape != CANVAS, other.image_shape
    second = next(iter(other.epoch(prefetch=0)))
    result = {}
    with deterministic_cudnn(torch), tempfile.TemporaryDirectory() as tmp:
        model = train_model(torch, dev)  # the state before its first step
        states = {k: create_train_state(m, make_optimizer(m, 1e-5))
                  for k, m in (("captured", model),
                               ("eager", copy.deepcopy(model)),
                               ("eager2", copy.deepcopy(model)))}
        del model
        step = make_fused_train_step(loader=loader, bf16=True, mesh=mesh)
        # each eager state its own step: with a mesh, its own DDP wrapper
        fns = {"captured": step, "eager": step.eager,
               "eager2": make_fused_train_step(loader=loader, bf16=True,
                                               mesh=mesh).eager}
        ckpt = None

        def advance(stage, raws):
            nonlocal ckpt
            metrics = {k: [] for k in states}
            for i, raw in enumerate(raws):
                for k in states:
                    states[k], m = fns[k](states[k], raw)
                    metrics[k].append(torch.stack(list(m.values())))
                if ckpt is None and states["eager"].step == 2:
                    ckpt = save_checkpoint(tmp, states["eager"])
            metrics = {k: torch.stack(v).float() for k, v in metrics.items()}
            gaps = {}
            for k in ("captured", "eager2"):
                gaps[k] = state_gaps(torch, states[k], states["eager"])
                gaps[k]["metrics"] = float(
                    (metrics[k] - metrics["eager"]).abs().max())
            got, ref = gaps["captured"], gaps["eager2"]
            if any(got.values()):
                # allowed only where the eager step itself does not
                # repeat, and then within its gap
                assert any(ref.values()), (stage, got)
                assert all(v <= ref[k] for k, v in got.items()), (stage, got,
                                                                   ref)
            result[stage] = gaps
            log(f"  {stage}: captured against eager, largest gaps "
                + ", ".join(f"{k} {v:.3g}" for k, v in got.items())
                + "; eager against eager: " + ", ".join(
                    f"{k} {v:.3g}" for k, v in ref.items()))

        if warmup:
            advance(f"{warmup} warm-up steps", batches[:warmup])
            assert len(step.graphs) == 1, len(step.graphs)
        n = warmup + steps
        advance(f"{steps} steps", batches[warmup:n])
        for st in states.values():
            st.lr = 2.5e-6
        advance("lr 1e-5 -> 2.5e-6, 1 step", batches[n:n + 1])
        for k in states:
            states[k] = restore_checkpoint(ckpt, states[k])
        assert states["captured"].step == 2
        assert states["captured"].lr == float(np.float32(1e-5))
        advance(f"restore of {os.path.basename(ckpt)}, 1 step",
                batches[n + 1:n + 2])
        advance(f"canvas {other.image_shape[0]}x{other.image_shape[1]}, "
                "1 step", [second])
        assert len(step.graphs) == 2, len(step.graphs)
        advance(f"back to {CANVAS[0]}x{CANVAS[1]}, 1 step",
                batches[n + 2:n + 3])
        assert len(step.graphs) == 2, len(step.graphs)
    return result


def phase7_train(torch, polling_cuda, tmp, cli, smi):
    from torch.utils.flop_counter import FlopCounterMode

    from ground_plane_polling_tpu_torch.data.kitti import KittiDataset
    from ground_plane_polling_tpu_torch.data.pipeline import KittiLoader
    from ground_plane_polling_tpu_torch.training.train import (
        CapturedTrainStep, create_train_state, make_fused_train_step,
        make_optimizer, make_train_step)

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    root = write_train_split(tmp, cli)
    log("phase 7a: train step, ResNet-50, FPN 512, one class, seeded, bf16 "
        f"autocast, augmentation, fused prepare, batch {TRAIN_BATCH}, "
        f"375x1242 frames on a {CANVAS[0]}x{CANVAS[1]} canvas: the captured "
        "step (one CUDA graph) against step.eager, in turns")
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
    step = make_fused_train_step(loader=loader, bf16=True)
    assert isinstance(step, CapturedTrainStep), type(step)
    runs = {}
    for name, fn in (("eager", step.eager), ("captured", step)):
        model = train_model(torch, dev)
        runs[name] = [create_train_state(model, make_optimizer(model, 1e-5)),
                      fn]
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as flops:  # one eager step
        runs["eager"][0], _ = step.eager(runs["eager"][0], batches[0])
    torch.cuda.synchronize()
    peak_eager = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the captured step's first call: its step, run eagerly, and the capture
    runs["captured"][0], _ = step(runs["captured"][0], batches[0])
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    peak_capture = torch.cuda.max_memory_allocated()
    step_all(runs, batches[1:TRAIN_WARMUP - 1])
    # the last warm-up step under torch.cuda's sync debug mode: where the
    # host waits for the card inside a step (a copy from pageable memory, a
    # read-back), it cannot queue ahead of the card
    syncs = {}
    for name, run in runs.items():
        torch.cuda.synchronize()
        (run[0], _), syncs[name] = host_syncs(
            torch, lambda run=run: run[1](run[0], batches[TRAIN_WARMUP - 1]))
        torch.cuda.synchronize()
        assert not syncs[name], f"the {name} step waits for the card at " \
            f"{syncs[name]}"
    # timed in turns: eager / captured / captured / eager, each state
    # stepping every timed batch once, in order
    timed = batches[TRAIN_WARMUP:]
    half = len(timed) // 2
    ms, windows, terms = block_turns(torch, runs, timed, TURNS)
    assert runs["captured"][0].step == runs["eager"][0].step == n
    assert len(step.graphs) == 1, len(step.graphs)
    step_flops = flops.get_total_flops()
    result = {"host_ms_per_batch": host_ms, "step_tflop": step_flops / 1e12,
              "host_syncs": {k: len(v) for k, v in syncs.items()},
              "capture_s": capture_s, "peak_gib": {
                  "eager_step": peak_eager / 2**30,
                  "captured_first_call": peak_capture / 2**30}}
    for name, v in ms.items():
        med = float(np.median(v))
        result[name] = {"median_ms": med,
                        "p90_ms": float(np.percentile(v, 90)),
                        "img_s": TRAIN_BATCH / med * 1e3,
                        "window_img_s": TRAIN_BATCH * len(v) / windows[name]}
    eager, captured = result["eager"], result["captured"]
    turns = [float(np.median(v)) for v in (
        ms["eager"][:half], ms["captured"][:half], ms["captured"][half:],
        ms["eager"][half:])]
    log(f"  {smi}: step median eager {eager['median_ms']:.3f} ms, captured "
        f"{captured['median_ms']:.3f} ms; p90 eager {eager['p90_ms']:.3f}, "
        f"captured {captured['p90_ms']:.3f} (CUDA events around each of "
        f"{TRAIN_TIMED} steps a variant after {TRAIN_WARMUP} warm-up steps; "
        f"block medians eager / captured / captured / eager: "
        + " / ".join(f"{t:.3f}" for t in turns) + "); img/s at the median "
        f"eager {eager['img_s']:.2f}, captured {captured['img_s']:.2f}; over "
        f"the windows (host clock, synchronized) eager "
        f"{eager['window_img_s']:.2f}, captured "
        f"{captured['window_img_s']:.2f}")
    log(f"  first call of the captured step (its step, eager, and the "
        f"capture): {capture_s:.2f} s; peak memory (max_memory_allocated) "
        f"of an eager step {peak_eager / 2**30:.3f} GiB, of the captured "
        f"step's first call {peak_capture / 2**30:.3f} GiB; reserved after "
        f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB (two states, the "
        "graph's pool)")
    log(f"  {smi}: {result['step_tflop']:.4f} TFLOP a step (FlopCounterMode "
        "over one step of step.eager: convolutions and matmuls, forward and "
        f"backward), {step_flops / (captured['median_ms'] * 1e-3) / 989e12:.1%}"
        " of 989 TFLOP/s bf16 at the captured median step; host loading "
        f"(decode, resize, pad, draw) {host_ms:.1f} ms a batch, not in the "
        "step")
    log("  host-device synchronizations in a step "
        "(torch.cuda.set_sync_debug_mode('warn') over one warm-up step): "
        + ", ".join(f"{k} {len(v)}" for k, v in syncs.items()))
    log("  loss terms over the timed steps, first / last: " + ", ".join(
        f"{k} {v[0]:.5g} / {v[-1]:.5g}" for k, v in terms.items()))

    # where the step's time goes: device work against the step's time
    def stepping(run):
        def fn():
            run[0], _ = run[1](run[0], batches[-1])
        return fn

    for name, run in runs.items():
        host, ops, busy = call_profile(torch, stepping(run), reps=3)
        med = result[name]["median_ms"]
        idle = None if busy is None else 1 - busy / med
        result[name].update(host_api_calls=host, device_ops=ops,
                            device_busy_ms=busy, idle_share=idle)
        log(f"  {name}: device busy "
            + (f"{busy:.3f} ms a step (kernels and copies, torch.profiler "
               f"over 3 steps), idle {idle:.1%} of the median step"
               if busy is not None else "not measured (no device events)")
            + f"; {ops:g} device operations and {host:g} host API calls "
            "that start device work a step")
    # fit's pacing: the captured step fed by the loader's producer thread
    # (prefetch 2) as fit feeds it, against the step on loaded batches
    run = runs["captured"]
    it = iter(loader.epoch())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LOADER_PACED_STEPS):
        raw = next(it, None)
        if raw is None:
            it = iter(loader.epoch())
            raw = next(it)
        run[0], _ = step(run[0], raw)
    torch.cuda.synchronize()
    paced = (time.perf_counter() - t0) / LOADER_PACED_STEPS * 1e3
    result["loader_paced_ms"] = paced
    log(f"  fit's pacing: {paced:.2f} ms a step fed by the loader "
        f"(producer thread, prefetch 2, {len(loader)} batches an epoch, "
        f"{LOADER_PACED_STEPS} steps, host clock) against "
        f"{captured['median_ms']:.2f} ms on loaded batches and "
        f"{host_ms:.2f} ms of host loading a batch: "
        + ("the loader paces the step" if paced > 1.1 * captured["median_ms"]
           else "the step paces the loop"))
    result["7a_equal"] = phase7a_equal(torch, loader, batches, dev, root)
    del runs, step, batches

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
        "steps of the captured step with the validation sweep, then "
        "--snapshot auto")
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
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err), \
            captured_calls(CapturedTrainStep) as steps:
        state = train_cli.main(common + ["kitti", root])
    launches = polling_cuda.LAUNCHES
    # every step of bin/train went through the captured step: one capture
    # (one canvas shape), then replays
    assert steps == {"captures": 1, "calls": 4}, steps
    record = buf.getvalue().strip().splitlines()[-1]
    assert launches > 0, "the validation sweep did not launch the kernel"
    # the default loader: native C++ where it builds, else cv2
    loaders = sorted({ln for ln in err.getvalue().splitlines()
                      if ln.startswith("KittiLoader:")})
    result["7d"] = {"launches": launches, "loaders": loaders,
                    "captured_steps": steps}
    result["root"] = root
    log("  default loader of bin/train: " + "; ".join(loaders))
    assert state.step == 4, state.step
    ckpt = latest_checkpoint(snaps)
    assert ckpt and ckpt.endswith("step_00000004.pt"), ckpt
    log(f"  epoch: {time.perf_counter() - t0:.2f} s wall (init, 4 steps, "
        f"validation, checkpoint); the captured train step: "
        f"{steps['captures']} capture, {steps['calls']} calls (the first "
        f"its eager step and the capture, then replays); {launches} polling "
        f"launches in the validation sweep; {record}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            captured_calls(CapturedTrainStep) as steps:
        state = train_cli.main(common + ["--snapshot", "auto",
                                         "--no-evaluation", "kitti", root])
    assert state.step == 8, state.step
    assert steps == {"captures": 1, "calls": 4}, steps
    ckpt = latest_checkpoint(snaps)
    assert ckpt.endswith("step_00000008.pt"), ckpt
    log(f"  --snapshot auto: resumed at step 4, ended at step {state.step} "
        f"through the captured step ({steps['captures']} capture, "
        f"{steps['calls']} calls), {os.path.basename(ckpt)} written "
        f"({time.perf_counter() - t0:.2f} s wall)")
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


DP_RANKS = 2  # phase 9b: two ranks on the one card, over gloo
DP_WARMUP, DP_TIMED = 3, 20
REMAT_WARMUP, REMAT_TIMED = 2, 10
RANK_TIMEOUT = 480  # seconds for phase 9b's rank processes
GROUP_TIMEOUT = 300  # seconds, their process group's (GPP_DIST_INIT_TIMEOUT)
# phase 9b: the ranks' bf16 step's loss terms against the 1-process
# step's at the same global batch: each rank's convolutions run one row,
# the single process's all of them, and bf16 rounds them otherwise; two
# ranks on one card measured 6.57e-5 in two runs (PERF.md)
DP_BF16_RTOL = 1e-3
NO_CLIP = float("inf")
# --dp-cards: the captured DDP step's replays against the eager DDP step
# from one copied state under deterministic cuDNN, a step at a time. Only
# the buckets' all-reduce may sum in another order (rounding: ~1e-7 of a
# gradient); a stale or missing bucket reduction is off by the gradient's
# own size. Parameters: 1% of one Adam update at lr 1e-5
DDP_EQUAL_STEPS = 3
DDP_GRAD_RTOL, DDP_METRIC_RTOL, DDP_PARAM_ATOL = 1e-4, 1e-5, 1e-7


def wait_ranks(procs):
    """Wait for the rank processes up to RANK_TIMEOUT in all, or until one
    has failed (the others would wait in its collectives); the caller
    kills those still running, and each rank's log (where a rank that
    hangs writes its threads' stacks first: faulthandler) goes into the
    failure."""
    deadline = time.monotonic() + RANK_TIMEOUT
    while time.monotonic() < deadline:
        codes = [p.poll() for p in procs]
        if None not in codes or any(codes):
            return
        time.sleep(0.5)


def check_ranks(procs, logs):
    """Every rank exited 0; else the failure holds each failed rank's
    exit code and the end of its log."""
    failed = []
    for r, (p, f) in enumerate(zip(procs, logs)):
        f.seek(0)
        text = f.read()
        f.close()
        if p.returncode != 0:
            failed.append(f"rank {r} exited {p.returncode}:\n{text[-3000:]}")
    assert not failed, "\n".join(failed)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def train_batches(torch, root, dev, n, mesh=None, batch=TRAIN_BATCH):
    """The phase 7 loader (augmentation, raw batches, seed SEED) over the
    split at `root`, this rank's rows with a mesh, and its first n
    batches."""
    from ground_plane_polling_tpu_torch.data.kitti import KittiDataset
    from ground_plane_polling_tpu_torch.data.pipeline import KittiLoader

    loader = KittiLoader(KittiDataset(root, "train"), batch_size=batch,
                         augment=True, raw_batches=True, seed=SEED,
                         device=dev, mesh=mesh, image_min_side=TRAIN_SIDES[0],
                         image_max_side=TRAIN_SIDES[1])
    batches = []
    while len(batches) < n:
        batches += list(loader.epoch(prefetch=0))[:n - len(batches)]
    return loader, batches


def one_step(torch, dev, loader, raw, bf16, mesh=None, remat=False,
             clipnorm=1e-3, dtype="float32"):
    """One fused step of the seeded full-width detector (parameters in
    `dtype`): its loss terms and its gradients (after the clip at
    `clipnorm`) on the host."""
    from ground_plane_polling_tpu_torch.training.train import (
        create_train_state, make_fused_train_step, make_optimizer)

    model = train_model(torch, dev, remat=remat).to(getattr(torch, dtype))
    state = create_train_state(model, make_optimizer(model, 1e-5))
    step = make_fused_train_step(loader=loader, bf16=bf16, clipnorm=clipnorm,
                                 mesh=mesh)
    _, m = step(state, raw)
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.detach().float().cpu()
             for n, p in model.named_parameters()})


def compare_steps(got, want, label, rtol=1e-4):
    """Loss terms within rtol and each gradient tensor within 1e-3 of its
    norm (test_one_f32_step_matches_jax's tolerances); the worst of each."""
    (terms, grads), (want_terms, want_grads) = got, want
    worst_term = max(abs(terms[k] - v) / abs(v) for k, v in want_terms.items())
    assert worst_term <= rtol, (label, terms, want_terms)
    ratios = {}
    for k, g in want_grads.items():
        norm = float(g.norm())
        gap = float((grads[k] - g).abs().max())
        assert gap <= 1e-3 * norm, (label, k, gap, norm)
        ratios[k] = gap / norm if norm else 0.0
    worst = max(ratios.values())
    top = sorted(ratios.items(), key=lambda kv: -kv[1])[:3]
    log(f"  {label}: loss terms within {worst_term:.3e} (rtol {rtol:g}); "
        f"each gradient within {worst:.3e} of its norm (bound 1e-3) over "
        f"{len(want_grads)} tensors, median "
        f"{np.median(list(ratios.values())):.3e}; the worst: "
        + ", ".join(f"{k} {v:.2e}" for k, v in top))
    return worst_term, worst


def step_all(runs, batches):
    """Each run's step over `batches`, the runs in turns batch by batch
    (runs: {name: [state, step]}; the states advance in place)."""
    for raw in batches:
        for run in runs.values():
            run[0], _ = run[1](run[0], raw)


def timed_turns(torch, runs, batches):
    """CUDA-event ms of each run's step over `batches`, the runs in turns
    step by step: {name: [ms]}; the steps' metrics must be finite."""
    events = {name: [] for name in runs}
    metrics = []
    for raw in batches:
        for name, run in runs.items():
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            run[0], m = run[1](run[0], raw)
            stop.record()
            events[name].append((start, stop))
            metrics.append(m["loss"])
    torch.cuda.synchronize()
    assert torch.isfinite(torch.stack(metrics)).all()
    return {name: np.array([a.elapsed_time(b) for a, b in ev])
            for name, ev in events.items()}


def device_busy(torch, runs, batches):
    """{name: (device ms a step summed over streams, of it NCCL's kernels,
    kernels and copies a step, host ms a step to enqueue, device ms a step
    by kernel name)} of each run over `batches`: torch.profiler, then the
    host clock around the steps before the synchronize."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    n = len(batches)
    for name, run in runs.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for raw in batches:
                run[0], _ = run[1](run[0], raw)
            torch.cuda.synchronize()
        # kernels and copies: a record_function range also lands on the
        # device's timeline (DDP's forward is one), and is no device work
        on_device = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)
                     and "annotation" not in str(
                         getattr(e, "activity_type", "")).lower()]
        nccl = [e for e in on_device if "nccl" in e.name.lower()]
        t0 = time.perf_counter()
        for raw in batches:
            run[0], _ = run[1](run[0], raw)
        enqueue = (time.perf_counter() - t0) / n * 1e3
        torch.cuda.synchronize()
        by_name = collections.Counter()
        for e in on_device:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3 / n
        out[name] = tuple(v / n for v in (
            sum(e.time_range.elapsed_us() for e in on_device) / 1e3,
            sum(e.time_range.elapsed_us() for e in nccl) / 1e3,
            len(on_device))) + (enqueue, by_name)
    return out


def block_turns(torch, runs, batches, order):
    """Each run's steps over `batches`, the runs in blocks in `order` (a
    name a block; each run steps every batch once, in order, over its
    blocks): ({name: CUDA-event ms of each step}, {name: host seconds of
    its blocks, each synchronized}, the steps' metrics on the host in the
    order they ran). Every metric must be finite."""
    blocks = collections.Counter(order)
    parts = {name: list(np.array_split(np.arange(len(batches)), n))
             for name, n in blocks.items()}
    events = {name: [] for name in runs}
    windows = dict.fromkeys(runs, 0.0)
    metrics = []
    for name in order:
        run = runs[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in parts[name].pop(0):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            run[0], m = run[1](run[0], batches[i])
            stop.record()
            events[name].append((start, stop))
            metrics.append(m)
        torch.cuda.synchronize()
        windows[name] += time.perf_counter() - t0
    terms = {k: torch.stack([m[k] for m in metrics]).float().cpu().numpy()
             for k in metrics[0]}
    for k, v in terms.items():
        assert np.isfinite(v).all(), (k, v)
    return ({name: np.array([a.elapsed_time(b) for a, b in ev])
             for name, ev in events.items()}, windows, terms)


DDP_TURNS = ("eager", "captured", "plain", "plain", "captured", "eager")


def phase9a_nccl(torch, root, smi):
    """On a 1-rank NCCL group: the DDP fused bf16 step captured against
    step.eager (the eager DDP step) and the captured plain step, in turns;
    its capture's peak memory; host syncs in a replay; device busy, idle
    share, host API calls and NCCL's device ms a step; the f32 gradients
    of the DDP step against the plain step; then (9a') captured against
    eager bit for bit, and (9d) the captured mesh detect calls."""
    import datetime

    import torch.distributed as dist

    from ground_plane_polling_tpu_torch.parallel import (data_parallel_mesh,
                                                         shutdown)
    from ground_plane_polling_tpu_torch.training.train import (
        DDP_WARMUP, CapturedTrainStep, create_train_state,
        make_fused_train_step, make_optimizer)

    log(f"phase 9a: 1-rank NCCL group, the DDP fused bf16 step at b"
        f"{TRAIN_BATCH} captured (DDP_WARMUP {DDP_WARMUP} eager steps, the "
        f"last followed by the capture) against step.eager and phase 7a's "
        f"captured plain step: {DP_TIMED} steps each after the warm-up, in "
        "blocks " + " / ".join(DDP_TURNS))
    dev = torch.device("cuda")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = data_parallel_mesh()
        assert dist.get_backend() == "nccl" and mesh.size == 1
        loader, batches = train_batches(torch, root, dev,
                                        DDP_WARMUP + 1 + DP_TIMED, mesh)
        step = make_fused_train_step(loader=loader, bf16=True, mesh=mesh)
        assert isinstance(step, CapturedTrainStep), type(step)
        runs = {}
        for name, fn in (("eager", step.eager), ("captured", step),
                         ("plain", make_fused_train_step(loader=loader,
                                                         bf16=True))):
            model = train_model(torch, dev)
            runs[name] = [create_train_state(model, make_optimizer(model,
                                                                   1e-5)), fn]
        step_all(runs, batches[:DDP_WARMUP - 1])
        assert not step.graphs
        # the captured step's DDP_WARMUP-th call, alone: its eager step
        # and the capture
        run = runs["captured"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run[0], _ = step(run[0], batches[DDP_WARMUP - 1])
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        assert len(step.graphs) == 1, len(step.graphs)
        for name in ("eager", "plain"):
            runs[name][0], _ = runs[name][1](runs[name][0],
                                             batches[DDP_WARMUP - 1])
        syncs = {}
        for name, run in runs.items():
            torch.cuda.synchronize()
            (run[0], _), syncs[name] = host_syncs(
                torch, lambda run=run: run[1](run[0], batches[DDP_WARMUP]))
            torch.cuda.synchronize()
        assert not syncs["captured"], f"the captured DDP step waits for " \
            f"the card at {syncs['captured']}"
        assert not syncs["eager"], syncs["eager"]
        ms = block_turns(torch, runs, batches[DDP_WARMUP + 1:], DDP_TURNS)[0]
        assert runs["captured"][0].step == runs["eager"][0].step == len(
            batches)
        assert len(step.graphs) == 1, len(step.graphs)
        result = {name: {"median_ms": float(np.median(v)),
                         "p90_ms": float(np.percentile(v, 90))}
                  for name, v in ms.items()}
        result.update(capture_s=capture_s, capture_peak_gib=peak / 2**30,
                      host_syncs={k: len(v) for k, v in syncs.items()})
        for name, r in result.items():
            if isinstance(r, dict) and "median_ms" in r:
                log(f"  {smi}: {name} step median {r['median_ms']:.3f} ms, "
                    f"p90 {r['p90_ms']:.3f} ms (CUDA events, blocks "
                    + " / ".join(DDP_TURNS) + ")")
        log(f"  the capture call (its eager DDP step and the capture): "
            f"{capture_s:.2f} s, peak memory {peak / 2**30:.3f} GiB "
            "(max_memory_allocated; three states on the card)")
        log("  host-device synchronizations in a step (sync debug mode): "
            + ", ".join(f"{k} {len(v)}" for k, v in syncs.items())
            + " (captured: a replay)")

        def stepping(run):
            def fn():
                run[0], _ = run[1](run[0], batches[-1])
            return fn

        busy_runs = device_busy(torch, runs, batches[-3:])
        for name, run in runs.items():
            host, ops, busy = call_profile(torch, stepping(run), reps=3)
            med = result[name]["median_ms"]
            _, nccl, _, enqueue, _ = busy_runs[name]
            result[name].update(
                host_api_calls=host, device_ops=ops, device_busy_ms=busy,
                idle_share=None if busy is None else 1 - busy / med,
                nccl_ms=nccl, enqueue_ms=enqueue)
            log(f"  {name}: device busy "
                + (f"{busy:.3f} ms a step, idle {1 - busy / med:.1%} of the "
                   "median step" if busy is not None else "not measured")
                + f"; {nccl:.3f} ms of NCCL's kernels; {ops:g} device "
                f"operations and {host:g} host API calls that start device "
                f"work a step (torch.profiler over 3 steps); the host "
                f"returns from a step in {enqueue:.3f} ms")
        more = busy_runs["eager"][4].copy()
        more.subtract(busy_runs["plain"][4])
        log("  device ms a step that DDP adds, by kernel or copy: " + "; ".join(
            f"{k[:60]} {v:+.3f}" for k, v in more.most_common(4)))
        del runs, step, fn
        result["9a_equal"] = phase7a_equal(
            torch, loader, batches, dev, root, mesh=mesh, warmup=DDP_WARMUP,
            steps=3, label="9a'")
        result["9d"] = phase9d_detect(torch, mesh, smi)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        raw = batches[0]
        result["f32"] = compare_steps(
            one_step(torch, dev, loader, raw, False, mesh),
            one_step(torch, dev, loader, raw, False),
            "f32 step, TF32 off: DDP (1-rank NCCL) against plain, post-clip")
    finally:
        shutdown()
    return result


MESH_DETECT = (("data_parallel b1", 1, False), ("data_parallel b4", 4, False),
               ("shard_spatial b1", 1, True))


def phase9d_detect(torch, mesh, smi):
    """The mesh detect calls on 9a's 1-rank NCCL group, captured against
    detect.eager: data parallel at b1 and b4, shard_spatial at b1, bf16,
    ResNet-50 FPN 512 at 416x1344, 21,634 planes, pose on."""
    from ground_plane_polling_tpu_torch.inference import (CapturedDetect,
                                                          make_detect_fn,
                                                          place_model)

    log("phase 9d: the captured mesh detect calls on the 1-rank NCCL group "
        "(the outputs' all-gather, or the width split's exchanges, inside "
        "the graph) against detect.eager: "
        + ", ".join(label for label, _, _ in MESH_DETECT) + ", bf16")
    dev = mesh.device
    rng = np.random.RandomState(SEED + 9)
    planes = synthetic_planes(rng, N_PLANES)
    model = place_model(full_width_model(torch, SEED), dev, torch.bfloat16)
    rows = {}
    for label, b, spatial in MESH_DETECT:
        detect = make_detect_fn(model, CANVAS, with_pose=True,
                                device_preprocess=True, mesh=mesh,
                                shard_spatial=spatial)
        assert isinstance(detect, CapturedDetect), type(detect)
        rows[label] = held_captured(
            torch, detect, detect_inputs(torch, rng, b, dev, planes), label)
        if spatial:
            rows[label]["convs"] = len(detect.spatial.last.windows)
    log(f"  {smi}")
    return rows


def grad_dtype(backend):
    """The dtype of 9b's gradient comparison: float32 for two ranks on one
    card (one row a rank against two: 7.0e-4 of a norm at worst, PERF.md);
    float64 across cards, where one row a rank against the single
    process's N rows rounds float32 further (a ReLU input on the other
    side of 0, a bias summed over cancelling terms), as
    tests/test_torch_distributed.py's docstring sets out."""
    return "float32" if backend == "gloo" else "float64"


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN's deterministic algorithms (the gradient comparison of 9b
    then reads the same sums in every run), restored after."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def dp_train_args(work, extra=(), batch=TRAIN_BATCH, steps=2):
    """bin/train on phase 7d's split: 1 epoch of `steps` steps, bf16,
    augmentation, the validation sweep."""
    return (["--batch-size", str(batch), "--epochs", "1", "--steps",
             str(steps), "--bf16", "--random-transform", "--device", "cuda",
             "--snapshot-path", os.path.join(work, "dp_snaps"),
             "--log-path", os.path.join(work, "dp_log.jsonl"),
             "--tensorboard-dir", os.path.join(work, "dp_tb"),
             "--image-min-side", str(TRAIN_SIDES[0]), "--image-max-side",
             str(TRAIN_SIDES[1])] + list(extra)
            + ["kitti", os.path.join(work, "kitti_train")])


def dp_evaluate_args(work, extra=()):
    return [os.path.join(work, "eval_model.npz"), os.path.join(work, "kitti"),
            "--device", "cuda"] + list(extra)


def check_compiled_form(backend, fn):
    """A rank's mesh step or detect function `fn` as `backend` gets it:
    captured over NCCL (CapturedTrainStep, CapturedDetect), eager over
    gloo (`fn.eager is fn`); returns its class name, or "eager"."""
    from ground_plane_polling_tpu_torch.inference import CapturedDetect
    from ground_plane_polling_tpu_torch.training.train import (
        CapturedTrainStep)

    if backend == "gloo":
        assert fn.eager is fn, type(fn)
        return "eager"
    assert isinstance(fn, (CapturedTrainStep, CapturedDetect)), type(fn)
    return type(fn).__name__


def sync_state(torch, dst, src):
    """dst's parameters, Adam's moments and step counts and its step
    counter set to src's, in place (a captured step's graph reads dst's
    tensors where they are)."""
    pairs = list(zip(dst.model.named_parameters(),
                     src.model.named_parameters()))
    assert all(a == b for (a, _), (b, _) in pairs)
    with torch.no_grad():
        for (_, pd), (_, ps) in pairs:
            pd.copy_(ps)
            held = src.optimizer.state[ps]
            for k, t in dst.optimizer.state[pd].items():
                t.copy_(held[k])
    dst.step = src.step


def replicas_equal(torch, mesh, tensors):
    """Asserts that every rank of the mesh holds `tensors` alike: each
    one's float64 sum and sum of magnitudes, all-gathered over the group
    and compared (DDP keeps the replicas equal bit for bit). Returns how
    many tensors were checked."""
    import torch.distributed as dist

    sums = torch.stack([torch.stack([t.double().sum(), t.double().abs().sum()])
                        for t in tensors]).flatten()
    every = [torch.empty_like(sums) for _ in range(mesh.size)]
    dist.all_gather(every, sums, group=mesh.group)
    for r, other in enumerate(every):
        assert torch.equal(other, sums), (
            f"rank {r}'s checksums differ from rank {mesh.rank}'s in "
            f"{int((other != sums).sum())} of {sums.numel()}")
    return len(tensors)


def ddp_equal(torch, root, mesh, world):
    """The captured DDP bf16 step against step.eager, one row a rank, from
    one seeded state under deterministic cuDNN: DDP's warm-up (eager on
    both sides, the last step followed by the capture), then
    DDP_EQUAL_STEPS steps, each from the eager state copied into the
    captured one, so that a step's gaps are its own: the replay's metrics,
    its reduced and clipped gradients and the state after it against the
    eager DDP step's. Then every rank's captured parameters and gradients
    are checked alike across the ranks. The step is released after."""
    from ground_plane_polling_tpu_torch.training.train import (
        DDP_WARMUP, create_train_state, make_fused_train_step,
        make_optimizer)

    loader, batches = train_batches(torch, root, mesh.device,
                                    DDP_WARMUP + DDP_EQUAL_STEPS, mesh, world)
    with deterministic_cudnn(torch):
        step = make_fused_train_step(loader=loader, bf16=True, mesh=mesh)
        model = train_model(torch, mesh.device)
        twin = copy.deepcopy(model)
        runs = {"captured": [create_train_state(
                    model, make_optimizer(model, 1e-5)), step],
                "eager": [create_train_state(
                    twin, make_optimizer(twin, 1e-5)), step.eager]}
        del model, twin
        step_all(runs, batches[:DDP_WARMUP])
        assert len(step.graphs) == 1, len(step.graphs)
        gaps = []
        for raw in batches[DDP_WARMUP:]:
            sync_state(torch, runs["captured"][0], runs["eager"][0])
            metrics = {}
            for name, run in runs.items():
                run[0], metrics[name] = run[1](run[0], raw)
            got, want = runs["captured"][0], runs["eager"][0]
            grad = 0.0
            for (_, pg), (_, pw) in zip(got.model.named_parameters(),
                                        want.model.named_parameters()):
                assert (pg.grad is None) == (pw.grad is None)
                if pw.grad is None:
                    continue
                gap = float((pg.grad - pw.grad).abs().max())
                grad = max(grad, gap / max(float(pw.grad.norm()), 1e-30))
            metric = max(abs(float(metrics["captured"][k]) - float(v))
                         / max(abs(float(v)), 1e-30)
                         for k, v in metrics["eager"].items())
            gaps.append({"grads": grad, "metrics": metric,
                         **state_gaps(torch, got, want)})
        state = runs["captured"][0]
        checked = replicas_equal(torch, mesh, [
            t for p in state.model.parameters() for t in (p.detach(), p.grad)
            if t is not None])
        step.release()
    for g in gaps:
        assert (g["grads"] <= DDP_GRAD_RTOL
                and g["metrics"] <= DDP_METRIC_RTOL
                and g["param"] <= DDP_PARAM_ATOL and g["step"] == 0
                and g["step_count"] == 0), gaps
    return {"gaps": gaps, "replicas_checked": checked,
            "bit_equal": not any(v for g in gaps for v in g.values())}


def ddp_turns(torch, root, mesh, world):
    """The captured DDP bf16 step against its eager step, one row a rank,
    in blocks eager / captured / captured / eager after DDP's warm-up (the
    last warm-up step followed by the capture): each step's ms; then the
    captured state's parameters and gradients checked alike on every rank.
    The step is released after."""
    from ground_plane_polling_tpu_torch.training.train import (
        DDP_WARMUP, create_train_state, make_fused_train_step,
        make_optimizer)

    loader, batches = train_batches(torch, root, mesh.device,
                                    DDP_WARMUP + DP_TIMED, mesh, world)
    step = make_fused_train_step(loader=loader, bf16=True, mesh=mesh)
    runs = {}
    for name, fn in (("eager", step.eager), ("captured", step)):
        model = train_model(torch, mesh.device)
        runs[name] = [create_train_state(model, make_optimizer(model, 1e-5)),
                      fn]
    step_all(runs, batches[:DDP_WARMUP])
    assert len(step.graphs) == 1, len(step.graphs)
    ms = block_turns(torch, runs, batches[DDP_WARMUP:], TURNS)[0]
    state = runs["captured"][0]
    checked = replicas_equal(torch, mesh, [
        t for p in state.model.parameters() for t in (p.detach(), p.grad)
        if t is not None])
    step.release()
    return {"ddp_ms": ms["captured"].tolist(),
            "ddp_eager_ms": ms["eager"].tolist(),
            "ddp_replicas_checked": checked}


def dp_steps(backend):
    """bin/train --data-parallel's steps in phase 9b: over NCCL enough for
    the captured step to capture (DDP_WARMUP eager steps) and replay
    twice; over gloo (eager) 2."""
    from ground_plane_polling_tpu_torch.training.train import DDP_WARMUP

    return DDP_WARMUP + 2 if backend == "nccl" else 2


def rank_worker(rank, port, work, world, backend):
    """Rank `rank` of phase 9b's `world` ranks over `backend`: the f32 (no
    clip) and bf16 steps on its row of the global batch of `world` rows;
    with NCCL (one card a rank) the captured DDP bf16 step timed against
    its eager step in turns and held against it (ddp_equal); then
    bin/train and bin/evaluate --data-parallel, their captured steps and
    calls counted; what it saw goes to work/rank{rank}.pt."""
    import torch

    from ground_plane_polling_tpu_torch.bin import evaluate
    from ground_plane_polling_tpu_torch.bin import train as train_cli
    from ground_plane_polling_tpu_torch.kernels import (int8_conv_cuda,
                                                        polling_cuda)
    from ground_plane_polling_tpu_torch.parallel import (data_parallel_mesh,
                                                         initialize,
                                                         shutdown)
    from ground_plane_polling_tpu_torch.training.train import (
        CapturedTrainStep, make_fused_train_step)

    initialize(f"localhost:{port}", world, rank, backend=backend)
    mesh = data_parallel_mesh()
    dev = mesh.device
    out = {"device": str(dev), "compiled": check_compiled_form(
        backend, make_fused_train_step(num_classes=1, mesh=mesh))}
    root = os.path.join(work, "kitti_train")
    loader, (raw,) = train_batches(torch, root, dev, 1, mesh, world)
    out["rows"] = int(raw["images"].shape[0])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    with deterministic_cudnn(torch):
        out["f32"] = one_step(torch, dev, loader, raw, False, mesh,
                              clipnorm=NO_CLIP, dtype=grad_dtype(backend))
    out["bf16"] = one_step(torch, dev, loader, raw, True, mesh)[0]
    out["steps_s"] = time.perf_counter() - t0
    if backend == "nccl":
        out.update(ddp_turns(torch, root, mesh, world))
        out["ddp_equal"] = ddp_equal(torch, root, mesh, world)

    polling_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), captured_calls(
            CapturedTrainStep) as steps, captured_calls() as calls:
        state = train_cli.main(dp_train_args(work, ["--data-parallel"],
                                             world, dp_steps(backend)))
    import ast

    out["train"] = {"step": state.step, "launches": polling_cuda.LAUNCHES,
                    "s": time.perf_counter() - t0, "record": ast.literal_eval(
                        buf.getvalue().strip().splitlines()[-1]),
                    "captured": {"step": steps, "detect": calls}}
    del state
    for name, extra in (("float", []), ("int8", ["--int8", "2"])):
        polling_cuda.LAUNCHES = 0
        int8_conv_cuda.CONV_LAUNCHES = int8_conv_cuda.QUANTIZE_LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                captured_calls() as calls:
            mean_ap, errors = evaluate.main(dp_evaluate_args(
                work, ["--data-parallel"] + extra))
        out[name] = {"mAP": mean_ap, "errors": errors,
                     "s": time.perf_counter() - t0,
                     "launches": (polling_cuda.LAUNCHES,
                                  int8_conv_cuda.CONV_LAUNCHES,
                                  int8_conv_cuda.QUANTIZE_LAUNCHES),
                     "captured": calls}
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    shutdown()  # the CLIs' captured steps and calls are dropped: collected
    return 0


def phase9b_ranks(torch, work, eval_b1, smi, world=DP_RANKS,
                  backend="gloo"):
    """`world` rank processes, each launched with a timeout and joined,
    each held against the single process here: by default two on the one
    card over gloo (NCCL refuses two ranks on one device); with
    --dp-cards, one a card over NCCL."""
    from ground_plane_polling_tpu_torch.bin import evaluate
    from ground_plane_polling_tpu_torch.bin import train as train_cli

    where = ("on the one card over gloo (times include gloo's copies "
             "through the host; not a DDP speed)" if backend == "gloo"
             else "one a card over NCCL")
    log(f"phase 9b: {world} ranks {where}: f32 and bf16 steps at global "
        f"b{world} against one process, bin/train and bin/evaluate "
        "--data-parallel")
    t0 = time.perf_counter()
    port = free_port()
    env = dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{port}",
               NUM_PROCESSES=str(world),
               GPP_DIST_INIT_TIMEOUT=str(GROUP_TIMEOUT))
    logs = [open(os.path.join(work, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--port", str(port), "--work", work, "--dp-cards", str(world),
         "--backend", backend],
        env=dict(env, PROCESS_ID=str(r)), stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    try:
        # the single process's side, while the ranks run
        dev = torch.device("cuda")
        loader, (raw,) = train_batches(torch, os.path.join(work,
                                                           "kitti_train"),
                                       dev, 1, batch=world)
        with deterministic_cudnn(torch):
            want_f32 = one_step(torch, dev, loader, raw, False,
                                clipnorm=NO_CLIP, dtype=grad_dtype(backend))
        want_bf16 = one_step(torch, dev, loader, raw, True)[0]
        with contextlib.redirect_stdout(io.StringIO()):
            want_int8 = evaluate.main(dp_evaluate_args(
                work, ["--int8", "2", "--eval-batch", "1"]))
        wait_ranks(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check_ranks(procs, logs)
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    log(f"  ranks on {[r['device'] for r in ranks]}, "
        f"{[r['rows'] for r in ranks]} rows each of the b{world} batch; "
        f"the train step over {backend}: "
        f"{[r['compiled'] for r in ranks]}")

    result = {}
    for r, got in enumerate(ranks):
        result[f"f32_rank{r}"] = compare_steps(
            got["f32"], want_f32, f"rank {r}: {grad_dtype(backend)} step, "
            "TF32 off, against 1 process, pre-clip")
    for k, g in ranks[0]["f32"][1].items():
        for other in ranks[1:]:
            assert torch.equal(other["f32"][1][k], g), k
    bf16_gap = max(abs(r["bf16"][k] - v) / abs(v) for r in ranks
                   for k, v in want_bf16.items())
    log(f"  bf16 step: loss terms within {bf16_gap:.3e} of 1 process's "
        f"(rtol {DP_BF16_RTOL:g}); the ranks' f32 gradients are equal; "
        f"steps {[round(r['steps_s'], 2) for r in ranks]} s a rank")
    assert bf16_gap <= DP_BF16_RTOL, (bf16_gap, [r["bf16"] for r in ranks],
                                      want_bf16)
    result["bf16_gap"] = bf16_gap

    if backend == "nccl":
        from ground_plane_polling_tpu_torch.training.train import DDP_WARMUP

        for r, got in enumerate(ranks):
            eq = got["ddp_equal"]
            worst = {k: max(g[k] for g in eq["gaps"]) for k in eq["gaps"][0]}
            result[f"ddp_equal_rank{r}"] = worst
            log(f"  rank {r}: captured DDP step against step.eager from one "
                f"copied state (deterministic cuDNN), {DDP_EQUAL_STEPS} "
                f"replays after {DDP_WARMUP} eager steps, each from the "
                f"eager state: largest gaps {worst} (bounds: gradients "
                f"{DDP_GRAD_RTOL:g} of their norm, metrics "
                f"{DDP_METRIC_RTOL:g}, parameters {DDP_PARAM_ATOL:g}); bit "
                f"for bit: {eq['bit_equal']}; parameters and gradients "
                f"alike on every rank ({eq['replicas_checked']} tensors, and "
                f"{got['ddp_replicas_checked']} after the timed turns)")
    steps = dp_steps(backend)
    records = [r["train"]["record"] for r in ranks]
    for r, got in enumerate(ranks):
        assert got["train"]["step"] == steps, (r, got["train"]["step"])
        assert got["train"]["launches"] > 0, r
        counts = [got["train"]["captured"]["step"],
                  got["train"]["captured"]["detect"],
                  got["float"]["captured"], got["int8"]["captured"]]
        if backend == "nccl":  # the captured step and sweep, captured calls
            assert counts[0] == {"captures": 1, "calls": steps}, counts
            assert all(c["captures"] >= 1 and c["calls"] >= c["captures"]
                       for c in counts[1:]), counts
        else:
            assert not any(c["calls"] for c in counts), counts
    log(f"  captures and calls of captured steps and detect calls in rank "
        f"{len(ranks) - 1}'s CLIs (bin/train's step, its sweep, bin/evaluate "
        f"float and --int8): {counts}")
    assert all(r["mAP"] == records[0]["mAP"] for r in records), records
    with open(os.path.join(work, "dp_log.jsonl")) as f:
        assert len(f.read().splitlines()) == 1
    assert len(os.listdir(os.path.join(work, "dp_tb"))) == 1
    snaps = os.path.join(work, "dp_snaps")
    snap = f"step_{steps:08d}.pt"
    assert os.listdir(snaps) == [snap], os.listdir(snaps)
    names = torch.load(os.path.join(snaps, snap), weights_only=True)["model"]
    assert not [k for k in names if k.startswith("module.")]
    log(f"  bin/train --data-parallel --tensorboard-dir, {steps} steps: "
        f"{[round(r['train']['s'], 2) for r in ranks]} s a rank, polling "
        f"launches {[r['train']['launches'] for r in ranks]}, mAP "
        f"{records[0]['mAP']:.6g} on every rank; one log line, one event "
        "file, one checkpoint (no `module.` names)")
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        state = train_cli.main(dp_train_args(work, [
            "--snapshot", "auto", "--no-evaluation", "--steps", "1"], world))
    assert state.step == steps + 1, state.step
    log(f"  1-process bin/train --snapshot auto from the {world}-rank "
        f"checkpoint: step {steps} -> {state.step} "
        f"({time.perf_counter() - t1:.2f} s)")

    for name, want in (("float", eval_b1), ("int8", want_int8)):
        want_ap, want_errors = want
        for r, got in enumerate(ranks):
            polls, convs, quants = got[name]["launches"]
            assert polls > 0, (name, r)
            if name == "int8":
                assert convs > 0 and convs % INT8_SITES[False] == 0, convs
                assert quants > 0
            assert abs(got[name]["mAP"] - want_ap) <= 1e-6, (name, r)
            for k, v in want_errors.items():
                assert abs(got[name]["errors"][k] - v) <= 1e-4, (name, r, k)
        log(f"  bin/evaluate --data-parallel {name}: "
            f"{[round(r[name]['s'], 2) for r in ranks]} s a rank, launches "
            "(polling, int8 conv, quantize) "
            f"{[r[name]['launches'] for r in ranks]}; mAP "
            f"{ranks[0][name]['mAP']:.6g} == 1 process's --eval-batch 1 "
            f"{want_ap:.6g} (mAP within 1e-6, errors within 1e-4)")
        result[f"evaluate_{name}_s"] = [r[name]["s"] for r in ranks]
    result["launches"] = {f"rank{r}": {
        "train_polling": got["train"]["launches"],
        "evaluate_polling": got["float"]["launches"][0],
        "evaluate_int8": list(got["int8"]["launches"])}
        for r, got in enumerate(ranks)}
    if backend == "nccl":
        result["scaling"] = dp_scaling(torch, work, ranks, world, smi)
    log(f"  phase 9b wall: {time.perf_counter() - t0:.2f} s")
    return result


def dp_scaling(torch, work, ranks, world, smi):
    """The ranks' DDP bf16 step (one row a card) against one card's plain
    step at b1 and at b`world`, timed here in turns after the ranks."""
    from ground_plane_polling_tpu_torch.training.train import (
        create_train_state, make_fused_train_step, make_optimizer)

    dev = torch.device("cuda")
    root = os.path.join(work, "kitti_train")
    runs, batches = {}, {}
    for b in (1, world):
        loader, batches[b] = train_batches(torch, root, dev,
                                           DP_WARMUP + DP_TIMED, batch=b)
        model = train_model(torch, dev)
        runs[b] = [create_train_state(model, make_optimizer(model, 1e-5)),
                   make_fused_train_step(loader=loader, bf16=True)]
    ms = {}
    for i in range(DP_WARMUP + DP_TIMED):
        for b, run in runs.items():
            ms.setdefault(b, []).append(timed_turns(
                torch, {b: run}, [batches[b][i]])[b][0])
    out = {f"one_card_b{b}_ms": float(np.median(v[DP_WARMUP:]))
           for b, v in ms.items()}
    out["ranks_ddp_ms"] = [float(np.median(r["ddp_ms"])) for r in ranks]
    out["ranks_ddp_eager_ms"] = [float(np.median(r["ddp_eager_ms"]))
                                 for r in ranks]
    ddp = max(out["ranks_ddp_ms"])
    out["img_s"] = {"ddp": world / ddp * 1e3,
                    **{f"one_card_b{b}": b / out[f"one_card_b{b}_ms"] * 1e3
                       for b in runs}}
    log(f"  {smi}: DDP step, 1 row on each of {world} cards: captured "
        f"median {out['ranks_ddp_ms']} ms by rank, eager "
        f"{out['ranks_ddp_eager_ms']} (blocks eager / captured / captured / "
        f"eager) ({out['img_s']['ddp']:.2f} img/s captured "
        f"at the slowest); one card, plain: b1 {out['one_card_b1_ms']:.3f} "
        f"ms, b{world} {out[f'one_card_b{world}_ms']:.3f} ms (CUDA events, "
        f"{DP_TIMED} steps after {DP_WARMUP}); img/s {out['img_s']}")
    return out


def phase9c_remat(torch, root, smi):
    """The captured b2 bf16 step with and without --remat: peak memory of
    the first call (its eager step and the capture into the graph's pool),
    step time in turns, and the f32 gradients."""
    from ground_plane_polling_tpu_torch.training.train import (
        CapturedTrainStep, create_train_state, make_fused_train_step,
        make_optimizer)

    log(f"phase 9c: --remat, the captured fused bf16 step at b{TRAIN_BATCH}:"
        " peak memory alone over the first call (its eager step and the "
        f"capture), then {REMAT_TIMED} steps after {REMAT_WARMUP} in turns")
    dev = torch.device("cuda")
    loader, batches = train_batches(torch, root, dev,
                                    REMAT_WARMUP + REMAT_TIMED)

    def build(remat):
        model = train_model(torch, dev, remat=remat)
        step = make_fused_train_step(loader=loader, bf16=True)
        assert isinstance(step, CapturedTrainStep), type(step)
        return [create_train_state(model, make_optimizer(model, 1e-5)), step]

    result = {}
    variants = (("plain", False), ("remat", True))
    for name, remat in variants:  # each alone on the card
        run = build(remat)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run[0], _ = run[1](run[0], batches[0])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        result[name] = {"peak_gib": peak / 2**30,
                        "step_gib": (peak - resident) / 2**30,
                        "reserved_gib": torch.cuda.memory_reserved() / 2**30}
        del run
    runs = {name: build(remat) for name, remat in variants}
    step_all(runs, batches[:REMAT_WARMUP])
    torch.cuda.synchronize()
    ms = timed_turns(torch, runs, batches[REMAT_WARMUP:])
    for name, v in ms.items():
        result[name]["median_ms"] = float(np.median(v))
        log(f"  {smi}: {name}: captured step median {np.median(v):.3f} ms "
            f"(CUDA events, in turns); first call's peak "
            f"{result[name]['peak_gib']:.3f} GiB, "
            f"{result[name]['step_gib']:.3f} GiB above the resident state "
            f"(max_memory_allocated), {result[name]['reserved_gib']:.3f} GiB "
            "reserved after it")
    del runs
    raw = batches[0]
    result["f32"] = compare_steps(
        one_step(torch, dev, loader, raw, False, remat=True,
                 clipnorm=NO_CLIP),
        one_step(torch, dev, loader, raw, False, clipnorm=NO_CLIP),
        "f32 step, TF32 off: remat against plain, pre-clip")
    return result


def dp_cards(torch, polling_cuda, smi, world, phase=None):
    """--dp-cards: phase 6's and phase 7's splits, then phase 9b, and
    phase 12c, over NCCL, one rank a card (`phase`: only that one)."""
    assert torch.cuda.device_count() >= world, torch.cuda.device_count()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        if phase in (None, "9b"):
            rng = np.random.RandomState(SEED + 1)
            cli = {"base": rng.randint(0, 256, (375, 1242, 3)).astype(
                np.uint8)}
            evaluated = phase6_evaluate(torch, polling_cuda, tmp, cli)
            write_train_split(tmp, cli)
            out["data_parallel"] = phase9b_ranks(
                torch, tmp, evaluated["b1"], smi, world, "nccl")
        if phase in (None, "12c"):
            out["shard_spatial"] = phase12c_spatial(
                torch, polling_cuda, tmp, smi, world, "nccl")
    print(smi)
    print(json.dumps(out))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phase9_parallel(torch, tmp, smi, eval_b1):
    t_phase = time.perf_counter()
    root = os.path.join(tmp, "kitti_train")
    result = {"9a": phase9a_nccl(torch, root, smi),
              "9b": phase9b_ranks(torch, tmp, eval_b1, smi),
              "9c": phase9c_remat(torch, root, smi)}
    log(f"  phase 9 wall: {time.perf_counter() - t_phase:.2f} s")
    return result


# phase 10: the other backbone families
BACKBONES_FULL = ("tiny", "vgg16", "densenet121", "mobilenet224_1.0")
# phase 10b: the depth each VGG and DenseNet name is cut to (the JAX
# classes' `blocks` / `block_sizes`), so that the CPU's side stays short:
# VGG's blocks 2 convs shorter (at least 1), DenseNet's blocks an eighth
# as deep (rounded up); the other names run at their full depth
SHRUNK_DEPTH = {"vgg16": (1, 1, 1, 1, 1), "vgg19": (1, 1, 2, 2, 2),
                "densenet121": (1, 2, 3, 2), "densenet169": (1, 2, 4, 4),
                "densenet201": (1, 2, 6, 4)}
DW_SITES = 13  # depthwise conv sites of MobileNet, each a launch
MOBILENET_SITES = 110  # conv sites of the MobileNet detector (split heads)
CLI_TIMEOUT = 240  # seconds for each of phase 10d's CLI processes


def phase10_model(name):
    """The detector of registry name `name`, at SHRUNK_DEPTH where it has
    one."""
    from ground_plane_polling_tpu_torch.models import (GPPRetinaNet,
                                                       backbone_registry)
    from ground_plane_polling_tpu_torch.models.densenet import (
        DenseNetBackbone)
    from ground_plane_polling_tpu_torch.models.vgg import VGGBackbone

    if name in SHRUNK_DEPTH:
        family = VGGBackbone if name.startswith("vgg") else DenseNetBackbone
        net = family(SHRUNK_DEPTH[name])
    else:
        net = backbone_registry()[name]()
    return GPPRetinaNet(net, backbone_channels=net.channels)


def depthwise_bound(x, y):
    """{"bytes": ms, "operations": ms} of one int8 depthwise 3x3 site: its
    input (float x for the fused quantize, 2 or 4 bytes an element),
    weights and scales read once and its output written once at the memory
    rate; 9 multiply-adds an output at the int8 peak."""
    c = x.shape[1]
    nbytes = (x.numel() * x.element_size() + 9 * c + 4 * c
              + y.numel() * y.element_size())
    return {"bytes": nbytes / PEAK_BYTES * 1e3,
            "operations": 18 * y.numel() / PEAK_INT8_OPS * 1e3}


def phase10c_depthwise(torch, int8_conv_cuda, int8_depthwise_cuda, sites,
                       label, floor_ms, other=None):
    """Each distinct depthwise shape of one forward: the kernel from the
    float site input (its fused quantize) against the plain version
    (quantize_int8_conv2d) bit for bit, and from the int8 input (its int32
    accumulators and bf16 output); device times (device_ms) of the fused
    kernel beside its bound, of the unfused pair (the quantize kernel, then
    the int8-input depthwise), of cuDNN's bf16 grouped conv and of the
    plain version (CUDA events). With `other` (another checkout's
    int8_depthwise_cuda, which takes int8 input), its kernel on this
    tree's int8 input, in turns with this tree's fused kernel (other,
    this, this, other; outputs equal). Returns rows."""
    import torch.nn.functional as F

    from ground_plane_polling_tpu_torch.ops import int8_conv as plain

    dw = int8_depthwise_cuda
    rows = []
    for key, e in sites.items():
        x_shape, w_shape, stride, pad = key
        x, s_x, conv = e["x"], e["s_x"], e["conv"]
        with torch.inference_mode():
            w8, s_w = e["weight"]
            site = (w8, s_w, conv.bias, stride, pad, x.dtype)
            y = dw.quantize_depthwise2d(x, s_x, *site)
            y_ref = plain.quantize_int8_conv2d(x, s_x, *site)
            x8 = int8_conv_cuda.quantize(x, s_x)
            acc = dw.depthwise2d_accumulate(x8, w8, stride, pad)
            acc_ref = plain.conv2d_int8(x8, w8, stride, pad)
            y8 = dw.depthwise2d(x8, w8, s_x, *site[1:])
            err = max(float((acc.double() - acc_ref.double()).abs().max()),
                      float((y.double() - y_ref.double()).abs().max()),
                      float((y8.double() - y_ref.double()).abs().max()))
            assert err == 0.0 and torch.equal(y, y_ref), (label, key, err)
            (top, bottom), (left, right) = pad
            xp = F.pad(x, (left, right, top, bottom))
            c = x_shape[1]
            bound = depthwise_bound(x, y)
            row = {
                "key": key, "n": e["n"], "err": err,
                "plan": dw.plan_depthwise(y.shape[0], y.shape[2],
                                          y.shape[3], c, stride),
                "ms": device_ms(torch, lambda: dw.quantize_depthwise2d(
                    x, s_x, *site)),
                "pair_ms": device_ms(torch, lambda: dw.depthwise2d(
                    int8_conv_cuda.quantize(x, s_x), w8, s_x, *site[1:])),
                "cudnn_ms": device_ms(torch, lambda: F.conv2d(
                    xp, conv.weight, None, stride, groups=c)),
                "plain_ms": cuda_ms(lambda: plain.quantize_int8_conv2d(
                    x, s_x, *site), 10, 3),
                "bound_by": max(bound, key=bound.get),
            }
            row["bound_ms"] = bound[row["bound_by"]]
            if other is not None:
                assert torch.equal(other.depthwise2d(x8, w8, s_x, *site[1:]),
                                   y_ref)
                turns = {"other": [], "this": []}
                for name in ("other", "this", "this", "other"):
                    turns[name].append(device_ms(torch, (
                        lambda: other.depthwise2d(x8, w8, s_x, *site[1:]))
                        if name == "other" else
                        (lambda: dw.quantize_depthwise2d(x, s_x, *site))))
                row["turns"] = turns
        rows.append(row)
        log(f"  {label} x{tuple(x_shape)} s{stride} pad{pad} x{e['n']}: "
            f"fused kernel {row['ms']:.4f} ms (bound {row['bound_ms']:.4f} "
            f"by {row['bound_by']}, {row['bound_ms'] / row['ms']:.1%} of "
            f"it; launch floor {floor_ms:.4f}; plan {row['plan']}), unfused "
            f"pair {row['pair_ms']:.4f}, cuDNN bf16 groups={c} "
            f"{row['cudnn_ms']:.4f}, plain (events) {row['plain_ms']:.4f}; "
            "equal bit for bit")
        if other is not None:
            log(f"    in turns, device ms, other tree (int8 input): "
                f"{row['turns']['other'][0]:.4f}, "
                f"{row['turns']['other'][1]:.4f}; this tree (fused): "
                f"{row['turns']['this'][0]:.4f}, "
                f"{row['turns']['this'][1]:.4f}")
    return rows


def depthwise_per_call(rows, floor_ms):
    """Sums over a forward's 13 sites of phase10c_depthwise's rows."""
    out = {k: sum(r[k] * r["n"] for r in rows) for k in (
        "ms", "pair_ms", "plain_ms", "bound_ms", "cudnn_ms")}
    out["err"] = max(r["err"] for r in rows)
    out["bound_by"] = "bytes" if all(
        r["bound_by"] == "bytes" for r in rows) else "operations"
    out["floor_ms"] = floor_ms * DW_SITES
    if "turns" in rows[0]:
        out["against"] = {name: [sum(r["turns"][name][i] * r["n"]
                                     for r in rows) for i in (0, 1)]
                          for name in ("other", "this")}
    return out


def run_clis(runs, work):
    """Start each (name, argv of `--cli`) as a process of this script at
    once, wait for all with CLI_TIMEOUT each and kill what is left; returns
    {name: (the CLI's launch counts, its last output lines)}."""
    logs = {name: open(os.path.join(work, f"{name}.log"), "w+")
            for name, _ in runs}
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cli", *argv],
        stdout=logs[name], stderr=subprocess.STDOUT) for name, argv in runs}
    try:
        deadline = time.monotonic() + CLI_TIMEOUT
        for p in procs.values():
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {}
    for name, p in procs.items():
        logs[name].seek(0)
        lines = logs[name].read().splitlines()
        logs[name].close()
        assert p.returncode == 0, f"{name} exited {p.returncode}:\n" + \
            "\n".join(lines[-40:])
        counts = json.loads(lines[-1].split("CLI_COUNTS ", 1)[1])
        out[name] = counts, lines[-3:-1]
    return out


def cli_worker(module, argv):
    """Run bin/`module`.main(argv) of the port and print its kernels'
    launch counts as the last line (phase 10d's processes)."""
    import importlib

    from ground_plane_polling_tpu_torch.kernels import (int8_conv_cuda,
                                                        int8_depthwise_cuda,
                                                        polling_cuda)

    result = importlib.import_module(
        f"ground_plane_polling_tpu_torch.bin.{module}").main(argv)
    print("CLI_COUNTS " + json.dumps({
        "polling": polling_cuda.LAUNCHES,
        "conv": int8_conv_cuda.CONV_LAUNCHES,
        "quantize": int8_conv_cuda.QUANTIZE_LAUNCHES,
        "depthwise": int8_depthwise_cuda.DEPTHWISE_LAUNCHES,
        "step": getattr(result, "step", None)}), flush=True)
    return 0


def phase10_backbones(torch, polling_cuda, int8_conv_cuda,
                      int8_depthwise_cuda, tmp, cli, other_dw=None):
    """The other backbone families: (a) one variant of each at full width
    in bf16; (b) every registry name, card against CPU in float32; (c)
    int8 on mobilenet224_1.0 with the depthwise kernel (and `other_dw`,
    another checkout's int8_depthwise_cuda, in turns); (d) the CLIs."""
    import copy

    from ground_plane_polling_tpu_torch.data.kitti import BGR_MEAN
    from ground_plane_polling_tpu_torch.inference import (make_detect_fn,
                                                          place_model)
    from ground_plane_polling_tpu_torch.models import (backbone_registry,
                                                       export_jax_params)
    from ground_plane_polling_tpu_torch.models import quantize as tq

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 10)
    planes = synthetic_planes(rng, N_PLANES)
    P_inv = np.linalg.pinv(P2).astype(np.float32)

    def detect_args(b):
        return (torch.from_numpy(rng.randint(0, 256, (b, *CANVAS, 3)).astype(
                    np.uint8)).to(dev),
                torch.from_numpy(np.tile(P_inv[None], (b, 1, 1))).to(dev),
                torch.from_numpy(np.tile(planes[None], (b, 1, 1))).to(dev))

    args = {b: detect_args(b) for b in (1, 4)}
    log(f"phase 10a: {', '.join(BACKBONES_FULL)} at full width: FPN 512, "
        f"seeded, bf16, {CANVAS[0]}x{CANVAS[1]}, {N_PLANES} planes, b1 and "
        "b4 (host clock over 10 synchronized calls after 3)")
    result = {"10a": {}}
    weights = {}
    for name in BACKBONES_FULL:
        t0 = time.perf_counter()
        model = full_width_model(torch, SEED, backbone=name)
        if name in ("densenet121", "mobilenet224_1.0"):  # for phase 10d
            weights[name] = os.path.join(tmp, f"{name}.npz")
            np.savez(weights[name], **export_jax_params(model))
        model = place_model(model, dev, torch.bfloat16)
        row = {}
        for b in (1, 4):
            detect = make_detect_fn(model, CANVAS, with_pose=True,
                                    device_preprocess=True, device=dev)
            polling_cuda.LAUNCHES = 0
            sec, out = timed_detect(torch, detect, args[b])
            assert polling_cuda.LAUNCHES == 13, polling_cuda.LAUNCHES
            scores = out.scores.float().cpu().numpy()
            assert scores.shape == (b, 100) and np.isfinite(scores).all()
            n_valid = (scores > 0).sum(axis=1)
            assert (n_valid >= 1).all(), (name, b, n_valid)
            row[f"b{b}_ms"] = sec * 1e3
            row[f"b{b}_img_s"] = b / sec
            log(f"  {name} b{b}: {sec * 1e3:.3f} ms per call, "
                f"{b / sec:.2f} img/s, 1 polling launch per call, valid "
                f"detections per image {n_valid.tolist()}")
        result["10a"][name] = row
        log(f"  {name}: {time.perf_counter() - t0:.2f} s wall (seeded init "
            "on the CPU, warm-up and timing)")
        del model, detect

    log("phase 10b: every registry name, float32 with TF32 off, 128x416: "
        "card against CPU (VGG and DenseNet at the depths of SHRUNK_DEPTH)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(rng.randint(0, 256, (1, 128, 416, 3)).astype(
        np.float32) - BGR_MEAN).permute(0, 3, 1, 2)
    worst = 0.0
    for name in sorted(backbone_registry()):
        cpu_net = place_model(full_width_model(
            torch, SEED, model=phase10_model(name)), "cpu")
        card_net = place_model(copy.deepcopy(cpu_net), dev)
        with torch.inference_mode():
            want = cpu_net(x)
            got = {k: v.cpu() for k, v in card_net(x.to(dev)).items()}
        errs = []
        for k, ref in want.items():
            atol = 1e-3 * float(ref.abs().max())
            np.testing.assert_allclose(got[k].numpy(), ref.numpy(),
                                       rtol=1e-3, atol=atol,
                                       err_msg=f"{name} f32 head {k}")
            errs.append(float((got[k] - ref).abs().max()) / max(atol, 1e-30))
        worst = max(worst, max(errs))
        log(f"  {name}: max |card - cpu| / (1e-3 max|cpu|) over the heads "
            f"{max(errs):.3f} (rtol 1e-3, atol 1e-3 max|cpu|)")
        del cpu_net, card_net
    result["10b_worst"] = worst

    name = "mobilenet224_1.0"
    model = place_model(full_width_model(torch, SEED, backbone=name), dev,
                        torch.bfloat16)
    canvases = [torch.from_numpy(rng.randint(0, 256, (1, *CANVAS, 3)).astype(
        np.uint8)).to(dev) for _ in range(INT8_CALIB)]
    scales = tq.collect_scales_uint8(model, canvases)
    assert scales.shape == (MOBILENET_SITES,) and (scales > 0).all()
    floor_ms = device_ms(torch, lambda: torch.cuda._sleep(0))
    log(f"phase 10c: int8, {name} bf16 at {CANVAS[0]}x{CANVAS[1]}, "
        f"calibrated (absmax) on {INT8_CALIB} canvases, {len(scales)} "
        f"sites, {DW_SITES} depthwise: the depthwise kernel against its "
        "plain version at every depthwise shape at b1 and b4 (device times "
        "as in phase 8a), beside the launch floor (torch.cuda._sleep(0): "
        f"{floor_ms:.4f} device ms)"
        + ("; with --against, the other tree's depthwise kernel in turns"
           if other_dw is not None else ""))
    mean = torch.as_tensor(BGR_MEAN, device=dev)
    per_call = {}
    for b in (1, 4):
        xb = (args[b][0].float() - mean).permute(0, 3, 1, 2)
        sites = int8_site_inputs(torch, tq, model, scales, xb,
                                 keep=lambda k: k[1][1] == 1)
        assert sum(e["n"] for e in sites.values()) == DW_SITES
        rows = phase10c_depthwise(torch, int8_conv_cuda,
                                  int8_depthwise_cuda, sites, f"b{b}",
                                  floor_ms, other_dw)
        del sites
        pc = per_call[f"b{b}"] = depthwise_per_call(rows, floor_ms)
        pc["rows"] = rows
        log(f"  per b{b} forward ({len(rows)} distinct shapes, {DW_SITES} "
            f"sites), device ms: fused kernel {pc['ms']:.4f} (bound "
            f"{pc['bound_ms']:.4f} by {pc['bound_by']}, "
            f"{pc['bound_ms'] / pc['ms']:.1%} of it; {DW_SITES} launch "
            f"floors {pc['floor_ms']:.4f}), unfused pair "
            f"{pc['pair_ms']:.4f}, cuDNN bf16 {pc['cudnn_ms']:.4f}, plain "
            f"(events) {pc['plain_ms']:.4f}"
            + (f"; in turns, other tree {pc['against']['other']}, this "
               f"tree {pc['against']['this']}" if "against" in pc else ""))

    log("  the int8 detect call, b1 and b4, timed in turns bf16, int8, "
        "int8, bf16 (host clock over 10 synchronized calls after 3)")
    launches = {"quantize": 0, "conv": 0, "depthwise": 0, "calls": 0}
    for b in (1, 4):
        fns = {kind: make_detect_fn(model, CANVAS, with_pose=True,
                                    device_preprocess=True, device=dev,
                                    quant_scales=q)
               for kind, q in (("bf16", None), ("int8", scales))}
        outs = {}
        for kind in ("bf16", "int8", "int8", "bf16"):
            int8_conv_cuda.QUANTIZE_LAUNCHES = 0
            int8_conv_cuda.CONV_LAUNCHES = 0
            int8_depthwise_cuda.DEPTHWISE_LAUNCHES = 0
            polling_cuda.LAUNCHES = 0
            sec, outs[kind] = timed_detect(torch, fns[kind], args[b])
            calls = 13
            int8 = kind == "int8"
            counts = {"quantize": int8_conv_cuda.QUANTIZE_LAUNCHES,
                      "conv": int8_conv_cuda.CONV_LAUNCHES,
                      "depthwise": int8_depthwise_cuda.DEPTHWISE_LAUNCHES}
            assert polling_cuda.LAUNCHES == calls, polling_cuda.LAUNCHES
            # the depthwise sites quantize inside their own launch
            assert counts == {
                "quantize": (MOBILENET_SITES - DW_SITES) * calls * int8,
                "conv": (MOBILENET_SITES - DW_SITES) * calls * int8,
                "depthwise": DW_SITES * calls * int8}, counts
            if int8:
                for k, v in counts.items():
                    launches[k] += v
                launches["calls"] += calls
            result.setdefault(f"10c_{kind}_b{b}_ms", []).append(sec * 1e3)
            log(f"  {kind} b{b}: {sec * 1e3:.3f} ms per call, "
                f"{b / sec:.2f} img/s; per call {counts['depthwise'] // calls}"
                f" depthwise, {counts['conv'] // calls} conv and "
                f"{counts['quantize'] // calls} quantize launches, 1 polling")
        sf, sq = (outs[k].scores.float().cpu().numpy() for k in ("bf16",
                                                                 "int8"))
        assert np.isfinite(sq).all() and ((sq > 0).sum(1) >= 1).all()
        log(f"  b{b} int8 against bf16 detections (this model's int8 error, "
            f"logged): counts {(sq > 0).sum(1).tolist()} against "
            f"{(sf > 0).sum(1).tolist()}, max |score gap| "
            f"{float(np.abs(sq - sf).max()):.3e}")
    del model

    log("phase 10d: run_network --backbone mobilenet224_1.0 --int8 2 and "
        "--backbone densenet121 on phase 3's frames, bin/train --backbone "
        "vgg16 (1 epoch of 3 steps, bf16) on phase 7's split: one process "
        f"each, at once, {CLI_TIMEOUT} s allowed")
    t0 = time.perf_counter()
    frames = [cli["images"], cli["calibs"], cli["planes"]]
    outs = {k: os.path.join(tmp, f"cli_{k}") for k in ("mobilenet",
                                                       "densenet")}
    runs = [("mobilenet", ["run_network", weights["mobilenet224_1.0"],
                           *frames, outs["mobilenet"], "--kitti",
                           "--backbone", "mobilenet224_1.0", "--int8", "2",
                           "--device", "cuda"]),
            ("densenet", ["run_network", weights["densenet121"], *frames,
                          outs["densenet"], "--kitti", "--backbone",
                          "densenet121", "--device", "cuda"]),
            ("train_vgg16", ["train", "--backbone", "vgg16", "--batch-size",
                             str(TRAIN_BATCH), "--epochs", "1", "--steps",
                             "3", "--bf16", "--random-transform",
                             "--no-evaluation", "--no-snapshots",
                             "--log-path", os.path.join(tmp, "vgg16.jsonl"),
                             "--image-min-side", str(TRAIN_SIDES[0]),
                             "--image-max-side", str(TRAIN_SIDES[1]),
                             "--device", "cuda", "kitti",
                             os.path.join(tmp, "kitti_train")])]
    ran = run_clis(runs, tmp)
    for key, name in (("mobilenet", "mobilenet224_1.0"),
                      ("densenet", "densenet121")):
        stem = os.path.basename(weights[name]).rsplit(".", 1)[0]
        kdir = os.path.join(outs[key], stem, "outputs", "kitti")
        names = sorted(os.listdir(kdir))
        assert names == [f"{i:06d}.txt" for i in range(4)], (key, names)
    m = ran["mobilenet"][0]
    assert m["polling"] > 0 and m["depthwise"] > 0, m
    assert m["depthwise"] % DW_SITES == 0, m
    assert m["conv"] == m["quantize"] == m["depthwise"] // DW_SITES * (
        MOBILENET_SITES - DW_SITES), m
    assert ran["densenet"][0]["polling"] > 0
    assert ran["densenet"][0]["depthwise"] == 0
    assert ran["train_vgg16"][0]["step"] == 3, ran["train_vgg16"]
    for key, (counts, tail) in ran.items():
        log(f"  {key}: launches {counts}; {' | '.join(tail)}")
    log(f"  phase 10d wall: {time.perf_counter() - t0:.2f} s")
    result["10c"] = {"per_call": per_call, "launches": launches}
    result["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 10 wall: {result['wall_s']:.2f} s")
    return result

# phase 11: the host-side extras

LOADER_TURNS = 3  # rounds of phase 11a's loader timing, each mode in turn


def gxx_has_header(name):
    """Whether g++ finds `name` on its default include path."""
    try:
        proc = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                              input=f"#include <{name}>\n",
                              capture_output=True, text=True, timeout=60)
    except OSError:
        return False
    return proc.returncode == 0


def phase11a_loader(torch, trained, cli, smi, native_builds):
    """What the machine has; the native loader against PIL and cv2; host
    ms per training batch, native against cv2, in turns."""
    from PIL import Image

    from ground_plane_polling_tpu_torch.data import native_loader
    from ground_plane_polling_tpu_torch.data.kitti import KittiDataset
    from ground_plane_polling_tpu_torch.data.pipeline import KittiLoader
    from ground_plane_polling_tpu_torch.kernels.nvcc_build import error_line

    log("phase 11a: the host libraries and the native image loader")
    try:
        gxx = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, timeout=60).stdout.splitlines()[0]
    except (OSError, IndexError):
        gxx = None
    headers = {h: gxx_has_header(h) for h in ("png.h", "jpeglib.h")}
    try:
        import h5py
        h5 = f"h5py {h5py.__version__}"
    except ImportError:
        h5 = "h5py absent"
    log(f"  g++: {gxx or 'absent'}; png.h "
        f"{'found' if headers['png.h'] else 'absent'}, jpeglib.h "
        f"{'found' if headers['jpeglib.h'] else 'absent'}; {h5}")
    lib, sec, error = native_builds["eval3d"]
    assert gxx is None or lib is not None, f"eval3d core: {error}"
    lib, sec, error = native_builds["loader"]
    if gxx and all(headers.values()):
        assert lib is not None, f"native loader did not build: {error}"
    root = trained["root"]
    log(f"  bin/train in phase 7d: {'; '.join(trained['7d']['loaders'])}; "
        f"{trained['7d']['launches']} polling launches in its validation "
        "sweep")
    if not native_loader.available():
        log("  native loader unavailable here, frames go through cv2: "
            + error_line(native_loader.build_error())
            + "; native decode, resize and timing not measured")
    else:
        ours = native_loader.NativeImageLoader()
        paths = sorted(os.path.join(cli["images"], n)
                       for n in os.listdir(cli["images"]))
        for path in paths:
            rgb = np.asarray(Image.open(path).convert("RGB"))
            got = ours.load_image(path, rgb.shape[:2], 1.0)
            np.testing.assert_array_equal(got.astype(np.uint8),
                                          rgb[:, :, ::-1], err_msg=path)
        log(f"  decode of phase 3's {len(paths)} frames: equal to PIL's "
            "pixels, bit for bit")
    sides = dict(image_min_side=TRAIN_SIDES[0], image_max_side=TRAIN_SIDES[1])
    kw = dict(batch_size=TRAIN_BATCH, augment=True, raw_batches=True,
              seed=SEED, device=torch.device("cuda"), **sides)
    modes = {"cv2": False}
    if native_loader.available():
        modes = {"native": True, "cv2": False}
    loaders = {m: KittiLoader(KittiDataset(root, "train"),
                              use_native_loader=on, **kw)
               for m, on in modes.items()}
    assert all(ld.image_shape == CANVAS for ld in loaders.values())
    if "native" in loaders:
        a, b = loaders["native"], loaders["cv2"]
        worst = 0
        for i in range(len(a.ds)):
            pa, pb = a._load_padded(i), b._load_padded(i)
            np.testing.assert_array_equal(pa[6], pb[6])  # true (h, w)
            worst = max(worst, int(np.abs(pa[0].astype(int)
                                          - pb[0].astype(int)).max()))
        assert worst <= 1, worst
        log(f"  resize and pad of {len(a.ds)} frames to {CANVAS[0]}x"
            f"{CANVAS[1]}: native within {worst} count of cv2")
    times = {m: [] for m in loaders}
    for _ in range(LOADER_TURNS):
        for m, ld in loaders.items():
            for group in ld._groups:
                t0 = time.perf_counter()
                ld._make_batch(group, SEED, torch.device("cuda"))
                times[m].append((time.perf_counter() - t0) * 1e3)
    for m, t in times.items():
        log(f"  {smi}: host loading (decode, resize, pad, pin; draws) "
            f"{m}: median {np.median(t):.2f} ms a b{TRAIN_BATCH} batch at "
            f"{CANVAS[0]}x{CANVAS[1]} (min {min(t):.2f}, max {max(t):.2f}, "
            f"{len(t)} batches in {LOADER_TURNS} turns)")
    return {m: float(np.median(t)) for m, t in times.items()}


def phase11b_eval3d(cli, tmp):
    """evaluate_3d on phase 3's KITTI txts (batch 1's without the score as
    the ground truth, batch 4's as the detections), with the C++ core and
    with the numpy path: equal results."""
    from ground_plane_polling_tpu_torch.utils import eval3d

    log("phase 11b: evaluate_3d with the C++ core and with the numpy path")
    gt_dir = os.path.join(tmp, "eval3d_gt")
    os.makedirs(gt_dir)
    det_dir = cli["kitti_b1"].replace("out_b1", "out_b4")
    n_rows = 0
    for name in sorted(os.listdir(cli["kitti_b1"])):
        rows = open(os.path.join(cli["kitti_b1"], name)).read().split("\n")
        rows = [" ".join(r.split()[:15]) for r in rows if r.strip()]
        n_rows += len(rows)
        with open(os.path.join(gt_dir, name), "w") as f:
            f.write("\n".join(rows) + "\n")
    ids = sorted(n[:-4] for n in os.listdir(gt_dir))
    gts = eval3d.load_label_dir(gt_dir, ids)
    dets = eval3d.load_label_dir(det_dir, ids)
    real = eval3d._native
    assert real() is not None, "the eval3d C++ core did not build"
    out = {}
    try:
        for name, native in (("native", real), ("numpy", lambda: None)):
            eval3d._native = native
            t0 = time.perf_counter()
            out[name] = (eval3d.evaluate_kitti_3d(gts, dets),
                         time.perf_counter() - t0)
    finally:
        eval3d._native = real
    (got, t_native), (want, t_numpy) = out["native"], out["numpy"]
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    log(f"  {len(ids)} frames, {n_rows} ground-truth rows: results equal; "
        f"{t_native:.3f} s with the C++ core, {t_numpy:.3f} s with numpy "
        f"(host wall); Car 3D moderate {got['Car']['3d']['moderate']:.4f}")
    return {"native_s": t_native, "numpy_s": t_numpy}


def phase11c_h5(torch, polling_cuda, cli, tmp):
    """phase 3's weights as a Keras .h5 through run_network, serve and
    convert_model; skipped where h5py is absent (host file IO: no kernel
    is skipped)."""
    log("phase 11c: .h5 weights (export, run_network, serve, convert_model)")
    try:
        import h5py  # noqa: F401
    except ImportError:
        log("  h5py absent on this machine: the .h5 part does not run")
        return None
    from ground_plane_polling_tpu_torch.bin import (convert_model,
                                                    run_network, serve)
    from ground_plane_polling_tpu_torch.models.h5_export import (
        export_reference_h5)
    from ground_plane_polling_tpu_torch.models.weights import load_npz

    h5 = os.path.join(tmp, "model_h5.h5")
    export_reference_h5(load_npz(cli["weights"]), h5)
    frames = [cli["images"], cli["calibs"], cli["planes"]]
    out = os.path.join(tmp, "out_h5")
    polling_cuda.LAUNCHES = 0
    with contextlib.redirect_stdout(io.StringIO()):
        run_network.main([h5, *frames, out, "--kitti", "--no-bf16",
                          "--device", "cuda"])
    assert polling_cuda.LAUNCHES > 0
    compare_txts(os.path.join(out, "model_h5", "outputs", "kitti"),
                 cli["kitti_b1"], "run_network on the .h5")
    served, _, _ = run_serve(serve, polling_cuda,
                             [h5, *frames, os.path.join(tmp, "serve_h5"),
                              "--once", "--no-bf16", "--batch-size", "2",
                              "--device", "cuda"])
    assert served == 4, served
    compare_txts(os.path.join(tmp, "serve_h5"), cli["kitti_b1"],
                 "serve on the .h5")
    back = os.path.join(tmp, "from_h5.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        convert_model.main([h5, back])
    with np.load(back) as a, np.load(cli["weights"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    log(f"  convert_model .h5 -> .npz: {len(b.files)} arrays equal to "
        "phase 3's")
    return True


def phase11_host_extras(torch, polling_cuda, tmp, cli, trained, smi,
                        native_builds):
    """(a) the host libraries and the native loader, (b) evaluate_3d's C++
    core against numpy, (c) .h5 weights, (d) run_network --save-images,
    (e) bin/debug."""
    from PIL import Image

    from ground_plane_polling_tpu_torch.bin import debug, run_network

    t_phase = time.perf_counter()
    loading = phase11a_loader(torch, trained, cli, smi, native_builds)
    evaluated = phase11b_eval3d(cli, tmp)
    phase11c_h5(torch, polling_cuda, cli, tmp)

    log("phase 11d: run_network --save-images on phase 3's frames, bf16")
    out = os.path.join(tmp, "out_images")
    polling_cuda.LAUNCHES = 0
    with contextlib.redirect_stdout(io.StringIO()):
        run_network.main([cli["weights"], cli["images"], cli["calibs"],
                          cli["planes"], out, "--save-images", "--device",
                          "cuda"])
    launches = polling_cuda.LAUNCHES
    assert launches > 0, "run_network did not launch the polling kernel"
    comp = os.path.join(out, "model", "images", "composite")
    names = sorted(os.listdir(comp))
    assert names == [f"{i:06d}.png" for i in range(4)], names
    for name in names:
        raw = np.asarray(Image.open(os.path.join(cli["images"], name)))
        png = np.asarray(Image.open(os.path.join(comp, name)))
        assert png.shape == (2 * raw.shape[0], raw.shape[1], 3), png.shape
    log(f"  {len(names)} composites of {2 * raw.shape[0]}x{raw.shape[1]}, "
        f"{launches} polling launches")

    log("phase 11e: bin/debug --anchors --resize --random-transform on "
        "phase 7's split")
    out = os.path.join(tmp, "debug_vis")
    with contextlib.redirect_stdout(io.StringIO()):
        debug.main(["--out", out, "--anchors", "--resize",
                    "--random-transform", "kitti", trained["root"]])
    frames = sorted(os.listdir(os.path.join(trained["root"], "train",
                                            "images")))
    assert sorted(os.listdir(out)) == frames, os.listdir(out)
    log(f"  {len(frames)} PNGs, one a frame")
    log(f"  phase 11 wall: {time.perf_counter() - t_phase:.2f} s")
    return {"loading_ms": loading, "eval3d": evaluated}


# phase 12: the last three options of the JAX detect API
# the conv sites of ResNet-50 split / fused, packed, and how many of them
# are the heads' (the trunk and the FPN have 61)
PACKED_SITES = {False: 91, True: 81}
HEAD_CONVS = {False: (75, 30), True: (50, 20)}  # unpacked, packed
PACKED_TAIL = (26, 127)  # the canvas of P4..P7 at 416x1344
INT8_CALIB_12 = 2  # canvases of 12b's own int8 calibration
# detections of two paths that must agree: phase 3's tolerances between
# its --batch 1 and --batch 4 runs, (atol, rtol)
DETECT_TOLS = {"scores": (1e-6, 0), "boxes": (2e-3, 0), "dims": (2e-3, 0),
               "keypoints": (0.5, 2e-3), "residuals": (1e-3, 0)}
SPATIAL_RANKS = 2  # phase 12c: two ranks on the one card, over gloo
SPATIAL_TIMED = 5  # 12c's timed bf16 calls, after 2 warm-up calls


def detect_inputs(torch, rng, b, dev, planes):
    P_inv = np.linalg.pinv(P2).astype(np.float32)
    return (torch.from_numpy(rng.randint(0, 256, (b, *CANVAS, 3)).astype(
                np.uint8)).to(dev),
            torch.from_numpy(np.tile(P_inv[None], (b, 1, 1))).to(dev),
            torch.from_numpy(np.tile(planes[None], (b, 1, 1))).to(dev))


def compare_detections(got, want, label, net_tol=None):
    """Labels and orientations equal; the other fields within
    DETECT_TOLS, or, with `net_tol`, scores, boxes and dims within rtol
    net_tol and atol net_tol of the field's largest |value|. Returns the
    largest gap of each field."""
    got = {k: v.float().cpu().numpy() for k, v in got._asdict().items()
           if v is not None}
    want = {k: v.float().cpu().numpy() for k, v in want._asdict().items()
            if v is not None}
    for key in ("labels", "orientations"):
        np.testing.assert_array_equal(got[key], want[key],
                                      err_msg=f"{label} {key}")
    gaps = {}
    for key, (atol, rtol) in DETECT_TOLS.items():
        if net_tol is not None and key in ("scores", "boxes", "dims"):
            atol, rtol = net_tol * float(np.abs(want[key]).max()), net_tol
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol,
                                   err_msg=f"{label} {key}")
        gaps[key] = float(np.nanmax(np.abs(got[key] - want[key])))
    return gaps


def phase12a_unfused(torch, polling_cuda, model, rng, planes):
    """fused_decode=False against the fused default, b1 and b4, bf16."""
    from ground_plane_polling_tpu_torch.inference import make_detect_fn

    from ground_plane_polling_tpu_torch.ops.anchors import anchors_for_shape

    log("phase 12a: the unfused decode (decode of all "
        f"{len(anchors_for_shape(CANVAS))} anchors, then the filter) against "
        "the fused one, bf16 at b1 and b4, timed in turns fused, unfused, "
        "unfused, fused")
    dev = torch.device("cuda")
    result = {"polling_launches": 0}
    for b in (1, 4):
        args = detect_inputs(torch, rng, b, dev, planes)
        fns = {name: make_detect_fn(model, CANVAS, with_pose=True,
                                    device_preprocess=True, device=dev,
                                    fused_decode=name == "fused")
               for name in ("fused", "unfused")}
        outs, times = {}, {}
        for name in ("fused", "unfused", "unfused", "fused"):
            polling_cuda.LAUNCHES = 0
            sec, outs[name] = timed_detect(torch, fns[name], args)
            assert polling_cuda.LAUNCHES == 13, polling_cuda.LAUNCHES
            if name == "unfused":
                result["polling_launches"] += polling_cuda.LAUNCHES
            times.setdefault(name, []).append(sec * 1e3)
        scores = outs["fused"].scores.float().cpu().numpy()
        assert (scores > 0).any(axis=1).all(), scores
        gaps = compare_detections(outs["unfused"], outs["fused"],
                                  f"12a b{b}")
        result[f"b{b}"] = {"ms": times, "gaps": gaps}
        log(f"  b{b}: ms per call, fused / unfused / unfused / fused: "
            f"{times['fused'][0]:.3f} / {times['unfused'][0]:.3f} / "
            f"{times['unfused'][1]:.3f} / {times['fused'][1]:.3f} (host "
            "clock over 10 synchronized calls after 3); 1 polling launch a "
            "call; detections equal (labels, orientations) and within phase "
            "3's tolerances, largest gaps "
            + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    return result


def phase12b_packed(torch, polling_cuda, int8_conv_cuda, split, rng,
                    planes):
    """pack_levels against unpacked: raw heads in f32 at b1 (split and
    fused), kernels a forward, the bf16 call in turns at b1 and b4, and
    int8 packed with its own calibration."""
    from ground_plane_polling_tpu_torch.data.kitti import BGR_MEAN
    from ground_plane_polling_tpu_torch.inference import (make_detect_fn,
                                                          place_model)
    from ground_plane_polling_tpu_torch.models import (build_detector,
                                                       fuse_detector_params)
    from ground_plane_polling_tpu_torch.models import quantize as tq

    dev = torch.device("cuda")
    state = split.state_dict()
    fused_state = fuse_detector_params(state)

    def detector(fuse, pack):
        net = build_detector("resnet50", fuse_cls_dim=fuse, pack_levels=pack)
        net.load_state_dict(fused_state if fuse else state)
        return net

    log(f"phase 12b: pack_levels, float32 with TF32 off at "
        f"{CANVAS[0]}x{CANVAS[1]} b1: packed against unpacked heads")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(rng.uniform(-128, 128, (1, 3, *CANVAS)).astype(
        np.float32)).to(dev)
    result = {}
    for fuse in (False, True):
        heads = {}
        for pack in (False, True):
            net = place_model(detector(fuse, pack), dev, torch.float32)
            with torch.inference_mode():
                heads[pack] = {k: v.cpu().numpy() for k, v in net(x).items()}
            sites = tq.count_convs(net, x)
            assert sites == (PACKED_SITES if pack else INT8_SITES)[fuse]
        for k, ref in heads[False].items():
            got = heads[True][k]
            atol = 1e-3 * float(np.abs(ref).max())
            np.testing.assert_allclose(got, ref, rtol=1e-3, atol=atol,
                                       err_msg=f"packed head {k}")
            log(f"  {'fused' if fuse else 'split'} {k}: max |packed - "
                f"unpacked| {np.abs(got - ref).max():.3e} (rtol 1e-3, atol "
                f"1e-3 * max|unpacked| = {atol:.3e})")
        unpacked, packed = HEAD_CONVS[fuse]
        log(f"  {'fused' if fuse else 'split'}: conv sites "
            f"{INT8_SITES[fuse]} -> {PACKED_SITES[fuse]}, of them the heads' "
            f"{unpacked} -> {packed}")

    log("phase 12b': bf16 detect call, unpacked and packed, b1 and b4, timed "
        "in turns unpacked, packed, packed, unpacked; kernels a forward "
        "(torch.profiler)")
    nets = {pack: place_model(detector(False, pack), dev, torch.bfloat16)
            for pack in (False, True)}
    mean = torch.as_tensor(BGR_MEAN, device=dev)
    result["polling_launches"] = 0
    for b in (1, 4):
        args = detect_inputs(torch, rng, b, dev, planes)
        fns = {pack: make_detect_fn(nets[pack], CANVAS, with_pose=True,
                                    device_preprocess=True, device=dev)
               for pack in (False, True)}
        times = {}
        for pack in (False, True, True, False):
            polling_cuda.LAUNCHES = 0
            sec, out = timed_detect(torch, fns[pack], args)
            assert polling_cuda.LAUNCHES == 13, polling_cuda.LAUNCHES
            if pack:
                result["polling_launches"] += polling_cuda.LAUNCHES
            scores = out.scores.float().cpu().numpy()
            assert np.isfinite(scores).all()
            assert (scores > 0).any(axis=1).all(), scores
            times.setdefault("packed" if pack else "unpacked", []).append(
                sec * 1e3)
        xb = (args[0].float() - mean).permute(0, 3, 1, 2)
        with torch.inference_mode():
            kernels = {("packed" if pack else "unpacked"): len(
                device_kernels(torch, lambda n=nets[pack]: n(xb), reps=1))
                for pack in (False, True)}
        result[f"bf16_b{b}"] = {"ms": times, "kernels": kernels}
        log(f"  b{b}: ms per call, unpacked / packed / packed / unpacked: "
            f"{times['unpacked'][0]:.3f} / {times['packed'][0]:.3f} / "
            f"{times['packed'][1]:.3f} / {times['unpacked'][1]:.3f} (host "
            "clock over 10 synchronized calls after 3); kernels a forward "
            f"{kernels['unpacked']} unpacked, {kernels['packed']} packed; "
            "scores finite, a detection an image, 1 polling launch a call")

    log(f"phase 12b'': int8 packed, calibrated (absmax) on {INT8_CALIB_12} "
        "canvases: the conv kernel against its plain version at every "
        f"shape of the {PACKED_TAIL[0]}x{PACKED_TAIL[1]} tail canvas, and "
        "the int8 detect call")
    packed = nets[True]
    canvases = [torch.from_numpy(rng.randint(0, 256, (1, *CANVAS, 3)).astype(
        np.uint8)).to(dev) for _ in range(INT8_CALIB_12)]
    scales = tq.collect_scales_uint8(packed, canvases)
    assert scales.shape == (PACKED_SITES[False],), scales.shape
    x1 = (canvases[0].float() - mean).permute(0, 3, 1, 2)
    tail = int8_site_inputs(torch, tq, packed, scales, x1,
                            keep=lambda k: k[0][2:] == PACKED_TAIL)
    assert sum(e["n"] for e in tail.values()) == HEAD_CONVS[False][1] // 2
    rows = phase8a_kernels(torch, int8_conv_cuda, tail, "tail b1")
    args = detect_inputs(torch, rng, 1, dev, planes)
    detect = make_detect_fn(packed, CANVAS, with_pose=True,
                            device_preprocess=True, device=dev,
                            quant_scales=scales)
    int8_conv_cuda.CONV_LAUNCHES = int8_conv_cuda.QUANTIZE_LAUNCHES = 0
    polling_cuda.LAUNCHES = 0
    sec, out = timed_detect(torch, detect, args)
    launches = (int8_conv_cuda.CONV_LAUNCHES, int8_conv_cuda.QUANTIZE_LAUNCHES,
                polling_cuda.LAUNCHES)
    assert launches == (13 * PACKED_SITES[False], 13 * PACKED_SITES[False],
                        13), launches
    scores = out.scores.float().cpu().numpy()
    assert np.isfinite(scores).all() and (scores > 0).any(axis=1).all()
    log(f"  int8 packed b1: {sec * 1e3:.3f} ms per call (host clock over 10 "
        f"synchronized calls after 3); per call {launches[0] // 13} conv, "
        f"{launches[1] // 13} quantize and {launches[2] // 13} polling "
        "launches")
    result["polling_launches"] += launches[2]
    result["int8"] = {"ms": sec * 1e3, "launches": launches,
                      "tail_rows": [{k: r[k] for k in (
                          "key", "n", "conv_ms", "conv_err", "quantize_err",
                          "conv_bound_ms", "cudnn_ms", "conv_plain_ms",
                          "plan")} for r in rows]}
    return result


def spatial_worker(rank, port, work, world, backend):
    """Rank `rank` of phase 12c's `world` ranks over `backend`: the
    width-sharded detect call at b1, float32 (TF32 off) once, then bf16
    timed; what it saw goes to work/spatial{rank}.pt."""
    import torch

    from ground_plane_polling_tpu_torch.inference import (make_detect_fn,
                                                          place_model)
    from ground_plane_polling_tpu_torch.kernels import polling_cuda
    from ground_plane_polling_tpu_torch.parallel import (data_parallel_mesh,
                                                         initialize,
                                                         shutdown)
    from ground_plane_polling_tpu_torch.parallel.spatial import (
        conv_window_bound)

    initialize(f"localhost:{port}", world, rank, backend=backend)
    mesh = data_parallel_mesh()
    out = {"device": str(mesh.device), "compiled": []}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(SEED + 12)
    planes = synthetic_planes(rng, N_PLANES)
    args = detect_inputs(torch, rng, 1, mesh.device, planes)
    model = full_width_model(torch, SEED)
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        net = place_model(model, mesh.device, dtype)
        detect = make_detect_fn(net, CANVAS, with_pose=True,
                                device_preprocess=True, mesh=mesh,
                                shard_spatial=True)
        out["compiled"].append(check_compiled_form(backend, detect))
        polling_cuda.LAUNCHES = 0
        if name == "f32":
            got = detect(*args)
            out["f32"] = {k: v.cpu() for k, v in got._asdict().items()
                          if v is not None}
            windows = detect.spatial.last.windows
            widest = max(windows, key=lambda w: w[2])
            out["windows"] = {
                "convs": len(windows), "widest": widest,
                "bound": conv_window_bound(widest[0], world, widest[1]),
                "within": all(w[2] <= conv_window_bound(w[0], world, w[1])
                              for w in windows)}
            out["f32_launches"] = polling_cuda.LAUNCHES
            continue
        for _ in range(2):
            detect(*args)
        torch.cuda.synchronize()
        mesh.barrier()
        polling_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        for _ in range(SPATIAL_TIMED):
            got = detect(*args)
        torch.cuda.synchronize()
        out["bf16_ms"] = (time.perf_counter() - t0) / SPATIAL_TIMED * 1e3
        out["bf16_launches"] = polling_cuda.LAUNCHES
        out["bf16_scores"] = got.scores.float().cpu()
        if detect.eager is not detect:  # captured (NCCL): in turns
            out["bf16_turns_ms"] = call_turns(
                torch, {"eager": detect.eager, "captured": detect}, args,
                n=SPATIAL_TIMED)
    torch.save(out, os.path.join(work, f"spatial{rank}.pt"))
    shutdown(detect)  # the f32 call is dropped: collected
    return 0


def phase12c_spatial(torch, polling_cuda, work, smi, world=SPATIAL_RANKS,
                     backend="gloo"):
    """shard_spatial: `world` rank processes, each launched with a timeout
    and joined, against the single process here (run first, alone on the
    card)."""
    from ground_plane_polling_tpu_torch.inference import (make_detect_fn,
                                                          place_model)

    where = ("on the one card over gloo (each exchange goes through the "
             "host)" if backend == "gloo" else "one a card over NCCL")
    log(f"phase 12c: shard_spatial, ResNet-50 at {CANVAS[0]}x{CANVAS[1]} b1, "
        f"{world} ranks {where}: float32 (TF32 off) against one process, "
        "bf16 timed against one process")
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(SEED + 12)
    planes = synthetic_planes(rng, N_PLANES)
    args = detect_inputs(torch, rng, 1, dev, planes)
    model = full_width_model(torch, SEED)
    want = make_detect_fn(place_model(model, dev, torch.float32), CANVAS,
                          with_pose=True, device_preprocess=True)(*args)
    one_ms = timed_detect(torch, make_detect_fn(
        place_model(model, dev, torch.bfloat16), CANVAS, with_pose=True,
        device_preprocess=True), args, n_iter=SPATIAL_TIMED)[0] * 1e3
    del model
    torch.cuda.empty_cache()
    port = free_port()
    env = dict(os.environ, GPP_DIST_INIT_TIMEOUT=str(GROUP_TIMEOUT))
    logs = [open(os.path.join(work, f"spatial{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--port", str(port), "--work", work, "--dp-cards", str(world),
         "--backend", backend, "--phase", "12c"],
        env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        wait_ranks(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check_ranks(procs, logs)
    ranks = [torch.load(os.path.join(work, f"spatial{r}.pt"),
                        weights_only=False) for r in range(world)]
    result = {"one_process_bf16_ms": one_ms}
    DetectionOutput = type(want)
    for r, got in enumerate(ranks):
        gaps = compare_detections(DetectionOutput(**got["f32"]), want,
                                  f"12c rank {r}", net_tol=1e-4)
        w = got["windows"]
        assert w["within"], w
        assert got["f32_launches"] == 1, got["f32_launches"]
        assert got["bf16_launches"] == SPATIAL_TIMED, got["bf16_launches"]
        scores = got["bf16_scores"].numpy()
        assert np.isfinite(scores).all() and (scores > 0).any(), scores
        result[f"rank{r}"] = {"gaps": gaps, "windows": w,
                              "compiled": got["compiled"],
                              "bf16_ms": got["bf16_ms"],
                              "bf16_turns_ms": got.get("bf16_turns_ms"),
                              "polling_launches": got["f32_launches"]
                              + got["bf16_launches"]}
        log(f"  rank {r} on {got['device']}: f32 detections equal to one "
            "process's (labels, orientations; scores, boxes, dims within "
            "rtol 1e-4 and 1e-4 of max; the polled fields within phase 3's "
            "tolerances), largest gaps "
            + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
            + f"; widest conv input {w['widest'][2]} columns (map "
            f"{w['widest'][0]} wide, kernel {w['widest'][1]}) against its "
            f"slab plus halo {w['bound']}, every one of {w['convs']} convs "
            f"within its own; the call {got['compiled'][1]}; bf16 "
            f"{got['bf16_ms']:.3f} ms per call (host clock over "
            f"{SPATIAL_TIMED} synchronized calls) against one process's "
            f"{one_ms:.3f}; 1 polling launch a call"
            + ("; in turns eager / captured / captured / eager: " + " / ".join(
                f"{t:.3f}" for t in (got["bf16_turns_ms"]["eager"][0],
                                     got["bf16_turns_ms"]["captured"][0],
                                     got["bf16_turns_ms"]["captured"][1],
                                     got["bf16_turns_ms"]["eager"][1]))
               + " ms" if got.get("bf16_turns_ms") else ""))
    log(f"  {smi}; phase 12c wall: {time.perf_counter() - t0:.2f} s")
    return result


def phase12_options(torch, polling_cuda, int8_conv_cuda, tmp, smi):
    """The unfused decode, pack_levels and shard_spatial at full width."""
    from ground_plane_polling_tpu_torch.inference import place_model

    t_phase = time.perf_counter()
    rng = np.random.RandomState(SEED + 12)
    planes = synthetic_planes(rng, N_PLANES)
    split = full_width_model(torch, SEED)
    model = place_model(copy.deepcopy(split), torch.device("cuda"),
                        torch.bfloat16)
    result = {"12a": phase12a_unfused(torch, polling_cuda, model, rng,
                                      planes)}
    del model
    t = time.perf_counter()
    result["12b"] = phase12b_packed(torch, polling_cuda, int8_conv_cuda,
                                    split, rng, planes)
    log(f"  phase 12a wall {t - t_phase:.2f} s, 12b "
        f"{time.perf_counter() - t:.2f} s")
    torch.cuda.empty_cache()
    result["12c"] = phase12c_spatial(torch, polling_cuda, tmp, smi)
    result["wall_s"] = time.perf_counter() - t_phase
    log(f"  {smi}; phase 12 wall: {result['wall_s']:.2f} s")
    return result


# phase 13: the captured detect call

NMS_OPS = 14  # f32 operations of one IoU decision (csrc/nms.cu)
# calls of each timed block of 13b; blocks in turns eager, captured,
# captured, eager
CAPTURE_CALLS = 20
# host-side CUDA API calls that start device work (profiler names)
HOST_LAUNCHES = ("LaunchKernel", "GraphLaunch", "MemcpyAsync",
                 "MemsetAsync")


@contextlib.contextmanager
def captured_calls(cls=None):
    """Counts of the captures and calls of `cls` (default CapturedDetect;
    training.train.CapturedTrainStep) while the block runs:
    {"captures": n, "calls": n}."""
    from ground_plane_polling_tpu_torch.inference import CapturedDetect

    cls = cls or CapturedDetect
    counts = {"captures": 0, "calls": 0}
    call, capture = cls.__call__, cls._capture

    def counted_call(self, *args):
        counts["calls"] += 1
        return call(self, *args)

    def counted_capture(self, *args):
        counts["captures"] += 1
        return capture(self, *args)

    cls.__call__, cls._capture = counted_call, counted_capture
    try:
        yield counts
    finally:
        cls.__call__, cls._capture = call, capture


def zero_launches():
    """Every kernel launch counter (inference.LAUNCH_COUNTERS) to 0;
    returns the counts before, by name."""
    from ground_plane_polling_tpu_torch.inference import LAUNCH_COUNTERS

    before = {name: getattr(m, name) for m, name in LAUNCH_COUNTERS}
    for m, name in LAUNCH_COUNTERS:
        setattr(m, name, 0)
    return before


def nms_bound_ms(scores, idx, valid, max_out):
    """Least time of greedy NMS on these inputs: the IoU decisions the
    result depends on (each kept candidate against every later valid one
    up to the last candidate decided: the max_out-th kept, else the last
    valid one) at the f32 peak, and the bytes (each candidate's box and
    score read once up to that same candidate, a set with none valid its
    first score; each output written once) at the memory rate. Returns
    (ms, "operations" or "bytes")."""
    scores, idx, valid = (np.asarray(t.cpu()) for t in (scores, idx, valid))
    s, k = scores.shape
    live = scores > -np.inf
    pairs, read = 0, 0
    for r in range(s):
        kept = idx[r][valid[r]]
        if not len(kept):
            read += 4
            continue
        stop = kept[-1] if len(kept) == max_out else \
            np.flatnonzero(live[r])[-1]
        upto = np.cumsum(live[r])  # valid candidates at or before i
        pairs += int((upto[stop] - upto[kept]).sum())
        read += (int(stop) + 1) * (16 + 4)
    ms = {"operations": NMS_OPS * pairs / PEAK_F32_OPS * 1e3,
          "bytes": (read + s * max_out * (8 + 1 + 4)) / PEAK_BYTES * 1e3}
    limit = max(ms, key=ms.get)
    return ms[limit], limit


def compare_nms(got, want, label):
    """NMS outputs bit for bit (index, valid, score)."""
    for name, g, w in zip(("idx", "valid", "score"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (label, name)
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(),
                                      err_msg=f"{label} {name}")


def nms_device_ops(torch, fn):
    """Device kernels of one call of fn() (torch.profiler, 5 calls, a spin
    kernel first), or None where the traces hold no device event."""
    kernels = device_kernels(torch, fn, reps=5)
    return len(kernels) / 5 if kernels else None


def phase13a_nms(torch, nms_cuda, model, rng, planes, other=None):
    """The NMS kernel against the plain fixpoint on the card, bit for bit:
    the real candidates of a b4 bf16 detect call (its first row as b1),
    12 and 48 random sets at K 1024, b4 with 200 of 1024 valid, one set
    at K 1024 in 30 tight clusters (about 30 kept, every candidate
    reached), the crafted cases, and (against the sequential loop) the
    large cases. Each timed beside its bound, the launch floor and the
    plain version; with `other` (another checkout's nms_cuda), its kernel
    in turns (other, this, this, other; outputs equal), the large cases
    too, and the device kernels of one call of each."""
    from ground_plane_polling_tpu_torch.inference import make_detect_fn
    from ground_plane_polling_tpu_torch.kernels import nms_cases
    from ground_plane_polling_tpu_torch.ops import filtering

    log("phase 13a: the NMS kernel against greedy_nms (the plain "
        "fixpoint) on the card, bit for bit (index, valid, score)")
    seen = []
    kernel = nms_cuda.greedy_nms

    def spy(*args):
        seen.append(args)
        return kernel(*args)

    detect = make_detect_fn(model, CANVAS, with_pose=True,
                            device_preprocess=True)
    nms_cuda.greedy_nms = spy
    try:
        detect.eager(*detect_inputs(torch, rng, 4, torch.device("cuda"),
                                    planes))
    finally:
        nms_cuda.greedy_nms = kernel
    (boxes4, scores, max_out, thr), = seen
    assert tuple(scores.shape) == (4, 1024) and max_out == 100, scores.shape

    def on_card(s, n_valid=None):
        b, sc = nms_cases.random_case(np.random.RandomState(SEED + s), s=s,
                                      n_valid=n_valid)
        return torch.from_numpy(b).cuda(), torch.from_numpy(sc).cuda()

    def turns(fn, args, reps):
        out = {"other": [], "this": []}
        for name in ("other", "this", "this", "other"):
            f = other.greedy_nms if name == "other" else fn
            out[name].append(device_ms(torch, lambda f=f: f(*args),
                                       reps=reps))
        log(f"    in turns, device ms: other tree {out['other'][0]:.4f}, "
            f"this tree {out['this'][0]:.4f}, {out['this'][1]:.4f}, other "
            f"tree {out['other'][1]:.4f}")
        return out

    floor_ms = device_ms(torch, lambda: torch.cuda._sleep(0), reps=20)
    log(f"  launch floor (torch.cuda._sleep(0)): {floor_ms:.4f} device ms")
    clustered = nms_cases.clustered_case(np.random.RandomState(SEED + 1))
    timed = (("b1", (boxes4[:1], scores[:1])), ("b4", (boxes4, scores)),
             ("s12", on_card(12)), ("s48", on_card(48)),
             ("b4_valid200", on_card(4, n_valid=200)),
             ("k1024_clustered", tuple(torch.from_numpy(a).cuda()
                                       for a in clustered)))
    rows = {"floor_ms": floor_ms}
    for label, (b, sc) in timed:
        args = (b, sc, max_out, thr)
        got = kernel(*args)
        compare_nms(got, filtering.greedy_nms(*args), label)
        ms = device_ms(torch, lambda: kernel(*args), reps=20)
        plain_ms = cuda_ms(lambda: filtering.greedy_nms(*args), calls=10,
                           warmup=2)
        bound, by = nms_bound_ms(sc, got[0], got[1], max_out)
        kept = got[1].sum(dim=1).tolist()
        valid = (sc > float("-inf")).sum(dim=1).tolist()
        row = rows[label] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "kept": kept, "valid": valid,
            "last_kept": [int(i[v].max()) if v.any() else -1
                          for i, v in zip(got[0], got[1])]}
        log(f"  {label}: S {sc.shape[0]}, K {sc.shape[1]}, valid "
            f"{sorted(set(valid))}, kept {sorted(set(kept))}, last kept "
            f"up to {max(row['last_kept'])}: equal; kernel {ms:.4f} ms "
            f"(device, CUDA events over 20 calls queued behind a spinning "
            f"kernel; launch floor {floor_ms:.4f}), bound {bound:.6f} ms "
            f"({by}), plain fixpoint {plain_ms:.4f} ms (host syncs "
            "included; a record, not a yardstick)")
        if other is not None:
            compare_nms(other.greedy_nms(*args), got, f"{label} other")
            row["turns"] = turns(kernel, args, reps=20)
    args = (boxes4, scores, max_out, thr)
    rows["device_ops"] = {"this": nms_device_ops(
        torch, lambda: kernel(*args))}
    if other is not None:
        rows["device_ops"]["other"] = nms_device_ops(
            torch, lambda: other.greedy_nms(*args))
    log(f"  device kernels a b4 call: {rows['device_ops']}")
    names = []
    for name, b, sc, m, t in nms_cases.crafted_cases():
        args = (torch.from_numpy(b).cuda(), torch.from_numpy(sc).cuda(), m,
                t)
        compare_nms(kernel(*args), filtering.greedy_nms(*args), name)
        names.append(name)
    log("  crafted cases equal: " + ", ".join(names))
    rows["large"] = {}
    for name, b, sc, m, t in nms_cases.large_cases():
        args = (torch.from_numpy(b).cuda(), torch.from_numpy(sc).cuda(), m,
                t)
        got = kernel(*args)
        compare_nms(got, filtering.greedy_nms_serial(*args), name)
        ms = device_ms(torch, lambda: kernel(*args), reps=5)
        row = rows["large"][name] = {"ms": ms,
                                     "kept": got[1].sum(dim=1).tolist()}
        log(f"  large case {name}: S {b.shape[0]}, K {b.shape[1]}, max_out "
            f"{m}, kept {row['kept'][:4]}: equal to greedy_nms_serial; "
            f"kernel {ms:.4f} ms")
        if other is not None:
            compare_nms(other.greedy_nms(*args), got, f"{name} other")
            row["turns"] = turns(kernel, args, reps=5)
    return rows


def call_profile(torch, fn, reps=5):
    """(host API calls that start device work, device operations, device
    ms) per call of fn(), from torch.profiler over `reps` calls; the
    device ms are None where the trace holds no device event."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and any(k in e.name for k in HOST_LAUNCHES)]
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3 / reps
    return len(host) / reps, len(device) / reps, (busy if device else None)


def call_turns(torch, fns, args, n=CAPTURE_CALLS):
    """Host-clock ms per call of each of fns {name: fn} over blocks of `n`
    synchronized calls, in turns (a, b, b, a): {name: [ms, ms]}."""
    names = list(fns)
    out = {name: [] for name in names}
    for name in names + names[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fns[name](*args)
        torch.cuda.synchronize()
        out[name].append((time.perf_counter() - t0) / n * 1e3)
    return out


def float_gaps(got, want):
    """{field: largest |got - want|} of the float fields; NaN where both
    are NaN counts as equal, NaN in one only fails."""
    gaps = {}
    for key, w in want._asdict().items():
        if key in ("labels", "orientations") or w is None:
            continue
        g = getattr(got, key).float().cpu().numpy()
        w = w.float().cpu().numpy()
        assert np.array_equal(np.isnan(g), np.isnan(w)), key
        gaps[key] = float(np.nanmax(np.abs(g - w))) if g.size else 0.0
    return gaps


def held_captured(torch, detect, args, label, int8_sites=None):
    """A CapturedDetect against its eager call on `args`: labels and
    orientations equal, the float fields' gaps (0 unless the eager call
    itself does not repeat bit for bit, and then within phase 3's
    tolerances), no host sync in a replay (torch.cuda's sync debug mode),
    one polling and one NMS launch a replay, BN_SITES of the frozen-BN
    kernel (a ResNet-50 forward), `int8_sites` of each int8 kernel, host API calls and device operations a call, ms a call in
    turns eager / captured / captured / eager, device ms and idle share."""
    t0 = time.perf_counter()
    detect(*args)  # warm-up and capture, then the first replay
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    eager = [detect.eager(*args) for _ in range(2)]
    zero_launches()
    got, syncs = host_syncs(torch, lambda: detect(*args))
    torch.cuda.synchronize()
    launches = zero_launches()
    for key in ("labels", "orientations"):
        np.testing.assert_array_equal(
            getattr(got, key).cpu().numpy(),
            getattr(eager[0], key).cpu().numpy(), err_msg=f"{label} {key}")
    gaps = float_gaps(got, eager[0])
    eager_gaps = float_gaps(eager[1], eager[0])
    nonzero = {k: v for k, v in gaps.items() if v}
    if nonzero:
        # allowed only where the eager call itself does not repeat bit for
        # bit, and then within phase 3's tolerances
        assert any(eager_gaps.values()), (label, nonzero)
        compare_detections(got, eager[0], label)
    _, eager_syncs = host_syncs(torch, lambda: detect.eager(*args))
    assert syncs == [], (label, syncs)
    assert launches["LAUNCHES"] == 1 and launches["NMS_LAUNCHES"] == 1, \
        (label, launches)
    assert launches["BN_ACT_LAUNCHES"] == BN_SITES, (label, launches)
    if int8_sites is not None:
        assert (launches["QUANTIZE_LAUNCHES"], launches["CONV_LAUNCHES"]
                ) == (int8_sites,) * 2, (label, launches)
    profiles = {k: call_profile(torch, lambda fn=fn: fn(*args))
                for k, fn in (("eager", detect.eager), ("captured", detect))}
    replays_ms = device_ms(torch, lambda: detect(*args), reps=5)
    turns = call_turns(torch, {"eager": detect.eager, "captured": detect},
                       args)
    ms = {k: float(np.mean(v)) for k, v in turns.items()}
    busy = {k: p[2] for k, p in profiles.items()}
    idle = {k: (1 - busy[k] / ms[k]) if busy[k] is not None else None
            for k in ms}
    valid = (got.scores > 0).sum(dim=1).tolist()
    row = {"capture_s": capture_s, "gaps": gaps, "eager_gaps": eager_gaps,
           "host_syncs": len(syncs), "eager_host_syncs": len(eager_syncs),
           "launches": launches, "turns_ms": turns, "ms": ms,
           "host_launches": {k: p[0] for k, p in profiles.items()},
           "device_ops": {k: p[1] for k, p in profiles.items()},
           "device_ms": busy, "replays_back_to_back_ms": replays_ms,
           "idle_share": idle, "valid": valid}
    log(f"  {label}: first call (warm-up, capture, replay) {capture_s:.2f} "
        f"s; valid detections {valid}; labels and orientations equal; "
        "largest float gap "
        + (", ".join(f"{k} {v:.3g}" for k, v in nonzero.items())
           + f" (eager against eager: {eager_gaps})" if nonzero
           else "0 in every field"))
    log(f"    host syncs in a replay {len(syncs)}, in an eager call "
        f"{len(eager_syncs)} {eager_syncs[:3]}; launches a replay "
        f"{launches}")
    log(f"    host API calls that start device work a call: eager "
        f"{profiles['eager'][0]:g}, captured {profiles['captured'][0]:g}; "
        f"device operations a call: eager {profiles['eager'][1]:g}, "
        f"captured {profiles['captured'][1]:g}")
    log(f"    ms a call (host clock, {CAPTURE_CALLS} synchronized calls a "
        "block, eager / captured / captured / eager): "
        f"{turns['eager'][0]:.3f} / {turns['captured'][0]:.3f} / "
        f"{turns['captured'][1]:.3f} / {turns['eager'][1]:.3f}; device ms a "
        "call (profiler): " + ", ".join(
            f"{k} {v:.3f}" if v is not None else f"{k} not measured"
            for k, v in busy.items())
        + f"; 5 replays back to back (CUDA events): {replays_ms:.3f} ms a "
        "replay; idle share of the call: " + ", ".join(
            f"{k} {v:.1%}" if v is not None else f"{k} not measured"
            for k, v in idle.items()))
    return row


def phase13b_captured(torch, model, scales, rng, planes, other_nms=None):
    """The captured call against detect.eager at full width, bf16 and int8
    at b1 and b4: equal outputs, host syncs, launches, times, idle share.
    With `other_nms` (another checkout's nms_cuda), also the device
    operations of the same call captured with that tree's NMS kernel."""
    from ground_plane_polling_tpu_torch.inference import (CapturedDetect,
                                                          make_detect_fn)
    from ground_plane_polling_tpu_torch.kernels import nms_cuda

    log("phase 13b: the captured detect call against detect.eager, "
        f"ResNet-50 FPN 512 at {CANVAS[0]}x{CANVAS[1]}, {N_PLANES} planes, "
        "pose on, bf16 and int8, b1 and b4")
    dev = torch.device("cuda")
    rows = {}
    for name, b, q in (("bf16", 1, None), ("bf16", 4, None),
                       ("int8", 1, scales), ("int8", 4, scales)):
        label = f"{name} b{b}"
        detect = make_detect_fn(model, CANVAS, with_pose=True,
                                device_preprocess=True, quant_scales=q)
        assert isinstance(detect, CapturedDetect), type(detect)
        args = detect_inputs(torch, rng, b, dev, planes)
        rows[label] = held_captured(
            torch, detect, args, label,
            None if q is None else INT8_SITES[False])
        other_ops = None
        if other_nms is not None:
            kernel = nms_cuda.greedy_nms
            nms_cuda.greedy_nms = other_nms.greedy_nms
            try:
                with_other = make_detect_fn(model, CANVAS, with_pose=True,
                                            device_preprocess=True,
                                            quant_scales=q)
                with_other(*args)
                other_ops = call_profile(torch,
                                         lambda: with_other(*args))[1]
            finally:
                nms_cuda.greedy_nms = kernel
            log(f"    device operations a call, captured with the other "
                f"tree's NMS: {other_ops:g}")
        rows[label]["device_ops_other_nms"] = other_ops
    return rows


def phase13_captured(torch, nms_cuda, smi, calls, other_nms=None):
    """The detect call as CUDA graphs: (a) the NMS kernel, (b) the
    captured call against detect.eager, (c) run_network and serve
    (phases 3 and 4) through the captured call. `other_nms`: another
    checkout's nms_cuda, timed in turns (13a) and captured (13b)."""
    from ground_plane_polling_tpu_torch.inference import place_model
    from ground_plane_polling_tpu_torch.models import quantize as tq

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 13)
    planes = synthetic_planes(rng, N_PLANES)
    model = place_model(full_width_model(torch, SEED), dev, torch.bfloat16)
    result = {"13a": phase13a_nms(torch, nms_cuda, model, rng, planes,
                                  other_nms)}
    canvases = [torch.from_numpy(rng.randint(0, 256, (1, *CANVAS, 3)).astype(
        np.uint8)).to(dev) for _ in range(INT8_CALIB_12)]
    scales = tq.collect_scales_uint8(model, canvases)
    result["13b"] = phase13b_captured(torch, model, scales, rng, planes,
                                      other_nms)
    log("phase 13c: run_network (phase 3) and serve (phase 4) through the "
        "captured call, their txts held as those phases hold them: "
        + "; ".join(f"phase {k}: {v['captures']} captures, {v['calls']} "
                    "calls" for k, v in calls.items()))
    for k, v in calls.items():
        assert v["captures"] > 0 and v["calls"] > v["captures"], (k, v)
    result["13c"] = calls
    result["wall_s"] = time.perf_counter() - t_phase
    log(f"  {smi}; phase 13 wall: {result['wall_s']:.2f} s")
    return result


def load_int8_tree(root, alias):
    """(kernels.int8_conv_cuda, kernels.int8_depthwise_cuda or None,
    kernels.nms_cuda or None) of the package in checkout `root`, imported
    under the top-level name `alias` (they build into that checkout)."""
    import importlib
    import importlib.util
    from pathlib import Path

    pkg = Path(root).resolve() / "ground_plane_polling_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    depthwise = None
    if (pkg / "kernels" / "int8_depthwise_cuda.py").exists():
        depthwise = importlib.import_module(
            f"{alias}.kernels.int8_depthwise_cuda")
    nms = None
    if (pkg / "kernels" / "nms_cuda.py").exists():
        nms = importlib.import_module(f"{alias}.kernels.nms_cuda")
    return (importlib.import_module(f"{alias}.kernels.int8_conv_cuda"),
            depthwise, nms)


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
                   "_parent_tree/): phases 8a and 10c also time its int8 "
                   "kernels in turns with this tree's at every shape, and "
                   "phase 13 its NMS kernel")
    p.add_argument("--dp-cards", type=int, default=None, metavar="N",
                   help="only phases 9b and 12c, over NCCL with one rank on "
                   "each of N cards (a machine with N cards), with the "
                   "captured DDP step and the captured width-sharded b1 "
                   "detect call timed against their eager forms and one "
                   "card's")
    # phase 9b's rank processes (the script starts them itself)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--work", default=None, help=argparse.SUPPRESS)
    p.add_argument("--backend", default="gloo", help=argparse.SUPPRESS)
    p.add_argument("--phase", default=None, choices=("9b", "12c"),
                   help="with --dp-cards, only that phase")
    argv = sys.argv[1:] if argv is None else argv
    # phase 10d's CLI processes: --cli MODULE ARGS... (the script starts
    # them itself)
    cli_args = argv[1:] if argv[:1] == ["--cli"] else None
    args = p.parse_args([] if cli_args is not None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if cli_args is not None:
        return cli_worker(cli_args[0], cli_args[1:])
    if args.rank is not None:
        import faulthandler

        # a rank that hangs writes its threads' stacks to its log and exits
        faulthandler.dump_traceback_later(RANK_TIMEOUT - 30, exit=True)
        worker = spatial_worker if args.phase == "12c" else rank_worker
        try:
            return worker(args.rank, args.port, args.work, args.dp_cards,
                          args.backend)
        except Exception:
            # out at once: the group's destruction at exit would wait for
            # the captured graphs still alive
            import traceback

            traceback.print_exc()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)
    from concurrent.futures import ThreadPoolExecutor

    from ground_plane_polling_tpu_torch.kernels import (frozen_bn_cuda,
                                                        int8_conv_cuda,
                                                        int8_depthwise_cuda,
                                                        nms_cuda,
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

    def host_build(module):
        """(library or None, seconds, g++'s error or None)."""
        t0 = time.perf_counter()
        try:
            lib, error = module.build(), None
        except (OSError, RuntimeError) as e:
            lib, error = None, str(e)
        return lib, time.perf_counter() - t0, error

    modules = [polling_cuda, int8_conv_cuda, int8_depthwise_cuda, nms_cuda,
               frozen_bn_cuda]
    other = other_dw = other_nms = None
    if args.against:
        other, other_dw, other_nms = load_int8_tree(args.against,
                                                    "gpp_against")
        modules += [m for m in (other, other_dw, other_nms) if m is not None]
    from ground_plane_polling_tpu_torch.data import native_loader
    from ground_plane_polling_tpu_torch.kernels.nvcc_build import error_line
    from ground_plane_polling_tpu_torch.utils import eval3d_native
    # one nvcc for each source and one g++ for each host library, started
    # together
    with ThreadPoolExecutor(len(modules) + 2) as pool:
        hosts = [pool.submit(host_build, m) for m in (native_loader,
                                                      eval3d_native)]
        builds = list(pool.map(timed_build, modules))
        native_builds = dict(zip(("loader", "eval3d"),
                                 (h.result() for h in hosts)))
    for lib, sec in builds:
        log(f"  built {lib} in {sec:.2f} s (in parallel)")
        log("  " + lib.with_suffix(".log").read_text().strip().replace(
            "\n", "\n  "))
    for name, (lib, sec, error) in native_builds.items():
        log(f"  g++ {name}: " + (f"built {lib} in {sec:.2f} s (in parallel)"
                                 if lib else "failed: " + error_line(error)))
    # the conv kernel runs on warpgroup MMAs: IGMMA in each instance's SASS
    igmma = sass_counts(builds[1][0], "IGMMA", "conv_kernel")
    log("  IGMMA instructions in the int8 conv kernel's SASS: "
        + ", ".join(f"{v} in {k}" for k, v in sorted(igmma.items())))
    assert igmma and all(v > 0 for v in igmma.values()), igmma

    if args.dp_cards:
        return dp_cards(torch, polling_cuda, smi, args.dp_cards, args.phase)
    kernel = phase1_kernel(torch, polling_cuda, twin, polling_cases)
    bn = phase1b_frozen_bn(torch, frozen_bn_cuda)
    counts, per_call, _ = phase2_main_path(torch, polling_cuda)
    launches = counts["LAUNCHES"]
    calls = {}
    with tempfile.TemporaryDirectory() as tmp:
        with captured_calls() as calls["3"]:
            cli = phase3_cli(torch, polling_cuda, twin, tmp)
        with captured_calls() as calls["4"]:
            phase4_serve(torch, polling_cuda, tmp, cli)
        phase5_fused(torch, polling_cuda)
        evaluated = phase6_evaluate(torch, polling_cuda, tmp, cli)
        trained = phase7_train(torch, polling_cuda, tmp, cli, smi)
        int8 = phase8_int8(torch, polling_cuda, int8_conv_cuda, tmp, cli,
                           other)
        parallel = phase9_parallel(torch, tmp, smi, evaluated["b1"])
        backbones = phase10_backbones(torch, polling_cuda, int8_conv_cuda,
                                      int8_depthwise_cuda, tmp, cli,
                                      other_dw)
        phase11_host_extras(torch, polling_cuda, tmp, cli, trained, smi,
                            native_builds)
        options = phase12_options(torch, polling_cuda, int8_conv_cuda, tmp,
                                  smi)
    captured = phase13_captured(torch, nms_cuda, smi, calls, other_nms)
    log(f"chip_smoke total: {time.perf_counter() - t_start:.2f} s after "
        "phase 0's device query")
    pc = int8["per_call"]
    nms = captured["13a"]
    dw = backbones["10c"]
    dw1, dw4 = dw["per_call"]["b1"], dw["per_call"]["b4"]

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
        # phase 9b, each rank: bin/train's sweep, bin/evaluate float and
        # --int8 (polling, int8 conv, quantize)
        "launches_data_parallel": parallel["9b"]["launches"],
        # phase 9d, a replay each: the captured data-parallel calls at b1
        # and b4 and the captured shard_spatial call on the 1-rank NCCL
        # group
        "launches_mesh_captured": {
            label: r["launches"]["LAUNCHES"]
            for label, r in parallel["9a"]["9d"].items()},
        # phase 12, counted on each path alone: the unfused calls at b1
        # and b4, the packed calls (bf16 at b1 and b4, int8 at b1), and
        # each shard_spatial rank's f32 call and timed bf16 calls
        "launches_phase12": {
            "unfused_decode": options["12a"]["polling_launches"],
            "pack_levels": options["12b"]["polling_launches"],
            "shard_spatial": [options["12c"][f"rank{r}"]["polling_launches"]
                              for r in range(SPATIAL_RANKS)]},
        "phase12_ms": {
            "fused_vs_unfused": {b: options["12a"][b]["ms"]
                                 for b in ("b1", "b4")},
            "unpacked_vs_packed": {b: options["12b"][f"bf16_{b}"]["ms"]
                                   for b in ("b1", "b4")},
            "shard_spatial_bf16_b1": {
                "one_process": options["12c"]["one_process_bf16_ms"],
                **{f"rank{r}": options["12c"][f"rank{r}"]["bf16_ms"]
                   for r in range(SPATIAL_RANKS)}}},
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
        # phase 12b: the int8 detect call of the packed model (91 sites),
        # and every conv shape of its 26 x 127 tail canvas against its
        # plain version
        "packed_launches": options["12b"]["int8"]["launches"][:2],
        "packed_tail": options["12b"]["int8"]["tail_rows"],
    }, {
        "name": "int8_depthwise",
        "route": "cuda",
        "source": "ground_plane_polling_tpu_torch/csrc/int8_depthwise.cu",
        # the grouped (feature_group_count = C) case of the conv rewrite,
        # x's quantize included
        "replaces": "ground_plane_polling_tpu/models/quantize.py:222",
        # phase 10c's int8 detect calls of mobilenet224_1.0
        "launches": dw["launches"]["depthwise"],
        "max_abs_err": max(dw1["err"], dw4["err"]),
        # per b1 int8 forward: the sum over its 13 depthwise sites, the
        # fused kernel from the float site input
        "ms": dw1["ms"],
        "plain_ms": dw1["plain_ms"],
        "bound_ms": dw1["bound_ms"],
        "bound_by": dw1["bound_by"],
        # cuDNN's bf16 grouped conv (groups = C), same shapes
        "library_ms": dw1["cudnn_ms"],
        "launches_per_call": DW_SITES,
        "ms_b4": dw4["ms"],
        # the quantize kernel, then the int8-input depthwise kernel
        "unfused_pair_ms": dw1["pair_ms"],
        "b4": {k: dw4[k] for k in ("ms", "plain_ms", "bound_ms", "cudnn_ms",
                                   "pair_ms", "err")},
        "floor_ms": dw1["floor_ms"],
        "against": ({b: dw["per_call"][b]["against"] for b in ("b1", "b4")}
                    if "against" in dw1 else None),
    }, {
        "name": "nms",
        "route": "cuda",
        "source": "ground_plane_polling_tpu_torch/csrc/nms.cu",
        "replaces": "ground_plane_polling_tpu/ops/filtering.py:85",
        # phase 13b's captured calls (bf16 and int8, b1 and b4), one a call
        "launches": sum(r["launches"]["NMS_LAUNCHES"]
                        for r in captured["13b"].values()),
        "max_abs_err": 0.0,  # bit for bit (phase 13a)
        "ms": nms["b1"]["ms"],
        "plain_ms": nms["b1"]["plain_ms"],
        "bound_ms": nms["b1"]["bound_ms"],
        "bound_by": nms["b1"]["bound_by"],
        # no one PyTorch call computes exact greedy NMS into fixed slots
        "library_ms": None,
        "launches_per_call": 1,
        "launches_phase2": counts["NMS_LAUNCHES"],
        # phase 9d's captured mesh calls, a replay each
        "launches_mesh_captured": {
            label: r["launches"]["NMS_LAUNCHES"]
            for label, r in parallel["9a"]["9d"].items()},
        "b4": {k: nms["b4"][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "kept")},
        # the launch floor (torch.cuda._sleep(0)), device ms
        "floor_ms": nms["floor_ms"],
        # 12 and 48 random sets at K 1024, b4 with 200 of 1024 valid,
        # one set at K 1024 in 30 tight clusters
        "sets": {label: {k: nms[label][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "kept")}
            for label in ("s12", "s48", "b4_valid200", "k1024_clustered")},
        "large_cases": nms["large"],
        # with --against ROOT: ROOT's NMS kernel in turns with this one
        # (other, this, this, other), device ms; the large cases' turns
        # are under large_cases
        "against": ({label: nms[label]["turns"] for label in (
            "b1", "b4", "s12", "s48", "b4_valid200", "k1024_clustered")}
            if "turns" in nms["b1"] else None),
        "device_ops_per_call": nms["device_ops"],
        # phase 13b: the captured call against eager, per configuration
        "captured_call": {label: {k: r[k] for k in (
            "ms", "device_ms", "idle_share", "host_launches", "device_ops",
            "device_ops_other_nms", "host_syncs", "eager_host_syncs",
            "capture_s")}
            for label, r in captured["13b"].items()},
    }, {
        "name": "frozen_bn",
        "route": "cuda",
        "source": "ground_plane_polling_tpu_torch/csrc/frozen_bn.cu",
        # no TPU kernel: the jnp BN, shortcut add and ReLU of a block,
        # which XLA fuses on the TPU
        "replaces": "ground_plane_polling_tpu/models/resnet.py:52",
        # phase 2's main path: 10 b1 and 10 b4 captured calls
        "launches": counts["BN_ACT_LAUNCHES"],
        # phase 1b: every trunk site shape, b1 and b4, bf16 and float32,
        # against the plain passes
        "max_abs_err": bn["max_abs_err"],
        # per b1 bf16 forward: the sum over its 49 sites, cold
        "ms": bn["b1"]["kernel_ms_cold"],
        "plain_ms": bn["b1"]["plain_ms_cold"],
        "bound_ms": bn["b1"]["bound_ms"],
        "bound_by": "bytes",
        # no one PyTorch call does a site's BN, shortcut and ReLU; the
        # plain passes it replaces are PyTorch's own kernels (plain_ms)
        "library_ms": None,
        "launches_per_call": BN_SITES,
        "ms_warm": bn["b1"]["kernel_ms_warm"],
        "b4": {k: bn["b4"][k] for k in ("kernel_ms_cold", "kernel_ms_warm",
                                        "plain_ms_cold", "plain_ms_warm",
                                        "bound_ms", "share")},
        "sites_checked": bn["checks"],
        # phase 13b and phase 9d, a replay each
        "launches_captured": {
            label: r["launches"]["BN_ACT_LAUNCHES"]
            for label, r in captured["13b"].items()},
        "launches_mesh_captured": {
            label: r["launches"]["BN_ACT_LAUNCHES"]
            for label, r in parallel["9a"]["9d"].items()},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
