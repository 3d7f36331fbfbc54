"""Inference CLI (port of ground_plane_polling_tpu/bin/run_network.py): run the
detector on a directory of images + calibrations, recover 6-DoF poses, and
write .mat dumps, KITTI-format labels and composite visualizations.

  python -m ground_plane_polling_tpu_torch.bin.run_network model.npz \
      images/ calibs/ planes.mat out/ --kitti --save-images

The weights are the JAX package's exported .npz with its .json sidecar, or
a Keras .h5 checkpoint of the reference (models/h5_import.py; num_classes
from its head widths). `--save-images` writes one PNG a frame: the 2D
boxes and keypoints above the 3D boxes of the recovered poses.
Frames are bucketed by padded canvas shape and detected `--batch` at a time;
a short bucket is padded by repeating its last frame. `--int8 [N]` runs
every conv int8, calibrated on the first N frames (decoded once, then
detected like the others).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def parse_args(argv):
    p = argparse.ArgumentParser(
        description="Run the network on a directory of images.")
    p.add_argument("model_path", help=".npz weights (with .json sidecar) "
                                      "or a reference Keras .h5")
    p.add_argument("image_dir")
    p.add_argument("calib_dir")
    p.add_argument("plane_params_path", help=".mat road-plane database")
    p.add_argument("output_dir")
    p.add_argument("--kitti", action="store_true",
                   help="Write KITTI-format result txts.")
    p.add_argument("--batch", type=int, default=1,
                   help="detect N images per call (grouped by padded shape, "
                        "short groups padded by repeating the last frame)")
    p.add_argument("--prep-threads", type=int,
                   default=max(1, min(4, (os.cpu_count() or 1) - 1)),
                   help="host decode/resize threads (outputs identical to "
                        "serial)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    p.add_argument("--backbone", default=None,
                   help="Override the sidecar's backbone name.")
    p.add_argument("--score-threshold", type=float, default=0.05)
    p.add_argument("--class-names", nargs="+", default=["Car"],
                   help="KITTI type string per class id (default Car)")
    p.add_argument("--bf16", action="store_true", default=True,
                   help="bf16 trunk (default); --no-bf16 runs float32 with "
                        "TF32 off")
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--image-min-side", type=int, default=800)
    p.add_argument("--image-max-side", type=int, default=1333)
    p.add_argument("--fuse-towers", action="store_true",
                   help="run the cls+dim heads as one block-diagonal tower "
                        "(identical outputs)")
    p.add_argument("--int8", type=int, nargs="?", const=8, default=0,
                   metavar="N",
                   help="run every conv int8 (post-training quantization), "
                        "calibrating on the first N images (default 8)")
    p.add_argument("--int8-percentile", type=float, default=100.0,
                   help="clip calibrated ranges to this percentile of |x| "
                        "(100 = absmax)")
    p.add_argument("--save-images", action="store_true",
                   help="Write composite 2D/3D visualization images.")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])

    import scipy.io
    import torch

    from ..data.frames import prepare_network_frame
    from ..data.planes import load_plane_database
    from ..inference import make_detect_fn, place_model, require_device
    from ..models import build_detector, load_state, read_weights
    from ..models.quantize import collect_scales_uint8
    from ..utils.kitti_writer import write_kitti_file
    from ..utils.visualization import (draw_3d_detections_from_pose,
                                       draw_detections_with_keypoints)

    device = require_device(args.device)
    if not args.bf16:  # float32 means float32: no TF32 in convs or matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    cfg = {}
    if os.path.exists(args.model_path + ".json"):
        with open(args.model_path + ".json") as f:
            cfg = json.load(f)
    backbone = args.backbone or cfg.get("backbone", "resnet50")
    flat, num_classes = read_weights(args.model_path, backbone,
                                     cfg.get("num_classes", 1))
    model = load_state(build_detector(backbone, num_classes,
                                      fuse_cls_dim=args.fuse_towers),
                       flat, args.model_path)
    model = place_model(model, device,
                        torch.bfloat16 if args.bf16 else torch.float32)
    planes = load_plane_database(args.plane_params_path)

    out_root = os.path.join(
        args.output_dir,
        os.path.basename(args.model_path).rsplit(".", 1)[0])
    os.makedirs(os.path.join(out_root, "outputs", "full"), exist_ok=True)
    if args.kitti:
        os.makedirs(os.path.join(out_root, "outputs", "kitti"), exist_ok=True)
    if args.save_images:
        os.makedirs(os.path.join(out_root, "images", "composite"),
                    exist_ok=True)

    detect_fns = {}
    quant_scales = None

    def get_fn(shape):
        if shape not in detect_fns:
            detect_fns[shape] = make_detect_fn(
                model, shape, num_classes=num_classes, with_pose=True,
                nms=cfg.get("nms", True),
                class_specific=cfg.get("class_specific_filter", True),
                orientation_specific=cfg.get("orientation_specific_filter",
                                             False),
                score_threshold=args.score_threshold,
                quant_scales=quant_scales, device_preprocess=True,
                device=device)
        return detect_fns[shape]

    def prepare(fn_txt):
        image_fp = None
        for ext in (".png", ".jpg"):
            cand = os.path.join(args.image_dir, fn_txt.replace(".txt", ext))
            if os.path.exists(cand):
                image_fp = cand
                break
        if image_fp is None:
            return None
        fr = prepare_network_frame(
            image_fp, os.path.join(args.calib_dir, fn_txt),
            args.image_min_side, args.image_max_side)
        fr["path"] = image_fp
        return fr

    def write_outputs(fr, out, j):
        """Write one image's .mat / KITTI txt / composite from row j of a
        host copy of a (possibly batched) detect output."""
        scale = fr["scale"]
        keep = out["scores"][j] > args.score_threshold
        boxes = out["boxes"][j][keep] / scale
        scores = out["scores"][j][keep]
        labels = out["labels"][j][keep]
        orientations = out["orientations"][j][keep]
        keypoints = out["keypoints"][j][keep].reshape(-1, 12)
        keyplanes = out["keyplanes"][j][keep].reshape(-1, 4)
        residuals = out["residuals"][j][keep]
        locations = out["locations"][j][keep]
        angles = out["angles"][j][keep]
        dims = out["pose_dims"][j][keep]

        stem = os.path.basename(fr["path"]).rsplit(".", 1)[0]
        scipy.io.savemat(
            os.path.join(out_root, "outputs", "full", stem + ".mat"),
            {"boxes": boxes[:, :4], "keypoints": boxes[:, 4:],
             "labels": labels, "scores": scores, "locations": locations,
             "angles": angles, "dimensions": dims, "residuals": residuals,
             "keyplanes": keyplanes, "keypoints3d": keypoints})
        if args.kitti:
            names = [args.class_names[int(l)]
                     if 0 <= int(l) < len(args.class_names) else "Car"
                     for l in labels]
            write_kitti_file(
                os.path.join(out_root, "outputs", "kitti", stem + ".txt"),
                boxes, scores, locations, angles, dims, fr["raw"].shape[:2],
                class_name=names)
        if args.save_images:
            from PIL import Image

            top = draw_detections_with_keypoints(
                fr["raw"].copy(), boxes, scores, labels, orientations,
                score_threshold=0.4)
            bottom = draw_3d_detections_from_pose(
                fr["raw"].copy(), boxes[:, :4], orientations, residuals,
                scores, labels, locations, angles, dims, fr["P"],
                score_threshold=0.4)
            comp = np.vstack([top, bottom])
            Image.fromarray(comp[:, :, ::-1]).save(
                os.path.join(out_root, "images", "composite",
                             stem + ".png"))

    batch = max(1, args.batch)
    # the plane database is shared by every frame: upload it once
    planes_dev = torch.as_tensor(np.tile(planes[None], (batch, 1, 1)),
                                 device=device)
    n_done = 0
    t_start = time.time()

    def run(chunk):
        nonlocal n_done
        t0 = time.time()
        padded = chunk + [chunk[-1]] * (batch - len(chunk))
        images = torch.from_numpy(np.stack([f["image"] for f in padded]))
        P_inv = torch.from_numpy(np.stack([f["P_inv"] for f in padded]))
        out = get_fn(chunk[0]["shape"])(images, P_inv, planes_dev)
        out = {k: v.cpu().numpy() for k, v in out._asdict().items()}
        for j, fr in enumerate(chunk):
            write_outputs(fr, out, j)
        dt = max(time.time() - t0, 1e-9)
        first = n_done
        n_done += len(chunk)
        label = (f"Image {first}" if len(chunk) == 1 else
                 f"Images {first}-{n_done - 1}")
        print(f"{label}: frame rate: {len(chunk) / dt:.2f}")

    calib_files = sorted(f for f in os.listdir(args.calib_dir)
                         if f.endswith(".txt"))

    prepared = {}  # frames decoded for int8 calibration, reused below
    if args.int8:
        canvases = []
        for fn in calib_files:
            prepared[fn] = fr = prepare(fn)
            if fr is not None:
                canvases.append(fr["image"])
            if len(canvases) >= args.int8:
                break
        if canvases:
            quant_scales = collect_scales_uint8(
                model, canvases, percentile=args.int8_percentile)

    def prepared_frames():
        """Frames in calib_files order, decoded ahead on a bounded pool
        (or taken from the calibration's)."""
        if args.prep_threads <= 1:
            for fn in calib_files:
                yield prepared.pop(fn) if fn in prepared else prepare(fn)
            return
        with ThreadPoolExecutor(args.prep_threads) as pool:
            q = collections.deque()
            it = iter(calib_files)

            def submit_next():
                fn = next(it, None)
                if fn in prepared:
                    q.append((None, prepared.pop(fn)))
                elif fn is not None:
                    q.append((pool.submit(prepare, fn), None))
                return fn is not None

            while len(q) < 2 * args.prep_threads and submit_next():
                pass
            while q:
                fut, fr = q.popleft()
                submit_next()
                yield fr if fut is None else fut.result()

    buckets = {}
    for fr in prepared_frames():
        if fr is None:
            continue
        buckets.setdefault(fr["shape"], []).append(fr)
        if len(buckets[fr["shape"]]) == batch:
            run(buckets.pop(fr["shape"]))
    for chunk in buckets.values():  # padded remainders
        run(chunk)
    if n_done:
        dt = time.time() - t_start
        print(f"done: {n_done} images in {dt:.2f}s "
              f"({n_done / max(dt, 1e-9):.1f} img/s)")


if __name__ == "__main__":
    main()
