"""Inference CLI (port of ground_plane_polling_tpu/bin/run_network.py): run the
detector on a directory of images + calibrations, recover 6-DoF poses, and
write .mat dumps and KITTI-format labels.

  python -m ground_plane_polling_tpu_torch.bin.run_network model.npz \
      images/ calibs/ planes.mat out/ --kitti

The weights are the JAX package's exported .npz with its .json sidecar.
Frames are bucketed by padded canvas shape and detected `--batch` at a time;
a short bucket is padded by repeating its last frame.
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
    p.add_argument("model_path", help=".npz weights (with .json sidecar)")
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
    # options of the JAX CLI that the port does not have yet
    p.add_argument("--save-images", action="store_true",
                   help="not ported yet (ROADMAP A10)")
    p.add_argument("--int8", type=int, nargs="?", const=8, default=0,
                   help="not ported yet (ROADMAP A16)")
    p.add_argument("--fuse-towers", action="store_true",
                   help="not ported yet (ROADMAP A11)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    for flag, item in (("save_images", "A10"), ("int8", "A16"),
                       ("fuse_towers", "A11")):
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet "
                f"(ROADMAP {item})")
    if args.model_path.endswith((".h5", ".hdf5")):
        raise NotImplementedError(
            ".h5 weights: the Keras import is ROADMAP A10; convert them to "
            ".npz with the JAX package's convert-model")

    import scipy.io
    import torch

    from ..data.frames import prepare_network_frame
    from ..data.planes import load_plane_database
    from ..inference import make_detect_fn, place_model
    from ..models import build_detector, load_weights
    from ..utils.kitti_writer import write_kitti_file

    device = torch.device(args.device)
    if not args.bf16:  # float32 means float32: no TF32 in convs or matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    cfg = {}
    if os.path.exists(args.model_path + ".json"):
        with open(args.model_path + ".json") as f:
            cfg = json.load(f)
    backbone = args.backbone or cfg.get("backbone", "resnet50")
    num_classes = cfg.get("num_classes", 1)
    model = load_weights(build_detector(backbone, num_classes),
                         args.model_path)
    model = place_model(model, device,
                        torch.bfloat16 if args.bf16 else torch.float32)
    planes = load_plane_database(args.plane_params_path)

    out_root = os.path.join(
        args.output_dir,
        os.path.basename(args.model_path).rsplit(".", 1)[0])
    os.makedirs(os.path.join(out_root, "outputs", "full"), exist_ok=True)
    if args.kitti:
        os.makedirs(os.path.join(out_root, "outputs", "kitti"), exist_ok=True)

    detect_fns = {}

    def get_fn(shape):
        if shape not in detect_fns:
            detect_fns[shape] = make_detect_fn(
                model, shape, num_classes=num_classes, with_pose=True,
                nms=cfg.get("nms", True),
                class_specific=cfg.get("class_specific_filter", True),
                orientation_specific=cfg.get("orientation_specific_filter",
                                             False),
                score_threshold=args.score_threshold,
                device_preprocess=True, device=device)
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
        """Write one image's .mat / KITTI txt from row j of a host copy of a
        (possibly batched) detect output."""
        scale = fr["scale"]
        keep = out["scores"][j] > args.score_threshold
        boxes = out["boxes"][j][keep] / scale
        scores = out["scores"][j][keep]
        labels = out["labels"][j][keep]
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

    def prepared_frames():
        """Frames in calib_files order, decoded ahead on a bounded pool."""
        if args.prep_threads <= 1:
            for fn in calib_files:
                yield prepare(fn)
            return
        with ThreadPoolExecutor(args.prep_threads) as pool:
            q = collections.deque()
            it = iter(calib_files)
            for fn in it:
                q.append(pool.submit(prepare, fn))
                if len(q) >= 2 * args.prep_threads:
                    break
            while q:
                fut = q.popleft()
                fn = next(it, None)
                if fn is not None:
                    q.append(pool.submit(prepare, fn))
                yield fut.result()

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
