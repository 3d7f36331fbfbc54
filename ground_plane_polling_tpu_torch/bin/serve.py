"""Micro-batching detection service over a directory (port of
ground_plane_polling_tpu/bin/serve.py): watch a directory, detect in
fixed-size batches, write one KITTI txt per image as images arrive.

  python -m ground_plane_polling_tpu_torch.bin.serve model.npz \
      incoming_images/ calibs/ planes.mat out/ --batch-size 2 [--once]

Each poll round lists the images (case-insensitive .png/.jpg, one per
stem) that have a calibration and are not done, decodes at most
`_intake_cap` of them, uploads each canvas as it is decoded, groups them by
padded shape and runs each group `--batch-size` at a time (a short group is
padded by repeating its last image; the padding rows are discarded). One
batch stays in flight: the next batch is dispatched before the previous one
is read back and written. A frame that fails to decode is retried on later
rounds and skipped after 5 attempts (at once under --once). Under --once a
backlog larger than the cap drains over further rounds, then the service
exits.

On a card the detect call is a CUDA graph replay
(inference.CapturedDetect) that never reads back from the card, so the
dispatch of a batch returns once its work is enqueued, and the card runs
it while the previous batch is read back and written. `--int8 [N]`
calibrates int8 scales once, on the first N frames of the first round,
before any detect call, and then runs every conv int8. A reference Keras
.h5 is read by models/h5_import.py, its num_classes taken from its head
widths, as run_network does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def parse_args(argv):
    p = argparse.ArgumentParser(
        description="Micro-batching detection service over a directory.")
    p.add_argument("model_path", help=".npz weights (with .json sidecar) "
                                      "or a reference Keras .h5")
    p.add_argument("image_dir", help="directory to watch for images")
    p.add_argument("calib_dir")
    p.add_argument("plane_params_path")
    p.add_argument("output_dir")
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--poll-interval", type=float, default=0.5)
    p.add_argument("--class-names", nargs="+", default=["Car"],
                   help="KITTI type string per class id for the txt "
                        "output (multi-class models; default Car)")
    p.add_argument("--once", action="store_true",
                   help="process what's there, then exit (no watching)")
    p.add_argument("--score-threshold", type=float, default=0.05)
    p.add_argument("--backbone", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    p.add_argument("--bf16", action="store_true", default=True,
                   help="bf16 trunk (default); --no-bf16 runs float32 with "
                        "TF32 off")
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--fuse-towers", action="store_true",
                   help="run the cls+dim heads as one block-diagonal tower "
                        "(identical outputs)")
    p.add_argument("--image-min-side", type=int, default=800)
    p.add_argument("--image-max-side", type=int, default=1333)
    p.add_argument("--int8", type=int, nargs="?", const=8, default=0,
                   metavar="N",
                   help="run every conv int8 (post-training quantization), "
                        "calibrating activation scales on the first N "
                        "arrivals (default 8)")
    p.add_argument("--int8-percentile", type=float, default=100.0,
                   help="clip calibrated ranges to this percentile of |x| "
                        "(100 = absmax)")
    return p.parse_args(argv)


def _intake_cap(batch_size, int8_n):
    """Max images decoded and uploaded per poll round: a few batches'
    worth keeps the overlap fed without staging an unbounded backlog in
    device memory (int8 calibration needs its whole sample in the first
    round)."""
    return max(4 * batch_size, int(int8_n or 0))


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])

    import numpy as np
    import torch

    from ..data.frames import prepare_network_frame
    from ..data.planes import load_plane_database
    from ..inference import make_detect_fn, place_model, require_device
    from ..models import build_detector, load_state, read_weights
    from ..models.quantize import collect_scales_uint8
    from ..utils.kitti_writer import write_kitti_file

    device = require_device(args.device)
    if not args.bf16:  # float32 means float32: no TF32 in convs or matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    on_cuda = device.type == "cuda"

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
    # shared constant input: upload the tiled plane DB once, not per batch
    planes_dev = torch.as_tensor(
        np.tile(planes[None].astype(np.float32), (args.batch_size, 1, 1)),
        device=device)
    os.makedirs(args.output_dir, exist_ok=True)

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

    def upload(array):
        """Host -> device copy that starts now and does not block: from
        pinned memory on the card, so the canvas streams up while earlier
        batches compute."""
        t = torch.from_numpy(array)
        if on_cuda:
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    def load_item(stem):
        # match the case-insensitive listing (0001.PNG must not be listed,
        # missed here, and silently marked done)
        for ext in (".png", ".jpg", ".PNG", ".JPG"):
            fp = os.path.join(args.image_dir, stem + ext)
            if os.path.exists(fp):
                break
        else:
            return None
        fr = prepare_network_frame(
            fp, os.path.join(args.calib_dir, stem + ".txt"),
            args.image_min_side, args.image_max_side)
        return {"stem": stem, "shape": fr["shape"], "scale": fr["scale"],
                "P_inv": fr["P_inv"], "image_hw": fr["raw"].shape[:2],
                "image_dev": upload(fr["image"])}

    def dispatch_batch(items):
        """items share one padded shape; pads to batch_size by repetition.
        Returns with the device work of polling and pose still queued."""
        n = len(items)
        items = items + [items[-1]] * (args.batch_size - n)
        out = get_fn(items[0]["shape"])(
            torch.stack([it["image_dev"] for it in items]),
            upload(np.stack([it["P_inv"] for it in items])),
            planes_dev)
        return n, items, out, time.time()

    def finalize_batch(pending):
        """Read a dispatched batch back and write its outputs."""
        n, items, out, t_disp = pending
        out = {k: v.cpu().numpy() for k, v in out._asdict().items()
               if v is not None}
        for j in range(n):
            it = items[j]
            keep = out["scores"][j] > args.score_threshold
            names = [args.class_names[int(l)]
                     if 0 <= int(l) < len(args.class_names) else "Car"
                     for l in out["labels"][j][keep]]
            write_kitti_file(
                os.path.join(args.output_dir, it["stem"] + ".txt"),
                out["boxes"][j][keep] / it["scale"], out["scores"][j][keep],
                out["locations"][j][keep], out["angles"][j][keep],
                out["pose_dims"][j][keep], it["image_hw"],
                class_name=names)
        # dispatch -> outputs-on-disk latency of this batch, overlap window
        # included (what a consumer of the directory sees)
        latencies.append(time.time() - t_disp)
        return n

    done = set()
    fail_counts: dict = {}
    latencies: list = []
    total = 0
    t_start = time.time()
    # bound how much backlog one round decodes: every loaded item holds a
    # canvas on the device, so an unbounded round would stage the whole
    # backlog there before the first dispatch; leftover stems stay not done
    # and the next round takes them at once (no sleep while fresh is not
    # empty)
    intake_cap = _intake_cap(args.batch_size, args.int8)
    while True:
        # set-dedupe: stem.png + stem.jpg must not process twice
        stems = sorted({
            f.rsplit(".", 1)[0] for f in os.listdir(args.image_dir)
            if f.lower().endswith((".png", ".jpg"))})
        fresh = [s for s in stems if s not in done
                 and os.path.exists(os.path.join(args.calib_dir, s + ".txt"))]
        if not fresh:
            if args.once:
                break
            time.sleep(args.poll_interval)
            continue
        fresh = fresh[:intake_cap]

        buckets = {}
        for stem in fresh:
            # a watcher must survive partially-written or corrupt frames:
            # retry on later polls, give up (and log) after a few attempts
            try:
                item = load_item(stem)
            except Exception as e:  # noqa: BLE001 — skip-and-retry
                fail_counts[stem] = fail_counts.get(stem, 0) + 1
                if fail_counts[stem] >= 5 or args.once:
                    print(f"skipping {stem}: {e}", file=sys.stderr)
                    done.add(stem)
                continue
            if item is not None:
                buckets.setdefault(item["shape"], []).append(item)
            done.add(stem)
        if args.int8 and quant_scales is None and buckets:
            # calibrate once, on the first arrivals, before any detect fn
            # is made: every shape's detect fn then runs int8
            canvases = [it["image_dev"] for items in buckets.values()
                        for it in items][:args.int8]
            quant_scales = collect_scales_uint8(
                model, canvases, percentile=args.int8_percentile)
            print(f"int8: calibrated on {len(canvases)} images", flush=True)
        t0 = time.time()
        n_round = 0
        pending = None  # one batch in flight
        for shape, items in buckets.items():
            for st in range(0, len(items), args.batch_size):
                dispatched = dispatch_batch(items[st:st + args.batch_size])
                if pending is not None:
                    n_round += finalize_batch(pending)
                pending = dispatched
        if pending is not None:
            n_round += finalize_batch(pending)
        total += n_round
        dt = time.time() - t0
        print(f"served {n_round} images in {dt:.2f}s "
              f"({n_round / max(dt, 1e-9):.1f} img/s); total {total}",
              flush=True)
        # no --once break here: a backlog bigger than intake_cap drains
        # over further rounds; the empty-`fresh` check is the only exit
    if total:
        line = f"done: {total} images in {time.time() - t_start:.2f}s"
        if latencies:
            lat = np.sort(np.asarray(latencies))
            p50 = lat[len(lat) // 2]
            p95 = lat[min(len(lat) - 1, int(np.ceil(0.95 * len(lat))) - 1)]
            line += (f"; batch latency p50 {p50*1e3:.0f} ms / "
                     f"p95 {p95*1e3:.0f} ms (n={len(lat)})")
        print(line, flush=True)
    return total


if __name__ == "__main__":
    main()
