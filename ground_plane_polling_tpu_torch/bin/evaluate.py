"""Evaluation CLI (port of ground_plane_polling_tpu/bin/evaluate.py): mAP per
class-orientation bucket + keypoint/h/w/l L1 errors on a prepared KITTI
split, from the JAX package's exported .npz weights. Runs float32 with TF32
off (the JAX CLI has no bf16 option); `--int8 [N]` runs every conv int8,
calibrated on the first N eval images.

  python -m ground_plane_polling_tpu_torch.bin.evaluate model.npz \
      kitti-data --subset val

Prints one line per bucket, then {"mAP": ..., "keypoint_error": ...}.

--data-parallel splits the sweep over the processes of a launch
(COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID; one per card): each
group holds one image a process, and every process prints the same
results.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv):
    p = argparse.ArgumentParser(description="Evaluate a GPP model.")
    p.add_argument("model_path", help=".npz weights (with .json sidecar)")
    p.add_argument("kitti_path")
    p.add_argument("--subset", default="val")
    p.add_argument("--score-threshold", type=float, default=0.05)
    p.add_argument("--iou-threshold", type=float, default=0.5)
    p.add_argument("--max-detections", type=int, default=100)
    p.add_argument("--image-min-side", type=int, default=800)
    p.add_argument("--image-max-side", type=int, default=1333)
    p.add_argument("--backbone", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    p.add_argument("--fuse-towers", action="store_true",
                   help="run the cls+dim heads as one block-diagonal tower "
                        "(identical outputs)")
    p.add_argument("--eval-batch", type=int, default=None,
                   help="same-shape images per detect call (identical "
                        "results; default 4; ignored under "
                        "--data-parallel)")
    p.add_argument("--int8", type=int, nargs="?", const=8, default=0,
                   metavar="N",
                   help="run every conv int8 (post-training quantization), "
                        "calibrating activation scales on the first N eval "
                        "images (default 8)")
    p.add_argument("--int8-percentile", type=float, default=100.0,
                   help="clip each conv input's calibrated range to this "
                        "percentile of |x| (100 = absmax)")
    p.add_argument("--data-parallel", action="store_true",
                   help="split the sweep over the processes of the launch "
                        "(one image a process in each group; identical "
                        "results)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])

    import torch

    from ..data.kitti import KittiDataset
    from ..data.pipeline import KittiLoader
    from ..inference import place_model, require_device
    from ..models import build_detector, load_weights
    from ..parallel import data_parallel_mesh, initialize, is_multi_host
    from ..training.loop import evaluate_model

    device = require_device(args.device)
    initialize(device=device)  # a no-op without a multi-process launch
    mesh = None
    if args.data_parallel:
        if is_multi_host():
            mesh = data_parallel_mesh(device=device)
            device = mesh.device
            if args.eval_batch is not None:  # explicit: warn it's ignored
                print("note: --eval-batch is ignored with --data-parallel "
                      "(groups are mesh-sized)", file=sys.stderr)
        else:
            print("note: --data-parallel requested but only one device is "
                  "visible; falling back to single-device batching",
                  file=sys.stderr)
    # float32 means float32: no TF32 in convs or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = {}
    if os.path.exists(args.model_path + ".json"):
        with open(args.model_path + ".json") as f:
            cfg = json.load(f)
    backbone = args.backbone or cfg.get("backbone", "resnet50")
    num_classes = cfg.get("num_classes", 1)

    ds = KittiDataset(args.kitti_path, args.subset)
    loader = KittiLoader(ds, image_min_side=args.image_min_side,
                         image_max_side=args.image_max_side)
    model = load_weights(build_detector(backbone, num_classes,
                                        fuse_cls_dim=args.fuse_towers),
                         args.model_path)
    model = place_model(model, device, torch.float32)

    mean_ap, errors, aps = evaluate_model(
        model, loader, num_classes=num_classes,
        score_threshold=args.score_threshold,
        max_detections=args.max_detections,
        iou_threshold=args.iou_threshold, mesh=mesh,
        eval_batch=args.eval_batch if args.eval_batch is not None else 4,
        int8_calib=args.int8, int8_percentile=args.int8_percentile)

    for bucket, (ap, n) in sorted(aps.items()):
        print(f"bucket {bucket} (class {bucket // 4}, orient {bucket % 4}): "
              f"AP={ap:.4f} over {int(n)} annotations")
    print(json.dumps({"mAP": mean_ap, **errors}))
    return mean_ap, errors


if __name__ == "__main__":
    main()
