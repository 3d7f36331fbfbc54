"""Offline KITTI AP_2D / AP_BEV / AP_3D / AOS evaluation (port of
ground_plane_polling_tpu/bin/evaluate_3d.py).

A stand-in for the external KITTI C++ devkit
(`evaluate_object_3d_offline gt_dir result_dir`), run on the KITTI-format
txts that run_network and serve write:

  gpp-torch-evaluate-3d /data/kitti/label_2 out/kitti \
      --classes Car --ap-mode 40 --json out/ap3d.json

Evaluates every GT id; a missing result file counts as zero detections
(the devkit aborts instead). Pure host-side numpy; see utils/eval3d.py for
the protocol.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        description="KITTI devkit-style AP2D/BEV/3D/AOS evaluation.")
    p.add_argument("gt_dir", help="ground-truth KITTI label directory")
    p.add_argument("det_dir", help="detection result directory "
                                   "(16-column KITTI rows with score)")
    p.add_argument("--classes", nargs="+", default=["Car"],
                   choices=["Car", "Pedestrian", "Cyclist"])
    p.add_argument("--metrics", nargs="+", default=["bbox", "bev", "3d"],
                   choices=["bbox", "bev", "3d"])
    p.add_argument("--ap-mode", default="40", choices=["11", "40"],
                   help="11-point (classic devkit) or R40 (2019 revision)")
    p.add_argument("--no-aos", action="store_true",
                   help="skip orientation similarity")
    p.add_argument("--json", default=None,
                   help="also write the result dict as JSON")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])

    from ..utils import eval3d

    import os
    ids = sorted(os.path.splitext(f)[0] for f in os.listdir(args.gt_dir)
                 if f.endswith(".txt"))
    if not ids:
        p.error(f"no .txt label files in {args.gt_dir}")
    gt = eval3d.load_label_dir(args.gt_dir, ids)
    det = eval3d.load_label_dir(args.det_dir, ids)
    missing = sum(1 for stem in ids if not os.path.exists(
        os.path.join(args.det_dir, stem + ".txt")))
    if missing:
        print(f"note: {missing}/{len(ids)} result files missing "
              "(scored as empty)", file=sys.stderr)

    results = eval3d.evaluate_kitti_3d(
        gt, det, classes=args.classes, metrics=args.metrics,
        ap_mode=args.ap_mode, compute_aos=not args.no_aos)
    print(eval3d.format_results(results))
    if args.json:
        # empty buckets are float('nan'); bare NaN tokens are not valid
        # JSON (jq / JSON.parse reject them) -> serialize as null
        def _nan_to_null(x):
            if isinstance(x, dict):
                return {k: _nan_to_null(v) for k, v in x.items()}
            if isinstance(x, float) and x != x:
                return None
            return x

        with open(args.json, "w") as f:
            json.dump(_nan_to_null(results), f, indent=2, allow_nan=False)
        print(f"wrote {args.json}")
    return results


if __name__ == "__main__":
    main()
