"""Data preparation CLI (port of ground_plane_polling_tpu/bin/
prepare_data.py, host only): modified-label generation and the
video-aware train/val split in one command.

  python -m ground_plane_polling_tpu_torch.bin.prepare_data \
      --label-dir raw/label_2 --calib-dir raw/calib \
      --image-dir raw/image_2 --devkit-dir raw/devkit_object \
      --output-dir kitti-data [--plane-db planes.mat]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys


def parse_args(argv):
    p = argparse.ArgumentParser(description="Prepare KITTI data for GPP.")
    p.add_argument("--label-dir", required=True,
                   help="Raw KITTI training label_2 directory.")
    p.add_argument("--calib-dir", required=True)
    p.add_argument("--image-dir", required=True)
    p.add_argument("--devkit-dir", required=True,
                   help="devkit_object dir containing mapping/.")
    p.add_argument("--output-dir", default="kitti-data")
    p.add_argument("--plane-db", default=None,
                   help="Road-plane .mat to copy into the output root.")
    p.add_argument("--no-symlinks", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])

    from ..data.label_prep import create_modified_labels
    from ..data.prepare_split import split_train_val

    mod_label_dir = os.path.join(args.output_dir, "_mod_labels")
    print("Generating modified labels ...")
    n = create_modified_labels(args.label_dir, args.calib_dir, mod_label_dir)
    print(f"  {n} label files")

    print("Creating video-aware train/val split ...")
    counts = split_train_val(
        args.image_dir, mod_label_dir, args.calib_dir, args.devkit_dir,
        args.output_dir, use_symlinks=not args.no_symlinks)
    print(f"  train: {counts['train']}  val: {counts['val']}")

    if args.plane_db:
        shutil.copyfile(
            args.plane_db,
            os.path.join(args.output_dir, "road_planes_database.mat"))
    print("Done.")
    return counts


if __name__ == "__main__":
    main()
