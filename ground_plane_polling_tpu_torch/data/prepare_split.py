"""Video-aware KITTI train/val split (the port's own copy of
ground_plane_polling_tpu/data/prepare_split.py).

KITTI object-detection frames come from driving videos; a random frame split
leaks near-duplicate frames across train/val. The devkit's train_rand.txt /
train_mapping.txt map each image index to its source drive; drives recorded
2011_09_26 with id <= 15 go to val and everything else to train, as in the
reference's prepare_kitti_data.py.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, Tuple

__all__ = ["image_to_video_mapping", "split_train_val"]

_MAP_RE = re.compile(
    r"^\s*[\d_]+\s+(\d{4}_\d{2}_\d{2})_drive_(\d{4})_sync\s+(\d+)\s*$")


def image_to_video_mapping(devkit_dir: str) -> Dict[int, Tuple[str, int]]:
    """image index -> (video name '2011_09_26_0005', frame index)."""
    with open(os.path.join(devkit_dir, "mapping", "train_mapping.txt")) as f:
        lines = f.readlines()
    mapping = {}
    with open(os.path.join(devkit_dir, "mapping", "train_rand.txt")) as f:
        for image_index, tok in enumerate(f.read().split(",")):
            tok = tok.strip()
            if not tok:
                continue
            m = _MAP_RE.match(lines[int(tok) - 1])
            if not m:
                raise ValueError(f"bad mapping line for image {image_index}")
            date, drive, frame = m.group(1), m.group(2), int(m.group(3))
            mapping[image_index] = (f"{date}_{drive}", frame)
    return mapping


def _is_val_video(video_name: str) -> bool:
    m = re.match(r"^(\d{4})_(\d{2})_(\d{2})_(\d+)$", video_name)
    if not m:
        raise ValueError(f"unrecognized video name {video_name!r}")
    month, day, vid = int(m.group(2)), int(m.group(3)), int(m.group(4))
    return month == 9 and day == 26 and vid <= 15


def split_train_val(image_dir: str, label_dir: str, calib_dir: str,
                    devkit_dir: str, out_dir: str,
                    use_symlinks: bool = True) -> Dict[str, int]:
    """Create out_dir/{train,val}/{images,labels,calibs} from flat KITTI
    training dirs. Returns counts per subset."""
    mapping = image_to_video_mapping(devkit_dir)
    counts = {"train": 0, "val": 0}
    link = os.symlink if use_symlinks else shutil.copyfile

    for fn in sorted(os.listdir(image_dir)):
        stem, ext = os.path.splitext(fn)
        if ext.lower() not in (".png", ".jpg"):
            continue
        idx = int(stem)
        video, frame = mapping[idx]
        subset = "val" if _is_val_video(video) else "train"
        counts[subset] += 1
        new_stem = f"{frame:09d}_{stem}"
        for src_dir, kind, src_ext in (
            (image_dir, "images", ext),
            (label_dir, "labels", ".txt"),
            (calib_dir, "calibs", ".txt"),
        ):
            dst_dir = os.path.join(out_dir, subset, kind)
            os.makedirs(dst_dir, exist_ok=True)
            src = os.path.abspath(os.path.join(src_dir, stem + src_ext))
            dst = os.path.join(dst_dir, new_stem + src_ext)
            if not os.path.exists(dst):
                link(src, dst)
    return counts
