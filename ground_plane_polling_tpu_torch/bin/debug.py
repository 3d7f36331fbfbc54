"""Dataset debug viewer (port of ground_plane_polling_tpu/bin/debug.py), the
Keras reference's retinanet-3D-debug without a window: it writes annotated
images (ground-truth boxes and keypoint glyphs, optionally the positive
anchors coloured by orientation) to an output directory, one PNG a frame.

  python -m ground_plane_polling_tpu_torch.bin.debug kitti /data/kitti \
      --out debug_vis --anchors --random-transform --limit 20

--resize applies the training resize (cv2, else PIL). --random-transform
draws each frame's augmentation from a torch.Generator seeded with 0 (the
JAX CLI's PRNGKey(0); the two generators draw different numbers) with
data/augment.py::draw_augmentation, as bin/train does, and applies it on
the CPU. Anchor targets come from ops/targets.py on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def parse_args(argv):
    p = argparse.ArgumentParser(description="Debug dataset plumbing.")
    sub = p.add_subparsers(dest="dataset_type")
    kitti = sub.add_parser("kitti")
    kitti.add_argument("kitti_path")
    p.add_argument("--subset", default="train")
    p.add_argument("--out", default="debug_vis")
    p.add_argument("--limit", type=int, default=10)
    p.add_argument("--anchors", action="store_true",
                   help="Also draw positive anchors per orientation.")
    p.add_argument("--random-transform", action="store_true")
    p.add_argument("--resize", action="store_true",
                   help="Apply the training resize before drawing.")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if args.dataset_type != "kitti":
        raise SystemExit("only kitti is supported")

    import torch
    from PIL import Image

    from ..data.augment import augment_example, draw_augmentation
    from ..data.frames import resize_uint8
    from ..data.kitti import KittiDataset, resize_scale
    from ..ops import anchors as anchor_ops
    from ..ops.targets import anchor_targets
    from ..utils.visualization import (draw_anchors,
                                       draw_annotations_with_keypoints)

    ds = KittiDataset(args.kitti_path, args.subset)
    os.makedirs(args.out, exist_ok=True)
    gen = torch.Generator().manual_seed(0)

    for i in range(min(args.limit, len(ds))):
        image = ds.load_image(i).astype(np.float32)
        anns, ignores = ds.load_annotations(i)

        if args.resize:
            scale = resize_scale(image.shape[:2])
            image = resize_uint8(image, scale).astype(np.float32)
            anns = anns.copy()
            anns[:, :12] *= scale
            ignores = ignores * scale

        if args.random_transform and len(anns):
            drawn = draw_augmentation(
                gen, torch.tensor([image.shape[:2]], dtype=torch.float32))
            g = np.zeros((max(len(anns), 1), 17), np.float32)
            g[: len(anns)] = anns
            ig = np.zeros((max(len(ignores), 1), 4), np.float32)
            ig[: len(ignores)] = ignores
            image_t, anns_t, ig_t = augment_example(
                torch.from_numpy(image), torch.from_numpy(g),
                torch.from_numpy(ig), drawn["transform"][0],
                drawn["flip_x"][0], drawn["photometric"][0])
            image = image_t.numpy()
            anns = anns_t.numpy()[: len(anns)]
            ignores = ig_t.numpy()[: len(ignores)]

        canvas = np.clip(image, 0, 255).astype(np.uint8)
        if args.anchors and len(anns):
            grid = anchor_ops.anchors_for_shape(image.shape[:2])
            g = np.zeros((32, 17), np.float32)
            m = np.zeros(32, bool)
            n = min(len(anns), 32)
            g[:n], m[:n] = anns[:n], True
            ig = np.zeros((8, 4), np.float32)
            gm = np.zeros(8, bool)
            k = min(len(ignores), 8)
            if k:
                ig[:k], gm[:k] = ignores[:k], True
            targets = anchor_targets(
                *(torch.from_numpy(a) for a in (grid, g, m, ig, gm)),
                num_classes=ds.num_classes)
            canvas = draw_anchors(canvas, grid, targets["labels"].numpy())
        canvas = draw_annotations_with_keypoints(canvas, anns)

        stem = os.path.basename(ds.image_paths[i]).rsplit(".", 1)[0]
        Image.fromarray(canvas[:, :, ::-1]).save(
            os.path.join(args.out, stem + ".png"))
        print(f"wrote {stem}.png ({len(anns)} annotations)")


if __name__ == "__main__":
    main()
