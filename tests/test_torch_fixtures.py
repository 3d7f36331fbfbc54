"""Shared inputs of the port's CLI tests (serve, evaluate, convert_model):
seeded ResNet-50 weights whose detections have well-separated scores, and
a prepared KITTI split whose labels are detections of those weights, so
that AP and the L1 errors are not trivially 0.

The classification out kernel is redrawn from N(0, 0.01) with a zero bias:
logits then spread over a few units (N(0, 0.05), as in
test_torch_run_network.py, saturates the top 100 scores at 1.0 within
1e-4, where a reordering of near-equal scores between two frameworks would
move AP).
"""

import json
import os

import numpy as np
import torch

from ground_plane_polling_tpu_torch.data.pipeline import KittiLoader
from ground_plane_polling_tpu_torch.data.kitti import KittiDataset
from ground_plane_polling_tpu_torch.data.planes import save_plane_database
from ground_plane_polling_tpu_torch.inference import make_detect_fn
from ground_plane_polling_tpu_torch.models import (build_detector,
                                                   export_jax_params,
                                                   init_detector)

from .fixtures import _calib_text

CLS_STD = 0.01
# (height, width) of the split's frames: two padded-shape buckets at
# --image-min-side 64 --image-max-side 224 (64x224 and 64x192)
FRAME_SIZES = ((128, 416), (128, 416), (140, 400), (128, 416), (140, 400))
# ranks (by score) of each frame's detections that become its labels: the
# others are false positives between them, so AP is neither 0 nor 1
LABEL_RANKS = (0, 1, 3, 6, 10, 15)


def resnet50_weights(path, seed=0, num_classes=1, cls_std=CLS_STD):
    """Seeded ResNet-50 detector export at `path` with its .json sidecar;
    returns the port model (float32, CPU)."""
    model = init_detector(build_detector("resnet50", num_classes), seed)
    out = model.classification.cls_out
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        out.weight.copy_(torch.randn(out.weight.shape, generator=gen)
                         * cls_std)
        out.bias.zero_()
    np.savez(path, **export_jax_params(model))
    with open(path + ".json", "w") as f:
        json.dump({"backbone": "resnet50", "num_classes": num_classes}, f)
    return model.eval()


def _label_row(box, dims, orient):
    """20-field modified label: type trunc occ alpha x1 y1 x2 y2 kp*8
    h w l orientation."""
    vals = " ".join(f"{v:.2f}" for v in (*box, *dims))
    return f"Car 0.00 0 0.00 {vals} {int(orient)}"


def make_prepared_split(root, model, subset="val", min_side=64,
                        max_side=224, seed=0, n_planes=10):
    """root/{subset}/{images,labels,calibs} + root/road_planes_database.mat,
    labels taken from `model`'s detections (ranks LABEL_RANKS). Returns
    root."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    dirs = {d: os.path.join(root, subset, d)
            for d in ("images", "labels", "calibs")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i, (h, w) in enumerate(FRAME_SIZES):
        name = f"{i:06d}"
        image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        Image.fromarray(image).save(os.path.join(dirs["images"],
                                                 name + ".png"))
        with open(os.path.join(dirs["calibs"], name + ".txt"), "w") as f:
            f.write(_calib_text())
        open(os.path.join(dirs["labels"], name + ".txt"), "w").close()
    planes = np.stack([rng.uniform(-0.02, 0.02, n_planes),
                       np.ones(n_planes), rng.uniform(-0.02, 0.02, n_planes),
                       rng.uniform(-2.0, -1.4, n_planes)], axis=1)
    planes[0] = [0.0, 1.0, 0.0, -1.65]
    save_plane_database(os.path.join(root, "road_planes_database.mat"),
                        planes)

    ds = KittiDataset(root, subset)
    # labels from the cv2 canvases, the frames of the CLI comparisons that
    # switch both native loaders off
    loader = KittiLoader(ds, image_min_side=min_side, image_max_side=max_side,
                         use_native_loader=False)
    for item in loader.eval_inputs():
        detect = make_detect_fn(model, item["image"].shape[1:3],
                                device_preprocess=True, device="cpu")
        out = detect(item["image"], item["P_inv"], item["planes"])
        boxes = out.boxes[0].numpy() / item["scale"]
        rows = [_label_row(boxes[r], out.dims[0, r].numpy(),
                           out.orientations[0, r])
                for r in LABEL_RANKS]
        with open(ds.label_paths[item["index"]], "w") as f:
            f.write("\n".join(rows) + "\n")
    return root

