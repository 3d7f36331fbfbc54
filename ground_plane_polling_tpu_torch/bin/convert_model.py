"""Convert exported weights or a training checkpoint into an inference
artifact (port of ground_plane_polling_tpu/bin/convert_model.py for the
.npz route): the flat `params/...` + `frozen/...` arrays of an .npz, or the
model of a `step_*.pt` that bin/train wrote, are written to a new .npz,
with a JSON sidecar that describes them (backbone, num_classes and the
filter flags that run_network, serve and evaluate read).

  python -m ground_plane_polling_tpu_torch.bin.convert_model \
      snapshots/step_00001234.pt model_out.npz --no-nms

num_classes comes from the flag, else from the classification head width,
else from the input's sidecar; a flag that contradicts the weights raises.
Unset filter flags keep the input sidecar's values.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv):
    p = argparse.ArgumentParser(description="Export inference weights.")
    p.add_argument("checkpoint", help="an exported .npz weight file or a "
                                      "step_*.pt training checkpoint")
    p.add_argument("model_out", help="output .npz (+ .json sidecar)")
    p.add_argument("--backbone", default=None,
                   help="default: the input's .json sidecar if present, "
                        "else resnet50")
    p.add_argument("--num-classes", type=int, default=None,
                   help="default: inferred from the classification head "
                        "width of the loaded weights")
    # filter flags default to None so an input sidecar's serving config
    # survives reconversion unless a flag is given
    p.add_argument("--nms", dest="nms", action="store_true", default=None)
    p.add_argument("--no-nms", dest="nms", action="store_false")
    p.add_argument("--class-specific-filter", action="store_true",
                   default=None)
    p.add_argument("--no-class-specific-filter", dest="class_specific_filter",
                   action="store_false")
    p.add_argument("--orientation-specific-filter", action="store_true",
                   default=None)
    p.add_argument("--no-orientation-specific-filter",
                   dest="orientation_specific_filter", action="store_false")
    return p.parse_args(argv)


def _inferred_num_classes(flat):
    """(num_classes from the head widths or None, cls out channels,
    anchors): cls out = A * 8 * C, box out = A * 12."""
    try:
        box_out_ch = flat["params/regression/box_out/bias"].shape[0]
        cls_out_ch = flat["params/classification/cls_out/bias"].shape[0]
    except KeyError as e:
        raise ValueError(f"not a split detector export: no {e}") from None
    num_anchors = max(box_out_ch // 12, 1)
    inferred = (cls_out_ch // (num_anchors * 8)
                if cls_out_ch % (num_anchors * 8) == 0 else None)
    return inferred, cls_out_ch, num_anchors


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    for path in (args.checkpoint, args.model_out):
        if path.endswith((".h5", ".hdf5")):
            raise NotImplementedError(
                f"{path}: Keras .h5 interop is ROADMAP A10b")
    if not args.checkpoint.endswith((".npz", ".pt")):
        raise NotImplementedError(
            f"{args.checkpoint}: JAX orbax checkpoints do not load here; "
            "the JAX package's convert_model "
            "(ground_plane_polling_tpu/bin/convert_model.py) turns one into "
            f"an .npz: convert_model {args.checkpoint} out.npz; or give an "
            "exported .npz or a step_*.pt of bin/train")

    import numpy as np

    from ..models.weights import load_npz
    from ..training.checkpoint import checkpoint_params

    in_cfg = {}
    if os.path.exists(args.checkpoint + ".json"):
        with open(args.checkpoint + ".json") as f:
            in_cfg = json.load(f)
    backbone = args.backbone or in_cfg.get("backbone", "resnet50")
    flat = (checkpoint_params(args.checkpoint)
            if args.checkpoint.endswith(".pt") else load_npz(args.checkpoint))

    inferred, cls_out_ch, num_anchors = _inferred_num_classes(flat)
    # precedence: flag > weights > input sidecar (a stale sidecar must not
    # outrank the weights)
    num_classes = args.num_classes or inferred or \
        in_cfg.get("num_classes") or 1
    if inferred is not None and num_classes != inferred:
        raise ValueError(
            f"--num-classes {num_classes} contradicts the loaded weights "
            f"(classification head width {cls_out_ch} -> {inferred} "
            f"classes at {num_anchors} anchors)")

    np.savez(args.model_out, **flat)

    def _flag(name, value, default):
        # flag > input sidecar > default
        if value is not None:
            return value
        return bool(in_cfg.get(name, default))

    config = {
        "backbone": backbone,
        "num_classes": num_classes,
        "nms": _flag("nms", args.nms, True),
        "class_specific_filter": _flag(
            "class_specific_filter", args.class_specific_filter, True),
        "orientation_specific_filter": _flag(
            "orientation_specific_filter",
            args.orientation_specific_filter, False),
    }
    with open(args.model_out + ".json", "w") as f:
        json.dump(config, f, indent=2)
    print(f"wrote {args.model_out} (+ .json config)")


if __name__ == "__main__":
    main()
