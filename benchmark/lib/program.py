"""The system under test: the port's detect call, built through its public
API from the benchmark's weights; and the controls that stand in its
place when the check is shown to fail.

`build(cfg, weights, pool, device)` builds the port's detector on
the meta device, places it (bf16, channels-last on a card), loads the
weights strictly (through the port's own conversion where the towers are
fused), runs the port's own int8 calibration where the configuration asks
for it (absmax over the pool's first frames, as `--int8 8` does), and
returns `inference.make_detect_fn` with uint8 frames preprocessed on the
device: a `CapturedDetect` on a card. The configuration's `build` object
sets the program's options that leave its outputs' meaning alone
(`BUILD_OPTIONS`); any other key is refused, since the reference would
not follow it.

Controls (`CONTROLS`), each computed in the precision just below the one
the configuration states, for the part it names:

  * program-int8: the port's own int8 path in place of its bf16 one;
  * reference-int4: the plain reference with every conv at 4 bits in
    place of the int8 program;
  * stage-bf16: the program's detections with polling and the pose solve
    done by the plain reference in bfloat16 instead of float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..reference import model as ref_model
from ..reference import pipeline as ref

__all__ = ["build", "BUILD_OPTIONS", "CONTROLS", "Outputs", "release"]

# option -> the function of the port that takes it
BUILD_OPTIONS = {"pack_levels": "build_detector",
                 "fuse_cls_dim": "build_detector",
                 "fused_decode": "make_detect_fn"}

class Outputs(NamedTuple):
    """The detect call's outputs, fields as the port's DetectionOutput."""
    boxes: torch.Tensor
    dims: torch.Tensor
    scores: torch.Tensor
    labels: torch.Tensor
    orientations: torch.Tensor
    keypoints: torch.Tensor
    keyplanes: torch.Tensor
    residuals: torch.Tensor
    locations: Optional[torch.Tensor] = None
    angles: Optional[torch.Tensor] = None
    pose_dims: Optional[torch.Tensor] = None


def build(cfg, weights, pool, device, int8: Optional[bool] = None):
    """The port's detect function for `cfg` on `device` (int8 when the
    configuration or `int8` says so)."""
    from ground_plane_polling_tpu_torch.inference import (make_detect_fn,
                                                          place_model)
    from ground_plane_polling_tpu_torch.models import build_detector
    from ground_plane_polling_tpu_torch.models.quantize import (
        collect_scales_uint8)
    from ground_plane_polling_tpu_torch.models.weights import (
        fuse_detector_params)

    options = cfg.get("build", {})
    unknown = sorted(set(options) - set(BUILD_OPTIONS))
    if unknown:
        raise ValueError(f"build options {unknown} are not ones the "
                         f"benchmark judges: {sorted(BUILD_OPTIONS)}")
    where = {fn: {k: v for k, v in options.items() if BUILD_OPTIONS[k] == fn}
             for fn in set(BUILD_OPTIONS.values())}
    device = torch.device(device)
    with torch.device("meta"):
        model = build_detector(cfg["backbone"], cfg["num_classes"],
                               cfg["feature_size"],
                               **where["build_detector"])
    model = place_model(model.to_empty(device=device), device,
                        getattr(torch, cfg["dtype"]))
    if model.fuse_cls_dim:
        weights = fuse_detector_params(weights)
    model.load_state_dict(weights, strict=True)
    scales = None
    if cfg["int8"] if int8 is None else int8:
        n = cfg["calibration_frames"]
        scales = collect_scales_uint8(model, [pool.frames[i]
                                              for i in range(n)])
    return make_detect_fn(
        model, cfg["canvas"], num_classes=cfg["num_classes"],
        with_pose=cfg["with_pose"], score_threshold=cfg["score_threshold"],
        max_detections=cfg["max_detections"],
        nms_threshold=cfg["nms_threshold"],
        pre_nms_top_k=cfg["pre_nms_top_k"], device_preprocess=True,
        quant_scales=scales, device=device, **where["make_detect_fn"])


def release(detect):
    """Free what a detect function holds on the card (its graphs)."""
    free = getattr(detect, "release", None)
    if free is not None:
        free()


def _stack(frames_out) -> Outputs:
    return Outputs(**{k: torch.stack([f[k] for f in frames_out])
                      for k in frames_out[0]})


def reference_int4(cfg, weights, pool, device):
    """The plain reference with every conv at 4 bits (scales calibrated on
    the pool's first frames), in the program's place."""
    w = {k: v.float() for k, v in weights.items()}
    device = torch.device(device)
    calib = [ref.network_input(pool.frames[i:i + 1], device)
             for i in range(cfg["calibration_frames"])]
    conv = ref_model.quantized_conv(ref_model.calibrate(w, calib, bits=4),
                                    bits=4)
    anchors = torch.from_numpy(ref.anchors_for_shape(cfg["canvas"])).to(
        device)

    @torch.inference_mode()
    def detect(images, P_inv, planes):
        raw = ref_model.forward(w, ref.network_input(images, device),
                                conv=conv)
        return _stack([ref.detect({k: v[i] for k, v in raw.items()},
                                  anchors, P_inv[i].to(device),
                                  planes[i].to(device), cfg)
                       for i in range(len(images))])

    return detect


def stage_bf16(cfg, weights, pool, device):
    """The program, with polling and the pose solve of its detections done
    by the reference in bfloat16."""
    program = build(cfg, weights, pool, device)

    @torch.inference_mode()
    def detect(images, P_inv, planes):
        out = program(images, P_inv, planes)
        fields = out._asdict()
        for i in range(len(images)):
            kp, kpl, res = ref.fit_road_planes(
                out.boxes[i], out.dims[i], out.orientations[i],
                P_inv[i].to(device), planes[i], torch.bfloat16)
            loc, ang, pdims = ref.solve_pose(
                kp, out.orientations[i].clamp(min=0), out.dims[i],
                torch.bfloat16)
            for k, v in (("keypoints", kp), ("keyplanes", kpl),
                         ("residuals", res), ("locations", loc),
                         ("angles", ang), ("pose_dims", pdims)):
                fields[k][i] = v
        return Outputs(**fields)

    detect.release = getattr(program, "release", None) or (lambda: None)
    return detect


def program_int8(cfg, weights, pool, device):
    """The port's own int8 path in place of its bf16 path."""
    return build(cfg, weights, pool, device, int8=True)


CONTROLS = {"program-int8": program_int8, "reference-int4": reference_int4,
            "stage-bf16": stage_bf16}
