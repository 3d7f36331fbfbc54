"""End-to-end inference: image -> 3D detections (port of
ground_plane_polling_tpu/inference.py).

  uint8 BGR canvas -> cast + mean subtraction on the device -> backbone ->
  FPN -> heads -> fused filter (pre-NMS top-k, sign-aware decode of the
  candidates, greedy NMS, top-k) -> ground-plane polling (the CUDA kernel on
  the card, its twin on the CPU) [-> pose solve].

Outputs mirror the JAX package: boxes, dims, scores, labels, orientations,
keypoints, keyplanes, residuals, padded to `max_detections` with -1, plus
the pose fields when `with_pose`. PyTorch runs eagerly, so there is no
compiled program; `make_detect_fn` fixes the image shape (the anchors) and
the filter settings. Unlike the JAX package there is no plane-count rule:
CUDA tensors always go through the polling kernel.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from .data.frames import resize_uint8, uint8_canvas
from .data.kitti import BGR_MEAN, preprocess_image, resize_scale
from .kernels import polling_cuda
from .models import build_detector, init_detector, load_weights
from .ops import anchors as anchor_ops
from .ops.filtering import filter_detections_fused_batch
from .ops.pose import solve_pose

__all__ = ["DetectionOutput", "make_detect_fn", "place_model",
           "require_device", "GPPDetector"]


class DetectionOutput(NamedTuple):
    boxes: torch.Tensor         # (B, M, 12)
    dims: torch.Tensor          # (B, M, 3)
    scores: torch.Tensor        # (B, M)
    labels: torch.Tensor        # (B, M) int32
    orientations: torch.Tensor  # (B, M) int32
    keypoints: torch.Tensor     # (B, M, 4, 3)
    keyplanes: torch.Tensor     # (B, M, 1, 4)
    residuals: torch.Tensor     # (B, M)
    locations: Optional[torch.Tensor] = None  # (B, M, 3) if with_pose
    angles: Optional[torch.Tensor] = None     # (B, M, 3) if with_pose
    pose_dims: Optional[torch.Tensor] = None  # (B, M, 3) if with_pose


def make_detect_fn(
    model,
    image_shape,
    num_classes: int = 1,
    with_pose: bool = False,
    class_specific: bool = True,
    orientation_specific: bool = False,
    nms: bool = True,
    score_threshold: float = 0.05,
    max_detections: int = 100,
    nms_threshold: float = 0.5,
    pre_nms_top_k: int = 1024,
    fused_decode: bool = True,
    mesh=None,
    shard_spatial: bool = False,
    device_preprocess: bool = False,
    quant_scales=None,
    device=None,
):
    """Build the detect function for one padded image shape.

    Returned signature: detect(images (B, H, W, 3), P_inv (B, 4, 3),
    planes (B, P, 4)) -> DetectionOutput. Images are raw uint8 BGR when
    `device_preprocess`, else mean-subtracted float. `model` maps NCHW
    images to the head outputs (models.GPPRetinaNet); `device` defaults to
    the device of its parameters, and inputs are moved there.
    """
    if not fused_decode:
        raise NotImplementedError(
            "fused_decode=False: the unfused decode is not ported "
            "(ROADMAP A4 drops it)")
    if mesh is not None or shard_spatial:
        raise NotImplementedError(
            "mesh / shard_spatial: multi-GPU inference is ROADMAP A15")
    if quant_scales is not None:
        raise NotImplementedError("quant_scales: int8 inference is ROADMAP A16")
    if device is None:
        device = next(model.parameters()).device
    device = torch.device(device)
    image_shape = (int(image_shape[0]), int(image_shape[1]))
    anchors = torch.as_tensor(anchor_ops.anchors_for_shape(image_shape),
                              device=device)
    mean = torch.as_tensor(BGR_MEAN, device=device)
    filter_kwargs = dict(
        num_classes=num_classes,
        class_specific=class_specific,
        orientation_specific=orientation_specific,
        nms=nms,
        score_threshold=score_threshold,
        max_detections=max_detections,
        nms_threshold=nms_threshold,
        pre_nms_top_k=pre_nms_top_k,
    )

    @torch.inference_mode()
    def detect(images, P_inv, planes) -> DetectionOutput:
        images = torch.as_tensor(images, device=device)
        P_inv = torch.as_tensor(P_inv, dtype=torch.float32, device=device)
        planes = torch.as_tensor(planes, dtype=torch.float32, device=device)
        if tuple(images.shape[1:3]) != image_shape:
            raise ValueError(f"images {tuple(images.shape)} do not match the "
                             f"detect function's shape {image_shape}")
        if device_preprocess:
            images = images.to(torch.float32) - mean
        raw = model(images.permute(0, 3, 1, 2))
        det = filter_detections_fused_batch(
            anchors, raw["regression"], raw["regression_dim"],
            raw["classification"], **filter_kwargs)
        poll = polling_cuda.fit_road_planes(
            det.boxes, det.dims, det.orientations, P_inv, planes)
        out = DetectionOutput(
            boxes=det.boxes, dims=det.dims, scores=det.scores,
            labels=det.labels, orientations=det.orientations,
            keypoints=poll.keypoints, keyplanes=poll.keyplanes,
            residuals=poll.residuals,
        )
        if with_pose:
            pose = solve_pose(poll.keypoints, det.orientations.clamp(min=0),
                              det.dims)
            out = out._replace(locations=pose.locations, angles=pose.angles,
                               pose_dims=pose.dimensions)
        return out

    return detect


def require_device(device) -> torch.device:
    """torch.device(device), refusing a CUDA device that is not there: a
    run that asks for the card never carries on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for, but CUDA is not "
                           "available")
    return device


def place_model(model, device, dtype=torch.float32):
    """Move a detector to `device` in `dtype` for inference; on CUDA it runs
    channels-last (NHWC in memory), which cuDNN prefers."""
    device = torch.device(device)
    model = model.to(device=device, dtype=dtype).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


class GPPDetector:
    """Convenience wrapper: model + weights + detect functions cached per
    (image shape, with_pose, uint8 input)."""

    def __init__(self, backbone: str = "resnet50", num_classes: int = 1,
                 dtype: torch.dtype = torch.float32, fuse_towers: bool = False,
                 device_preprocess: bool = True, device="cuda",
                 **filter_kwargs):
        # the card unless the caller asks for the CPU; no card raises
        self.device = require_device(device)
        self.model = place_model(
            build_detector(backbone, num_classes, fuse_cls_dim=fuse_towers),
            self.device, dtype)
        self.backbone = backbone
        self.num_classes = num_classes
        self.device_preprocess = device_preprocess
        self.filter_kwargs = filter_kwargs
        self.ready = False
        self._fns = {}

    def init(self, seed: int):
        """Seeded random weights (models.init_detector)."""
        init_detector(self.model, seed)
        self.ready = True
        return self.model

    def load(self, weights_path: str):
        """Load the JAX package's exported `.npz` weights, strictly; with
        fused towers, split weights are converted on load."""
        if weights_path.endswith((".h5", ".hdf5")):
            raise NotImplementedError(
                ".h5 weights: the Keras import is ROADMAP A10b; convert them "
                "to .npz with the JAX package's convert-model")
        load_weights(self.model, weights_path)
        self.ready = True
        return self.model

    def __call__(self, images, P_inv, planes, with_pose: bool = False):
        if not self.ready:
            raise RuntimeError("call .init() or .load() first")
        images = torch.as_tensor(images, device=self.device)
        device_pre = self.device_preprocess and images.dtype == torch.uint8
        key = (tuple(images.shape[1:3]), bool(with_pose), device_pre)
        if key not in self._fns:
            self._fns[key] = make_detect_fn(
                self.model, images.shape[1:3], num_classes=self.num_classes,
                with_pose=with_pose, device_preprocess=device_pre,
                device=self.device, **self.filter_kwargs)
        return self._fns[key](images, P_inv, planes)

    def detect_image(self, image_bgr, P, planes, with_pose: bool = True,
                     min_side: int = 800, max_side: int = 1333,
                     pad_multiple: int = 32, score_threshold: float = 0.05):
        """Detect on one raw BGR image with a (3, 4) calibration: resize,
        calibration rescale, pinv, padding, and boxes mapped back to raw
        pixels. Returns numpy arrays of the detections above
        `score_threshold`."""
        compiled_thr = self.filter_kwargs.get("score_threshold", 0.05)
        if score_threshold < compiled_thr:
            warnings.warn(
                f"detect_image score_threshold={score_threshold} is below "
                f"the detector's filter threshold ({compiled_thr}); "
                "candidates in between were already dropped — build the "
                f"detector with score_threshold={score_threshold}",
                stacklevel=2)
        image_bgr = np.asarray(image_bgr)
        scale = resize_scale(image_bgr.shape[:2], min_side, max_side)
        resized = resize_uint8(image_bgr, scale)
        ph = int(np.ceil(resized.shape[0] / pad_multiple)) * pad_multiple
        pw = int(np.ceil(resized.shape[1] / pad_multiple)) * pad_multiple
        if self.device_preprocess:
            net_in = uint8_canvas(resized, ph, pw)[None]
        else:
            padded = np.zeros((ph, pw, 3), np.float32)
            padded[: resized.shape[0], : resized.shape[1]] = resized
            net_in = preprocess_image(padded)[None]
        P_inv = np.linalg.pinv(np.diag([scale, scale, 1.0]) @ np.asarray(P))
        out = self(net_in, P_inv[None].astype(np.float32),
                   np.asarray(planes, np.float32)[None], with_pose=with_pose)
        out = {k: v[0].cpu().numpy() for k, v in out._asdict().items()
               if v is not None}
        keep = out["scores"] > score_threshold
        result = {
            "boxes": out["boxes"][keep] / scale,
            "dims": out["dims"][keep],
            "scores": out["scores"][keep],
            "labels": out["labels"][keep],
            "orientations": out["orientations"][keep],
            "keypoints3d": out["keypoints"][keep],
            "keyplanes": out["keyplanes"][keep],
            "residuals": out["residuals"][keep],
        }
        if with_pose:
            result["locations"] = out["locations"][keep]
            result["angles"] = out["angles"][keep]
            result["pose_dims"] = out["pose_dims"][keep]
        return result
