"""End-to-end inference: image -> 3D detections (port of
ground_plane_polling_tpu/inference.py).

  uint8 BGR canvas -> cast + mean subtraction on the device -> backbone ->
  FPN -> heads (every conv int8 with `quant_scales`, models/quantize.py;
  with `shard_spatial`, each rank's columns of the image,
  parallel/spatial.py) -> filter: fused (pre-NMS top-k, sign-aware decode
  of the candidates, greedy NMS, top-k) or, with `fused_decode=False`,
  the decode of every anchor and the same selection -> ground-plane
  polling (the CUDA kernel on the card, its twin on the CPU) [-> pose
  solve].

Outputs mirror the JAX package: boxes, dims, scores, labels, orientations,
keypoints, keyplanes, residuals, padded to `max_detections` with -1, plus
the pose fields when `with_pose`. `make_detect_fn` fixes the image shape
(the anchors) and the filter settings. On a card it returns a
`CapturedDetect`: one CUDA graph of the whole call per input signature,
as the JAX package's jit compiles one executable per input shape, and no
host sync between the input copy and the outputs (greedy NMS is a kernel,
the pose solve has no SVD). With a mesh that holds where
`parallel.mesh.capturable` says so (an NCCL group, or none): the outputs'
all-gather, or `shard_spatial`'s exchanges, are captured inside the
graph. On the CPU, and on a gloo mesh, the call runs eagerly. Unlike the
JAX package there is no plane-count rule: CUDA tensors always go through
the polling kernel.

Tracing (utils/profiling.py): while a profiler records, a call is the
host range `gpp.detect`, and its stages `gpp.trunk`, `gpp.filter`,
`gpp.polling` and `gpp.pose` wherever `run` executes Python (an eager
call, a capture). With GPP_TRACE=1 the stages are also stamped on the
card, inside the graph: `profiling.stage_ms` reads them back.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from .data.frames import resize_uint8, uint8_canvas
from .data.kitti import BGR_MEAN, preprocess_image, resize_scale
from .kernels import (int8_conv_cuda, int8_depthwise_cuda, nms_cuda,
                      polling_cuda)
from .models import build_detector, init_detector, load_state, read_weights
from .models.quantize import collect_scales, quantize_apply
from .ops import anchors as anchor_ops
from .ops import box_coder
from .ops.filtering import (filter_detections_batch,
                            filter_detections_fused_batch)
from .ops.pose import solve_pose
from .parallel.mesh import capturable, check_mesh
from .parallel.spatial import SpatialModel
from .utils.profiling import span, stage_stamps

__all__ = ["CapturedDetect", "DetectionOutput", "LAUNCH_COUNTERS",
           "decode_predictions", "make_detect_fn", "place_model",
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


def decode_predictions(raw, anchors, num_classes: int):
    """Raw head outputs -> decoded boxes (B, N, 12) and dims (B, N, 3C) of
    every anchor. The xm/xt side comes from the argmax of the whole 8C
    classification row (first index on ties): a score in the first 4C
    columns means left of the anchor centre."""
    cls = raw["classification"]
    if cls.shape[-1] != 8 * num_classes:
        raise ValueError(
            f"classification width {cls.shape[-1]} != 8*num_classes "
            f"({8 * num_classes}) — wrong num_classes for this model")
    half = cls.shape[-1] // 2
    sign = torch.where(cls.argmax(dim=-1) < half, -1.0, 1.0).to(
        raw["regression"].dtype)
    boxes = box_coder.decode_boxes(anchors[None], raw["regression"], sign)
    dims = box_coder.decode_dims(raw["regression_dim"])
    return boxes, dims


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
    `quant_scales`: per-conv-site int8 activation scales
    (models.quantize.collect_scales); every conv then runs int8.

    `mesh` (parallel.data_parallel_mesh): every rank passes the same full
    batch, runs its rows on its device and all-gathers the outputs, so
    every rank returns the whole batch's outputs. The batch must divide by
    the mesh's size.

    `fused_decode=False` decodes every anchor (`decode_predictions`), then
    filters (ops.filtering.filter_detections_batch): the reference's
    filter layer, literally; the default decodes only the pre-NMS
    candidates, with the same outputs.

    On a CUDA device the result is a CapturedDetect (one CUDA graph per
    input signature, replayed; with a mesh, where `capturable` says so: an
    NCCL group or none, the collectives inside the graph); `detect.eager`
    is the same call run eagerly, for comparisons. On the CPU, and on a
    gloo mesh, `detect` runs eagerly and `detect.eager` is `detect`.

    `shard_spatial` (requires `mesh`): the image WIDTH is split over the
    ranks instead of the batch (parallel/spatial.py). Every rank passes
    the same full batch, of any size; each computes its columns of every
    map through the backbone, the FPN and the head towers, with the
    columns that its convs, pools and upsampling read across taken from
    their owners; the head output maps are gathered whole, and the
    filter, polling and pose run on every rank, which returns the whole
    outputs. A model built with `pack_levels` runs its heads per level
    here (the same outputs).
    """
    if shard_spatial and mesh is None:
        raise ValueError("shard_spatial requires a mesh")
    check_mesh(mesh)
    net = model if quant_scales is None else quantize_apply(model,
                                                            quant_scales)
    if device is None:
        device = (next(model.parameters()).device if mesh is None
                  else mesh.device)
    device = torch.device(device)
    image_shape = (int(image_shape[0]), int(image_shape[1]))
    columns = slice(None)
    if shard_spatial:
        net = SpatialModel(net, mesh, image_shape)
        columns = net.columns()
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

    def select(images, P_inv, planes):
        """This rank's part of the full inputs (views): its rows, or under
        shard_spatial its columns of the images."""
        if tuple(images.shape[1:3]) != image_shape:
            raise ValueError(f"images {tuple(images.shape)} do not match the "
                             f"detect function's shape {image_shape}")
        if mesh is not None and not shard_spatial:
            rows = mesh.rows(len(images))
            images, P_inv, planes = images[rows], P_inv[rows], planes[rows]
        return images[:, :, columns], P_inv, planes

    def run(images, P_inv, planes) -> DetectionOutput:
        """The call on this rank's part of the inputs, on the device: four
        stages, each a host span (a graph's replay runs no Python, so only
        its capture shows them) and, with GPP_TRACE=1 on a card, between
        device stamps (utils/profiling.py)."""
        stamp = stage_stamps(device)
        stamp(0)
        with span("trunk"):
            if device_preprocess:
                images = images.to(torch.float32) - mean
            raw = net(images.permute(0, 3, 1, 2))
        stamp(1)
        with span("filter"):
            if fused_decode:
                det = filter_detections_fused_batch(
                    anchors, raw["regression"], raw["regression_dim"],
                    raw["classification"], **filter_kwargs)
            else:
                boxes, dims = decode_predictions(raw, anchors, num_classes)
                det = filter_detections_batch(
                    boxes, dims, raw["classification"], **filter_kwargs)
        stamp(2)
        with span("polling"):
            poll = polling_cuda.fit_road_planes(
                det.boxes, det.dims, det.orientations, P_inv, planes)
        stamp(3)
        out = DetectionOutput(
            boxes=det.boxes, dims=det.dims, scores=det.scores,
            labels=det.labels, orientations=det.orientations,
            keypoints=poll.keypoints, keyplanes=poll.keyplanes,
            residuals=poll.residuals,
        )
        with span("pose"):
            if with_pose:
                pose = solve_pose(poll.keypoints,
                                  det.orientations.clamp(min=0), det.dims)
                out = out._replace(locations=pose.locations,
                                   angles=pose.angles,
                                   pose_dims=pose.dimensions)
            if mesh is not None and not shard_spatial:
                out = _gather(out, mesh)
        stamp(4)
        return out

    @torch.inference_mode()
    def detect(images, P_inv, planes) -> DetectionOutput:
        with span("detect"):
            images, P_inv, planes = select(images, P_inv, planes)
            # this rank's part alone is uploaded
            return run(torch.as_tensor(images, device=device),
                       torch.as_tensor(P_inv, dtype=torch.float32,
                                       device=device),
                       torch.as_tensor(planes, dtype=torch.float32,
                                       device=device))

    # the SpatialModel of shard_spatial (its last call's conv windows)
    detect.spatial = net if shard_spatial else None
    detect.eager = detect
    if not capturable(mesh, device):
        return detect
    return CapturedDetect(detect, run, select, device)


# the kernels' launch counters: (module, name) of each
LAUNCH_COUNTERS = ((polling_cuda, "LAUNCHES"), (nms_cuda, "NMS_LAUNCHES"),
                   (int8_conv_cuda, "QUANTIZE_LAUNCHES"),
                   (int8_conv_cuda, "CONV_LAUNCHES"),
                   (int8_depthwise_cuda, "DEPTHWISE_LAUNCHES"))


def _launch_counts():
    return [getattr(m, name) for m, name in LAUNCH_COUNTERS]


def _set_launches(counts):
    for (m, name), n in zip(LAUNCH_COUNTERS, counts):
        setattr(m, name, n)


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: tuple             # static (images, P_inv, planes)
    out: DetectionOutput      # static outputs, rewritten by each replay
    launches: list            # kernel launches of one replay, per counter


class CapturedDetect:
    """A detect call on a card as captured CUDA graphs, one per input
    signature (the shapes of images, P_inv and planes, and the images'
    dtype; a new batch size or plane count is a new signature, as under
    JAX's jit).

    `select` takes this rank's part of the full inputs (all of them
    without a mesh; its rows, or under shard_spatial its columns of the
    images), and `run` runs the call on that part on the device. The first
    call of a signature runs `run` once on the stream it then captures on,
    which builds the nvcc libraries, fills the kernels' plans and cuDNN's
    choices, allocates the per-stream workspaces of the polling and int8
    kernels there, so that the capture allocates none, and starts NCCL's
    communicator; then it captures `run` on static input buffers, which
    hold this rank's part only. All graphs of one CapturedDetect share one
    memory pool, and replay on the caller's current stream. A capture that
    fails raises: an operation that syncs the host (`.item()`, a copy to
    the host) cannot be captured, and the call never carries on eagerly.

    With a mesh, the outputs' all-gather (data parallel) or the width
    split's edge-strip and slab all-reduces (shard_spatial) are inside the
    graph. The signature is the full inputs', which every rank sees alike,
    so every rank captures the same collectives in the same order and
    replays them in step. On more than one rank NCCL's communicator waits,
    as it is destroyed, for every graph that holds its collectives: end the
    group with `parallel.shutdown(detect)`, which calls `release()` first.

    Each call copies its part of the inputs into the signature's static
    buffers, replays, and returns copies of the outputs made on the stream
    after the replay, so a result stays valid while later calls run. The
    kernels' launch counters (LAUNCH_COUNTERS) count a call's launches as
    the eager call does: the first call's warm-up and capture are set-up
    and are taken back, and every replay adds the launches it replays.

    The graphs read the model's parameters and buffers where they lay at
    the capture: updates in place are seen, tensors that replace them are
    not, and int8 weights are quantized at the capture. `spatial` is the
    eager call's (under shard_spatial, its last Python forward: the
    capture's conv windows).

    While a profiler records, a call is the range `gpp.detect`, holding
    `gpp.detect.inputs` (the inputs, their signature and this rank's
    part), then `gpp.detect.capture` (a signature's first call: warm-up
    and capture) or `gpp.detect.copy_in`, then `gpp.detect.replay` and
    `gpp.detect.copy_out` (the output copies)."""

    def __init__(self, eager, run, select, device):
        self.eager = eager
        self.spatial = eager.spatial
        self._run = run
        self._select = select
        self.device = device
        self.graphs = {}
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.Stream(device)

    def _capture(self, inputs) -> _Graph:
        static = tuple(torch.empty(x.shape, dtype=x.dtype,
                                   device=self.device) for x in inputs)
        for s, x in zip(static, inputs):
            s.copy_(x)
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        before = _launch_counts()
        try:
            with torch.cuda.stream(self._stream):
                self._run(*static)  # warm-up: builds, plans, workspaces
            warm = _launch_counts()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream,
                                  capture_error_mode="thread_local"):
                out = self._run(*static)
            captured = [a - b for a, b in zip(_launch_counts(), warm)]
        finally:
            _set_launches(before)  # set-up, not a call: the replay counts
        caller.wait_stream(self._stream)
        return _Graph(graph, static, out, captured)

    def release(self):
        """Wait for the card, then free every graph (and with them the
        collectives they hold); a later call captures anew."""
        if self.graphs:
            torch.cuda.synchronize(self.device)
            for g in self.graphs.values():
                g.graph.reset()
            self.graphs.clear()

    def __call__(self, images, P_inv, planes) -> DetectionOutput:
        with span("detect"), torch.inference_mode():
            with span("detect.inputs"):
                full = (torch.as_tensor(images),
                        torch.as_tensor(P_inv).float(),
                        torch.as_tensor(planes).float())
                key = tuple((tuple(x.shape), x.dtype) for x in full)
                inputs = self._select(*full)
            with torch.cuda.device(self.device):
                g = self.graphs.get(key)
                if g is None:
                    with span("detect.capture"):
                        g = self.graphs[key] = self._capture(inputs)
                else:
                    with span("detect.copy_in"):
                        for s, x in zip(g.inputs, inputs):
                            s.copy_(x)
                with span("detect.replay"):
                    g.graph.replay()
                    _set_launches([n + k for n, k in zip(_launch_counts(),
                                                         g.launches)])
                with span("detect.copy_out"):
                    return DetectionOutput(*(None if t is None else t.clone()
                                             for t in g.out))


def _gather(out: DetectionOutput, mesh) -> DetectionOutput:
    """Every rank's rows of each output, in rank order, on every rank: the
    fields go as one float32 block (int32 labels and orientations, small
    integers, are exact in float32) through one collective."""
    fields = {k: v for k, v in out._asdict().items() if v is not None}
    b = out.boxes.shape[0]
    block = torch.cat([v.reshape(b, -1).float() for v in fields.values()],
                      dim=1)
    block = mesh.gather_rows(block)
    gathered, at = {}, 0
    for k, v in fields.items():
        width = v[0].numel()
        gathered[k] = block[:, at:at + width].reshape(
            -1, *v.shape[1:]).to(v.dtype)
        at += width
    return out._replace(**gathered)


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
        self._quant_scales = None

    @property
    def quant_scales(self):
        """Per-conv-site int8 activation scales (None: the float path)."""
        return self._quant_scales

    @quant_scales.setter
    def quant_scales(self, value):
        # the detect fns hold the scales they were made with: drop them
        self._quant_scales = value
        self._fns.clear()

    def quantize(self, calib_images, percentile: float = 100.0):
        """Calibrate and switch to int8 convs (models/quantize.py).

        calib_images: preprocessed float32 (B, H, W, 3) network inputs (BGR,
        BGR mean subtracted), as the network sees them; shapes may differ
        between entries. Setting `.quant_scales = None` goes back to
        float. Returns the scales."""
        if not self.ready:
            raise RuntimeError("call .init() or .load() first")
        batches = [torch.as_tensor(np.asarray(im, np.float32),
                                   device=self.device).permute(0, 3, 1, 2)
                   for im in calib_images]
        self.quant_scales = collect_scales(self.model, batches,
                                           percentile=percentile)
        return self.quant_scales

    def init(self, seed: int):
        """Seeded random weights (models.init_detector)."""
        init_detector(self.model, seed)
        self.ready = True
        return self.model

    def load(self, weights_path: str):
        """Load the JAX package's exported `.npz` weights or a reference
        Keras `.h5` checkpoint (models/h5_import.py), strictly; with fused
        towers, split weights are converted on load. int8 scales are kept;
        the int8 weights follow the new weights."""
        flat, _ = read_weights(weights_path, self.backbone, self.num_classes)
        load_state(self.model, flat, weights_path)
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
                quant_scales=self.quant_scales, device=self.device,
                **self.filter_kwargs)
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
