"""Post-training int8 quantization (PTQ) of the detector (port of
ground_plane_polling_tpu/models/quantize.py).

Every conv of the forward can run as

    quantize(x; s_x)  ->  int8 conv  ->  y_int32 * (s_x * s_w[c])  (+ bias)

on the CUDA kernels of kernels/int8_conv_cuda.py, a depthwise conv
(MobileNet's, groups = channels) on the one kernel of
kernels/int8_depthwise_cuda.py that does all three steps from the float x
(their plain versions on the CPU), with a per-tensor activation scale
`s_x` per conv SITE and symmetric per-output-channel weight scales `s_w`. Everything else (frozen
BN, ReLU, residual adds, the detection pipeline) runs as before in the
model's dtype.

A site is one conv call, numbered by call order from 0 in each forward, as
the JAX package numbers the conv equations of its jaxpr: a head conv shared
across the five pyramid levels is five sites. ResNet-50 with split heads
has 136 sites, with fused towers 111. The model's forward calls its convs
in the JAX package's order (models/retinanet.py), so scales carry between
the packages as a numpy (S,) vector. `_intercept` routes each nn.Conv2d
call of a forward through a callback, by giving every conv of the model an
instance `forward` for the duration of the call; a conv's input is what
its float forward would take (SameConv2d's unpadded map, since SAME
padding is part of that conv, as in the JAX package).

Calibration (`make_calibration_fn`, `collect_scales`) takes each site's
input absmax, or a percentile of |x|, keeps the stats on the device and
reads them back once per batch; batches aggregate by max (absmax) or mean
(percentile), then s_x = max(agg, 1e-8) / 127.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from ..data.kitti import BGR_MEAN
from ..kernels import int8_conv_cuda, int8_depthwise_cuda
from ..ops.int8_conv import SCALE_EPS, quantize_weight
from .fpn import SameConv2d
from .resnet import same_padding

__all__ = ["count_convs", "make_calibration_fn", "collect_scales",
           "collect_scales_uint8", "quantize_apply", "percentile_of",
           "QuantizedModel"]

def conv_padding(conv: nn.Conv2d, x: torch.Tensor):
    """((top, bottom), (left, right)) zero padding of `conv` on input `x`.
    A site is a plain conv or a depthwise one (groups = in = out
    channels)."""
    depthwise = conv.groups == conv.in_channels == conv.out_channels
    if ((conv.groups != 1 and not depthwise)
            or tuple(conv.dilation) != (1, 1)
            or conv.padding_mode != "zeros" or isinstance(conv.padding, str)
            or conv.stride[0] != conv.stride[1]):
        raise ValueError(f"int8 conv sites take plain or depthwise convs: "
                         f"{conv}")
    if isinstance(conv, SameConv2d):
        return same_padding(x.shape[2], x.shape[3], conv.kernel_size[0],
                            conv.stride[0])
    ph, pw = conv.padding
    return (ph, ph), (pw, pw)


def _float_conv(site, conv, x):
    return type(conv).forward(conv, x)


@contextlib.contextmanager
def _intercept(model: nn.Module, conv_fn: Callable):
    """Within the context, each nn.Conv2d call in `model`'s forward returns
    conv_fn(site, conv, x); yields a one-item list that counts the sites
    called so far."""
    convs = [m for m in model.modules() if isinstance(m, nn.Conv2d)]
    counter = [0]

    def route(conv):
        def forward(x):
            site = counter[0]
            counter[0] += 1
            return conv_fn(site, conv, x)
        return forward

    for conv in convs:
        conv.__dict__["forward"] = route(conv)
    try:
        yield counter
    finally:
        for conv in convs:
            conv.__dict__.pop("forward", None)


@torch.no_grad()
def count_convs(model: nn.Module, *args) -> int:
    """Number of conv sites of model(*args) (works on the meta device)."""
    with _intercept(model, _float_conv) as counter:
        model(*args)
    return counter[0]


def percentile_of(values: torch.Tensor, q: float) -> torch.Tensor:
    """The q-th percentile of all of `values`, linearly interpolated
    between the two order statistics around the rank q / 100 (n - 1), as a
    float32 0-dim tensor on their device. The rank and the weights are
    float32, as jnp.percentile computes them (numpy.percentile's float64
    rank lands within one order statistic of it). Sort based: torch.quantile
    refuses more than 2^24 elements, and one layer1 map of ResNet-50 at
    416x1344 holds 8.9 M."""
    flat = values.reshape(-1).float()
    n = flat.numel()
    f32 = np.float32
    rank = f32(q) / f32(100.0) * (f32(n) - f32(1.0))
    low = np.floor(rank)
    high_weight = rank - low
    lo = min(max(int(low), 0), n - 1)
    hi = min(max(int(np.ceil(rank)), 0), n - 1)
    ordered = torch.sort(flat).values
    return (ordered[lo] * float(f32(1.0) - high_weight)
            + ordered[hi] * float(high_weight))


def make_calibration_fn(model: nn.Module,
                        percentile: float = 100.0) -> Callable:
    """calib(images) -> (S,) float32 stats on the model's device: each
    site's input absmax, or the `percentile` of its |x| when below 100
    (outliers otherwise stretch the int8 grid)."""

    def stat(x):
        ax = x.abs().float()
        if percentile >= 100.0:
            return ax.amax()
        return percentile_of(ax, percentile)

    @torch.inference_mode()
    def calib(images):
        stats = []

        def cb(site, conv, x):
            stats.append(stat(x))
            return type(conv).forward(conv, x)

        with _intercept(model, cb):
            model(images)
        return torch.stack(stats)

    return calib


def collect_scales(model: nn.Module, batches: Sequence,
                   percentile: float = 100.0) -> np.ndarray:
    """Per-site int8 activation scales (numpy float32 (S,)) from the
    calibration pass over `batches` (NCHW image tensors as the model takes
    them). Across batches absmax takes the max; a percentile takes the
    mean of the per-batch percentiles (a max would drift back toward the
    absmax as batches grow)."""
    calib = make_calibration_fn(model, percentile)
    stats = [calib(images).cpu().numpy() for images in batches]
    if percentile >= 100.0:
        agg = np.maximum.reduce(stats)
    else:
        agg = np.mean(stats, axis=0)
    return np.maximum(agg, SCALE_EPS) / 127.0


def collect_scales_uint8(model: nn.Module, canvases,
                         percentile: float = 100.0) -> np.ndarray:
    """`collect_scales` on network canvases (H, W, 3) or (1, H, W, 3), numpy
    or tensors, in the CLIs' upload convention: uint8 is raw BGR (cast and
    the BGR mean subtracted here), float is already preprocessed."""
    device = next(model.parameters()).device
    mean = torch.as_tensor(BGR_MEAN, device=device)
    batches = []
    for canvas in canvases:
        im = torch.as_tensor(canvas, device=device)
        raw_uint8 = im.dtype == torch.uint8
        im = im.to(torch.float32)
        if raw_uint8:
            im = im - mean
        if im.dim() == 3:
            im = im[None]
        batches.append(im.permute(0, 3, 1, 2))
    return collect_scales(model, batches, percentile=percentile)


class QuantizedModel:
    """`model` with every conv site run int8 at `scales` (numpy (S,)).
    Calling it runs the model's forward. Each conv's weight is quantized at
    its first call and again after it changes (a load, a move to another
    dtype or device)."""

    def __init__(self, model: nn.Module, scales):
        self.model = model
        self.scales = np.asarray(scales, np.float32)
        self._weights = {}  # conv -> (key of its weight, w8, s_w)

    def int8_weight(self, conv: nn.Conv2d):
        """(w8 in channels-last memory, s_w) of the conv's weight as it is
        now, in its own dtype (a bf16 weight gives the scales of its bf16
        values)."""
        w = conv.weight
        # an inference tensor has no version counter, and changes only in
        # inference mode
        version = None if w.is_inference() else w._version
        key = (w.data_ptr(), version, w.dtype, w.device)
        hit = self._weights.get(conv)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                w8, s_w = quantize_weight(w.detach())
            hit = (key, w8.contiguous(memory_format=torch.channels_last), s_w)
            self._weights[conv] = hit
        return hit[1], hit[2]

    def _conv(self, site, conv, x, pad=None):
        """Conv site `site` int8 on x, zero-padded by `pad` ((top, bottom),
        (left, right); default: the conv's own padding of x)."""
        if site >= len(self.scales):
            raise ValueError(f"{len(self.scales)} int8 scales for a forward "
                             "with more conv sites")
        s_x = float(self.scales[site])
        w8, s_w = self.int8_weight(conv)
        if pad is None:
            pad = conv_padding(conv, x)
        args = (s_w, conv.bias, conv.stride[0], pad, conv.weight.dtype)
        if conv.groups != 1:  # one launch quantizes x and convolves
            return int8_depthwise_cuda.quantize_depthwise2d(x, s_x, w8, *args)
        return int8_conv_cuda.conv2d(int8_conv_cuda.quantize(x, s_x), w8, s_x,
                                     *args)

    def __call__(self, images):
        with _intercept(self.model, self._conv) as counter:
            out = self.model(images)
        if counter[0] != len(self.scales):
            raise ValueError(f"{len(self.scales)} int8 scales for a forward "
                             f"with {counter[0]} conv sites")
        return out


def quantize_apply(model: nn.Module, scales) -> QuantizedModel:
    """`model` with every conv running int8 x int8 -> int32 at the
    per-site activation `scales` of `collect_scales`."""
    return QuantizedModel(model, scales)
