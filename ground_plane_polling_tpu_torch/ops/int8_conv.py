"""int8 convolution, plain PyTorch (port of the conv rewrite in
ground_plane_polling_tpu/models/quantize.py::quantize_apply).

One conv site runs as

    x8 = quantize_activation(x, s_x)          round(x / s_x), clamped to +-127
    acc = conv2d_int8(x8, w8, stride, padding)  int8 x int8 -> exact int32
    y = dequantize(acc, s_x, s_w, dtype)      float(acc) * (s_x * s_w[c])
    y = y + bias                              in the output dtype

with a per-tensor activation scale `s_x` and per-output-channel weight
scales `s_w` (`quantize_weight`). `int8_conv2d` is the last three steps,
the function of the CUDA conv kernel (kernels/int8_conv_cuda.py).

These are the plain versions: the CPU path and the tests use them, and on
the card they only serve as the kernels' reference (of the conv kernel,
and of the depthwise kernel for a (C, 1, 3, 3) weight). Tensors are NCHW
(and OIHW) in any memory format. Each step rounds where the JAX package's does:
true float32 division (torch turns a division by a Python scalar on CUDA
into a multiplication by its reciprocal, so the divisor is a tensor on the
input's device), round half to even, float32 products.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["quantize_activation", "quantize_weight", "conv2d_int8",
           "dequantize", "int8_conv2d", "SCALE_EPS"]

SCALE_EPS = 1e-8


def _divide(x: torch.Tensor, s) -> torch.Tensor:
    """float32 x / s with IEEE division on every device."""
    return x.float() / torch.as_tensor(s, dtype=torch.float32,
                                       device=x.device)


def quantize_activation(x: torch.Tensor, s_x: float) -> torch.Tensor:
    """int8 round(x / s_x), clamped to [-127, 127]."""
    return torch.round(_divide(x, s_x)).clamp(-127, 127).to(torch.int8)


def quantize_weight(w: torch.Tensor):
    """(w8, s_w) of an OIHW kernel, symmetric per output channel:
    s_w = max(amax |w|, 1e-8) / 127 in float32, from `w` in the dtype the
    conv runs in (a bf16 kernel gives the scales of its bf16 values)."""
    wf = w.float()
    s_w = _divide(wf.abs().amax(dim=(1, 2, 3)).clamp(min=SCALE_EPS), 127.0)
    w8 = torch.round(wf / s_w[:, None, None, None]).clamp(-127, 127)
    return w8.to(torch.int8), s_w


def conv2d_int8(x8: torch.Tensor, w8: torch.Tensor, stride: int,
                padding) -> torch.Tensor:
    """int32 accumulators of the int8 conv; `padding` is
    ((top, bottom), (left, right)) of int8 zeros. A weight of Cin / g input
    channels makes it a conv of g groups (a (C, 1, kh, kw) weight on C
    channels: depthwise, JAX's feature_group_count = C). Computed as a
    float64 conv, which is exact: |acc| <= K * 127^2 < 2^53 for any K of
    the detector (K = kh kw Cin <= 4,608 gives 7.4e7; float32 would not be
    exact above 2^24)."""
    (top, bottom), (left, right) = padding
    x = F.pad(x8.double(), (left, right, top, bottom))
    groups = x8.shape[1] // w8.shape[1]
    return F.conv2d(x, w8.double(), stride=stride,
                    groups=groups).to(torch.int32)


def dequantize(acc: torch.Tensor, s_x: float, s_w: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """float(acc) * (s_x * s_w[c]) in float32, cast to `out_dtype`."""
    deq = s_w.float() * torch.as_tensor(s_x, dtype=torch.float32,
                                        device=s_w.device)
    return (acc.float() * deq[:, None, None]).to(out_dtype)


def int8_conv2d(x8, w8, s_x, s_w, bias, stride, padding, out_dtype):
    """The conv kernel's function: int8 conv, dequantize, then the bias
    (or None) added in `out_dtype`."""
    y = dequantize(conv2d_int8(x8, w8, stride, padding), s_x, s_w, out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)[:, None, None]
    return y
