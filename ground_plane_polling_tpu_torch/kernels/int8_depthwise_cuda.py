"""int8 depthwise 3x3 convolution on the card: the wrapper of the
hand-written CUDA kernel in ../csrc/int8_depthwise.cu, with its
dequantize and bias epilogue.

It replaces the grouped case (feature_group_count = C) of the conv rewrite
of ground_plane_polling_tpu/models/quantize.py::quantize_apply, which XLA
lowers on the TPU: MobileNet's 13 depthwise convs under --int8. The
activation comes quantized by kernels.int8_conv_cuda.quantize (NCHW int8
in channels-last memory); the weight is the (C, 1, 3, 3) int8 kernel of a
groups=C conv. CUDA tensors go through the kernel, which raises if it
cannot build or launch; CPU tensors go through the plain version,
ops.int8_conv.int8_conv2d (an exact float64 grouped conv), and only they
do. The output is NCHW in channels-last memory, as the conv kernel's.

The library is compiled with nvcc at first use (kernels/nvcc_build.py),
with no FMA contraction. `DEPTHWISE_LAUNCHES` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..ops import int8_conv as twin
from .int8_conv_cuda import _nhwc, _on_cuda, _stream
from .nvcc_build import CSRC, build_library

__all__ = ["DEPTHWISE_LAUNCHES", "SOURCE", "build", "depthwise2d",
           "depthwise2d_accumulate", "is_depthwise"]

DEPTHWISE_LAUNCHES = 0

SOURCE = CSRC / "int8_depthwise.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC")
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_LIMIT = 2**31

_lib = None


def build() -> Path:
    """Compile the kernel (once per source and flag set) and return the
    path of the shared library; nvcc's report lands beside it as `.log`."""
    return build_library(SOURCE, NVCC_FLAGS, "libgpp_int8_depthwise")


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.gpp_int8_depthwise.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_float]
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.gpp_int8_depthwise.restype = ctypes.c_int
        _lib = lib
    return _lib


def is_depthwise(x_channels: int, w_shape) -> bool:
    """Whether a conv of `w_shape` (OIHW) on `x_channels` input channels
    is a depthwise 3x3 conv: groups = in = out channels."""
    o, i, kh, kw = w_shape
    return i == 1 and o == x_channels and (kh, kw) == (3, 3)


def _launch(x8, w8, s_x, s_w, bias, stride, padding, out_dtype):
    """The kernel on CUDA tensors."""
    global DEPTHWISE_LAUNCHES
    if (x8.dim() != 4 or w8.dim() != 4 or x8.dtype != torch.int8
            or w8.dtype != torch.int8
            or not is_depthwise(x8.shape[1], w8.shape)):
        raise ValueError(f"int8 depthwise conv takes int8 NCHW x (C) and a "
                         f"(C, 1, 3, 3) int8 w, got {x8.dtype} "
                         f"{tuple(x8.shape)} and {w8.dtype} "
                         f"{tuple(w8.shape)}")
    b, c, h, w = x8.shape
    (top, bottom), (left, right) = padding
    if stride < 1 or min(top, bottom, left, right) < 0:
        raise ValueError(f"int8 depthwise conv: stride {stride}, padding "
                         f"{padding}")
    ho = (h + top + bottom - 3) // stride + 1
    wo = (w + left + right - 3) // stride + 1
    if ho < 0 or wo < 0:
        raise ValueError(f"int8 depthwise conv: padding {padding} on {h}x{w}")
    if not _nhwc(x8) or not w8.is_contiguous():
        raise ValueError("int8 depthwise conv takes x in channels-last "
                         "memory and a contiguous w")
    if x8.numel() >= _LIMIT or b * ho * wo * c >= _LIMIT:
        raise ValueError(f"int8 depthwise conv too large: x "
                         f"{tuple(x8.shape)}")
    if out_dtype != torch.int32:
        if (s_w is None or s_w.dtype != torch.float32
                or tuple(s_w.shape) != (c,) or not s_w.is_contiguous()):
            raise ValueError(f"int8 depthwise conv: s_w must be ({c},) "
                             "float32")
        if bias is not None and (bias.dtype != out_dtype or tuple(
                bias.shape) != (c,) or not bias.is_contiguous()):
            raise ValueError(f"int8 depthwise conv: bias must be ({c},) "
                             f"{out_dtype}")
    device = x8.device
    _on_cuda([x8, w8, s_w, bias], device)
    vec = 8 if c % 8 == 0 else 1
    if vec == 8 and (x8.data_ptr() % 8 or w8.data_ptr() % 8):
        raise ValueError("int8 depthwise conv: x and w must be 8-byte "
                         "aligned")
    out = torch.empty((b, ho, wo, c), dtype=out_dtype, device=device)
    if out.numel():
        DEPTHWISE_LAUNCHES += 1
        lib = _library()
        args = (x8.data_ptr(), w8.data_ptr(), b, h, w, c, stride, top, left,
                ho, wo, float(s_x),
                s_w.data_ptr() if s_w is not None else None,
                bias.data_ptr() if bias is not None else None,
                out.data_ptr(), _KINDS[out_dtype], vec, _stream(device))
        if device.index == torch.cuda.current_device():
            err = lib.gpp_int8_depthwise(*args)
        else:
            with torch.cuda.device(device):
                err = lib.gpp_int8_depthwise(*args)
        if err != 0:
            raise RuntimeError(f"int8 depthwise kernel launch failed: CUDA "
                               f"error {err}")
    return out.permute(0, 3, 1, 2)


def depthwise2d(x8, w8, s_x: float, s_w, bias, stride: int, padding,
                out_dtype: torch.dtype) -> torch.Tensor:
    """int8 depthwise 3x3 conv of x8 (N, C, H, W) with w8 (C, 1, 3, 3),
    dequantized by s_x * s_w[c] into `out_dtype` (float32 or bf16), plus
    `bias` ((C,) of `out_dtype`, or None); `padding` is ((top, bottom),
    (left, right)): the kernel on CUDA tensors, ops.int8_conv.int8_conv2d
    on CPU ones."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8 depthwise conv writes float32 or bf16, not "
                         f"{out_dtype}")
    if x8.device.type == "cpu":
        return twin.int8_conv2d(x8, w8, s_x, s_w, bias, stride, padding,
                                out_dtype)
    return _launch(x8, w8, s_x, s_w, bias, stride, padding, out_dtype)


def depthwise2d_accumulate(x8, w8, stride: int, padding) -> torch.Tensor:
    """The raw int32 accumulators of the same conv (the kernel's third
    output kind; ops.int8_conv.conv2d_int8 on CPU tensors)."""
    if x8.device.type == "cpu":
        return twin.conv2d_int8(x8, w8, stride, padding)
    return _launch(x8, w8, 0.0, None, None, stride, padding, torch.int32)
