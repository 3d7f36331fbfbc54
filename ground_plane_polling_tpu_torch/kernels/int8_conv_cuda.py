"""int8 convolution on the card: wrappers of the hand-written CUDA kernels
in ../csrc/int8_conv.cu, the activation quantize pass and the int8 conv
with its dequantize and bias epilogue.

Together they replace the conv rewrite of
ground_plane_polling_tpu/models/quantize.py::quantize_apply (quantize x,
int8 x int8 -> int32 conv, dequantize), which XLA lowers on the TPU. CUDA
tensors go through the kernels, which raise if they cannot build or
launch; the wrappers check their inputs, allocate the outputs with
torch.empty and launch on the current stream. CPU tensors go through the
plain versions in ops.int8_conv, and only they do.

Layouts on the card: `quantize` returns an NCHW int8 tensor in
channels-last memory (NHWC), which `conv2d` takes with a weight in
channels-last memory (OIHW indexed, [Cout][kh][kw][Cin] in memory); the
output is NCHW in channels-last memory, in float32 or bf16, as the float
conv's output on the card. `padding` is ((top, bottom), (left, right)),
so Flax's asymmetric SAME padding needs no pass of its own.

The library is compiled with nvcc at first use (kernels/nvcc_build.py),
with IEEE division and no FMA contraction: the quantize pass divides as
the JAX package does. `QUANTIZE_LAUNCHES` and `CONV_LAUNCHES` count the
launches of each kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..ops import int8_conv as twin
from .nvcc_build import CSRC, build_library

__all__ = ["CONV_LAUNCHES", "QUANTIZE_LAUNCHES", "SOURCE", "build",
           "conv2d", "conv2d_accumulate", "quantize"]

QUANTIZE_LAUNCHES = 0
CONV_LAUNCHES = 0

SOURCE = CSRC / "int8_conv.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-prec-div=true", "-fmad=false", "-Xptxas=-v",
              "-shared", "-Xcompiler", "-fPIC")
_FLOATS = (torch.float32, torch.bfloat16)
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_LIMIT = 2**31

_lib = None


def build() -> Path:
    """Compile the kernels (once per source and flag set) and return the
    path of the shared library; nvcc's report lands beside it as `.log`."""
    return build_library(SOURCE, NVCC_FLAGS, "libgpp_int8_conv")


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.gpp_int8_quantize.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        lib.gpp_int8_quantize.restype = ctypes.c_int
        lib.gpp_int8_conv.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 12
            + [ctypes.c_float] + [ctypes.c_void_p] * 3
            + [ctypes.c_int, ctypes.c_void_p])
        lib.gpp_int8_conv.restype = ctypes.c_int
        _lib = lib
    return _lib


def _call(device, fn, *args):
    """fn(*args, stream of `device`) with `device` current; raises on a
    CUDA error."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: CUDA error "
                           f"{err}")


def _nhwc(t: torch.Tensor) -> bool:
    return t.permute(0, 2, 3, 1).is_contiguous()


def _on_cuda(tensors, device):
    for t in tensors:
        if t is not None and (not t.is_cuda or t.device != device):
            raise ValueError(f"int8 conv kernels take tensors on one CUDA "
                             f"device, got {t.device} beside {device}")


def _quantize(x: torch.Tensor, s_x: float) -> torch.Tensor:
    """The quantize kernel on a CUDA tensor."""
    global QUANTIZE_LAUNCHES
    if x.dim() != 4 or x.dtype not in _FLOATS:
        raise ValueError(f"quantize takes a 4-D float32 or bf16 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.numel() >= _LIMIT or not s_x > 0:
        raise ValueError(f"quantize: {tuple(x.shape)} at scale {s_x}")
    _on_cuda([x], x.device)
    b, c, h, w = x.shape
    out = torch.empty((b, h, w, c), dtype=torch.int8, device=x.device)
    if out.numel():
        QUANTIZE_LAUNCHES += 1
        _call(x.device, _library().gpp_int8_quantize, x.data_ptr(),
              x.dtype == torch.bfloat16, b, c, h, w, *x.stride(),
              float(s_x), out.data_ptr())
    return out.permute(0, 3, 1, 2)


def quantize(x: torch.Tensor, s_x: float) -> torch.Tensor:
    """int8 round(x / s_x) clamped to +-127 of an NCHW float32 or bf16
    tensor: the kernel on a CUDA tensor (NHWC int8 out), the plain version
    on a CPU one."""
    if x.device.type == "cpu":
        return twin.quantize_activation(x, s_x)
    return _quantize(x, s_x)


def _launch(x8, w8, s_x, s_w, bias, stride, padding, out_dtype):
    """The conv kernel on CUDA tensors."""
    global CONV_LAUNCHES
    if (x8.dim() != 4 or w8.dim() != 4 or x8.dtype != torch.int8
            or w8.dtype != torch.int8 or x8.shape[1] != w8.shape[1]):
        raise ValueError(f"int8 conv takes int8 NCHW x and OIHW w, got "
                         f"{x8.dtype} {tuple(x8.shape)} and {w8.dtype} "
                         f"{tuple(w8.shape)}")
    if not (_nhwc(x8) and _nhwc(w8)):
        raise ValueError("int8 conv takes x and w in channels-last memory")
    b, c, h, w = x8.shape
    o, _, kh, kw = w8.shape
    (top, bottom), (left, right) = padding
    ho = (h + top + bottom - kh) // stride + 1
    wo = (w + left + right - kw) // stride + 1
    if min(top, bottom, left, right) < 0 or stride < 1 or ho < 0 or wo < 0:
        raise ValueError(f"int8 conv: stride {stride}, padding {padding} on "
                         f"{h}x{w} with a {kh}x{kw} kernel")
    if x8.numel() >= _LIMIT or w8.numel() >= _LIMIT or b * ho * wo * o >= \
            _LIMIT:
        raise ValueError(f"int8 conv too large: x {tuple(x8.shape)}, w "
                         f"{tuple(w8.shape)}")
    if out_dtype != torch.int32:
        if (s_w.dtype != torch.float32 or tuple(s_w.shape) != (o,)
                or not s_w.is_contiguous()):
            raise ValueError(f"int8 conv: s_w must be ({o},) float32")
        if bias is not None and (bias.dtype != out_dtype or tuple(
                bias.shape) != (o,) or not bias.is_contiguous()):
            raise ValueError(f"int8 conv: bias must be ({o},) {out_dtype}")
    device = x8.device
    _on_cuda([x8, w8, s_w, bias], device)
    if c % 16 == 0 and (x8.data_ptr() % 16 or w8.data_ptr() % 16):
        raise ValueError("int8 conv: x and w must be 16-byte aligned")
    out = torch.empty((b, ho, wo, o), dtype=out_dtype, device=device)
    if out.numel():
        CONV_LAUNCHES += 1
        _call(device, _library().gpp_int8_conv, x8.data_ptr(),
              w8.data_ptr(), b, h, w, c, o, kh, kw, stride, top, left, ho,
              wo, float(s_x), s_w.data_ptr() if s_w is not None else None,
              bias.data_ptr() if bias is not None else None, out.data_ptr(),
              _KINDS[out_dtype])
    return out.permute(0, 3, 1, 2)


def conv2d(x8, w8, s_x: float, s_w, bias, stride: int, padding,
           out_dtype: torch.dtype) -> torch.Tensor:
    """int8 conv of x8 (N, Cin, H, W) with w8 (Cout, Cin, kh, kw),
    dequantized by s_x * s_w[c] into `out_dtype` (float32 or bf16), plus
    `bias` ((Cout,) of `out_dtype`, or None): the kernel on CUDA tensors,
    ops.int8_conv.int8_conv2d on CPU ones."""
    if out_dtype not in _FLOATS:
        raise ValueError(f"int8 conv writes float32 or bf16, not {out_dtype}")
    if x8.device.type == "cpu":
        return twin.int8_conv2d(x8, w8, s_x, s_w, bias, stride, padding,
                                out_dtype)
    return _launch(x8, w8, s_x, s_w, bias, stride, padding, out_dtype)


def conv2d_accumulate(x8, w8, stride: int, padding) -> torch.Tensor:
    """The raw int32 accumulators of the same conv (the kernel's third
    output kind; ops.int8_conv.conv2d_int8 on CPU tensors)."""
    if x8.device.type == "cpu":
        return twin.conv2d_int8(x8, w8, stride, padding)
    return _launch(x8, w8, 0.0, None, None, stride, padding, torch.int32)
