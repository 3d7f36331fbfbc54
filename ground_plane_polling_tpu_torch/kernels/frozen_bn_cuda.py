"""The frozen batch norm, residual add and ReLU of a ResNet site on the
card: the wrapper of the hand-written CUDA kernel in ../csrc/frozen_bn.cu,
which runs a site's three to six elementwise passes as one.

`frozen_bn_act(x, s, b, relu, r, sp, bp)` is
    y = x * s + b, then ReLU if `relu`            (r None)
    y = (x * s + b) + r, then ReLU                (sp, bp None: identity)
    y = (x * s + b) + (r * sp + bp), then ReLU    (a projection's BN)
on an NCHW x in channels-last memory, float32 or bf16, with the per-channel
s, b, sp, bp of x's type: bit for bit the plain passes (`plain`), which
round each multiply and each add to x's type. CUDA tensors go through the
kernel, which raises on tensors it does not take and if it cannot build or
launch; CPU tensors go through `plain`, and only they do. `supports(x)`
says which maps the kernel takes: float32 or bf16, 4-D, channels-last
contiguous and 16-byte aligned, C a multiple of 8 and at most
MAX_CHANNELS. The kernel has no backward, and refuses tensors that
require grad under autograd: a training forward takes `plain`.

The output is a fresh torch.empty_like(x), written on the current stream;
the launch allocates nothing and does not sync the host, so a captured
CUDA graph holds it as it is. The library is compiled with nvcc at first
use (kernels/nvcc_build.py), with no FMA contraction. `BN_ACT_LAUNCHES`
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .int8_conv_cuda import _stream
from .nvcc_build import CSRC, build_library, load_library

__all__ = ["BN_ACT_LAUNCHES", "MAX_CHANNELS", "SOURCE", "build",
           "frozen_bn_act", "plain", "supports"]

BN_ACT_LAUNCHES = 0

SOURCE = CSRC / "frozen_bn.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC")
_KINDS = {torch.float32: 0, torch.bfloat16: 1}
_LIMIT = 2**31
# a block stages s, b, sp, bp in shared memory: 4 C values of 4 bytes
# within the 48 KB a launch gets without opting in to more
MAX_CHANNELS = 3072

_lib = None
_sms = {}  # device index -> SMs


def build() -> Path:
    """Compile the kernel (once per source and flag set) and return the
    path of the shared library; nvcc's report lands beside it as `.log`."""
    return build_library(SOURCE, NVCC_FLAGS, "libgpp_frozen_bn")


def _library():
    global _lib
    if _lib is None:
        lib = load_library(build)
        lib.gpp_frozen_bn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
            + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.gpp_frozen_bn.restype = ctypes.c_int
        _lib = lib
    return _lib


def supports(x: torch.Tensor) -> bool:
    """Whether the kernel takes x (or a residual like it), of any device:
    float32 or bf16, 4-D in channels-last memory, C a multiple of 8 up to
    MAX_CHANNELS, fewer than 2^31 elements, 16-byte aligned."""
    return (x.dtype in _KINDS and x.dim() == 4
            and x.shape[1] % 8 == 0 and x.shape[1] <= MAX_CHANNELS
            and x.numel() < _LIMIT
            and x.is_contiguous(memory_format=torch.channels_last)
            and x.data_ptr() % 16 == 0)


def plain(x, s, b, relu: bool, r=None, sp=None, bp=None) -> torch.Tensor:
    """The plain passes of the same function, one TensorIterator op each
    (any layout, any device)."""
    y = x * s[:, None, None] + b[:, None, None]
    if r is not None:
        if sp is not None:
            r = r * sp[:, None, None] + bp[:, None, None]
        y = y + r
    return torch.relu(y) if relu else y


def _sm_count(device) -> int:
    n = _sms.get(device.index)
    if n is None:
        n = _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _check(x, s, b, relu, r, sp, bp):
    """Raises ValueError unless the kernel takes these tensors."""
    if not supports(x):
        raise ValueError(f"frozen_bn_act takes a float32 or bf16 NCHW x in "
                         f"16-byte aligned channels-last memory with C a "
                         f"multiple of 8 up to {MAX_CHANNELS}, got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if (sp is None) != (bp is None) or (sp is not None and r is None):
        raise ValueError("frozen_bn_act: sp and bp come together, with r")
    if r is not None and not relu:
        raise ValueError("frozen_bn_act: a site with a shortcut takes its "
                         "ReLU")
    c = x.shape[1]
    for name, p in (("s", s), ("b", b), ("sp", sp), ("bp", bp)):
        if p is not None and (p.dtype != x.dtype or tuple(p.shape) != (c,)
                              or not p.is_contiguous()
                              or p.data_ptr() % 16):
            raise ValueError(f"frozen_bn_act: {name} must be a contiguous, "
                             f"16-byte aligned ({c},) {x.dtype}")
    if r is not None and (r.dtype != x.dtype or r.shape != x.shape
                          or not supports(r)):
        raise ValueError(f"frozen_bn_act: r must have x's type, shape and "
                         f"layout, got {r.dtype} {tuple(r.shape)} "
                         f"{r.stride()}")
    for t in (s, b, r, sp, bp):
        if t is not None and t.device != x.device:
            raise ValueError(f"frozen_bn_act takes tensors on one device, "
                             f"got {t.device} beside {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, s, b, r, sp, bp)):
        raise ValueError("frozen_bn_act has no backward: under autograd "
                         "take `plain`")


def _launch(x, s, b, relu, r, sp, bp, out):
    """One launch of the kernel into `out` on the current stream."""
    global BN_ACT_LAUNCHES
    BN_ACT_LAUNCHES += 1
    device = x.device
    residual = 0 if r is None else 1 if sp is None else 2
    args = (x.data_ptr(), r.data_ptr() if r is not None else None,
            s.data_ptr(), b.data_ptr(),
            sp.data_ptr() if sp is not None else None,
            bp.data_ptr() if bp is not None else None, out.data_ptr(),
            _KINDS[x.dtype], int(relu), residual, x.numel(), x.shape[1],
            _sm_count(device), _stream(device))
    if device.index == torch.cuda.current_device():
        err = _library().gpp_frozen_bn(*args)
    else:
        with torch.cuda.device(device):
            err = _library().gpp_frozen_bn(*args)
    if err != 0:
        raise RuntimeError(f"frozen BN kernel launch failed: CUDA error "
                           f"{err}")


def frozen_bn_act(x, s, b, relu: bool, r=None, sp=None,
                  bp=None) -> torch.Tensor:
    """The site's output (module docstring): `plain` on CPU tensors; on a
    card's, one launch of the kernel, which raises ValueError on tensors
    it does not take (`_check`) rather than fall back."""
    if not x.is_cuda:
        return plain(x, s, b, relu, r, sp, bp)
    _check(x, s, b, relu, r, sp, bp)
    out = torch.empty_like(x)
    if out.numel():
        _launch(x, s, b, relu, r, sp, bp, out)
    return out
