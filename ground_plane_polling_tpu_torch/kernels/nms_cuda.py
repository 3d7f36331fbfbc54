"""Greedy NMS on the card: wrapper of the hand-written CUDA kernel in
../csrc/nms.cu.

It replaces the greedy NMS of ground_plane_polling_tpu/ops/filtering.py::
_greedy_nms (the fixpoint that XLA lowers to a while_loop on the TPU):
one launch a call, one block a candidate set, which walks the candidates
in rank order 32 at a time, resolves each word in one warp's registers
while the other warps compute the next word's IoU decisions against the
candidates kept so far and, for its candidates still live, within the
word and against the word after, and stops at max_out kept or past the
last valid candidate. So it is exact greedy NMS with no host sync, no
bitmask in device memory and no scratch. What bounds it is one SM
working through each word's decisions and the barriers after them (one
SM a set, so sets run in parallel), not its operations or bytes. `greedy_nms` has
the contract of the plain version, ops.filtering.greedy_nms: CUDA
tensors go through the kernel, which raises if it cannot build or
launch; CPU tensors go through the plain version, and only they do. The
wrapper checks its inputs, allocates only the three outputs with
torch.empty and launches on the current stream.

The library is compiled with nvcc at first use (kernels/nvcc_build.py),
with no FMA contraction, so that every IoU decision equals the plain
version's. `NMS_LAUNCHES` counts launches of the kernel, one a call.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..ops import filtering as twin
from .nvcc_build import CSRC, build_library

__all__ = ["MAX_CANDIDATES", "NMS_LAUNCHES", "SOURCE", "build", "greedy_nms"]

NMS_LAUNCHES = 0

SOURCE = CSRC / "nms.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC")
# the kernel keeps no state a candidate (the candidates stream through a
# fixed ring in shared memory); the limit keeps its 32-bit candidate
# indices and the set offsets far from overflow
MAX_CANDIDATES = 2**24

_lib = None


def build() -> Path:
    """Compile the kernel (once per source and flag set) and return the
    path of the shared library; nvcc's report lands beside it as `.log`."""
    return build_library(SOURCE, NVCC_FLAGS, "libgpp_nms")


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.gpp_nms.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                                + [ctypes.c_float] + [ctypes.c_void_p] * 4)
        lib.gpp_nms.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(boxes4, scores, max_out: int, iou_threshold: float):
    """The kernel on CUDA tensors."""
    global NMS_LAUNCHES
    s, k = scores.shape
    if (boxes4.shape != (s, k, 4) or boxes4.dtype != torch.float32
            or scores.dtype != torch.float32):
        raise ValueError(f"nms takes float32 boxes (S, K, 4) and scores "
                         f"(S, K), got {boxes4.dtype} "
                         f"{tuple(boxes4.shape)} and {scores.dtype} "
                         f"{tuple(scores.shape)}")
    device = scores.device
    if not boxes4.is_cuda or boxes4.device != device:
        raise ValueError(f"nms takes tensors on one CUDA device, got "
                         f"{boxes4.device} and {device}")
    if max_out < 0 or max_out >= 2**31 or k > MAX_CANDIDATES \
            or s >= 2**31:
        raise ValueError(f"nms: {s} sets of {k} candidates, max_out "
                         f"{max_out}")
    boxes4, scores = boxes4.contiguous(), scores.contiguous()
    if boxes4.data_ptr() % 16:
        boxes4 = boxes4.clone()  # the kernel copies a box as 16 bytes
    idx = torch.empty((s, max_out), dtype=torch.long, device=device)
    valid = torch.empty((s, max_out), dtype=torch.bool, device=device)
    score = torch.empty((s, max_out), dtype=torch.float32, device=device)
    if s * max_out == 0:
        return idx, valid, score
    if k == 0:
        return idx.zero_(), valid.zero_(), score.fill_(float("-inf"))
    lib = _library()
    # the raw handle of the current stream (torch.cuda.current_stream
    # builds a Stream object, several microseconds a call)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    args = (boxes4.data_ptr(), scores.data_ptr(), s, k, max_out,
            float(iou_threshold), idx.data_ptr(), valid.data_ptr(),
            score.data_ptr(), stream)
    NMS_LAUNCHES += 1
    if device.index == torch.cuda.current_device():
        err = lib.gpp_nms(*args)
    else:
        with torch.cuda.device(device):
            err = lib.gpp_nms(*args)
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: CUDA error {err}")
    return idx, valid, score


def greedy_nms(boxes4, scores, max_out: int, iou_threshold: float):
    """Same contract as ops.filtering.greedy_nms: boxes4 (S, K, 4), scores
    (S, K) sorted descending with -inf for invalid rows -> idx (S, max_out)
    int64, valid (S, max_out) bool, score (S, max_out). Runs the kernel on
    CUDA tensors, the plain version on CPU ones."""
    if scores.device.type == "cpu":
        return twin.greedy_nms(boxes4, scores, max_out, iou_threshold)
    if scores.device.type != "cuda":
        raise ValueError(f"nms has no kernel for device {scores.device}")
    return _launch(boxes4, scores, max_out, iou_threshold)
