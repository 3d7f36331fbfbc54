"""Tracing of the port: named host spans, device stamps of the detect
call's stages, and torch.profiler traces.

Usage:
    with trace("inference", logdir="/tmp/trace"):   # a Chrome trace
        out = detect(...)

    with span("trunk"):       # a range "gpp.trunk" while a profiler records
        ...

    GPP_TRACE=1 python ...    # detect calls on a card stamp their stages
    profiling.stage_ms("cuda:0", last=100)   # trunk, filter, polling, pose

Spans are host ranges of the profiler: they share its clock with the
device's events, and nest on the calling thread. With no profiler
recording, `span` returns one shared null context and records nothing.
Stage stamps are device timestamps written by a one-thread kernel
(csrc/stamp.cu) at each stage boundary of the detect call, inside its
CUDA graph, into a ring of RING calls a device; `stage_ms` reads it back
once. Without GPP_TRACE=1 nothing of them is built, allocated, captured
or launched.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from ..kernels import nvcc_build

__all__ = ["trace", "span", "stage_stamps", "stage_ms", "STAGES", "RING"]

# the stages between the detect call's five stamps
STAGES = ("trunk", "filter", "polling", "pose")
BOUNDARIES = len(STAGES) + 1
# calls a device's ring keeps
RING = 1024
STAMP_SOURCE = nvcc_build.CSRC / "stamp.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_NULL = contextlib.nullcontext()
# a range of the FUNCTION scope: the profiler records it on the host
# only, where record_function's user scope also copies it onto the
# device's timeline, as if it were device work
_Range = torch._C._profiler._RecordFunctionFast

_lib = None
# device index -> int64: RING x BOUNDARIES stamps (ns), then the counter
_rings = {}


@contextlib.contextmanager
def trace(name: str, logdir: Optional[str] = None):
    """torch.profiler trace around a block, the CPU and, where there is
    one, the card, with the block as a `record_function(name)` range and
    the port's spans inside it; the Chrome trace lands under `logdir` as
    `{name}.{pid}.{ns}.pt.trace.json` (TensorBoard's profiler plugin reads
    it). A no-op when logdir is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(name):
            yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        logdir, f"{name}.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def span(name: str):
    """The host range "gpp.<name>" around a `with` block while a profiler
    records; otherwise the shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Range("gpp." + name)


def _no_stamp(boundary: int):
    pass


def _cuda_index(device) -> int:
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(nvcc_build.build_library(
            STAMP_SOURCE, NVCC_FLAGS, "libgpp_stamp")))
        lib.gpp_stamp.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                                  + [ctypes.c_void_p])
        lib.gpp_stamp.restype = ctypes.c_int
        _lib = lib
    return _lib


def stage_stamps(device):
    """The stamp function of one detect call on `device`: stamp(i) queues
    on the current stream the device time of boundary i (0 the start, 1-3
    after the trunk, the filter and polling, 4 the end, which moves the
    ring to the next call). The switch, GPP_TRACE=1 in the environment, is
    read here; without it, or off a card, stamp does nothing."""
    if torch.device(device).type != "cuda" \
            or os.environ.get("GPP_TRACE") != "1":
        return _no_stamp
    index = _cuda_index(device)
    lib = _library()
    ring = _rings.get(index)
    if ring is None:
        ring = _rings[index] = torch.zeros(
            RING * BOUNDARIES + 1, dtype=torch.int64,
            device=torch.device("cuda", index))
    ptr = ring.data_ptr()

    def stamp(boundary: int):
        stream = torch._C._cuda_getCurrentRawStream(index)
        with torch.cuda.device(index):
            err = lib.gpp_stamp(ptr, boundary, BOUNDARIES, RING, stream)
        if err != 0:
            raise RuntimeError(f"stage stamp launch failed: CUDA error {err}")

    return stamp


def stage_ms(device, last: int = RING):
    """The stage times of the last `last` calls stamped on `device`, in
    call order: a float64 array (n, 4) of trunk, filter, polling and pose
    device ms (None where no call was stamped there). One read-back, after
    the card has run what was queued."""
    ring = _rings.get(_cuda_index(device)) if _rings else None
    if ring is None:
        return None
    torch.cuda.synchronize(ring.device)
    host = ring.cpu().numpy()
    count = int(host[-1])
    n = min(last, count, RING)
    if n <= 0:
        return None
    stamps = host[:-1].reshape(RING, BOUNDARIES)[
        np.arange(count - n, count) % RING]
    return np.diff(stamps, axis=1) / 1e6
