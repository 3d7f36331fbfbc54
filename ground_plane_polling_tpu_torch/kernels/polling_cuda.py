"""Ground-plane polling on the card: wrapper of the hand-written CUDA kernel
in ../csrc/polling.cu.

The kernel replaces ground_plane_polling_tpu/kernels/polling_pallas.py::
_poll_kernel together with the preparation before that pallas_call and the
jnp epilogue after it: from the raw inputs of `fit_road_planes` it
normalizes the planes, casts the rays and computes the expected distances,
scores every (detection, plane) pair and reduces each detection's row to
its winning plane, in one launch, without writing the (B, D, P)
scoreboards. Per pair it does 123 f32 operations, 9 of them on the MUFU
pipe, so at B 4, D 100, P 21,634 it is bound by operations (78 M on the
MUFU pipe beside 1.07 GFLOP), not by bytes.

`fit_road_planes` takes the tensors of ops.polling.fit_road_planes. CUDA
tensors go through the kernel, which raises if it cannot build or launch;
the wrapper checks them, allocates the outputs and launches, and runs no
torch arithmetic on them. CPU tensors go through the plain twin in
ops.polling. The twin on the card computes its rays with a float32 matrix
product; the comparison of kernel and twin assumes
`torch.backends.cuda.matmul.allow_tf32` is off (PyTorch's default), since
with TF32 the twin's rays keep only about three decimal digits.

The plane axis is split across blocks (`plan_splits`); the splits' states
merge in a workspace of the wrapper's, and per detection group a counter
that the kernel leaves at 0 after each launch. Workspaces are kept per
device and stream, so launches on one stream never share them with
launches that could run at the same time.

The kernel is compiled with nvcc at first use, from the source in the
package, into `_build/` beside it (a library with a plain C entry point,
loaded with ctypes). `LAUNCHES` counts kernel launches: one per call with
at least one detection.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..ops import polling as twin

__all__ = ["LAUNCHES", "SOURCE", "build", "fit_road_planes", "plan_splits"]

LAUNCHES = 0

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "polling.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=true", "-prec-sqrt=false", "-ftz=true",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
# fewest planes in one split: four per lane of a warp
MIN_SPLIT_PLANES = 128
_STATE_INTS = 5
_FLOATS = (torch.float32, torch.bfloat16)
_INTS = (torch.int32, torch.int64)

_lib = None
_slots = {}       # device index -> (detections per block, blocks in a wave)
_workspaces = {}  # (device index, stream) -> (states, counters)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build() -> Path:
    """Compile the kernel (once per source and flag set) and return the
    path of the shared library; nvcc's report lands beside it as `.log`."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libgpp_polling_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: concurrent builds agree on one file
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.gpp_poll_config.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.gpp_poll_config.restype = ctypes.c_int
        lib.gpp_poll_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_void_p] * 6)
        lib.gpp_poll_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _wave(device):
    """(detections per block, blocks the card holds at once) for the
    kernel on `device`."""
    if device.index not in _slots:
        warps, per_sm = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(device):
            err = _library().gpp_poll_config(ctypes.byref(warps),
                                             ctypes.byref(per_sm))
        if err != 0:
            raise RuntimeError(f"polling kernel occupancy query failed: "
                               f"CUDA error {err}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _slots[device.index] = (warps.value, sms * per_sm.value)
    return _slots[device.index]


def plan_splits(b, d, p, warps, wave):
    """Splits of the plane axis for B `b`, D `d`, P `p` with `warps`
    detections per block: as many as fill one wave of `wave` blocks, and
    no more than leave MIN_SPLIT_PLANES planes a split."""
    groups = b * -(-d // warps)
    return max(1, min(wave // max(groups, 1), -(-p // MIN_SPLIT_PLANES)))


def _workspace(device, stream, n_states, n_counters):
    """States and zeroed counters for one launch, kept per device and
    stream; the kernel leaves the counters at 0."""
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < n_states or ws[1].numel() < n_counters:
        if ws is not None:  # grow, never shrink: b1 and b4 calls alternate
            n_states = max(n_states, ws[0].numel())
            n_counters = max(n_counters, ws[1].numel())
        ws = (torch.empty(n_states, dtype=torch.int32, device=device),
              torch.zeros(n_counters, dtype=torch.int32, device=device))
        _workspaces[key] = ws
    return ws


def _check(boxes, dimensions, orientations, P_inv, planes):
    b, d = boxes.shape[:2]
    p = planes.shape[1] if planes.dim() == 3 else -1
    if ((boxes.shape, dimensions.shape, orientations.shape, P_inv.shape,
         planes.shape) != ((b, d, 12), (b, d, 3), (b, d), (b, 4, 3),
                           (b, p, 4))):
        raise ValueError(
            f"polling shapes: boxes {tuple(boxes.shape)}, dimensions "
            f"{tuple(dimensions.shape)}, orientations "
            f"{tuple(orientations.shape)}, P_inv {tuple(P_inv.shape)}, "
            f"planes {tuple(planes.shape)}")
    tensors = (boxes, dimensions, orientations, P_inv, planes)
    for t, kinds in zip(tensors, (_FLOATS, _FLOATS, _INTS, _FLOATS,
                                  _FLOATS)):
        if t.dtype not in kinds:
            raise ValueError(f"polling kernel takes {kinds}, got {t.dtype}")
    if p == 0:
        raise ValueError("the plane database is empty")
    index = boxes.get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"polling kernel takes tensors on one CUDA "
                             f"device, got {t.device}")
    if b * d * 12 >= 2**31 or b * p * 4 >= 2**31:
        raise ValueError(f"polling inputs too large: B {b}, D {d}, P {p}")
    return b, d, p


def _launch(boxes, dimensions, orientations, P_inv, planes,
            splits=None) -> twin.PollResult:
    """The kernel on CUDA tensors; `splits` fixes the number of splits of
    the plane axis (default: plan_splits)."""
    global LAUNCHES
    b, d, p = _check(boxes, dimensions, orientations, P_inv, planes)
    boxes, dimensions, orientations, P_inv, planes = (
        t.contiguous() for t in (boxes, dimensions, orientations, P_inv,
                                 planes))
    device = boxes.device
    f32 = torch.float32
    keypoints = torch.empty((b, d, 4, 3), dtype=f32, device=device)
    keyplanes = torch.empty((b, d, 1, 4), dtype=f32, device=device)
    residuals = torch.empty((b, d), dtype=f32, device=device)
    if b * d > 0:
        lib = _library()
        warps, wave = _wave(device)
        s = splits or plan_splits(b, d, p, warps, wave)
        # the raw handle of the current stream (torch.cuda.current_stream
        # builds a Stream object, several microseconds a call)
        stream = torch._C._cuda_getCurrentRawStream(device.index)
        states, counters = _workspace(device, stream,
                                      b * d * s * _STATE_INTS,
                                      b * -(-d // warps))
        bf16 = torch.bfloat16
        args = (boxes.data_ptr(), boxes.dtype == bf16,
                dimensions.data_ptr(), dimensions.dtype == bf16,
                orientations.data_ptr(), orientations.dtype == torch.int64,
                P_inv.data_ptr(), P_inv.dtype == bf16,
                planes.data_ptr(), planes.dtype == bf16, b, d, p, s,
                keypoints.data_ptr(), keyplanes.data_ptr(),
                residuals.data_ptr(), states.data_ptr(), counters.data_ptr(),
                stream)
        LAUNCHES += 1
        if device.index == torch.cuda.current_device():
            err = lib.gpp_poll_launch(*args)
        else:
            with torch.cuda.device(device):
                err = lib.gpp_poll_launch(*args)
        if err != 0:
            raise RuntimeError(f"polling kernel launch failed: CUDA error {err}")
    return twin.PollResult(keypoints=keypoints, keyplanes=keyplanes,
                           residuals=residuals)


def fit_road_planes(boxes, dimensions, orientations, P_inv,
                    planes) -> twin.PollResult:
    """Same contract as ops.polling.fit_road_planes: boxes (B, D, 12),
    dimensions (B, D, 3), orientations (B, D), P_inv (B, 4, 3), planes
    (B, P, 4). Runs the CUDA kernel on CUDA tensors, the twin on CPU ones."""
    tensors = (boxes, dimensions, orientations, P_inv, planes)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"polling inputs on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return twin.fit_road_planes(*tensors)
    if device.type != "cuda":
        raise ValueError(f"polling has no kernel for device {device}")
    return _launch(*tensors)
