"""Ground-plane polling on the card: wrapper of the hand-written CUDA kernel
in ../csrc/polling.cu.

The kernel replaces ground_plane_polling_tpu/kernels/polling_pallas.py::
_poll_kernel and the jnp epilogue of fit_road_planes_pallas, fused: it
scores every (detection, plane) pair and reduces each detection's row to
its winning plane in one launch, without writing the (B, D, P) scoreboards.
Per pair it does about 150 f32 operations, so at B 4, D 100, P 21,634 it is
compute- and launch-bound (about 1.3 GFLOP), not memory-bound.

`fit_road_planes` takes the tensors of ops.polling.fit_road_planes. CUDA
tensors go through the kernel, which raises if it cannot build or launch;
CPU tensors go through the plain twin in ops.polling. The cheap
per-detection inputs (normalized planes, rays, expected distances) are
computed with torch before the launch.

The kernel is compiled with nvcc at first use, from the source in the
package, into `_build/` beside it (a library with a plain C entry point,
loaded with ctypes). `LAUNCHES` counts kernel launches.
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

__all__ = ["LAUNCHES", "SOURCE", "build", "fit_road_planes"]

LAUNCHES = 0

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "polling.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC")

_lib = None


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
        fn = lib.gpp_poll_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(rays, expected, planes_n):
    """rays (B, D, 4, 3), expected (B, D, 6), planes_n (B, P, 4), float32
    on one CUDA device -> PollResult."""
    global LAUNCHES
    b, d = rays.shape[:2]
    p = planes_n.shape[1]
    if (rays.shape != (b, d, 4, 3) or expected.shape != (b, d, 6)
            or planes_n.shape != (b, p, 4)):
        raise ValueError(
            f"polling shapes: rays {tuple(rays.shape)}, expected "
            f"{tuple(expected.shape)}, planes {tuple(planes_n.shape)}")
    for t in (rays, expected, planes_n):
        if t.dtype != torch.float32 or t.device != rays.device:
            raise ValueError(f"polling kernel takes float32 tensors on one "
                             f"CUDA device, got {t.dtype} on {t.device}")
    if p == 0:
        raise ValueError("the plane database is empty")
    if b * d * 12 >= 2**31 or b * p * 4 >= 2**31:
        raise ValueError(f"polling inputs too large: B {b}, D {d}, P {p}")
    rays = rays.reshape(b, d, 12).contiguous()
    expected = expected.contiguous()
    planes_n = planes_n.contiguous()
    keypoints = rays.new_empty((b, d, 4, 3))
    keyplanes = rays.new_empty((b, d, 1, 4))
    residuals = rays.new_empty((b, d))
    if b * d > 0:
        lib = _library()
        with torch.cuda.device(rays.device):
            stream = torch.cuda.current_stream(rays.device).cuda_stream
            LAUNCHES += 1
            err = lib.gpp_poll_launch(
                rays.data_ptr(), expected.data_ptr(), planes_n.data_ptr(),
                b, d, p, keypoints.data_ptr(), keyplanes.data_ptr(),
                residuals.data_ptr(), stream)
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
    f32 = torch.float32
    boxes, dimensions, P_inv, planes = (
        t.to(f32) for t in (boxes, dimensions, P_inv, planes))
    return _launch(twin.rays_from_boxes(boxes, P_inv),
                   twin.expected_distances(dimensions, orientations),
                   twin.normalize_planes(planes))
