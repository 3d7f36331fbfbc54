"""ctypes bindings for the native eval3d core (native/gpp_eval3d.cpp, port
of ground_plane_polling_tpu/utils/eval3d_native.py).

The library is built with g++ at first use into `_build/`, keyed by its
source and flags (kernels/nvcc_build.py), with the JAX package's flags. It
computes the two hot spots of the KITTI devkit protocol: rotated BEV/3D
overlap matrices and the per-image, per-threshold matching loop.
utils/eval3d.py takes it when it builds and `GPP_EVAL3D_NATIVE` is not
"0", and keeps the numpy path for an image of more than 4,096 detections.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..kernels.nvcc_build import build_library, load_library

__all__ = ["available", "build", "build_error", "bev_overlap", "overlap_3d",
           "compute_stats", "SOURCE", "GXX_FLAGS"]

SOURCE = Path(__file__).resolve().parent.parent / "native" / "gpp_eval3d.cpp"
# the JAX package's command: g++ -O3 -shared -fPIC -std=c++17 SRC
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_error: Optional[str] = None

_D = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def build() -> Path:
    """Compile the library (once per source and flags); returns its path.
    Raises RuntimeError with g++'s errors, or OSError without g++."""
    return build_library(SOURCE, GXX_FLAGS, "libgpp_eval3d", compiler="g++")


def _load():
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib = load_library(build)
        except (OSError, RuntimeError) as e:
            _error = str(e)
            return None
        lib.gpp_bev_overlap.restype = ctypes.c_int
        lib.gpp_bev_overlap.argtypes = [_D, ctypes.c_int, _D, ctypes.c_int,
                                        _D]
        lib.gpp_3d_overlap.restype = ctypes.c_int
        lib.gpp_3d_overlap.argtypes = [_D, ctypes.c_int, _D, ctypes.c_int,
                                       _D]
        lib.gpp_compute_stats.restype = ctypes.c_int
        lib.gpp_compute_stats.argtypes = [
            _D, ctypes.c_int, ctypes.c_int,        # overlap, nd, ng
            _D, _I32, _I32,                        # scores, ig_det, ig_gt
            _D, ctypes.c_int,                      # dc_ov, ndc
            _D, _D, ctypes.c_int,                  # alpha_det/gt, aos
            ctypes.c_double, _D, ctypes.c_int,     # min_ov, thresholds, T
            _I64, _I64, _I64, _D]                  # tp, fp, fn, sim
        _lib = lib
        return _lib


def available() -> bool:
    if os.environ.get("GPP_EVAL3D_NATIVE", "1") == "0":
        return False
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (the compiler's or the loader's
    message), or None when it loaded."""
    _load()
    return _error


def _rows5(d) -> np.ndarray:
    """[x, z, ry, l, w] rows from a parsed label dict."""
    return np.ascontiguousarray(
        np.stack([d["loc"][:, 0], d["loc"][:, 2], d["ry"],
                  d["dims"][:, 2], d["dims"][:, 1]], axis=1), np.float64)


def _rows7(d) -> np.ndarray:
    """[x, z, ry, l, w, y, h] rows."""
    return np.ascontiguousarray(
        np.stack([d["loc"][:, 0], d["loc"][:, 2], d["ry"],
                  d["dims"][:, 2], d["dims"][:, 1],
                  d["loc"][:, 1], d["dims"][:, 0]], axis=1), np.float64)


def bev_overlap(det, gt) -> np.ndarray:
    lib = _load()
    nd, ng = len(det["ry"]), len(gt["ry"])
    out = np.zeros((nd, ng), np.float64)
    if nd and ng:
        lib.gpp_bev_overlap(_rows5(det), nd, _rows5(gt), ng, out)
    return out


def overlap_3d(det, gt) -> np.ndarray:
    lib = _load()
    nd, ng = len(det["ry"]), len(gt["ry"])
    out = np.zeros((nd, ng), np.float64)
    if nd and ng:
        lib.gpp_3d_overlap(_rows7(det), nd, _rows7(gt), ng, out)
    return out


def compute_stats(overlap, scores, ignored_det, ignored_gt, dc_ov,
                  alpha_det, alpha_gt, compute_aos: bool,
                  min_overlap: float, thresholds,
                  out_tp, out_fp, out_fn, out_sim) -> None:
    """Accumulate one image's devkit stats across all thresholds.

    out_* are (T,) int64/float64 arrays accumulated IN PLACE across
    images (caller zero-initializes once)."""
    lib = _load()
    nd, ng = overlap.shape
    rc = lib.gpp_compute_stats(
        np.ascontiguousarray(overlap, np.float64), nd, ng,
        np.ascontiguousarray(scores, np.float64),
        np.ascontiguousarray(ignored_det, np.int32),
        np.ascontiguousarray(ignored_gt, np.int32),
        np.ascontiguousarray(dc_ov, np.float64), dc_ov.shape[1],
        np.ascontiguousarray(alpha_det, np.float64),
        np.ascontiguousarray(alpha_gt, np.float64),
        int(compute_aos), float(min_overlap),
        np.ascontiguousarray(thresholds, np.float64), len(thresholds),
        out_tp, out_fp, out_fn, out_sim)
    if rc != 0:
        raise RuntimeError("gpp_compute_stats failed "
                           f"(nd={nd} exceeds the native buffer)")
