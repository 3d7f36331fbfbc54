"""ctypes bindings for the native C++ image loader (native/gpp_loader.cpp,
port of ground_plane_polling_tpu/data/native_loader.py).

The library is built with g++ at first use into `_build/`, keyed by its
source and flags (kernels/nvcc_build.py), with the JAX package's flags, so
that its pixels are the JAX package's. It decodes PNG and JPEG, converts to
BGR, resizes bilinearly in float and zero-pads into a canvas, off the GIL
on a C++ thread pool. `available()` says whether it built; `build_error()`
keeps the compiler's message when it did not, and data/pipeline.py then
takes the cv2/PIL path, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..kernels.nvcc_build import build_library, load_library

__all__ = ["available", "build", "build_error", "NativeImageLoader",
           "SOURCE", "GXX_FLAGS", "GXX_LIBS"]

SOURCE = Path(__file__).resolve().parent.parent / "native" / "gpp_loader.cpp"
# the JAX package's command: g++ -O3 -shared -fPIC -std=c++17 SRC -lpng
# -ljpeg -pthread (no -march=native, no fast-math)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
GXX_LIBS = ("-lpng", "-ljpeg", "-pthread")

_lock = threading.Lock()
_lib = None
_error: Optional[str] = None


def build() -> Path:
    """Compile the library (once per source and flags); returns its path.
    Raises RuntimeError with g++'s errors, or OSError without g++."""
    return build_library(SOURCE, GXX_FLAGS, "libgpp_loader", compiler="g++",
                         libs=GXX_LIBS)


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
        lib.gpp_load_image.restype = ctypes.c_int
        lib.gpp_load_image.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.gpp_load_batch.restype = ctypes.c_int
        lib.gpp_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int]
        lib.gpp_image_size.restype = ctypes.c_int
        lib.gpp_image_size.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (the compiler's or the loader's
    message), or None when it loaded."""
    _load()
    return _error


class NativeImageLoader:
    """Image loading through the C++ library."""

    def __init__(self, n_threads: int = 8):
        self.lib = _load()
        if self.lib is None:
            raise RuntimeError(f"native loader unavailable: {_error}")
        self.n_threads = n_threads

    def image_size(self, path: str):
        """(h, w) of an image file (a PNG's header only)."""
        h = ctypes.c_int()
        w = ctypes.c_int()
        if self.lib.gpp_image_size(path.encode(), ctypes.byref(h),
                                   ctypes.byref(w)) != 0:
            raise IOError(f"cannot probe {path}")
        return h.value, w.value

    def load_image(self, path: str, out_hw, scale: float) -> np.ndarray:
        """One image -> zero-padded float32 BGR canvas (out_h, out_w, 3)."""
        out = np.empty((*out_hw, 3), np.float32)
        h = ctypes.c_int()
        w = ctypes.c_int()
        rc = self.lib.gpp_load_image(
            path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out_hw[0], out_hw[1], scale, ctypes.byref(h), ctypes.byref(w))
        if rc != 0:
            raise IOError(f"cannot decode {path}")
        return out

    def load_batch(self, paths: Sequence[str], out_hw,
                   scales: Sequence[float]) -> np.ndarray:
        """Threaded batch -> (N, out_h, out_w, 3) float32 BGR, zero-padded."""
        n = len(paths)
        out = np.zeros((n, *out_hw, 3), np.float32)
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        c_scales = np.asarray(scales, np.float64)
        if c_scales.shape != (n,):
            raise ValueError(f"{n} paths but scales of shape "
                             f"{c_scales.shape}")
        failures = self.lib.gpp_load_batch(
            c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out_hw[0], out_hw[1],
            c_scales.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            self.n_threads)
        if failures:
            raise IOError(f"{failures}/{n} images failed to decode")
        return out
