"""Build a source of the package at first use into a shared library with a
plain C interface in `_build/` beside the package (loaded with ctypes): the
CUDA kernels with nvcc, the host libraries of `native/` with g++. A library
is named by a hash of its flags, its source and every header the source
reaches by `#include` in its own directory or an `-I` directory of the
flags, so a changed source, header or flag builds anew; the compiler's
report lands beside it as `.log`. Each build writes a file of its own
process and renames it into place, so processes that build at once agree
on one library."""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "build_key", "build_library", "error_line",
           "load_library", "nvcc", "sources_of"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_INCLUDE = re.compile(rb'^\s*#\s*include\s*([<"])([^>"]+)[>"]', re.M)


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _include_dirs(flags):
    dirs, flags = [], list(flags)
    for i, f in enumerate(flags):
        if f == "-I" and i + 1 < len(flags):
            dirs.append(Path(flags[i + 1]))
        elif f.startswith("-I") and len(f) > 2:
            dirs.append(Path(f[2:]))
    return dirs


def sources_of(source: Path, flags=()) -> list:
    """`source` and every file it includes, transitively, that lies beside
    the including file (quoted includes) or in an `-I` directory of
    `flags`, in a fixed order. Headers found nowhere there (the toolkit's,
    the system's) are left out."""
    dirs = _include_dirs(flags)
    seen, order, todo = set(), [], [Path(source).resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        order.append(path)
        for quote, name in _INCLUDE.findall(path.read_bytes()):
            name = name.decode()
            where = ([path.parent] if quote == b'"' else []) + dirs
            for d in where:
                hit = d / name
                if hit.is_file():
                    todo.append(hit.resolve())
                    break
    return order


def build_key(source: Path, flags) -> str:
    """Hash of the flags and of the contents of `sources_of(source, flags)`
    (each with its path relative to the source's directory or absolute)."""
    h = hashlib.sha256(" ".join(flags).encode())
    base = Path(source).resolve().parent
    for path in sources_of(source, flags):
        name = (path.relative_to(base) if path.is_relative_to(base)
                else path)
        h.update(b"\0" + str(name).encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def build_library(source: Path, flags, name: str, compiler=None,
                  libs=()) -> Path:
    """Compile `source` with `flags` (once per `build_key` of the flags and
    `libs`) into `_build/{name}_{key}.so` and return its path: `compiler`
    (default nvcc) runs as `compiler *flags source *libs -o out`, the
    libraries after the source that needs them. Raises RuntimeError with
    the compiler's errors if it fails, OSError if it cannot be run."""
    out = BUILD_DIR / f"{name}_{build_key(source, (*flags, *libs))}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    compiler = compiler or nvcc()
    proc = subprocess.run(
        [compiler, *flags, str(source), *libs, "-o", str(tmp)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed "
                           f"({proc.returncode}) on {source}:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: concurrent builds agree on one file
    return out


def load_library(build) -> ctypes.CDLL:
    """ctypes.CDLL of the library that `build()` returns. A file that does
    not load (copied from a machine with other shared libraries) is
    removed and built once more; raises OSError or RuntimeError if that
    fails too."""
    path = build()
    try:
        return ctypes.CDLL(str(path))
    except OSError:
        path.unlink(missing_ok=True)
        return ctypes.CDLL(str(build()))


def error_line(message) -> str:
    """The line of a build's error message that says what failed (the
    compiler's first error, else its last line); "" for no message."""
    lines = (message or "").strip().splitlines()
    return next((ln for ln in lines if "error" in ln),
                lines[-1] if lines else "")
