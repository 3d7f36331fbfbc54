"""Build a CUDA source of the package with nvcc, at first use, into a shared
library with a plain C interface in `_build/` beside the package (loaded
with ctypes by the kernels' wrappers). A library is named by a hash of its
flags, its source and every header the source reaches by `#include` in its
own directory or an `-I` directory of the flags, so a changed source,
header or flag builds anew; nvcc's report lands beside it as `.log`."""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "build_key", "build_library", "nvcc",
           "sources_of"]

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


def build_library(source: Path, flags, name: str) -> Path:
    """Compile `source` with `flags` (once per `build_key`) into
    `_build/{name}_{key}.so` and return its path."""
    out = BUILD_DIR / f"{name}_{build_key(source, flags)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source}:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: concurrent builds agree on one file
    return out
