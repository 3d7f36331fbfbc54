"""The PyTorch port stands alone: it imports with JAX blocked, and no file
of it (nor chip_smoke.py) imports JAX or the JAX package."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "ground_plane_polling_tpu_torch"

_BLOCKED = ("jax", "jaxlib", "flax", "optax", "ground_plane_polling_tpu")


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        f"for m in {_BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        f"{_BLOCKED!r} and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax)\b|from\s+(jax|flax)\b)|"
    r"ground_plane_polling_tpu\.|\bjax\b", re.MULTILINE)


@pytest.mark.parametrize(
    "path", sorted(list(PORT.rglob("*.py")) + list(PORT.rglob("*.cu"))
                   + [REPO / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_reference_in_port_sources(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


def test_polling_wrapper_has_no_fallback():
    """A CUDA tensor goes through the kernel or raises: the wrapper has no
    try/except that could fall back to the twin."""
    src = (PORT / "kernels" / "polling_cuda.py").read_text()
    assert not re.search(r"^\s*(try|except)\b", src, re.MULTILINE)
