"""What a run loads: never JAX nor the JAX package (compared by whole
top-level names, since the port's name begins with the JAX package's),
and the plain reference nothing of the port."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "ground_plane_polling_tpu"}


def _child(code: str) -> dict:
    done = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_port():
    tops = _child("""
        import json, sys
        sys.path.insert(0, ".")
        import benchmark.reference.model, benchmark.reference.pipeline
        import benchmark.reference.judge, benchmark.lib.bounds
        print(json.dumps(sorted({m.partition(".")[0]
                                 for m in sys.modules})))
    """)
    assert "ground_plane_polling_tpu_torch" not in tops
    assert not FORBIDDEN & set(tops)


def test_a_run_loads_no_jax():
    out = _child("""
        import json, sys, time
        sys.path.insert(0, "."); sys.path.insert(0, "benchmark/tests")
        import tempfile
        from pathlib import Path
        from conftest import make_tiny
        from benchmark import run as harness
        d = Path(tempfile.mkdtemp())
        b = make_tiny(d)
        r = harness.run("r50-bf16-b1-stream", 3, 0.2, True, device="cpu",
                        benchmark=b, bench=d, t_start=time.perf_counter())
        tops = sorted({m.partition(".")[0] for m in sys.modules})
        print(json.dumps({"tops": tops,
                          "forbidden": harness.forbidden_modules(),
                          "metrics": sorted(r["metrics"])}))
    """)
    assert out["forbidden"] == []
    assert "ground_plane_polling_tpu_torch" in out["tops"]
    assert not FORBIDDEN & set(out["tops"])


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from benchmark.run import forbidden_modules

    fake = dict.fromkeys(["ground_plane_polling_tpu_torch",
                          "ground_plane_polling_tpu_torch.ops",
                          "jaxtyping", "flaxen", "torch"])
    monkeypatch.setattr(sys, "modules", fake)
    assert forbidden_modules() == []
    fake["jax.numpy"] = None
    fake["ground_plane_polling_tpu.ops"] = None
    assert forbidden_modules() == ["ground_plane_polling_tpu", "jax"]
