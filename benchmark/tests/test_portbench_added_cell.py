"""A later change adds a cell by adding files alone: a configuration (here
one that builds the program with `pack_levels`), a traffic mix and a
per-layer metric, written here into a copy of the benchmark, and the
harness runs them, unchanged, by their names."""

from __future__ import annotations

import json

import pytest

from conftest import make_tiny, run_tiny

READER = '''"""calls_per_s.added: detect calls finished a second."""


def read(ctx):
    return len(ctx.calls) / ctx.window_s if ctx.window_s > 0 else None
'''


def _added(tmp_path, **build):
    """The tiny benchmark in `tmp_path` with a cell `added-b2` of a new
    configuration (the bf16 one with `build` options and its own limits)
    under a new mix and a new metric."""
    benchmark = make_tiny(tmp_path)
    cfg = json.loads((tmp_path / "configs" / "gpp-r50-fpn512-bf16.json")
                     .read_text())
    cfg.update(name="gpp-added", cls_out_std=0.02)
    cfg["build"] = {**cfg["build"], **build}
    (tmp_path / "configs" / "gpp-added.json").write_text(json.dumps(cfg))
    mix = {"generator": "loop", "batch": 2, "in_flight": 1, "pool": 4,
           "warmup_calls": 1, "trace_calls": 2, "check_frames": 2}
    (tmp_path / "traffic" / "offline-b2.json").write_text(json.dumps(mix))
    (tmp_path / "metrics" / "calls_per_s.added.py").write_text(READER)
    benchmark["workloads"].append({
        "name": "added-b2", "config": "gpp-added", "traffic": "offline-b2",
        "chips": 1, "why": "added from files alone"})
    benchmark["end_to_end"][0]["workloads"].append("added-b2")
    benchmark["per_layer"].append({
        "name": "calls_per_s.added", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "host loop",
        "moves": "detect_img_per_s", "workloads": ["added-b2"]})
    return benchmark


def test_a_cell_from_new_files_runs(tmp_path, monkeypatch):
    import ground_plane_polling_tpu_torch.models as models

    built = []
    real = models.build_detector

    def spy(*args, **kw):
        built.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(models, "build_detector", spy)
    benchmark = _added(tmp_path, pack_levels=True)
    result = run_tiny(benchmark, tmp_path, "added-b2", seconds=0.2)
    assert built and all(kw["pack_levels"] for kw in built)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"detect_img_per_s", "setup_s"}
    assert result["attempted"] % 2 == 0
    traced = run_tiny(benchmark, tmp_path, "added-b2", seconds=0.2,
                      trace=True)
    assert "calls_per_s.added" in traced["metrics"]
    assert "host_dispatch_ms.offline" not in traced["metrics"]


def test_a_build_option_the_reference_does_not_follow_is_refused(tmp_path):
    benchmark = _added(tmp_path, orientation_specific=True)
    with pytest.raises(ValueError, match="orientation_specific"):
        run_tiny(benchmark, tmp_path, "added-b2", seconds=0.2)
