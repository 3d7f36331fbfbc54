"""Fixtures of the benchmark's own tests: a copy of the benchmark's files
in a temporary directory with every cell cut to a size a CPU test holds
(the published widths, a 64 x 224 canvas, 512 planes, small pools), and
a helper that runs a cell there on the CPU, past the harness's look for a
card."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"canvas": [64, 224], "frame": [60, 210], "planes": 512,
        "calibration_frames": 2}
TINY_TRAFFIC = {"pool": 8, "warmup_calls": 1, "trace_calls": 2,
                "check_frames": 4}
# Limits of the check at the tiny size, with the keys each configuration
# compares, set between CPU readings of the sound program (seeds 11-14)
# and of the controls (seeds 21-22) there (score and choice gaps in
# logits; `.p50` the largest over the batch positions of a position's
# median; the choice gap the mean over the frames): bf16 sound
# score_gap.p50 <= 0.0132, box_gap.p50 <= 0.0233, choice_gap <= 0.026,
# the int8 program in its place 0.046-0.063, 0.086-0.133, 0.12-0.22, the
# NMS at 0.3 a choice gap of 0.18; int8 sound score_gap.p50 <= 0.068,
# box_gap <= 0.27, box_gap.p50 <= 0.13, dims_gap.p50 <= 0.011, choice_gap
# <= 0.31, the int4 reference in its place 2.7-2.8, 3.5-4.5, 1.2-1.9,
# 0.19-0.23, 3.8-5.5, the NMS at 0.3 a choice gap of 0.54; half of the
# detections dropped a choice gap of 1.2-1.6; residual_gap <= 1.9e-6 m
# and the other polling and pose gaps 0 on the CPU (the port's CPU path
# and the reference run the same float32 operations there), bf16 polling
# in their place 1.5e3-8.1e5 m, 0.010-0.011, 0.0022-0.031 and 2.
_POLL = {"short_frames": 0.0, "nms_overlap": 0.0, "residual_gap": 1e-3,
         "plane_gap": 1e-4, "keypoint_gap": 1e-4, "pose_gap": 1e-4}
TINY_LIMITS = {
    "gpp-r50-fpn512-bf16": {"score_gap.p50": 0.025, "box_gap.p50": 0.045,
                            "choice_gap": 0.06, **_POLL},
    "gpp-r50-fpn512-int8": {"score_gap.p50": 0.4, "box_gap": 1.0,
                            "box_gap.p50": 0.4, "dims_gap.p50": 0.05,
                            "choice_gap": 0.45, **_POLL},
}


def make_tiny(dst: Path, limits=TINY_LIMITS) -> dict:
    """Copy the benchmark's configurations, mixes and metrics to `dst`,
    every configuration cut to the tiny size, with the tiny size's limits
    (`limits`: configuration name -> limits); returns its BENCHMARK
    object."""
    for kind in ("configs", "traffic", "metrics"):
        shutil.copytree(BENCH / kind, dst / kind)
    for path in (dst / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(TINY)
        if limits and cfg["name"] in limits:
            cfg["limits"] = dict(limits[cfg["name"]])
        path.write_text(json.dumps(cfg))
    for path in (dst / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(TINY_TRAFFIC)
        path.write_text(json.dumps(mix))
    benchmark = json.loads((ROOT / "BENCHMARK.json").read_text())
    (dst / "BENCHMARK.json").write_text(json.dumps(benchmark))
    return benchmark


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(benchmark object, directory) of the tiny copy."""
    dst = tmp_path_factory.mktemp("tiny_bench")
    return make_tiny(dst), dst


def run_tiny(benchmark, bench, workload, seed=987654321012, seconds=0.3,
             trace=False, **kw):
    from benchmark.run import run

    return run(workload, seed, seconds, trace, device="cpu",
               benchmark=benchmark, bench=bench,
               t_start=time.perf_counter(), **kw)
