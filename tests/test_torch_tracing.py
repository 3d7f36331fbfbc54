"""The port's tracing (utils/profiling.py) on the CPU: `span` records
nothing and costs one check without a profiler, and a `gpp.` host range
with one; the eager detect call's spans and their order; the device stage
stamps, which nothing builds or launches without GPP_TRACE=1 and never
off a card; and the ring's read-back arithmetic, on a ring held on the
CPU. The stamps themselves run on the card (tests/test_torch_gpu.py)."""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ground_plane_polling_tpu_torch
from ground_plane_polling_tpu_torch import inference
from ground_plane_polling_tpu_torch.kernels import nvcc_build
from ground_plane_polling_tpu_torch.models import (build_detector,
                                                   init_detector)
from ground_plane_polling_tpu_torch.utils import profiling
from ground_plane_polling_tpu_torch.utils.profiling import span

CANVAS = (64, 128)


def _tiny_detect():
    """(the eager detect call of a seeded tiny-backbone detector on the
    CPU, pose on, its inputs)"""
    model = init_detector(build_detector("tiny", feature_size=16), 0).eval()
    detect = inference.make_detect_fn(model, CANVAS, with_pose=True,
                                      device_preprocess=True, device="cpu",
                                      score_threshold=0.005)
    rng = np.random.RandomState(0)
    P = np.array([[721.5, 0.0, 609.6, 44.9], [0.0, 721.5, 172.9, 0.2],
                  [0.0, 0.0, 1.0, 0.003]])
    args = (rng.randint(0, 256, (2, *CANVAS, 3)).astype(np.uint8),
            np.tile(np.linalg.pinv(P)[None], (2, 1, 1)).astype(np.float32),
            np.tile(np.array([[0.0, 1.0, 0.0, -1.65]], np.float32),
                    (2, 7, 1)))
    return detect, args


def _gpp_ranges(prof):
    return [e for e in prof.events() if e.name.startswith("gpp.")]


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    """No profiler: every span is one shared null context, and no range is
    made (the range type raises if it is)."""
    def refuse(name):
        raise AssertionError(f"a range {name!r} with no profiler")

    monkeypatch.setattr(profiling, "_Range", refuse)
    first, second = span("trunk"), span("detect.replay")
    assert first is second is profiling._NULL
    with first:
        torch.ones(2) + 1


def test_span_records_a_gpp_range_under_the_profiler():
    """Under torch.profiler on the CPU a span is the host range
    "gpp.<name>", around the operations of its block, nested in the span
    that holds it, and of the FUNCTION scope (0), which the profiler does
    not copy onto the device's timeline."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer"):
            with span("inner"):
                torch.ones(4) + 1
    ranges = {e.name: e for e in _gpp_ranges(prof)}
    assert set(ranges) == {"gpp.outer", "gpp.inner"}
    outer, inner = ranges["gpp.outer"], ranges["gpp.inner"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert {e.name for e in inner.cpu_children} >= {"aten::ones",
                                                     "aten::add"}
    assert outer.scope == inner.scope == 0


def test_eager_detect_spans_its_stages_in_order():
    """An eager detect call under the profiler is one gpp.detect range
    holding gpp.trunk, gpp.filter, gpp.polling and gpp.pose, one each, in
    that order and without overlap; its outputs equal an unprofiled
    call's, bit for bit."""
    detect, args = _tiny_detect()
    want = detect(*args)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = detect(*args)
    for key, value in want._asdict().items():
        torch.testing.assert_close(getattr(got, key), value, rtol=0, atol=0)
    ranges = _gpp_ranges(prof)
    (call,) = [e for e in ranges if e.name == "gpp.detect"]
    stages = sorted((e for e in ranges if e.name != "gpp.detect"),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in stages] == ["gpp.trunk", "gpp.filter",
                                        "gpp.polling", "gpp.pose"]
    for a, b in zip(stages, stages[1:]):
        assert a.time_range.end <= b.time_range.start
    assert call.time_range.start <= stages[0].time_range.start
    assert stages[-1].time_range.end <= call.time_range.end


@pytest.mark.parametrize("switch", [None, "1"])
def test_cpu_detect_never_builds_the_stamp_library(monkeypatch, switch):
    """With GPP_TRACE unset, and even with it on, a detect call on the CPU
    never asks for the stamp library and keeps no ring."""
    def refuse(*args, **kwargs):
        raise AssertionError("a build on the CPU detect path")

    if switch is None:
        monkeypatch.delenv("GPP_TRACE", raising=False)
    else:
        monkeypatch.setenv("GPP_TRACE", switch)
    monkeypatch.setattr(nvcc_build, "build_library", refuse)
    monkeypatch.setattr(profiling, "_rings", {})
    detect, args = _tiny_detect()
    assert detect(*args).scores.shape == (2, 100)
    assert profiling._rings == {}
    assert profiling.stage_stamps("cpu") is profiling._no_stamp
    assert profiling.stage_ms("cuda:0") is None


def test_stamps_are_off_on_a_card_without_the_switch(monkeypatch):
    """stage_stamps for a CUDA device, GPP_TRACE unset or not "1": the
    no-op, before any build or allocation."""
    monkeypatch.setattr(nvcc_build, "build_library", None)
    for value in (None, "0", "true"):
        if value is None:
            monkeypatch.delenv("GPP_TRACE", raising=False)
        else:
            monkeypatch.setenv("GPP_TRACE", value)
        assert profiling.stage_stamps("cuda:0") is profiling._no_stamp


@pytest.mark.parametrize("count,last,slots", [
    (3, 10, [0, 1, 2]),            # fewer calls than asked for
    (5, 2, [3, 4]),
    (profiling.RING + 2, 4, [profiling.RING - 2, profiling.RING - 1, 0, 1]),
])
def test_stage_ms_reads_the_last_calls_of_the_ring(monkeypatch, count, last,
                                                   slots):
    """The last calls' rows, oldest first, across the ring's wrap; each
    row's four stages are the differences of its five stamps, in ms."""
    ring = torch.zeros(profiling.RING * profiling.BOUNDARIES + 1,
                       dtype=torch.int64)
    rows = ring[:-1].view(profiling.RING, profiling.BOUNDARIES)
    for slot in range(profiling.RING):
        rows[slot] = slot * 10**7 + torch.tensor([0, 4, 5, 7, 11]) * (
            slot + 1) * 1000
    ring[-1] = count
    monkeypatch.setattr(profiling, "_rings", {0: ring})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    got = profiling.stage_ms("cuda:0", last=last)
    want = [[0.004 * (s + 1), 0.001 * (s + 1), 0.002 * (s + 1),
             0.004 * (s + 1)] for s in slots]
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_no_record_function_outside_profiling():
    """Every host range of the package goes through utils/profiling.py:
    no other module calls record_function or makes a range itself."""
    package = Path(ground_plane_polling_tpu_torch.__file__).parent
    found = [str(p.relative_to(package)) for p in package.rglob("*.py")
             if p.name != "profiling.py"
             and any(word in p.read_text()
                     for word in ("record_function", "_RecordFunction"))]
    assert found == []
