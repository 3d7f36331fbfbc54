"""The traced window: torch.profiler (CUPTI) over a slice of calls after
the measured window, reduced to what the per-layer readers need.

A spinning kernel goes first and is left out, since the card's traces
have been seen to lose their first device events. The window is the
host range `bench.window` around the slice; `busy_s` is the union of the
device operations' intervals (kernels, copies, sets) inside it. Idle gaps
are the holes in that union, each put down to the innermost `bench.*`
host range that holds its start.
"""

from __future__ import annotations

import collections
import re
from typing import NamedTuple

import torch

__all__ = ["Trace", "profile_calls", "kernel_time"]


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    ops: dict            # device op name -> (count, seconds)
    gaps: list           # the 10 longest [(host range, seconds)]
    calls: list          # the calls of the slice


def profile_calls(run_slice, cuda: bool = True):
    """Profile run_slice() -> calls; returns a Trace (with no device
    operations where `cuda` is false: the CPU tests)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        if cuda:
            torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()
        with torch.profiler.record_function("bench.window"):
            calls = run_slice()
        if cuda:
            torch.cuda.synchronize()
    return _reduce(prof.events(), calls)


def _reduce(events, calls) -> Trace:
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type != cuda
            and e.name.startswith("bench.")]
    window = [e for e in host if e.name == "bench.window"]
    if not window:
        raise RuntimeError("the trace holds no bench.window range")
    w0 = window[0].time_range.start
    w1 = window[0].time_range.end
    # the host ranges show on the device's timeline too: left out
    device = [e for e in events if e.device_type == cuda
              and "spin_kernel" not in e.name
              and not e.name.startswith("bench.")
              and e.time_range.end > w0 and e.time_range.start < w1]
    ops = collections.defaultdict(lambda: [0, 0.0])
    spans = []
    for e in device:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        ops[e.name][0] += 1
        ops[e.name][1] += (t - s) / 1e6
        spans.append((s, t))
    spans.sort()
    busy, gaps, end = 0.0, [], w0
    for s, t in spans:
        if s > end:
            gaps.append((end, s))
        if t > end:
            busy += t - max(s, end)
            end = t
    if w1 > end:
        gaps.append((end, w1))
    ranges = [e for e in host if e.name != "bench.window"]
    labelled = []
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        inside = [e for e in ranges
                  if e.time_range.start <= s < e.time_range.end]
        name = (min(inside, key=lambda e: e.time_range.elapsed_us()).name
                [len("bench."):] if inside else "other")
        labelled.append((name, (t - s) / 1e6))
    labelled.sort(key=lambda g: -g[1])
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6,
                 ops={k: tuple(v) for k, v in ops.items()},
                 gaps=labelled, calls=calls)


def kernel_time(trace: Trace, pattern: str):
    """(launches, seconds) of the device ops whose name matches
    `pattern` (a regular expression searched in the name)."""
    rx = re.compile(pattern)
    n, s = 0, 0.0
    for name, (count, seconds) in trace.ops.items():
        if rx.search(name):
            n += count
            s += seconds
    return n, s


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The contract's breakdown: the device ops that took most time, and
    the longest idle gaps by the host's range."""
    ops = sorted(trace.ops.items(), key=lambda kv: -kv[1][1])[:top]
    return {"device_ops": [[name[:160], seconds]
                           for name, (_, seconds) in ops],
            "idle_gaps": [[name, seconds]
                          for name, seconds in trace.gaps[:top]]}
