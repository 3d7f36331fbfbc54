"""Tracing and profiling hooks (port of ground_plane_polling_tpu/utils/
profiling.py): wall-clock stage timers and torch.profiler traces.

Usage:
    with trace("inference", logdir="/tmp/trace"):   # device trace
        out = detect(...)

    timer = StageTimer()
    with timer.stage("forward") as s:
        s.result = detect(...)      # timer waits for s.result's device
    print(timer.summary())
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Optional

import torch

__all__ = ["trace", "StageTimer"]


@contextlib.contextmanager
def trace(name: str, logdir: Optional[str] = None):
    """torch.profiler trace around a block, the CPU and, where there is
    one, the card, with the block as a `record_function(name)` range; the
    Chrome trace lands under `logdir` as `{name}.{pid}.{ns}.pt.trace.json`
    (TensorBoard's profiler plugin reads it). A no-op when logdir is
    None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(name):
            yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        logdir, f"{name}.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def _cuda_devices(obj, found):
    """The CUDA devices of the tensors in `obj` (nested tuples, lists,
    named tuples and dicts)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, found)
    return found


class StageTimer:
    """Accumulating wall-clock timers that wait for the stage's result.

    Store the stage's output on the yielded holder so the timer can wait
    for it: CUDA work is queued, and without waiting a "stage" records
    only the time to queue it:

        with timer.stage("forward") as s:
            s.result = detect_fn(images)

    At the end of the stage the timer synchronizes every CUDA device that
    holds a tensor of the result (nothing for CPU tensors)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    class _Holder:
        result = None

    @contextlib.contextmanager
    def stage(self, name: str):
        holder = self._Holder()
        t0 = time.perf_counter()
        yield holder
        for device in _cuda_devices(holder.result, set()):
            torch.cuda.synchronize(device)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> str:
        rows = []
        for name in self.totals:
            mean_ms = 1e3 * self.totals[name] / max(self.counts[name], 1)
            rows.append(f"{name}: {mean_ms:.2f} ms avg "
                        f"({self.counts[name]} calls)")
        return "; ".join(rows)
