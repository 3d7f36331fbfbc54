"""Shared arithmetic of the metric readers (metrics/<name>.py). A reader
that finds nothing to read returns None, and the run leaves the metric
out; a share of a peak or a roofline is never given as 0 for want of a
reading."""

from __future__ import annotations

import statistics

import numpy as np

from .bounds import int8_conv_bound_ms, poll_bound_ms
from .trace import kernel_time

__all__ = ["host_dispatch_ms", "mfu_pct", "idle_pct", "poll_roofline_pct",
           "conv_roofline_pct"]

POLL_KERNEL = r"\bpoll_kernel\b"
CONV_KERNEL = r"\bconv_kernel<"


def host_dispatch_ms(ctx):
    """Median host ms from the detect call's dispatch to its return, over
    the window's calls."""
    if not ctx.calls:
        return None
    return statistics.median(c.dispatch_ms for c in ctx.calls)


def mfu_pct(ctx):
    """The reference's FLOPs a frame times the frames the window finished,
    over its seconds, as a share of the configuration's peak."""
    if not ctx.calls or ctx.window_s <= 0:
        return None
    rate = ctx.flops_per_frame * ctx.frames / ctx.window_s
    return 100.0 * rate / ctx.peak_ops


def idle_pct(ctx):
    """Share of the traced window with no device operation running."""
    t = ctx.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def _kernel_ms(ctx, pattern, per_call):
    """Device ms of one call's launches of a kernel, averaged over the
    launches the trace kept (`per_call` a call); None where it kept fewer
    than half of them: a trace on the card's machine can lose events."""
    t = ctx.trace
    if t is None:
        return None
    launches, seconds = kernel_time(t, pattern)
    want = per_call * len(t.calls)
    if launches > want or launches < want / 2 or seconds <= 0:
        return None
    return seconds * 1e3 / launches * per_call


def poll_roofline_pct(ctx):
    """The polling call's least time (each call's valid detections a
    frame, averaged over the traced calls) over the polling kernel's
    device ms a call."""
    ms = _kernel_ms(ctx, POLL_KERNEL, 1)
    if ms is None:
        return None
    calls = ctx.trace.calls
    bound_ms = sum(poll_bound_ms(
        [int(n) for n in (np.asarray(c.outputs["labels"]) >= 0).sum(axis=1)],
        ctx.cfg["max_detections"], ctx.cfg["planes"])
        for c in calls) / len(calls)
    return 100.0 * bound_ms / ms


def conv_roofline_pct(ctx):
    """The int8 conv sites' least time, summed over a call's sites, over
    the int8 conv kernel's device ms a call; None without the kernel."""
    sites = ctx.conv_sites
    ms = _kernel_ms(ctx, CONV_KERNEL, len(sites))
    if ms is None:
        return None
    return 100.0 * sum(int8_conv_bound_ms(x, w, y, 2)
                       for x, w, y in sites) / ms
