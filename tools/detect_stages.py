"""Splits the port's detect call by stage on the card, from the program's
own spans and stage stamps, in a cell of the benchmark.

    python tools/detect_stages.py --workload r50-bf16-b1-stream \
        --seed 7 [--calls 100] [--root ROOT] [--cost-calls 50] \
        [--graph] [--out FILE]

Builds the cell's system as `benchmark/run.py` does (its inputs from the
seed, the port's captured detect call, the warm-up calls), with the
port's stamps on (GPP_TRACE=1), then drives `--calls` calls of the cell's
loop under torch.profiler, as the benchmark's traced slice does, and
reports:
  stages_ms  trunk, filter, polling and pose device ms a call from the
             stamps (utils/profiling.py::stage_ms): median, min, max;
  spans_ms   the host ranges by name (the program's `gpp.*`, the loop's
             `bench.*`): count and median ms;
  busy_s, window_s, busy_ms_per_call  as the benchmark's trace reduces
             them (benchmark/lib/trace.py), and poll_kernel's device ms a
             call where the trace kept its launches;
  gaps       the longest idle gaps of the device, each put down to the
             innermost host range, `gpp.*` or `bench.*`, that holds its
             start, and the idle time by range;
  timer_ns   the granularity of the card's %globaltimer as the stamps see
             it: the smallest step between stamps, with and without a
             profiler recording.
With `--cost-calls N`: the captured call's device ms without stamps and
with them, from two systems of the same weights built with GPP_TRACE unset
and set, in turns (off, on, on, off), CUDA events around N back-to-back
calls of one batch. With `--graph`: the kernel nodes of each system's
graph (cudaGraphDebugDotPrint), and the stamp kernels among them. With
`--root ROOT`, the port is imported from another checkout (for example
the parent commit unpacked with `git archive`): stamps and the cost are
then read only where it has them.

Needs a CUDA card; prints one JSON object as its last line (and writes it
to --out).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
TOP_GAPS = 10


def _host_ranges(events):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in events if e.device_type != cuda
            and e.name.startswith(("gpp.", "bench."))]


def _device_spans(events, w0, w1):
    """[(start, end)] of the device operations inside the window, as
    benchmark/lib/trace.py counts them (host ranges on the device's
    timeline and the spin kernel left out)."""
    cuda = torch.autograd.DeviceType.CUDA
    return sorted((max(e.time_range.start, w0), min(e.time_range.end, w1))
                  for e in events if e.device_type == cuda
                  and "spin_kernel" not in e.name
                  and not e.name.startswith(("bench.", "gpp."))
                  and e.time_range.end > w0 and e.time_range.start < w1)


def labelled_gaps(events):
    """The device's idle gaps in the bench.window range, each with the
    innermost gpp.* or bench.* host range that holds its start: the
    longest TOP_GAPS [(range, ms)], and the idle ms by range."""
    ranges = _host_ranges(events)
    (window,) = [e for e in ranges if e.name == "bench.window"]
    w0, w1 = window.time_range.start, window.time_range.end
    gaps, end = [], w0
    for s, t in _device_spans(events, w0, w1):
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if w1 > end:
        gaps.append((end, w1))
    inner = [e for e in ranges if e.name != "bench.window"]
    named = []
    for s, t in gaps:
        holding = [e for e in inner
                   if e.time_range.start <= s < e.time_range.end]
        name = (min(holding, key=lambda e: e.time_range.elapsed_us()).name
                if holding else "other")
        named.append((name, (t - s) / 1e3))
    by_range = collections.defaultdict(float)
    for name, ms in named:
        by_range[name] += ms
    return (sorted(named, key=lambda g: -g[1])[:TOP_GAPS],
            dict(sorted(by_range.items(), key=lambda kv: -kv[1])))


def span_ms(events):
    """{range name: [count, median ms]} of the gpp.* and bench.* host
    ranges."""
    ms = collections.defaultdict(list)
    for e in _host_ranges(events):
        ms[e.name].append(e.time_range.elapsed_us() / 1e3)
    return {k: [len(v), statistics.median(v)] for k, v in sorted(ms.items())}


def _summary(values):
    return {"median": float(np.median(values)), "min": float(np.min(values)),
            "max": float(np.max(values))}


def stage_table(stages):
    """{stage: median, min, max} of stage_ms's rows, and the medians'
    sum."""
    from ground_plane_polling_tpu_torch.utils.profiling import STAGES

    table = {name: _summary(stages[:, i]) for i, name in enumerate(STAGES)}
    table["sum_of_medians"] = sum(table[n]["median"] for n in STAGES)
    return table


def timer_ns(device, stamps=400):
    """Steps of %globaltimer seen by back-to-back stamps of one call slot:
    the smallest positive step and the greatest common divisor of all."""
    from ground_plane_polling_tpu_torch.utils import profiling

    stamp = profiling.stage_stamps(device)
    ring = profiling._rings[torch.device(device).index or 0]
    times = []
    for _ in range(stamps):
        stamp(0)
        torch.cuda.synchronize(device)
        times.append(int(ring[int(ring[-1]) % profiling.RING
                              * profiling.BOUNDARIES]))
    steps = np.diff(np.asarray(times, dtype=np.int64))
    positive = steps[steps > 0]
    return {"min_step": int(positive.min()) if positive.size else None,
            "gcd": int(np.gcd.reduce(positive)) if positive.size else None,
            "zero_steps": int((steps == 0).sum()), "stamps": stamps}


def graph_kernels(detect):
    """(kernel nodes, stamp kernel nodes) of each graph of a captured call
    whose graphs were made in debug mode."""
    out = []
    for g in detect.graphs.values():
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "graph.dot")
            g.graph.debug_dump(path)
            dot = Path(path).read_text()
        # a node's label opens with its kind; a kernel's names its function
        out.append([dot.count('label="{KERNEL'),
                    dot.count("gpp_stage_stamp")])
    return out


def cost(gen, cfg, traffic, inputs, device, calls, has_stamps):
    """Device ms a call without and with stamps, in turns."""
    systems = {}
    for name, switch in (("off", None), ("on", "1")):
        if name == "on" and not has_stamps:
            continue
        if switch is None:
            os.environ.pop("GPP_TRACE", None)
        else:
            os.environ["GPP_TRACE"] = switch
        systems[name] = gen.build(cfg, inputs, device)
        gen.drive(systems[name], inputs, traffic, device, None,
                  calls=traffic["warmup_calls"])
    batch = traffic["batch"]
    images = inputs.pool.frames[:batch].to(device)
    P_inv = inputs.pool.P_inv[:batch].to(device)
    planes = inputs.planes[None].expand(batch, *inputs.planes.shape)
    times = collections.defaultdict(list)
    order = ["off", "on", "on", "off"] * 3
    for name in order:
        if name not in systems:
            continue
        detect = systems[name]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(calls):
            detect(images, P_inv, planes)
        end.record()
        end.synchronize()
        times[name].append(start.elapsed_time(end) / calls)
    for system in systems.values():
        gen.release(system)
    return {k: {"blocks": v, "median": statistics.median(v)}
            for k, v in times.items()}


def measure(workload, seed, calls, device="cuda", bench=None,
            benchmark=None, cost_calls=0, graph=False):
    from benchmark.lib.readers import POLL_KERNEL
    from benchmark.lib.trace import _reduce, kernel_time
    from benchmark.run import BENCH, cell, load_json, named_module

    bench = bench or BENCH
    benchmark = benchmark or load_json(ROOT / "BENCHMARK.json")
    from ground_plane_polling_tpu_torch.utils import profiling

    has_stamps = hasattr(profiling, "stage_ms")
    device = torch.device(device)
    cuda = device.type == "cuda"
    entry, cfg, traffic = cell(benchmark, workload, bench)
    gen = named_module("lib", traffic["generator"])
    inputs = gen.prepare(cfg, traffic, seed, device)
    result = {"workload": workload, "seed": seed, "calls": calls,
              "stamps": has_stamps,
              "device": torch.cuda.get_device_name(device) if cuda
              else "cpu"}
    real_graph = torch.cuda.CUDAGraph
    if graph:
        def debugged():
            g = real_graph(keep_graph=True)  # kept for its dump
            g.enable_debug_mode()
            return g
        torch.cuda.CUDAGraph = debugged
    try:
        os.environ["GPP_TRACE"] = "1"
        system = gen.build(cfg, inputs, device)
        gen.drive(system, inputs, traffic, device, None,
                  calls=traffic["warmup_calls"])
        if graph:
            result["graph_kernels_on"] = graph_kernels(system)
            os.environ.pop("GPP_TRACE")
            plain = gen.build(cfg, inputs, device)
            gen.drive(plain, inputs, traffic, device, None,
                      calls=traffic["warmup_calls"])
            result["graph_kernels_off"] = graph_kernels(plain)
            gen.release(plain)
            os.environ["GPP_TRACE"] = "1"
    finally:
        torch.cuda.CUDAGraph = real_graph
    # the cell's loop unprofiled: the host's dispatch ms and the stages
    plain = gen.drive(system, inputs, traffic, device, None, calls=calls,
                      start=traffic["warmup_calls"])[0]
    result["dispatch_ms_unprofiled"] = statistics.median(
        c.dispatch_ms for c in plain)
    if has_stamps and cuda:
        result["stages_ms_unprofiled"] = stage_table(
            profiling.stage_ms(device, last=len(plain)))
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        if cuda:
            torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize(device)
        with record_function("bench.window"):
            done = gen.drive(system, inputs, traffic, device, None,
                             calls=calls, start=traffic["warmup_calls"],
                             named=True)[0]
        if cuda:
            torch.cuda.synchronize(device)
    events = prof.events()
    trace = _reduce(events, done)
    result["dispatch_ms_profiled"] = statistics.median(
        c.dispatch_ms for c in done)
    result.update(busy_s=trace.busy_s, window_s=trace.window_s,
                  busy_ms_per_call=trace.busy_s * 1e3 / len(done),
                  spans_ms=span_ms(events))
    launches, seconds = kernel_time(trace, POLL_KERNEL)
    result["poll_kernel"] = {"launches": launches,
                             "ms_per_launch": (seconds * 1e3 / launches
                                               if launches else None)}
    result["gaps"], result["idle_ms_by_range"] = labelled_gaps(events)
    if has_stamps and cuda:
        stages = profiling.stage_ms(device, last=len(done))
        result["stages_ms"] = stage_table(stages)
        result["stamped_calls"] = len(stages)
        result["timer_ns"] = timer_ns(device)
        with profile(activities=activities):
            result["timer_ns_profiled"] = timer_ns(device)
    gen.release(system)
    if cost_calls and cuda:
        result["device_ms_per_call"] = cost(gen, cfg, traffic, inputs,
                                            device, cost_calls, has_stamps)
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--calls", type=int, default=100)
    parser.add_argument("--cost-calls", type=int, default=0)
    parser.add_argument("--graph", action="store_true")
    parser.add_argument("--root", default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    result = measure(args.workload, args.seed, args.calls,
                     cost_calls=args.cost_calls, graph=args.graph)
    result["root"] = args.root
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
