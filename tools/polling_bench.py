"""Times the PyTorch port's polling kernel on the card and reads what its
build and its launches say about it.

    python tools/polling_bench.py [--against ROOT] [--out FILE]

For each tree (this checkout and, with --against, the package of another
checkout, for example the parent commit unpacked with `git archive`) and
each shape (B, D, P) in SHAPES, on random_case inputs:
  call_ms    the whole `fit_road_planes` call, median of CALLS calls with
             CUDA events around each, after warm-up; trees are timed in
             turns: other, this, this, other;
  host_ms    the host time until the call returns, median of CALLS;
  kernel_ms  the polling kernel's device time per call, and the number of
             device kernels per call, from torch.profiler; the trace's
             launch figures (grid, block, registers, blocks and warps per
             SM, Kineto's estimate of the achieved occupancy);
  issue_slot_share  the share of the card's issue slots that the plane
             loop fills, a lower bound derived from the SASS count and
             kernel_ms;
and for each tree's built library, from `cuobjdump -sass`, the kernel's
SASS: instructions in its plane loop and per (detection, plane) pair (the
loop's compares with the 0.7 m vote threshold, 6 a pair, give the pairs
per iteration; a build whose SASS writes the threshold otherwise gets no
loop figures).

Needs a CUDA card; prints one JSON object as its last line (and writes it
to --out).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = ((1, 100, 21634), (4, 100, 21634))
CALLS = 50


def cuda_ms(fn, calls=CALLS, warmup=5):
    """Median milliseconds of one call of fn(), CUDA events around each of
    `calls` calls, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def host_ms(fn, calls=CALLS, warmup=5):
    """Median host milliseconds until fn() returns, the card idle at each
    start (the time the caller waits to enqueue the call)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def load_tree(root, alias):
    """(polling_cuda, polling_cases) of the package in checkout `root`,
    imported under the top-level name `alias`."""
    if root is None:
        from ground_plane_polling_tpu_torch.kernels import (polling_cases,
                                                            polling_cuda)
        return polling_cuda, polling_cases
    pkg = Path(root).resolve() / "ground_plane_polling_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return (importlib.import_module(f"{alias}.kernels.polling_cuda"),
            importlib.import_module(f"{alias}.kernels.polling_cases"))


def case_tensors(cases, shape):
    args = cases.random_case(np.random.RandomState(0), *shape)
    return [torch.from_numpy(np.asarray(a)).cuda() for a in args]


def profile_call(fn, n=20):
    """Device time of the polling kernel per call, device kernels per call,
    and the polling kernel's launch figures from the trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        trace = json.load(open(f.name))
    kernels = [e for e in trace.get("traceEvents", [])
               if e.get("cat") == "kernel"]
    poll = [e for e in kernels if "poll" in e.get("name", "")]
    out = {"kernels_per_call": len(kernels) / n,
           "kernel_ms": (sum(e["dur"] for e in poll) / 1e3 / n
                         if poll else None),
           "kernel_name": poll[0]["name"] if poll else None}
    if poll:
        args = poll[-1].get("args", {})
        for key in ("grid", "block", "registers per thread",
                    "shared memory", "blocks per SM", "warps per SM",
                    "est. achieved occupancy %"):
            if key in args:
                out[key] = args[key]
    return out


def sass_figures(cuda_mod, lib):
    """Instructions of each polling kernel in the library: in all, in its
    plane loop and per (detection, plane) pair. A pair takes 6 votes, each
    a compare with the 0.7 m threshold; the plane loop is the innermost
    backward branch whose body holds such compares, the one with the most
    of them where several do (an unrolled loop beside its remainder)."""
    cuobjdump = Path(cuda_mod._nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        return {"error": proc.stderr.strip()[-300:]}
    figures = {}
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*\.{5,}|"
                                 r"Function : |\Z)", proc.stdout, re.S):
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
        addr = {int(a, 16): i for i, (a, _) in enumerate(ins)}
        text = [t.strip() for _, t in ins]
        loops = []  # (first, last, vote compares)
        for i, t in enumerate(text):
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", t)
            lo = addr.get(int(m.group(1), 16)) if m else None
            if lo is not None and lo < i:
                votes = sum("0.69999998" in x for x in text[lo:i + 1])
                if votes >= 6:
                    loops.append((lo, i, votes))
        inner = [a for a in loops if not any(
            a[0] <= b[0] and b[1] <= a[1] and a != b for b in loops)]
        entry = {"instructions": len(text)}
        if inner:
            lo, hi, votes = max(inner, key=lambda a: a[2])
            n = hi - lo + 1
            entry.update(
                loop_instructions=n, pairs_per_iteration=votes / 6,
                instructions_per_pair=n * 6 / votes,
                mufu_per_pair=sum("MUFU" in x for x in text[lo:hi + 1])
                * 6 / votes)
        figures[name] = entry
    return figures


def issue_slot_share(sass, shape, profile, clock_mhz):
    """Share of the card's issue slots (4 warp instructions per SM per
    cycle at the top SM clock) that the plane loop's instructions fill over
    the kernel's device time: B D P pairs at the SASS count per pair, over
    32 lanes. It leaves out the instructions outside the loop, and a clock
    below the top one, so it is a lower bound."""
    per_pair = [f["instructions_per_pair"] for f in sass.values()
                if "instructions_per_pair" in f]
    if not per_pair or not profile.get("kernel_ms"):
        return None
    warp_instructions = per_pair[0] * float(np.prod(shape)) / 32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = profile["kernel_ms"] * 1e-3 * clock_mhz * 1e6 * sms * 4
    return warp_instructions / slots


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--against", default=None,
                   help="root of another checkout to time in turns")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("polling_bench: no CUDA device", file=sys.stderr)
        return 2

    trees = {"this": load_tree(None, None)}
    if args.against:
        trees["other"] = load_tree(args.against, "gpp_other")
    order = (["other", "this", "this", "other"] if args.against
             else ["this", "this"])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    clock_mhz = float(smi.split(",")[-1].split()[0])
    result = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "calls": CALLS, "trees": {}}
    for label, (cuda_mod, _) in trees.items():
        lib = cuda_mod.build()
        result["trees"][label] = {
            "source": str(cuda_mod.SOURCE),
            "ptxas": lib.with_suffix(".log").read_text().strip(),
            "sass": sass_figures(cuda_mod, lib), "shapes": {}}
    for shape in SHAPES:
        inputs = {label: case_tensors(cases, shape)
                  for label, (_, cases) in trees.items()}
        for label in order:
            cuda_mod = trees[label][0]
            t = inputs[label]
            entry = result["trees"][label]["shapes"].setdefault(
                str(shape), {"call_ms": [], "host_ms": []})
            entry["call_ms"].append(
                cuda_ms(lambda: cuda_mod.fit_road_planes(*t)))
            entry["host_ms"].append(
                host_ms(lambda: cuda_mod.fit_road_planes(*t)))
        for label, (cuda_mod, _) in trees.items():
            t = inputs[label]
            entry = result["trees"][label]["shapes"][str(shape)]
            entry["profile"] = profile_call(
                lambda: cuda_mod.fit_road_planes(*t))
            entry["issue_slot_share"] = issue_slot_share(
                result["trees"][label]["sass"], shape, entry["profile"],
                clock_mhz)
            print(f"{label} {shape}: call ms {entry['call_ms']}, host ms "
                  f"{entry['host_ms']}, profile {entry['profile']}",
                  flush=True)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(smi)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
