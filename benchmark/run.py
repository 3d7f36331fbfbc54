"""One run of one cell of the port's benchmark.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Finds the cell in BENCHMARK.json at the checkout's root, its
configuration in `benchmark/configs/<config>.json`, its traffic mix in
`benchmark/traffic/<traffic>.json` and each metric's reader in
`benchmark/metrics/<metric>.py`, all by name. The mix names its generator
(`benchmark/lib/<generator>.py`: the detect loop, lib/loop.py) and the
configuration its judge (`benchmark/reference/<judge>.py`). Set-up: the
generator makes the inputs from the seed, builds the system under test
through the port's public API and warms up the cell's own shapes;
`setup_s` runs from the start of this process to the first timed call.
The window then drives the mix for `--seconds`; with `--trace 1` a
further slice of calls runs under torch.profiler. After the window the
peak memory is read, the system is freed, and the judge compares a
seeded sample of what the window produced with the plain reference's
answers. The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the last key of that object.

Exits with a code other than 0, printing no result, without a card (or
with fewer than the cell asks for), and where the process holds jax,
jaxlib, flax or the JAX package once the window has closed.
`--control <name>` puts a control in the program's place (the check's
own tests use it; the benchmark's runs do not).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ground_plane_polling_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def find(kind: str, name: str, suffix: str, bench: Path = BENCH) -> Path:
    """The file of a configuration, mix or metric, by its name."""
    path = bench / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def load_reader(name: str, bench: Path = BENCH):
    """The `read(ctx)` of metric `name` (metrics/<name>.py)."""
    path = find("metrics", name, ".py", bench)
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell(benchmark: dict, workload: str, bench: Path = BENCH):
    """(workload entry, configuration, traffic mix) of a cell."""
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg = load_json(find("configs", w["config"], ".json", bench))
    traffic = load_json(find("traffic", w["traffic"], ".json", bench))
    return w, cfg, traffic


def metrics_of(benchmark: dict, workload: str, trace: bool):
    """The metric entries a run of `workload` reports."""
    group = benchmark["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def forbidden_modules():
    """Loaded modules whose top-level name is one the runs may not hold."""
    tops = {name.partition(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


class Context:
    """What the metric readers read: the window's calls and seconds, the
    set-up time, the trace, and the reference's counts."""

    def __init__(self, cfg, traffic, calls, window_s, setup_s, trace):
        self.cfg = cfg
        self.traffic = traffic
        self.calls = calls
        self.window_s = window_s
        self.setup_s = setup_s
        self.trace = trace
        self._flops = None
        self._sites = None

    @property
    def frames(self) -> int:
        return sum(len(c.frames) for c in self.calls)

    @property
    def flops_per_frame(self) -> float:
        """The reference forward's FLOPs a frame (FlopCounterMode)."""
        if self._flops is None:
            from benchmark.reference.model import flops_per_frame
            self._flops = flops_per_frame(self.cfg)
        return self._flops

    @property
    def peak_ops(self) -> float:
        from benchmark.lib.bounds import PEAKS
        return PEAKS["int8" if self.cfg["int8"] else self.cfg["dtype"]]

    @property
    def conv_sites(self):
        """[(input, weight, output shape)] of a call's conv sites."""
        if self._sites is None:
            import torch

            from benchmark.reference.model import conv_census, param_spec
            w = {k: torch.empty(s, device="meta")
                 for k, (s, _) in param_spec(self.cfg).items()}
            self._sites = conv_census(w, torch.empty(
                (self.traffic["batch"], 3, *self.cfg["canvas"]),
                device="meta"))
        return self._sites


def named_module(kind: str, name: str):
    """The generator (lib/<name>.py) or judge (reference/<name>.py) that a
    mix or a configuration names."""
    if not name.isidentifier():
        raise ValueError(f"{kind} module {name!r} is not a module name")
    find(kind, name, ".py")
    return importlib.import_module(f"benchmark.{kind}.{name}")


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", control: str = None, fault: str = None,
        benchmark: dict = None, bench: Path = BENCH, t_start=T_START):
    """One run; returns the result object (and does not print it).
    `control` puts a control of the generator's system in its place;
    `fault` plants one of the generator's FAULTS under the timed path
    (the check's tests and readings)."""
    import torch

    from benchmark.lib.inputs import sub_seed
    from benchmark.lib.trace import breakdown, profile_calls

    marks = [("start", time.perf_counter())]
    benchmark = benchmark or load_json(ROOT / "BENCHMARK.json")
    entry, cfg, traffic = cell(benchmark, workload, bench)
    gen = named_module("lib", traffic["generator"])
    judge = named_module("reference", cfg["judge"]).judge
    device = torch.device(device)
    inputs = gen.prepare(cfg, traffic, seed, device)
    marks.append(("inputs", time.perf_counter()))
    planted = gen.FAULTS[fault] if fault else None
    system = gen.build(planted.cfg(cfg) if planted and planted.cfg else cfg,
                       inputs, device, control)
    if planted and planted.wrap:
        system = planted.wrap(system)
    marks.append(("build", time.perf_counter()))
    # warm-up: the cell's own shapes (capture on a card), its readback
    warm, _ = gen.drive(system, inputs, traffic, device, None,
                        calls=traffic["warmup_calls"])
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("warmup", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    # seconds of each part of the set-up: the interpreter and imports
    # (start), the card's context and the inputs, the system built, the
    # capture and warm-up calls
    setup_parts = {name: t - prev for (name, t), (_, prev)
                   in zip(marks, [("", t_start)] + marks[:-1])}

    calls, window_s = gen.drive(system, inputs, traffic, device, seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    traced = None
    if trace:
        after = calls[-1].index + 1

        def run_slice():
            return gen.drive(system, inputs, traffic, device, None,
                             calls=traffic["trace_calls"], start=after,
                             named=True)[0]

        traced = profile_calls(run_slice, device.type == "cuda")
    gen.release(system)
    del system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers = judge(cfg, inputs, gen.samples(
        warm, calls, inputs, traffic, sub_seed(seed, 5)), device)
    # the configuration names the numbers it compares, each with its limit
    checks = {k: {"value": numbers[k], "limit": v}
              for k, v in cfg["limits"].items()}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    check_s = time.perf_counter() - t_check

    ctx = Context(cfg, traffic, calls, window_s, setup_s, traced)
    metrics = {}
    for m in metrics_of(benchmark, workload, trace):
        value = load_reader(m["name"], bench)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": gen.attempted(calls),
              "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": entry["chips"],
                         "memory_peak_bytes": peak}}
    if traced is not None:
        result["device"]["busy_s"] = traced.busy_s
        result["device"]["window_s"] = traced.window_s
        result["breakdown"] = breakdown(traced)
    result["setup_parts"] = setup_parts
    result["check_s"] = check_s
    result["detail"] = {k: v for k, v in numbers.items() if k not in checks}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", default=None)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    benchmark = load_json(ROOT / "BENCHMARK.json")
    entry, _, _ = cell(benchmark, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 control=args.control, benchmark=benchmark)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port "
              "alone", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
