"""Readings for the limits of the check: the numbers the judge gives for
sound runs of the program over many seeds, for each control in the
program's place and for each planted fault (lib/faults.py) over a few,
in one process (the imports are paid once, not once a seed).

    python benchmark/readings.py --workload r50-bf16-b4-offline \
        --seeds 1-12 --controls program-int8,stage-bf16 \
        --faults nms_threshold,swap_position --control-seeds 101-103 \
        --seconds 2 --out chiprun_out/readings.jsonl

Each reading is one JSON line: workload, program, control or fault,
seed, the numbers and whether the configuration's limits passed them.
The windows are short, at the cell's own load: long enough to finish
calls and to judge as many frames as a run does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--controls", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.run import run

    plan = [({}, s) for s in seeds(args.seeds)] if args.seeds else []
    for control in filter(None, args.controls.split(",")):
        plan += [({"control": control}, s)
                 for s in seeds(args.control_seeds)]
    for fault in filter(None, args.faults.split(",")):
        plan += [({"fault": fault}, s) for s in seeds(args.control_seeds)]
    out = open(args.out, "a") if args.out else None
    try:
        for planted, seed in plan:
            t0 = time.perf_counter()
            result = run(args.workload, seed, args.seconds, False,
                         t_start=t0, **planted)
            line = json.dumps({
                "workload": args.workload,
                "program": "/".join(planted.values()) or "program",
                "seed": seed, "correct": result["correct"],
                "numbers": {k: v["value"]
                            for k, v in result["checks"].items()},
                "detail": result["detail"],
                "check_s": result["check_s"],
                "frames": result["attempted"],
                "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
