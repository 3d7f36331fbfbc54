"""Times the PyTorch port's greedy-NMS kernel (csrc/nms.cu) alone on the
card, against the kernels of other checkouts in turns.

    python tools/nms_bench.py [--against ROOT ...] [--out FILE]

Each ROOT is another checkout (for example the parent commit unpacked
with `git archive`); its `kernels/nms_cuda.py` builds into that checkout.
For each case, on inputs of kernels/nms_cases.py made from fixed seeds,
at max_out 100 (1,500 for kept_past_shared_list) and IoU threshold 0.5:
  b1, b4, s48        random_case sets at K 1024 (about 100 kept by
                     candidate 110-125);
  clustered_b1, _b4  clustered_case sets at K 1024 (about 30 kept, every
                     candidate reached);
  large_cases()      48 sets at K 1024, K 16,384, max_out 1,500;
every tree's outputs must equal this tree's, and this tree's the plain
version's (greedy_nms, or greedy_nms_serial past K 1024), bit for bit.
Then each tree's device ms a call (chip_smoke.device_ms: CUDA events
around calls queued behind a spinning kernel, the least of 3), in turns:
the trees in order, this tree, this tree, the trees in reverse; beside
the bound (chip_smoke.nms_bound_ms), the kept count and the last kept
candidate of the first sets.

Needs a CUDA card; prints one JSON object as its last line (and writes it
to --out).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from ground_plane_polling_tpu_torch.kernels import (  # noqa: E402
    nms_cases, nms_cuda)
from ground_plane_polling_tpu_torch.ops import filtering  # noqa: E402


def cases():
    """[(name, boxes, scores, max_out, threshold, calls a timing)]."""
    random = [(name, *nms_cases.random_case(np.random.RandomState(s), s=s),
               100, 0.5, 20)
              for name, s in (("b1", 1), ("b4", 4), ("s48", 48))]
    clustered = [(f"clustered_{name}", *nms_cases.clustered_case(
        np.random.RandomState(10 + s), s=s), 100, 0.5, 20)
        for name, s in (("b1", 1), ("b4", 4))]
    return random + clustered + [(*c, 5) for c in nms_cases.large_cases()]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--against", nargs="*", default=[], metavar="ROOT")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("nms_bench needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    trees = {"this": nms_cuda}
    for i, root in enumerate(args.against):
        trees[root] = chip_smoke.load_int8_tree(root, f"gpp_other{i}")[2]
        if trees[root] is None:
            raise SystemExit(f"{root} has no kernels/nms_cuda.py")
    for module in trees.values():
        module.build()
    order = list(args.against) + ["this", "this"] + args.against[::-1]
    result = {"device": smi, "order": order, "cases": {}}
    for name, boxes, scores, max_out, thr, calls in cases():
        call = (torch.from_numpy(boxes).cuda(),
                torch.from_numpy(scores).cuda(), max_out, thr)
        got = nms_cuda.greedy_nms(*call)
        plain = (filtering.greedy_nms_serial if scores.shape[1] > 1024
                 else filtering.greedy_nms)
        chip_smoke.compare_nms(got, plain(*call), name)
        for root in args.against:
            chip_smoke.compare_nms(trees[root].greedy_nms(*call), got,
                                   f"{name} {root}")
        ms = {tree: [] for tree in trees}
        for tree in order:
            ms[tree].append(chip_smoke.device_ms(
                torch, lambda f=trees[tree].greedy_nms: f(*call),
                reps=calls))
        bound, by = chip_smoke.nms_bound_ms(call[1], got[0], got[1],
                                            max_out)
        row = result["cases"][name] = {
            "S": scores.shape[0], "K": scores.shape[1], "ms": ms,
            "bound_ms": bound, "bound_by": by,
            "kept": got[1].sum(dim=1).tolist()[:4],
            "last_kept": [int(i[v].max()) if v.any() else -1
                          for i, v in zip(got[0][:4], got[1][:4])]}
        print(name, json.dumps(row), flush=True)
    print(smi)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
