"""Times the PyTorch port's frozen-BN kernel (csrc/frozen_bn.cu) on the
card at every site of ResNet-50's trunk at 416x1344, beside the plain
passes it replaces and its byte bound.

    python tools/frozen_bn_bench.py [--out FILE]

For each distinct site (C, H, W, variant; SITES, with its count in one
forward) at b1 and b4, bf16, seeded non-identity BN:
  kernel_ms    device ms of one launch, from a CUDA graph of
               GRAPH_LAUNCHES launches back to back (the captured call has
               no host time between them either), median of REPLAYS
               replays; `warm` on one input (in the trunk the conv has just
               written it, so small maps sit in the 50 MB L2), `cold`
               rotating over input sets of more than twice the L2;
  plain_ms     the plain passes (frozen_bn_cuda.plain: a multiply and an
               add a BN, the residual add, the ReLU), the same way;
  bound_ms     the kernel's bytes (each map read once, the output written
               once, the BN vectors) at 3.35 TB/s; `share` = bound / cold;
and the sums over the 49 sites of a forward. Then the bf16 trunk's forward
(b1, b4), fused against plain: graphs of TRUNK_CALLS forwards replayed in
turns (plain, fused, fused, plain).

Needs a CUDA card; prints one JSON object as its last line (and writes it
to --out).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ground_plane_polling_tpu_torch.kernels import frozen_bn_cuda  # noqa: E402
from ground_plane_polling_tpu_torch.models import resnet  # noqa: E402

# (C, H, W, variant, sites of a forward) at 416x1344: the stem, then per
# stage conv1 and conv2 (relu), the first block's conv3 with the
# projection's BN, the other blocks' conv3 with the identity shortcut
SITES = ((64, 208, 672, "relu", 1),
         (64, 104, 336, "relu", 6), (256, 104, 336, "projected", 1),
         (256, 104, 336, "identity", 2),
         (128, 52, 168, "relu", 8), (512, 52, 168, "projected", 1),
         (512, 52, 168, "identity", 3),
         (256, 26, 84, "relu", 12), (1024, 26, 84, "projected", 1),
         (1024, 26, 84, "identity", 5),
         (512, 13, 42, "relu", 6), (2048, 13, 42, "projected", 1),
         (2048, 13, 42, "identity", 2))
BATCHES = (1, 4)
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20
GRAPH_LAUNCHES = 20
REPLAYS = 10
TRUNK_CALLS = 10


def capture(fns, launches):
    """A CUDA graph of max(launches, len(fns)) calls that walk the list
    `fns` in turn, back to back, and that count; warmed up off the
    capture, replayed once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph, n = torch.cuda.CUDAGraph(), max(launches, len(fns))
    with torch.cuda.graph(graph):
        for i in range(n):
            fns[i % len(fns)]()
    graph.replay()
    return graph, n


def replay_ms(graph, n, replays=REPLAYS):
    """Device ms of one of the graph's n calls: the median over `replays`
    replays, CUDA events around each."""
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / n)
    return statistics.median(times)


def graph_ms(fns, launches=GRAPH_LAUNCHES):
    """Device ms of one call, from a graph of GRAPH_LAUNCHES calls back to
    back, as the captured detect call launches them, with no host time
    between them."""
    return replay_ms(*capture(fns, launches))


def site_inputs(b, c, h, w, variant, gen, device):
    """(x, s, b, relu, r, sp, bp) of a site in bf16, channels-last."""
    def vec(scale, offset):
        return (torch.rand(c, generator=gen) * scale + offset).to(
            torch.bfloat16).to(device)

    def map_():
        return torch.randn(b, c, h, w, generator=gen).to(torch.bfloat16).to(
            device).contiguous(memory_format=torch.channels_last)

    r = map_() if variant != "relu" else None
    proj = variant == "projected"
    return (map_(), vec(2.0, -0.5), vec(0.5, -0.25), True, r,
            vec(2.0, -0.5) if proj else None,
            vec(0.5, -0.25) if proj else None)


def kernel_bytes(b, c, h, w, variant):
    maps = {"relu": 2, "identity": 3, "projected": 3}[variant]
    vectors = 4 if variant == "projected" else 2
    return (maps * b * c * h * w + vectors * c) * 2


def time_site(b, c, h, w, variant, device):
    gen = torch.Generator().manual_seed(c * h + b)
    one = site_inputs(b, c, h, w, variant, gen, device)
    per_set = kernel_bytes(b, c, h, w, variant)
    sets = [one] + [site_inputs(b, c, h, w, variant, gen, device)
                    for _ in range(-(-2 * L2_BYTES // per_set))]
    got = frozen_bn_cuda.frozen_bn_act(*one)
    want = frozen_bn_cuda.plain(*one)
    equal = bool(torch.equal(got.view(torch.int16), want.contiguous(
        memory_format=torch.channels_last).view(torch.int16)))
    out = {"equal": equal, "bytes": per_set,
           "bound_ms": per_set / HBM_BYTES_PER_S * 1e3}
    for name, fn in (("kernel", frozen_bn_cuda.frozen_bn_act),
                     ("plain", frozen_bn_cuda.plain)):
        out[f"{name}_ms_warm"] = graph_ms([lambda: fn(*one)])
        out[f"{name}_ms_cold"] = graph_ms([lambda a=a: fn(*a)
                                           for a in sets])
    out["share"] = out["bound_ms"] / out["kernel_ms_cold"]
    del sets
    return out


def time_trunk(b, device):
    """Device ms of the bf16 ResNet-50 trunk's forward, fused and plain,
    each a graph of TRUNK_CALLS forwards, replayed in turns (plain, fused,
    fused, plain, three times)."""
    torch.manual_seed(0)
    trunk = resnet.ResNetBackbone().to(device=device, dtype=torch.bfloat16)
    trunk = trunk.eval().to(memory_format=torch.channels_last)
    x = torch.randn(b, 3, 416, 1344, device=device).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    kernel, graphs = frozen_bn_cuda.frozen_bn_act, {}
    with torch.inference_mode():
        for name in ("plain", "fused"):
            # the sites call the wrapper through its module: the plain
            # passes in its place are the trunk before the kernel
            frozen_bn_cuda.frozen_bn_act = (kernel if name == "fused"
                                            else frozen_bn_cuda.plain)
            try:
                graphs[name] = capture([lambda: trunk(x)], TRUNK_CALLS)
            finally:
                frozen_bn_cuda.frozen_bn_act = kernel
    times = {"plain": [], "fused": []}
    for name in ("plain", "fused", "fused", "plain") * 3:
        times[name].append(replay_ms(*graphs[name], replays=1))
    return {k: {"blocks": v, "median": statistics.median(v)}
            for k, v in times.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("frozen_bn_bench needs a CUDA card")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(frozen_bn_cuda.build().with_suffix(".log").read_text(), flush=True)
    result = {"device": smi, "sites": {}, "forward": {}, "trunk": {}}
    for b in BATCHES:
        sums = dict.fromkeys(("kernel_ms_warm", "kernel_ms_cold",
                              "plain_ms_warm", "plain_ms_cold", "bound_ms",
                              "bytes"), 0.0)
        for c, h, w, variant, n in SITES:
            key = f"b{b}_c{c}_{h}x{w}_{variant}"
            out = time_site(b, c, h, w, variant, device)
            out["sites"] = n
            result["sites"][key] = out
            for k in sums:
                sums[k] += n * out[k]
            print(key, json.dumps(out), flush=True)
        sums["share"] = sums["bound_ms"] / sums["kernel_ms_cold"]
        result["forward"][f"b{b}"] = sums
        print(f"forward b{b}", json.dumps(sums), flush=True)
        result["trunk"][f"b{b}"] = time_trunk(b, device)
        print(f"trunk b{b}", json.dumps(result["trunk"][f"b{b}"]), flush=True)
    result["all_equal"] = all(v["equal"] for v in result["sites"].values())
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
