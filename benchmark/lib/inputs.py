"""Everything a run feeds both sides, made from `--seed`: the weights, a
pool of frames with their calibrations, and the road-plane database.

Weights follow the recipe of the program's smoke script, drawn here and
not by the program: lecun-normal conv kernels in the trunk and the FPN
(a normal truncated at two standard deviations, variance 1 / fan_in),
N(0, 0.01) tower and out kernels, the classification out kernel from
N(0, cls_out_std) so that seeded weights give detections above the 0.05
threshold, zero biases, identity frozen batch norm. They are drawn on the
device in two calls of its generator and rounded to the type they are
served in; both sides get those values.

Frames are uint8 BGR canvases: a KITTI frame resized by the CLIs' rule
fills the top-left `frame` region with seeded noise, the rest of the
canvas is zero padding. Each frame has its own KITTI-like camera (P2 with
its focal lengths and principal point moved by up to 2%), given as the
pseudo-inverse of the resized projection. Planes are drawn like the
synthetic database of the program's bench: (U(-0.05, 0.05), 1,
U(-0.05, 0.05), U(-2.5, -1.0)).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..reference.model import BN_EPS, lecun_std, param_spec

__all__ = ["sub_seed", "make_weights", "Pool", "make_pool", "make_planes",
           "P2"]

# KITTI's P2 of a 1242 x 375 camera
P2 = np.array([[721.5, 0.0, 609.6, 44.9],
               [0.0, 721.5, 172.9, 0.2],
               [0.0, 0.0, 1.0, 0.003]])
_TRUNC_STD = 0.87962566103423978  # std of a unit normal cut at +-2


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, stream])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


@torch.no_grad()
def make_weights(cfg, seed: int, device, dtype) -> dict:
    """name -> weight in `dtype` on `device`, keyed as the program's
    state dict."""
    spec = param_spec(cfg)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    trunk = [k for k, (_, kind) in spec.items() if kind == "trunk"]
    heads = [k for k, (_, kind) in spec.items()
             if kind in ("tower", "cls_out")]

    def draw(names, fill):
        n = sum(math.prod(spec[k][0]) for k in names)
        flat = torch.empty(n, device=device)
        fill(flat)
        out, at = {}, 0
        for k in names:
            size = math.prod(spec[k][0])
            out[k] = flat[at:at + size].view(spec[k][0])
            at += size
        return out

    drawn = draw(trunk, lambda t: torch.nn.init.trunc_normal_(
        t, 0.0, 1.0, -2.0, 2.0, generator=gen))
    for k in trunk:
        drawn[k] = drawn[k] * (lecun_std(spec[k][0]) / _TRUNC_STD)
    towers = draw(heads, lambda t: t.normal_(0.0, 1.0, generator=gen))
    for k in heads:
        std = cfg["cls_out_std"] if spec[k][1] == "cls_out" else 0.01
        drawn[k] = towers[k] * std
    weights = {}
    for k, (shape, kind) in spec.items():
        if kind == "bias" or kind == "bn_shift":
            t = torch.zeros(shape, device=device)
        elif kind == "bn_scale":
            t = torch.full(shape, 1.0 / math.sqrt(1.0 + BN_EPS),
                           device=device)
        else:
            t = drawn[k]
        weights[k] = t.to(dtype)
    return weights


class Pool(NamedTuple):
    frames: torch.Tensor  # (N, H, W, 3) uint8, pinned host memory
    P_inv: torch.Tensor   # (N, 4, 3) float32, pinned host memory


def make_pool(cfg, size: int, seed: int, device) -> Pool:
    """`size` seeded frames and their cameras, in host memory (pinned when
    a card holds the device)."""
    h, w = cfg["canvas"]
    fh, fw = cfg["frame"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    noise = torch.randint(0, 256, (size, fh, fw, 3), generator=gen,
                          dtype=torch.uint8, device=device)
    pin = torch.device(device).type == "cuda"
    frames = torch.zeros((size, h, w, 3), dtype=torch.uint8, pin_memory=pin)
    frames[:, :fh, :fw].copy_(noise)
    rng = np.random.default_rng(sub_seed(seed, 3))
    scale = fw / cfg["raw_frame"][1]
    P_inv = np.empty((size, 4, 3), np.float32)
    for i in range(size):
        P = P2.copy()
        P[0, 0] *= rng.uniform(0.98, 1.02)
        P[1, 1] = P[0, 0]
        P[0, 2] *= rng.uniform(0.98, 1.02)
        P[1, 2] *= rng.uniform(0.98, 1.02)
        P_inv[i] = np.linalg.pinv(np.diag([scale, scale, 1.0]) @ P)
    P_inv_t = torch.empty((size, 4, 3), dtype=torch.float32, pin_memory=pin)
    P_inv_t.copy_(torch.from_numpy(P_inv))
    return Pool(frames, P_inv_t)


def make_planes(cfg, seed: int, device) -> torch.Tensor:
    """(P, 4) float32 road planes on the device."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 4))
    u = torch.rand((cfg["planes"], 3), generator=gen, device=device)
    return torch.stack([u[:, 0] * 0.1 - 0.05, torch.ones_like(u[:, 0]),
                        u[:, 1] * 0.1 - 0.05, u[:, 2] * -1.5 - 1.0], dim=1)
