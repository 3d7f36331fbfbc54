"""The detect generator: a closed loop of detect calls over a pool of
frames, driven by a mix's parameters (`traffic/<mix>.json`, whose
`generator` names this module):

  * `batch`: frames a call;
  * `in_flight`: calls dispatched before the oldest is read back (0: each
    call is uploaded, run and read back before the next is sent, as one
    camera fed frame by frame; 1: the next batch is dispatched before the
    last one's outputs are read, as the program's serve and evaluate loops
    order it);
  * `pool`: distinct frames, cycled in the seeded order in which they
    were drawn, `batch` at a time;
  * `warmup_calls`, `trace_calls`, `check_frames`: calls of the set-up's
    warm-up and of the traced slice, frames the judge reads.

Each call: `generate` (which frames), `upload` (frames and cameras from
pinned host memory to the card, asynchronously), `dispatch` (the detect
call: on a card the port's captured call, which returns once the replay
is queued), `readback` (the outputs queued into pinned host buffers) and
`wait` (the host waits for a call's outputs to reach host memory). Spans
are host-clock times; under the profiler each is also a named range, so
that idle gaps on the device can be put down to what the host was doing.

A generator module gives the harness (run.py) `prepare`, `build`,
`drive`, `attempted`, `samples` and `release`, with the signatures
below; a mix that drives another system names a module of its own.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import inputs as seeded
from . import program
from .faults import FAULTS

__all__ = ["Call", "Inputs", "prepare", "build", "drive", "attempted",
           "samples", "release", "FAULTS"]


class Inputs(NamedTuple):
    """What both sides get, made from the seed."""
    weights: dict          # name -> weight, in the served type
    pool: seeded.Pool      # frames and cameras in pinned host memory
    planes: torch.Tensor   # (P, 4) road planes on the device


def prepare(cfg, traffic, seed: int, device) -> Inputs:
    return Inputs(seeded.make_weights(cfg, seed, device,
                                      getattr(torch, cfg["dtype"])),
                  seeded.make_pool(cfg, traffic["pool"], seed, device),
                  seeded.make_planes(cfg, seed, device))


def build(cfg, inputs: Inputs, device, control: Optional[str] = None):
    """The system under test: the port's detect call (lib/program.py), or
    the control named `control` in its place."""
    fn = program.CONTROLS[control] if control else program.build
    return fn(cfg, inputs.weights, inputs.pool, device)


release = program.release


class Call:
    """One detect call: its frames, host-clock spans and outputs."""

    __slots__ = ("index", "frames", "t_upload", "t_dispatch",
                 "t_dispatched", "t_done", "outputs", "_event", "_slot")

    def __init__(self, index, frames):
        self.index = index
        self.frames = frames
        self.outputs = None

    @property
    def dispatch_ms(self) -> float:
        return (self.t_dispatched - self.t_dispatch) * 1e3

    @property
    def latency_ms(self) -> float:
        """From the start of its upload to its outputs in host memory."""
        return (self.t_done - self.t_upload) * 1e3


def _named(name, on):
    if on:
        return torch.profiler.record_function("bench." + name)
    return contextlib.nullcontext()


def drive(detect, inputs: Inputs, traffic, device, seconds: Optional[float],
          calls: Optional[int] = None, start: int = 0, named: bool = False):
    """Run the closed loop for `seconds` of host clock (or `calls` calls),
    starting at call number `start`; returns (the calls in order, each read
    back, and the window's seconds: from the first upload to the last
    outputs in host memory)."""
    batch, in_flight = traffic["batch"], traffic["in_flight"]
    pool, planes = inputs.pool, inputs.planes
    n = len(pool.frames)
    if n % batch:
        raise ValueError(f"a pool of {n} frames does not split into "
                         f"batches of {batch}")
    device = torch.device(device)
    cuda = device.type == "cuda"
    expanded = planes[None].expand(batch, *planes.shape)
    slots = [None] * (in_flight + 1)
    pending = collections.deque()
    done = []

    def harvest(call):
        with _named("wait", named):
            if cuda:
                call._event.synchronize()
            call.t_done = time.perf_counter()
        call.outputs = {k: v.numpy().copy() for k, v in call._slot.items()}
        call._slot = call._event = None
        done.append(call)

    t0 = time.perf_counter()
    k = start
    while True:
        if calls is not None and k - start >= calls:
            break
        if seconds is not None and time.perf_counter() - t0 >= seconds:
            break
        with _named("generate", named):
            at = (k * batch) % n
            call = Call(k, list(range(at, at + batch)))
        call.t_upload = time.perf_counter()
        with _named("upload", named):
            images = pool.frames[at:at + batch].to(device, non_blocking=True)
            P_inv = pool.P_inv[at:at + batch].to(device, non_blocking=True)
        call.t_dispatch = time.perf_counter()
        with _named("dispatch", named):
            out = detect(images, P_inv, expanded)
        call.t_dispatched = time.perf_counter()
        with _named("readback", named):
            fields = {key: v for key, v in out._asdict().items()
                      if v is not None}
            s = k % len(slots)
            if slots[s] is None:
                slots[s] = {key: torch.empty(v.shape, dtype=v.dtype,
                                             pin_memory=cuda)
                            for key, v in fields.items()}
            for key, v in fields.items():
                slots[s][key].copy_(v, non_blocking=cuda)
            call._slot = slots[s]
            call._event = torch.cuda.Event() if cuda else None
            if cuda:
                call._event.record()
        pending.append(call)
        while len(pending) > in_flight:
            harvest(pending.popleft())
        k += 1
    while pending:
        harvest(pending.popleft())
    if not done:
        return done, 0.0
    return done, done[-1].t_done - done[0].t_upload


def attempted(calls) -> int:
    """Frames the window finished (a closed loop waits for every call it
    sends; one that fails raises)."""
    return sum(len(c.frames) for c in calls)


def samples(warm, calls, inputs: Inputs, traffic, seed: int):
    """What the judge reads: [(frame, P_inv, the program's outputs, batch
    position)] of `check_frames` frames of the window's calls drawn from
    `seed`, positions cycling through the batch so that every position is
    judged alike (calls drawn again where fewer finished)."""
    count = traffic["check_frames"]
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(calls), size=count, replace=len(calls) < count)
    batch = len(calls[0].frames)
    pool = inputs.pool
    out = []
    for i, c in enumerate(picks):
        call, at = calls[int(c)], i % batch
        frame = call.frames[at]
        out.append((pool.frames[frame], pool.P_inv[frame],
                    {k: v[at] for k, v in call.outputs.items()}, at))
    return out
