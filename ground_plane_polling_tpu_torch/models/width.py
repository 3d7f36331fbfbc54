"""The width layer: the operations of the detector's forward that read
across image columns, apart from its convs. These are the pools, the
FPN's upsampling and the gather of the head output maps.

Each runs as the plain op unless a column split is active (`split_columns`;
parallel/spatial.py). A split holds one rank's contiguous columns of
every map and runs each op on them, taking the columns it needs from
their owners. The convs are routed to the split by the same context
(models/quantize.py's `_intercept`). The modules call these functions and
need not know whether a split is active.

Padding follows Flax: `same_padding` is XLA's SAME, which puts an odd
pixel after (bottom, right).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

__all__ = ["same_padding", "same_pad", "pool_padding", "pool2d",
           "upsample_to", "gather", "active", "split_columns"]

_SPLIT = contextvars.ContextVar("gpp_column_split", default=None)


def same_padding(h: int, w: int, kernel: int, stride: int):
    """((top, bottom), (left, right)) of XLA's SAME padding for a `kernel`
    window at `stride` on an h x w map: the total padding
    max((ceil(n/s) - 1) s + k - n, 0) is split with the extra pixel after
    (bottom/right)."""
    pads = []
    for n in (h, w):
        out = -(-n // stride)
        total = max((out - 1) * stride + kernel - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def same_pad(x: torch.Tensor, kernel: int, stride: int,
             value: float = 0.0) -> torch.Tensor:
    """Pad NCHW `x` as XLA's SAME does (`same_padding`)."""
    (top, bottom), (left, right) = same_padding(x.shape[2], x.shape[3],
                                                kernel, stride)
    return F.pad(x, (left, right, top, bottom), value=value)


def pool_padding(h: int, w: int, kernel: int, stride: int, padding):
    """((top, bottom), (left, right)) of a pool: "same" or an int on every
    side."""
    if padding == "same":
        return same_padding(h, w, kernel, stride)
    return (padding, padding), (padding, padding)


def pool_fill(kind: str) -> float:
    """The padding value of a pool: -inf for max, a counted zero for avg
    (Flax's SAME average pool counts the padded zeros)."""
    return float("-inf") if kind == "max" else 0.0


def pool2d(x: torch.Tensor, kind: str, kernel: int, stride: int,
           padding="same") -> torch.Tensor:
    """`kind` ("max" or "avg") pooling of NCHW `x` over `pool_padding`,
    filled with `pool_fill`."""
    split = _SPLIT.get()
    if split is not None:
        return split.pool2d(x, kind, kernel, stride, padding)
    if kind == "max" and padding != "same":  # torch pads with -inf itself
        return F.max_pool2d(x, kernel, stride=stride, padding=padding)
    (top, bottom), (left, right) = pool_padding(x.shape[2], x.shape[3],
                                                kernel, stride, padding)
    x = F.pad(x, (left, right, top, bottom), value=pool_fill(kind))
    pool = F.max_pool2d if kind == "max" else F.avg_pool2d
    return pool(x, kernel, stride=stride)


def upsample_to(x: torch.Tensor, target_hw) -> torch.Tensor:
    """Nearest-neighbour resize of NCHW `x` to (target_h, target_w): an
    exact 2x repeat where the sizes double, else torch's 'nearest-exact'
    (half-pixel centres, which is what JAX's image.resize 'nearest'
    computes)."""
    split = _SPLIT.get()
    if split is not None:
        return split.upsample_to(x, target_hw)
    h, w = x.shape[2], x.shape[3]
    th, tw = int(target_hw[0]), int(target_hw[1])
    if th == 2 * h and tw == 2 * w:
        return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return F.interpolate(x, size=(th, tw), mode="nearest-exact")


def gather(x: torch.Tensor) -> torch.Tensor:
    """The whole width of a head output map (under a split, its ranks'
    columns put together on every rank; else `x`)."""
    split = _SPLIT.get()
    return x if split is None else split.gather(x)


def active():
    """The active column split, or None."""
    return _SPLIT.get()


@contextlib.contextmanager
def split_columns(split):
    """Within the context, the functions above run on `split` (an object
    with their methods, parallel/spatial.py)."""
    token = _SPLIT.set(split)
    try:
        yield split
    finally:
        _SPLIT.reset(token)
