"""Width-sharded single-image inference (port of the JAX package's
`make_detect_fn(mesh=..., shard_spatial=True)`,
ground_plane_polling_tpu/inference.py:111-119, 187-204).

JAX shards the image width over the mesh and XLA's SPMD partitioner runs
the conv trunk on each device's columns, with halo exchanges, gathering
the head output maps at the anchor flatten. Here each rank of a
DataParallelMesh (one process a device) holds a contiguous range of
columns of every map of the forward: `owned`, a pure function of (width,
ranks, rank), so ranges are uneven where a width does not divide. Every
operation that reads across columns runs on this rank's output columns
and takes the input columns they read from their owners:

  * every conv (`_intercept` of models/quantize.py routes each call to
    `ColumnSplit.conv`), with a halo for a kernel wider than 1 and
    realignment where a stride-2 output's columns do not lie over the
    input columns this rank owns;
  * the pools and the FPN's nearest upsampling (models/width.py);
  * the head output maps, gathered whole onto every rank
    (`width.gather`) before the heads flatten them.

Padding applies only at the image's true left and right edges: zeros for
convs, -inf for max pools, counted zeros for DenseNet's average pool.
Elementwise operations, frozen BN, residual adds and channel concats run
on the columns as they are.

The exchange (`ColumnSplit.fetch`) uses one all-reduce of fixed-width
edge strips (`DataParallelMesh.all_gather`), which NCCL and gloo both
have; no rank gathers a whole map before the heads. A map's global width
is not seen in its columns, so `record_widths` runs the forward once on
the meta device (shapes only) and notes each width operation's global
input width in call order; the sharded forward takes them in the same
order and checks each against the columns it holds. The upsamplings'
index tables (which input column and row each output copies, and the
columns each rank needs) are read from the resize once, when the
SpatialModel is built, and stay on the device: the forward reads nothing
back to the host, so a CUDA graph can capture it.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from ..models import width
from ..models.fpn import SameConv2d
from ..models.quantize import QuantizedModel, _intercept

__all__ = ["owned", "ColumnSplit", "SpatialModel", "record_widths",
           "upsample_tables", "conv_window_bound"]


def owned(size: int, ranks: int, rank: int):
    """[start, stop) of the columns of a map `size` wide that `rank` of
    `ranks` holds: floor(rank size / ranks) on. A rank holds none where
    the map is narrower than the ranks."""
    return rank * size // ranks, (rank + 1) * size // ranks


def conv_window_bound(size: int, ranks: int, kernel: int) -> int:
    """The widest input a rank's conv may take on a map `size` wide: the
    widest slab, ceil(size / ranks), plus a halo of kernel - 1 columns
    (the realignment of a stride-2 output fits in the same bound)."""
    return -(-size // ranks) + kernel - 1


def float_conv(site, conv, x, pad):
    """The float conv of `conv` on x with pad ((top, bottom), (left,
    right)) of zeros."""
    (top, bottom), (left, right) = pad
    if top != bottom or left != right:
        x = F.pad(x, (left, right, top, bottom))
        top = left = 0
    return F.conv2d(x, conv.weight, conv.bias, conv.stride, (top, left),
                    conv.dilation, conv.groups)


def conv_pads(conv, h: int, w: int):
    """((top, bottom), (left, right)) of `conv` on a map h x w (the global
    width): SameConv2d's SAME padding, else its symmetric padding."""
    if isinstance(conv, SameConv2d):
        return width.same_padding(h, w, conv.kernel_size[0], conv.stride[0])
    ph, pw = conv.padding
    return (ph, ph), (pw, pw)


class _Recorder:
    """The width layer of `record_widths`: plain ops that note, in call
    order, each one's kind and its input's global width."""

    def __init__(self):
        self.widths = []

    def conv(self, site, conv, x):
        self.widths.append(("conv", x.shape[3]))
        return type(conv).forward(conv, x)

    def pool2d(self, x, kind, kernel, stride, padding):
        self.widths.append(("pool", x.shape[3]))
        with width.split_columns(None):
            return width.pool2d(x, kind, kernel, stride, padding)

    def upsample_to(self, x, target_hw):
        self.widths.append(("upsample", (x.shape[3], int(target_hw[1]),
                                         x.shape[2], int(target_hw[0]))))
        with width.split_columns(None):
            return width.upsample_to(x, target_hw)

    def gather(self, x):
        self.widths.append(("gather", x.shape[3]))
        return x


def record_widths(model, image_shape) -> list:
    """[(kind, global input width)] of every width operation of model's
    forward on images of `image_shape`, in call order, from a pass on the
    meta device (no weight is read). An upsampling's entry is (input
    width, target width, input height, target height)."""
    meta = {name: torch.empty_like(t, device="meta") for name, t in
            itertools.chain(model.named_parameters(), model.named_buffers())}
    rec = _Recorder()
    images = torch.empty((1, 3, *image_shape), device="meta")
    with torch.no_grad(), width.split_columns(rec), \
            _intercept(model, rec.conv):
        torch.func.functional_call(model, meta, (images,))
    return rec.widths


class ColumnSplit:
    """One forward's width layer on this rank's columns (models/width.py
    calls its methods, and `_intercept` its `conv`). `widths` comes from
    `record_widths`, `tables` from `upsample_tables` (by the operation's
    position); `inner(site, conv, x, pad)` runs a conv site on the window
    of columns it reads (float_conv, or the int8 conv of a
    QuantizedModel). `windows` notes each conv's (global input width,
    kernel, width of the window it ran on)."""

    def __init__(self, mesh, widths, tables, inner=float_conv):
        self.mesh = mesh
        self.widths = widths
        self.tables = tables
        self.inner = inner
        self.at = 0
        self.windows = []

    def _next(self, kind, x):
        """The recorded global width of this operation's input, checked
        against the columns that x holds."""
        if self.at >= len(self.widths) or self.widths[self.at][0] != kind:
            raise RuntimeError(
                f"width operation {self.at} is a {kind}, which the shape "
                "pass did not record there: the forward's order changed")
        size = self.widths[self.at][1]
        self.at += 1
        held = size[0] if kind == "upsample" else size
        start, stop = owned(held, self.mesh.size, self.mesh.rank)
        if x.shape[3] != stop - start:
            raise RuntimeError(
                f"width operation {self.at - 1} ({kind}) got {x.shape[3]} "
                f"columns, but rank {self.mesh.rank} holds {stop - start} "
                f"of {held}")
        return size

    def fetch(self, x, size, need):
        """This rank's columns [lo, hi) of a map `size` wide, of which x
        holds this rank's own; need[q] = (lo, hi) of each rank q, within
        [0, size). Columns of other ranks come from one all-gather of
        every rank's edge strips, as wide as the farthest reach of any
        rank past its own columns (none if no rank reaches past)."""
        n, r = self.mesh.size, self.mesh.rank
        own = [owned(size, n, q) for q in range(n)]
        reach = max([max(a - lo, hi - b, 0) for (a, b), (lo, hi)
                     in zip(own, need) if hi > lo] or [0])
        a, b = own[r]
        lo, hi = need[r]
        if reach == 0:
            return x[..., max(lo - a, 0):max(hi - a, 0)]
        held = b - a
        strips = x.new_zeros((2, *x.shape[:3], reach))
        edge = min(reach, held)
        if edge:
            strips[0, ..., :edge] = x[..., :edge]            # left edge
            strips[1, ..., reach - edge:] = x[..., held - edge:]  # right
        strips = self.mesh.all_gather(strips)
        pieces = []
        for q, (qa, qb) in enumerate(own):
            u, v = max(lo, qa), min(hi, qb)
            if u >= v:
                continue
            if q == r:
                pieces.append(x[..., u - a:v - a])
            elif q < r:  # the right edge of a rank to the left
                pieces.append(strips[q, 1, ..., u - qb + reach:v - qb + reach])
            else:
                pieces.append(strips[q, 0, ..., u - qa:v - qa])
        if not pieces:
            return x[..., :0]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=3)

    def window(self, x, size, kernel, stride, left, right, fill):
        """(columns, n): the input window of this rank's n output columns of
        a `kernel` wide, `stride` window op over a map `size` wide padded
        with `left` and `right` columns of `fill`. A rank with no output
        column gets `kernel` columns of fill (its op's one output column
        is dropped)."""
        n, r = self.mesh.size, self.mesh.rank
        out = (size + left + right - kernel) // stride + 1
        need, spans = [], []
        for q in range(n):
            c, d = owned(out, n, q)
            lo, hi = c * stride - left, (d - 1) * stride - left + kernel
            spans.append((lo, hi, d - c))
            need.append((max(lo, 0), min(hi, size)) if d > c else (0, 0))
        lo, hi, n_out = spans[r]
        cols = self.fetch(x, size, need)
        if n_out == 0:
            return x.new_full((*x.shape[:3], kernel), fill), 0
        pads = (max(-lo, 0), max(hi - size, 0))
        if any(pads):
            cols = F.pad(cols, pads, value=fill)
        return cols, n_out

    def conv(self, site, conv, x):
        size = self._next("conv", x)
        (top, bottom), (left, right) = conv_pads(conv, x.shape[2], size)
        xw, n_out = self.window(x, size, conv.kernel_size[1], conv.stride[1],
                                left, right, 0.0)
        self.windows.append((size, conv.kernel_size[1], xw.shape[3]))
        y = self.inner(site, conv, xw, ((top, bottom), (0, 0)))
        return y[..., :n_out]

    def pool2d(self, x, kind, kernel, stride, padding):
        size = self._next("pool", x)
        (top, bottom), (left, right) = width.pool_padding(
            x.shape[2], size, kernel, stride, padding)
        fill = width.pool_fill(kind)
        xw, n_out = self.window(x, size, kernel, stride, left, right, fill)
        xw = F.pad(xw, (0, 0, top, bottom), value=fill)
        pool = F.max_pool2d if kind == "max" else F.avg_pool2d
        return pool(xw, kernel, stride=stride)[..., :n_out]

    def upsample_to(self, x, target_hw):
        """Nearest: each output column copies one input column, the one
        torch's own resize picks on this device (models/width.py), by the
        operation's tables (`upsample_tables`)."""
        at = self.at
        size, target, height, target_h = self._next("upsample", x)
        need, rows, cols = self.tables[at]
        # target_hw's width is this rank's columns of the target
        if (x.shape[2], int(target_hw[0]), int(target_hw[1])) != (
                height, target_h, len(cols)):
            raise RuntimeError(
                f"upsampling {at} of a {x.shape[2]}-row map to "
                f"{tuple(target_hw)}, but the shape pass recorded "
                f"{height} rows to {target_h}, and rank {self.mesh.rank} "
                f"holds {len(cols)} of the {target} target columns")
        return self.fetch(x, size, need).index_select(2, rows).index_select(
            3, cols)

    def gather(self, x):
        """The whole map on every rank: each rank's columns, in rank
        order, from one all-gather of slabs as wide as the widest."""
        size = self._next("gather", x)
        n = self.mesh.size
        own = [owned(size, n, q) for q in range(n)]
        wide = max(b - a for a, b in own)
        slab = x.new_zeros((*x.shape[:3], wide))
        slab[..., :x.shape[3]] = x
        slabs = self.mesh.all_gather(slab)
        return torch.cat([slabs[q, ..., :b - a]
                          for q, (a, b) in enumerate(own)], dim=3)


def _nearest_source(size: int, target: int, device) -> torch.Tensor:
    """The input index that each of `target` outputs of models/width.py's
    nearest resize of `size` reads (a repeat where the size doubles, else
    'nearest-exact'), from the resize itself on `device`, as int64."""
    index = torch.arange(size, dtype=torch.float32, device=device)
    if target == 2 * size:
        return index.repeat_interleave(2).long()
    return F.interpolate(index.view(1, 1, size), size=target,
                         mode="nearest-exact").view(target).long()


def upsample_tables(widths, ranks: int, rank: int, device) -> dict:
    """{position of an upsampling in `widths`: (need, rows, cols)}: every
    rank's input columns [lo, hi) (`ColumnSplit.fetch`'s need), and, on
    `device`, the input row that each output row copies and the column of
    the fetched ones that each of this rank's output columns copies. The
    indices come from the resize on `device` (`_nearest_source`), read
    back here, once."""
    tables = {}
    for at, (kind, size) in enumerate(widths):
        if kind != "upsample":
            continue
        width_in, target, height, target_h = size
        src = _nearest_source(width_in, target, device)
        src_host = src.tolist()
        need = []
        for q in range(ranks):
            c, d = owned(target, ranks, q)
            need.append((src_host[c], src_host[d - 1] + 1) if d > c
                        else (0, 0))
        c, d = owned(target, ranks, rank)
        tables[at] = (need, _nearest_source(height, target_h, device),
                      src[c:d] - need[rank][0])
    return tables


class SpatialModel:
    """`model` (or a models.quantize.QuantizedModel) run with one image's
    width split over `mesh`: called with this rank's columns of the NCHW
    images (`columns`), it returns the whole head outputs on every rank.
    `last` is the ColumnSplit of the latest call (its conv windows; a
    replayed CUDA graph runs no Python, so after a replay the
    capture's)."""

    def __init__(self, model, mesh, image_shape):
        quantized = isinstance(model, QuantizedModel)
        self.model = model.model if quantized else model
        self.inner = model._conv if quantized else float_conv
        self.n_sites = len(model.scales) if quantized else None
        self.mesh = mesh
        self.image_width = int(image_shape[1])
        self.widths = record_widths(self.model, image_shape)
        self.tables = upsample_tables(self.widths, mesh.size, mesh.rank,
                                      mesh.device)
        self.last = None

    def columns(self) -> slice:
        """This rank's columns of the image."""
        return slice(*owned(self.image_width, self.mesh.size,
                            self.mesh.rank))

    def __call__(self, images):
        split = ColumnSplit(self.mesh, self.widths, self.tables, self.inner)
        with width.split_columns(split), \
                _intercept(self.model, split.conv) as sites:
            out = self.model(images)
        if split.at != len(self.widths):
            raise RuntimeError(f"{split.at} of {len(self.widths)} recorded "
                               "width operations ran")
        if self.n_sites is not None and sites[0] != self.n_sites:
            raise ValueError(f"{self.n_sites} int8 scales for a forward "
                             f"with {sites[0]} conv sites")
        self.last = split
        return out
