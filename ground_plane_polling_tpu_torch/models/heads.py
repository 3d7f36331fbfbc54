"""Per-level prediction heads, shared across pyramid levels (port of
ground_plane_polling_tpu/models/heads.py).

  * classification: 4x conv(256)+relu, out conv -> A * 8C, sigmoid. Layout
    per anchor is 8C = [sign-half 0 | sign-half 1], each half 4*c + o.
  * box/keypoint regression: 4x conv(512)+relu, out conv -> A * 12.
  * dimension regression: 4x conv(128)+relu, out conv -> A * 3C.
  * fused classification + dimension (`--fuse-towers`): one 384-wide tower
    with block-diagonal kernels, exactly the two split heads;
    `fuse_cls_dim_params` converts split weights.

Each head returns (B, H*W*A, K) float32 per level: `forward` is
`finalize(raw(x))`. `raw(x, mask)` runs the tower and the out conv on one
map and gives the raw NCHW output map; with a `mask` (a packed canvas of
levels, models/retinanet.py) the gap pixels are re-zeroed after every
tower ReLU, so that each level's border reads zeros as in its own SAME
conv (the out conv is not masked: its gap outputs are sliced away).
`finalize` flattens a map (permuted to NHWC before the reshape, so anchors
come out in (h, w, anchor) order, matching ops.anchors.anchors_for_shape)
and casts it to float32, with the sigmoid for classification.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ClassificationHead", "BoxRegressionHead", "DimRegressionHead",
           "FusedClsDimHead", "fuse_cls_dim_params"]


def _flatten_anchors(x: torch.Tensor, per_anchor: int) -> torch.Tensor:
    b, ch, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w * (ch // per_anchor),
                                         per_anchor)


class _Head(nn.Module):
    """4x conv+relu tower and an out conv; subclasses name the layers."""

    prefix = ""

    def __init__(self, cin: int, width: int, out_ch: int):
        super().__init__()
        for i in range(4):
            self.add_module(f"{self.prefix}_{i}",
                            nn.Conv2d(cin if i == 0 else width, width, 3,
                                      padding=1))
        self.add_module(f"{self.prefix}_out",
                        nn.Conv2d(width, out_ch, 3, padding=1))

    def raw(self, x, mask=None):
        for i in range(4):
            x = F.relu(getattr(self, f"{self.prefix}_{i}")(x))
            if mask is not None:
                x = x * mask
        return getattr(self, f"{self.prefix}_out")(x)

    def forward(self, x):
        return self.finalize(self.raw(x))


class ClassificationHead(_Head):
    prefix = "cls"

    def __init__(self, cin: int, num_classes: int = 1, num_anchors: int = 12,
                 width: int = 256):
        super().__init__(cin, width, num_anchors * 8 * num_classes)
        self.per_anchor = 8 * num_classes

    def finalize(self, x):
        return torch.sigmoid(_flatten_anchors(x, self.per_anchor).float())


class BoxRegressionHead(_Head):
    prefix = "box"

    def __init__(self, cin: int, num_anchors: int = 12, width: int = 512):
        super().__init__(cin, width, num_anchors * 12)

    def finalize(self, x):
        return _flatten_anchors(x, 12).float()


class DimRegressionHead(_Head):
    prefix = "dim"

    def __init__(self, cin: int, num_classes: int = 1, num_anchors: int = 12,
                 width: int = 128):
        super().__init__(cin, width, num_anchors * 3 * num_classes)
        self.per_anchor = 3 * num_classes

    def finalize(self, x):
        return _flatten_anchors(x, self.per_anchor).float()


class FusedClsDimHead(_Head):
    """Classification and dimension heads as ONE (cls_width + dim_width)-wide
    tower. Both read the same pyramid feature, so with the weights of
    `fuse_cls_dim_params` (layer 0 concatenated over output channels,
    layers 1-3 and the out conv block-diagonal) it computes exactly what
    the two split heads compute: convolution is linear in the channels and
    ReLU is elementwise. Inference only; returns (classification,
    regression_dim)."""

    prefix = "clsdim"

    def __init__(self, cin: int, num_classes: int = 1, num_anchors: int = 12,
                 cls_width: int = 256, dim_width: int = 128):
        cls_ch = num_anchors * 8 * num_classes
        super().__init__(cin, cls_width + dim_width,
                         cls_ch + num_anchors * 3 * num_classes)
        self.cls_ch, self.cls_width = cls_ch, cls_width
        self.num_classes = num_classes

    def finalize(self, x):
        cls_map, dim_map = x[:, :self.cls_ch], x[:, self.cls_ch:]
        classification = torch.sigmoid(
            _flatten_anchors(cls_map, 8 * self.num_classes).float())
        return (classification,
                _flatten_anchors(dim_map, 3 * self.num_classes).float())


def _block_diag(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """OIHW kernel [[k1, 0], [0, k2]] over (output, input) channels."""
    o1, i1 = k1.shape[:2]
    o2, i2 = k2.shape[:2]
    out = k1.new_zeros((o1 + o2, i1 + i2, *k1.shape[2:]))
    out[:o1, :i1] = k1
    out[o1:, i1:] = k2
    return out


def fuse_cls_dim_params(cls_state: dict, dim_state: dict) -> dict:
    """Split head weights -> FusedClsDimHead weights, float32 OIHW state
    dicts keyed by layer ('cls_0.weight', 'dim_out.bias', ... in,
    'clsdim_0.weight', ... out). Layer 0 kernels concatenate over output
    channels (both towers read the whole feature); layers 1-3 and the out
    conv become block-diagonal. Exact."""
    need = [f"{p}_{i}.{leaf}" for p, state in (("cls", cls_state),
                                                ("dim", dim_state))
            for i in (0, 1, 2, 3, "out") for leaf in ("weight", "bias")]
    missing = [k for k in need if k not in {**cls_state, **dim_state}]
    if missing:
        raise ValueError(f"fuse_cls_dim_params: missing {missing}")
    fused = {}
    for i in (0, 1, 2, 3, "out"):
        ck = cls_state[f"cls_{i}.weight"].float()
        dk = dim_state[f"dim_{i}.weight"].float()
        fused[f"clsdim_{i}.weight"] = (torch.cat([ck, dk], 0) if i == 0
                                       else _block_diag(ck, dk))
        fused[f"clsdim_{i}.bias"] = torch.cat(
            [cls_state[f"cls_{i}.bias"].float(),
             dim_state[f"dim_{i}.bias"].float()])
    return fused
