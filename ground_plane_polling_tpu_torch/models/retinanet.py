"""GPP-RetinaNet assembly: backbone -> FPN -> shared heads over P3..P7
(port of ground_plane_polling_tpu/models/retinanet.py). With
`fuse_cls_dim` the classification and dimension heads run as one
block-diagonal tower (`clsdim`, heads.FusedClsDimHead); the outputs are the
same.

With `pack_levels`, P4..P7 are packed into one canvas (`_pack_tail`), so
each head runs twice a forward (on P3, then on the canvas) instead of five
times; the gap pixels are re-zeroed after every tower ReLU, so the maps
sliced out of the canvas are those of the per-level convs. The parameters
are the same tree either way.

forward takes NCHW float images and returns the per-anchor regression
(B, A, 12), dimension regression (B, A, 3C) and sigmoid classification
(B, A, 8C), float32, concatenated over levels in P3..P7 order.
"""

from __future__ import annotations

import torch
from torch import nn

from . import width
from .fpn import FPN
from .heads import (BoxRegressionHead, ClassificationHead, DimRegressionHead,
                    FusedClsDimHead)

__all__ = ["GPPRetinaNet"]


def _pack_tail(features, gap: int = 1):
    """Pack P4..P7 (NCHW) into one canvas: P4 at the origin, the rest
    stacked in a column to its right, `gap` zero pixels between regions.

    Returns (canvas, mask (1, 1, H, W) of ones on the levels, layout
    [(row, col, h, w)] per level). The canvas keeps the memory format of
    the features (channels-last on the card, where cuDNN would otherwise
    convert it at every tower conv)."""
    f0 = features[0]
    b, c, h0, w0 = f0.shape
    col_w = max(f.shape[3] for f in features[1:])
    col_h = sum(f.shape[2] for f in features[1:]) + gap * (len(features) - 2)
    H, W = max(h0, col_h), w0 + gap + col_w
    fmt = (torch.channels_last
           if f0.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    canvas = torch.empty((b, c, H, W), dtype=f0.dtype, device=f0.device,
                         memory_format=fmt).zero_()
    mask = torch.zeros((1, 1, H, W), dtype=f0.dtype, device=f0.device)
    layout = [(0, 0, h0, w0)]
    r = 0
    for f in features[1:]:
        layout.append((r, w0 + gap, f.shape[2], f.shape[3]))
        r += f.shape[2] + gap
    for f, (r, col, h, w) in zip(features, layout):
        canvas[:, :, r:r + h, col:col + w] = f
        mask[:, :, r:r + h, col:col + w] = 1.0
    return canvas, mask, layout


class GPPRetinaNet(nn.Module):
    def __init__(self, backbone: nn.Module, backbone_channels=(512, 1024, 2048),
                 num_classes: int = 1, num_anchors: int = 12,
                 feature_size: int = 512, fuse_cls_dim: bool = False,
                 pack_levels: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.fuse_cls_dim = fuse_cls_dim
        self.pack_levels = pack_levels
        self.backbone = backbone
        self.fpn = FPN(backbone_channels, feature_size)
        self.regression = BoxRegressionHead(feature_size, num_anchors)
        if fuse_cls_dim:
            self.clsdim = FusedClsDimHead(feature_size, num_classes,
                                          num_anchors)
        else:
            self.classification = ClassificationHead(
                feature_size, num_classes, num_anchors)
            self.regression_dim = DimRegressionHead(
                feature_size, num_classes, num_anchors)

    def forward(self, images: torch.Tensor) -> dict:
        features = self.fpn(*self.backbone(images))
        # under a column split (parallel/spatial.py) the heads run per
        # level: each rank holds columns of every level, not of a canvas
        if self.pack_levels and width.active() is None:
            canvas, mask, layout = _pack_tail(features[1:])

            def raw_maps(head):
                p3 = head.raw(features[0])
                tail = head.raw(canvas, mask)
                return [p3] + [tail[:, :, r:r + h, c:c + w]
                               for r, c, h, w in layout]
        else:
            def raw_maps(head):
                return [width.gather(head.raw(f)) for f in features]

        def run(head):
            out = [head.finalize(m) for m in raw_maps(head)]
            if isinstance(out[0], tuple):  # FusedClsDimHead
                return tuple(torch.cat(p, dim=1) for p in zip(*out))
            return torch.cat(out, dim=1)

        # the JAX package's call order (box, then dim, then cls; or box,
        # then the fused tower; each on P3 before the packed tail): int8
        # calibration numbers conv sites by it
        regression = run(self.regression)
        if self.fuse_cls_dim:
            classification, regression_dim = run(self.clsdim)
        else:
            regression_dim = run(self.regression_dim)
            classification = run(self.classification)
        return {
            "regression": regression,
            "regression_dim": regression_dim,
            "classification": classification,
        }
