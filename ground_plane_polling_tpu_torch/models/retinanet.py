"""GPP-RetinaNet assembly: backbone -> FPN -> shared heads over P3..P7
(port of ground_plane_polling_tpu/models/retinanet.py, levels not packed).
With `fuse_cls_dim` the classification and dimension heads run as one
block-diagonal tower (`clsdim`, heads.FusedClsDimHead); the outputs are the
same.

forward takes NCHW float images and returns the per-anchor regression
(B, A, 12), dimension regression (B, A, 3C) and sigmoid classification
(B, A, 8C), float32, concatenated over levels in P3..P7 order.
"""

from __future__ import annotations

import torch
from torch import nn

from .fpn import FPN
from .heads import (BoxRegressionHead, ClassificationHead, DimRegressionHead,
                    FusedClsDimHead)

__all__ = ["GPPRetinaNet"]


class GPPRetinaNet(nn.Module):
    def __init__(self, backbone: nn.Module, backbone_channels=(512, 1024, 2048),
                 num_classes: int = 1, num_anchors: int = 12,
                 feature_size: int = 512, fuse_cls_dim: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.fuse_cls_dim = fuse_cls_dim
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
        # the JAX package's call order (box, then dim, then cls; or box,
        # then the fused tower): int8 calibration numbers conv sites by it
        regression = [self.regression(f) for f in features]
        if self.fuse_cls_dim:
            cls, dim = zip(*(self.clsdim(f) for f in features))
        else:
            dim = [self.regression_dim(f) for f in features]
            cls = [self.classification(f) for f in features]
        return {
            "regression": torch.cat(regression, dim=1),
            "regression_dim": torch.cat(dim, dim=1),
            "classification": torch.cat(cls, dim=1),
        }
