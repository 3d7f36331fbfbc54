"""Detector factory (port of ground_plane_polling_tpu/models/__init__.py for
the resnet family)."""

from __future__ import annotations

from .resnet import RESNET_STAGES, ResNetBackbone
from .retinanet import GPPRetinaNet
from .weights import (export_jax_params, fuse_detector_params, init_detector,
                      load_jax_params, load_weights)

__all__ = ["build_detector", "fuse_detector_params", "GPPRetinaNet",
           "RESNET_STAGES", "export_jax_params", "init_detector",
           "load_jax_params", "load_weights"]


def build_detector(backbone: str = "resnet50", num_classes: int = 1,
                   feature_size: int = 512, fuse_cls_dim: bool = False,
                   remat: bool = False) -> GPPRetinaNet:
    """The detector for a backbone name, on the CPU in float32; load or
    init weights, then move it with `.to(device, dtype)`. `fuse_cls_dim`
    runs the classification and dimension heads as one block-diagonal tower
    (inference only; `load_weights` converts split weights). `remat`
    rematerializes the backbone's blocks on the backward pass (ResNet
    family only)."""
    if remat and backbone not in RESNET_STAGES:
        raise ValueError("remat is implemented for the resnet family")
    if backbone not in RESNET_STAGES:
        raise ValueError(
            f"unsupported backbone {backbone!r}; this port supports "
            f"{sorted(RESNET_STAGES)} (other backbones: ROADMAP A17)")
    return GPPRetinaNet(ResNetBackbone(RESNET_STAGES[backbone], remat=remat),
                        num_classes=num_classes, feature_size=feature_size,
                        fuse_cls_dim=fuse_cls_dim)
