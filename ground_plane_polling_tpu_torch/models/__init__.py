"""Detector factory (port of ground_plane_polling_tpu/models/__init__.py for
the resnet family)."""

from __future__ import annotations

from .resnet import RESNET_STAGES, ResNetBackbone
from .retinanet import GPPRetinaNet
from .weights import (export_jax_params, init_detector, load_jax_params,
                      load_weights)

__all__ = ["build_detector", "GPPRetinaNet", "RESNET_STAGES",
           "export_jax_params", "init_detector", "load_jax_params",
           "load_weights"]


def build_detector(backbone: str = "resnet50", num_classes: int = 1,
                   feature_size: int = 512) -> GPPRetinaNet:
    """The detector for a backbone name, on the CPU in float32; load or
    init weights, then move it with `.to(device, dtype)`."""
    if backbone not in RESNET_STAGES:
        raise ValueError(
            f"unsupported backbone {backbone!r}; this port supports "
            f"{sorted(RESNET_STAGES)} (other backbones: ROADMAP A17)")
    return GPPRetinaNet(ResNetBackbone(RESNET_STAGES[backbone]),
                        num_classes=num_classes, feature_size=feature_size)
