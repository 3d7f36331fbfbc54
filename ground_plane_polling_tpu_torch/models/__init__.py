"""Backbone registry and detector factory (port of
ground_plane_polling_tpu/models/__init__.py)."""

from __future__ import annotations

import functools

from . import densenet, mobilenet, tiny, vgg
from .resnet import RESNET_STAGES, ResNetBackbone
from .retinanet import GPPRetinaNet
from .weights import (export_jax_params, fuse_detector_params, init_detector,
                      load_jax_params, load_state, load_weights, read_weights)

__all__ = ["backbone_registry", "build_detector", "fuse_detector_params",
           "GPPRetinaNet", "RESNET_STAGES", "export_jax_params",
           "init_detector", "load_jax_params", "load_state", "load_weights",
           "read_weights"]


def backbone_registry() -> dict:
    """Backbone name -> constructor of an (images -> (C3, C4, C5))
    module whose `channels` are the widths of C3, C4 and C5: the JAX
    package's 13 names."""
    reg = {name: functools.partial(ResNetBackbone, stages)
           for name, stages in RESNET_STAGES.items()}
    for module in (vgg, densenet, mobilenet, tiny):
        reg.update(module.REGISTRY)
    return reg


def build_detector(backbone: str = "resnet50", num_classes: int = 1,
                   feature_size: int = 512, fuse_cls_dim: bool = False,
                   remat: bool = False) -> GPPRetinaNet:
    """The detector for a backbone name, on the CPU in float32; load or
    init weights, then move it with `.to(device, dtype)`. `fuse_cls_dim`
    runs the classification and dimension heads as one block-diagonal tower
    (inference only; `load_weights` converts split weights). `remat`
    rematerializes the backbone's blocks on the backward pass (ResNet
    family only)."""
    reg = backbone_registry()
    if backbone not in reg:
        raise ValueError(
            f"unknown backbone {backbone!r}; available: {sorted(reg)}")
    if remat:
        if backbone not in RESNET_STAGES:
            raise ValueError("remat is implemented for the resnet family")
        net = reg[backbone](remat=True)
    else:
        net = reg[backbone]()
    return GPPRetinaNet(net, backbone_channels=net.channels,
                        num_classes=num_classes, feature_size=feature_size,
                        fuse_cls_dim=fuse_cls_dim)
