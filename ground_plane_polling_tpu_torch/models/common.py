"""Shared model building blocks (port of
ground_plane_polling_tpu/models/common.py).

FrozenBatchNorm is inference-mode batch norm with constant statistics,
y = gamma (x - mean) / sqrt(var + eps) + beta. As in the JAX package it is
applied after the conv, in the compute dtype, as one per-channel
y = x * scale + shift; it is not folded into the conv weights. The weight
bridge (models/weights.py) turns gamma/beta/mean/var into scale/shift.

`frozen_bn_act` is a ResNet site's BN with its residual add and ReLU. On
the card outside autograd it runs as one launch of
kernels/frozen_bn_cuda.py (csrc/frozen_bn.cu) instead of one elementwise
pass per operation, with the same roundings: each multiply and add rounded
to the map's type, bit for bit the plain expression. That covers every
site of an inference forward there (bf16, float32 and int8; a float32 or
bf16 map in channels-last memory with C a multiple of 8), and a map the
kernel does not take raises rather than fall back. On the CPU and under
autograd (the kernel has no backward: training, remat, the captured train
step) it runs the plain expression, `frozen_bn_cuda.plain`, which
FrozenBatchNorm's forward is too.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels import frozen_bn_cuda

__all__ = ["FrozenBatchNorm", "BN_EPS", "PRIOR_PROB_BIAS",
           "prior_prob_bias", "frozen_bn_act", "frozen_bn_affine"]

BN_EPS = 1e-5


def prior_prob_bias(probability: float = 0.01) -> float:
    """Classification out-conv bias -log((1-p)/p): the initial sigmoid
    output is p, as in the reference's prior-probability initializer."""
    return -math.log((1.0 - probability) / probability)


PRIOR_PROB_BIAS = prior_prob_bias(0.01)


def frozen_bn_affine(gamma, beta, mean, var, eps: float = BN_EPS):
    """float32 (scale, shift) of a frozen batch norm, computed as the JAX
    package's FrozenBatchNorm does."""
    inv = gamma * torch.reciprocal(torch.sqrt(var + eps))
    return inv, beta - mean * inv


class FrozenBatchNorm(nn.Module):
    """Per-channel affine on NCHW input with constant buffers."""

    def __init__(self, channels: int):
        super().__init__()
        ones = torch.ones(channels)
        scale, shift = frozen_bn_affine(ones, torch.zeros(channels),
                                        torch.zeros(channels), ones)
        self.register_buffer("scale", scale)
        self.register_buffer("shift", shift)

    def forward(self, x):
        # in the input's dtype: under bf16 autocast the conv output is
        # bf16, and float32 buffers would lift every activation to f32
        return frozen_bn_cuda.plain(x, self.scale.to(x.dtype),
                                    self.shift.to(x.dtype), relu=False)


def frozen_bn_act(x, bn: FrozenBatchNorm, relu: bool, residual=None,
                  residual_bn: FrozenBatchNorm = None):
    """bn(x), plus the shortcut `residual` (after `residual_bn`, where the
    shortcut is a projection conv's output), then ReLU if `relu`: the
    kernel's wrapper outside autograd (one launch on the card, the plain
    passes on the CPU), else the plain passes, with the BNs' buffers in
    the map's type."""
    dtype = x.dtype
    proj = residual_bn is not None
    site = (frozen_bn_cuda.plain if torch.is_grad_enabled()
            else frozen_bn_cuda.frozen_bn_act)
    return site(x, bn.scale.to(dtype), bn.shift.to(dtype), relu, residual,
                residual_bn.scale.to(dtype) if proj else None,
                residual_bn.shift.to(dtype) if proj else None)
