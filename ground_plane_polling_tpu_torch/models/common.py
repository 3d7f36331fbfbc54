"""Shared model building blocks (port of
ground_plane_polling_tpu/models/common.py).

FrozenBatchNorm is inference-mode batch norm with constant statistics,
y = gamma (x - mean) / sqrt(var + eps) + beta. As in the JAX package it is
applied after the conv, in the compute dtype, as one per-channel
y = x * scale + shift; it is not folded into the conv weights. The weight
bridge (models/weights.py) turns gamma/beta/mean/var into scale/shift.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["FrozenBatchNorm", "BN_EPS", "PRIOR_PROB_BIAS",
           "prior_prob_bias", "frozen_bn_affine"]

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
        return (x * self.scale.to(x.dtype)[:, None, None]
                + self.shift.to(x.dtype)[:, None, None])
