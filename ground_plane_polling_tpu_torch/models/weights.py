"""Weight bridge from the JAX package and the seeded init.

`load_jax_params` reads the flat `params/...` and `frozen/...` arrays that
ground_plane_polling_tpu/training/checkpoint.py::export_params writes (one
`.npz`) and returns a state dict for the detector of `build_detector`:
conv kernels go from HWIO to OIHW, and each FrozenBatchNorm's
scale/bias/mean/var (eps 1e-5) becomes its per-channel scale and shift.
Module names mirror the Flax tree, so the mapping is by name.
`export_jax_params` writes the same layout back from a model (frozen BN as
gamma = scale, beta = shift, mean 0, var 1 - eps).

`init_detector` makes random weights from a seed with the JAX package's
init semantics: lecun_normal trunk and FPN convs, N(0, 0.01) tower and
out convs, zero biases, a zero classification out kernel with the
prior-probability bias, and identity frozen BN.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import (BN_EPS, PRIOR_PROB_BIAS, FrozenBatchNorm,
                     frozen_bn_affine)

__all__ = ["load_jax_params", "export_jax_params", "load_npz",
           "load_weights", "init_detector"]

_BN_FIELDS = ("scale", "bias", "mean", "var")
_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def load_npz(path: str) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def load_jax_params(flat: dict) -> dict:
    """Flat JAX export -> torch state dict. Raises ValueError on any key it
    cannot place; `load_weights` adds the strict check on the module side."""
    state, bns, bad = {}, {}, []
    for key, value in flat.items():
        collection, _, path = key.partition("/")
        parts = path.split("/")
        value = np.asarray(value, np.float32)
        if collection == "params" and parts[-1] == "kernel" and value.ndim == 4:
            state[".".join(parts[:-1]) + ".weight"] = torch.from_numpy(
                np.ascontiguousarray(value.transpose(3, 2, 0, 1)))
        elif collection == "params" and parts[-1] == "bias" and value.ndim == 1:
            state[".".join(parts[:-1]) + ".bias"] = torch.from_numpy(value)
        elif collection == "frozen" and parts[-1] in _BN_FIELDS:
            bns.setdefault(".".join(parts[:-1]), {})[parts[-1]] = value
        else:
            bad.append(key)
    for name, fields in bns.items():
        if set(fields) != set(_BN_FIELDS):
            bad.append(f"frozen/{name.replace('.', '/')} "
                       f"(has {sorted(fields)}, needs {list(_BN_FIELDS)})")
            continue
        scale, shift = frozen_bn_affine(
            *(torch.from_numpy(fields[f]) for f in _BN_FIELDS))
        state[name + ".scale"] = scale
        state[name + ".shift"] = shift
    if bad:
        raise ValueError(f"cannot map {len(bad)} weight entries: {bad[:10]}")
    return state


def export_jax_params(model: torch.nn.Module) -> dict:
    """Model -> the flat `params/...` / `frozen/...` arrays of the JAX
    package's export (inverse of `load_jax_params` up to float rounding)."""
    flat = {}
    for name, module in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(module, torch.nn.Conv2d):
            flat[f"params/{path}/kernel"] = (
                module.weight.detach().float().cpu().permute(2, 3, 1, 0)
                .numpy().copy())
            if module.bias is not None:
                flat[f"params/{path}/bias"] = (
                    module.bias.detach().float().cpu().numpy().copy())
        elif isinstance(module, FrozenBatchNorm):
            scale = module.scale.detach().float().cpu().numpy()
            flat[f"frozen/{path}/scale"] = scale.copy()
            flat[f"frozen/{path}/bias"] = (
                module.shift.detach().float().cpu().numpy().copy())
            flat[f"frozen/{path}/mean"] = np.zeros_like(scale)
            flat[f"frozen/{path}/var"] = np.full_like(scale, 1.0 - BN_EPS)
    return flat


def load_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Strictly load an exported `.npz` into `model`: every array is used
    and every module weight is filled, or this raises."""
    state = load_jax_params(load_npz(path))
    ref = model.state_dict()
    missing = sorted(set(ref) - set(state))
    unexpected = sorted(set(state) - set(ref))
    shapes = [k for k in set(ref) & set(state) if ref[k].shape != state[k].shape]
    if missing or unexpected or shapes:
        raise ValueError(
            f"{path}: weights do not match the model: missing {missing[:10]}, "
            f"unexpected {unexpected[:10]}, shape mismatch {sorted(shapes)[:10]}")
    model.load_state_dict(state, strict=True)
    return model


@torch.no_grad()
def init_detector(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded random weights with the JAX package's init semantics."""
    gen = torch.Generator().manual_seed(seed)
    heads = ("regression.", "classification.", "regression_dim.")
    for name, module in model.named_modules():
        if isinstance(module, FrozenBatchNorm):
            scale, shift = frozen_bn_affine(
                torch.ones_like(module.scale, device="cpu"),
                torch.zeros_like(module.shift, device="cpu"),
                torch.zeros_like(module.shift, device="cpu"),
                torch.ones_like(module.scale, device="cpu"))
            module.scale.copy_(scale)
            module.shift.copy_(shift)
        if not isinstance(module, torch.nn.Conv2d):
            continue
        w = torch.empty(module.weight.shape)
        if name == "classification.cls_out":
            w.zero_()
        elif name.startswith(heads):
            w.normal_(0.0, 0.01, generator=gen)
        else:  # lecun_normal: truncated normal, variance 1 / fan_in
            o, i, kh, kw = w.shape
            std = math.sqrt(1.0 / (i * kh * kw)) / _TRUNC_STD
            torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                        generator=gen)
        module.weight.copy_(w)
        if module.bias is not None:
            module.bias.fill_(PRIOR_PROB_BIAS if name == "classification.cls_out"
                              else 0.0)
    return model
