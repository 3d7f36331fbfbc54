"""Weight bridge from the JAX package and the seeded init.

`load_jax_params` reads the flat `params/...` and `frozen/...` arrays that
ground_plane_polling_tpu/training/checkpoint.py::export_params writes (one
`.npz`) and returns a state dict for the detector of `build_detector`:
conv kernels go from HWIO to OIHW, and each FrozenBatchNorm's
scale/bias/mean/var (eps 1e-5) becomes its per-channel scale and shift.
Module names mirror the Flax tree, so the mapping is by name.
`export_jax_params` writes the same layout back from a model (frozen BN as
gamma = scale, beta = shift, mean 0, var 1 - eps); a fused model writes the
`params/clsdim/...` tree that the JAX package's fused model reads.
`fuse_detector_params` turns a split state dict into the fused one, and
`load_state` applies it when the model has fused towers. A reference Keras
`.h5` reaches the same arrays through models/h5_import.py (`read_weights`).

`init_detector` makes random weights from a seed with the JAX package's
init semantics: lecun_normal trunk and FPN convs, N(0, 0.01) tower and
out convs, zero biases, a zero classification out kernel with the
prior-probability bias, and identity frozen BN. The fused out conv keeps
that meaning per block: prior bias and a zero kernel on the classification
channels, N(0, 0.01) on the dimension block, zero elsewhere.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import (BN_EPS, PRIOR_PROB_BIAS, FrozenBatchNorm,
                     frozen_bn_affine)
from .heads import fuse_cls_dim_params

__all__ = ["load_jax_params", "export_jax_params", "fuse_detector_params",
           "load_npz", "load_state", "load_weights", "read_weights",
           "init_detector", "H5_SUFFIXES"]

H5_SUFFIXES = (".h5", ".hdf5")

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
    return state_to_jax_params(model.state_dict())


def state_to_jax_params(state: dict) -> dict:
    """A detector's state dict (conv weights and biases, FrozenBN scale and
    shift) -> the JAX package's flat export, as `export_jax_params`."""
    flat = {}
    for key, value in state.items():
        name, _, field = key.rpartition(".")
        path = name.replace(".", "/")
        value = value.detach().float().cpu()
        if field == "weight" and value.ndim == 4:
            flat[f"params/{path}/kernel"] = (
                value.permute(2, 3, 1, 0).numpy().copy())
        elif field == "bias":
            flat[f"params/{path}/bias"] = value.numpy().copy()
        elif field == "scale":
            scale = value.numpy()
            flat[f"frozen/{path}/scale"] = scale.copy()
            flat[f"frozen/{path}/mean"] = np.zeros_like(scale)
            flat[f"frozen/{path}/var"] = np.full_like(scale, 1.0 - BN_EPS)
        elif field == "shift":
            flat[f"frozen/{path}/bias"] = value.numpy().copy()
        else:
            raise ValueError(f"cannot export state entry {key!r}")
    return flat


def fuse_detector_params(state: dict) -> dict:
    """Split detector state dict -> the fused-towers one: the
    'classification.*' and 'regression_dim.*' entries become one 'clsdim.*'
    head (heads.fuse_cls_dim_params); everything else passes through. A
    fused state dict comes back unchanged."""
    if any(k.startswith("clsdim.") for k in state):
        return dict(state)
    heads = {"classification": {}, "regression_dim": {}}
    out = {}
    for key, value in state.items():
        head, _, rest = key.partition(".")
        if head in heads:
            heads[head][rest] = value
        else:
            out[key] = value
    if not all(heads.values()):
        raise ValueError(
            "fuse_detector_params expects a split detector state dict with "
            "'classification' and 'regression_dim' head entries; got "
            f"{sorted({k.partition('.')[0] for k in state})}")
    fused = fuse_cls_dim_params(heads["classification"],
                                heads["regression_dim"])
    out.update({f"clsdim.{k}": v for k, v in fused.items()})
    return out


def read_weights(path: str, backbone: str = "resnet50",
                 num_classes: int = 1):
    """(flat arrays, num_classes) of a weight file: an exported `.npz`
    (num_classes as given, from its sidecar), or a reference Keras `.h5`
    (models/h5_import.py, for `backbone`; num_classes from its head
    widths, as the JAX package's CLIs take it)."""
    if not path.endswith(H5_SUFFIXES):
        return load_npz(path), num_classes
    from .h5_import import flatten_variables, h5_num_classes, load_reference_h5

    variables = load_reference_h5(path, backbone=backbone)
    return flatten_variables(variables), h5_num_classes(variables)


def load_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Strictly load an exported `.npz` into `model` (`load_state`)."""
    return load_state(model, load_npz(path), path)


def load_state(model: torch.nn.Module, flat: dict,
               what: str = "weights") -> torch.nn.Module:
    """Strictly load the flat JAX arrays `flat` into `model`: every array is
    used and every module weight is filled, or this raises (naming `what`).
    A model with fused towers takes split weights (converted here) or fused
    ones."""
    state = load_jax_params(flat)
    if getattr(model, "fuse_cls_dim", False):
        state = fuse_detector_params(state)
    ref = model.state_dict()
    missing = sorted(set(ref) - set(state))
    unexpected = sorted(set(state) - set(ref))
    shapes = [k for k in set(ref) & set(state) if ref[k].shape != state[k].shape]
    if missing or unexpected or shapes:
        raise ValueError(
            f"{what}: weights do not match the model: missing {missing[:10]}, "
            f"unexpected {unexpected[:10]}, shape mismatch {sorted(shapes)[:10]}")
    model.load_state_dict(state, strict=True)
    return model


@torch.no_grad()
def init_detector(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded random weights with the JAX package's init semantics."""
    gen = torch.Generator().manual_seed(seed)
    heads = ("regression.", "classification.", "regression_dim.", "clsdim.")
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
        elif name == "clsdim.clsdim_out":
            cls_ch, cls_width = model.clsdim.cls_ch, model.clsdim.cls_width
            w.zero_()
            w[cls_ch:, cls_width:].normal_(0.0, 0.01, generator=gen)
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
        if name == "clsdim.clsdim_out":
            module.bias[:model.clsdim.cls_ch] = PRIOR_PROB_BIAS
    return model
