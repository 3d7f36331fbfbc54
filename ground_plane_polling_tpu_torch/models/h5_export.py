"""Export detector weights as a Keras h5 checkpoint in the Keras
reference's layout (port of ground_plane_polling_tpu/models/h5_export.py).

The inverse of models/h5_import.py: writes the Keras 2.2 full-model-save
weight layout (``model_weights/<top layer>/<owning layer>/<weight>:0``,
head layers nested one group deeper under their submodel, keras_resnet
backbone names). The weights come as the JAX package's ``{"params",
"frozen"}`` tree, as its flat `.npz` arrays, or as a detector of the port
(through models/weights.py::export_jax_params, whose frozen BN is each
channel's scale and shift with mean 0 and variance 1 - eps); the datasets
are the JAX package's `export_reference_h5` of the same tree, and the
round trip through `load_reference_h5` is exact.

Scope: the resnet family (the backbones the reference distributes trained
models for). The single A*12 regression out-conv is split back into the
reference's five parallel op convs (4+2+2+2+2, inverse concat order).
"""

from __future__ import annotations

import numpy as np

from .h5_import import _KNOWN_STAGES, unflatten_variables

__all__ = ["export_reference_h5"]


def _conv_entry(p):
    out = {"kernel": np.asarray(p["kernel"], np.float32)}
    if "bias" in p:
        out["bias"] = np.asarray(p["bias"], np.float32)
    return out


def _bn_entry(z):
    return {
        "gamma": np.asarray(z["scale"], np.float32),
        "beta": np.asarray(z["bias"], np.float32),
        "moving_mean": np.asarray(z["mean"], np.float32),
        "moving_variance": np.asarray(z["var"], np.float32),
    }


def _split_regression_out(entry, num_anchors):
    """Inverse of h5_import._fuse_regression_out: one (kh, kw, cin, A*12)
    conv -> five op convs of per-anchor widths 4+2+2+2+2."""
    widths = [4, 2, 2, 2, 2]
    kernel = entry["kernel"]
    kh, kw, cin, _ = kernel.shape
    kernel = kernel.reshape(kh, kw, cin, num_anchors, 12)
    bias = entry["bias"].reshape(num_anchors, 12)
    out = {}
    offset = 0
    for i, k_i in enumerate(widths, start=1):
        out[f"pyramid_regression_op{i}"] = {
            "kernel": kernel[..., offset:offset + k_i].reshape(
                kh, kw, cin, num_anchors * k_i),
            "bias": bias[:, offset:offset + k_i].reshape(num_anchors * k_i),
        }
        offset += k_i
    return out


def _backbone_layers(params, frozen, backbone, stage_sizes):
    """flax resnet trees -> keras_resnet layer names.

    keras_resnet's numerical_names mode ('a', 'b1', 'b2', ...) applies to
    the MID stages of resnet101/152 only (numerical_names=[False, True,
    True, False] in keras_resnet.models.ResNet101/152); first/last stages
    and all of resnet50 use letter spellings ('a', 'b', 'c', ...)."""
    layers = {"conv1": _conv_entry(params["conv1"]),
              "bn_conv1": _bn_entry(frozen["bn1"])}
    for stage, n_blocks in enumerate(stage_sizes):
        s = str(stage + 2)
        numerical = backbone != "resnet50" and stage in (1, 2)
        for block in range(n_blocks):
            if block == 0 or not numerical:
                b = chr(ord("a") + block)
            else:
                b = f"b{block}"
            ours_p = params[f"stage{stage + 1}_block{block + 1}"]
            ours_z = frozen[f"stage{stage + 1}_block{block + 1}"]
            for branch, conv, bn in (("branch2a", "conv1", "bn1"),
                                     ("branch2b", "conv2", "bn2"),
                                     ("branch2c", "conv3", "bn3")):
                layers[f"res{s}{b}_{branch}"] = _conv_entry(ours_p[conv])
                layers[f"bn{s}{b}_{branch}"] = _bn_entry(ours_z[bn])
            if block == 0:
                layers[f"res{s}{b}_branch1"] = _conv_entry(
                    ours_p["conv_proj"])
                layers[f"bn{s}{b}_branch1"] = _bn_entry(ours_z["bn_proj"])
    return layers


_FPN_NAMES = [
    ("c5_reduce", "C5_reduced"), ("p5", "P5"),
    ("c4_reduce", "C4_reduced"), ("p4", "P4"),
    ("c3_reduce", "C3_reduced"), ("p3", "P3"),
    ("p6", "P6"), ("p7", "P7"),
]


def export_reference_h5(variables, path: str, backbone: str = "resnet50",
                        num_anchors: int = 12,
                        stage_sizes=None) -> None:
    """Write ``variables`` as a reference-layout h5: a ``{"params",
    "frozen"}`` tree, the flat `.npz` arrays of one, or a split detector of
    the port.

    Head layers nest under their reference submodel groups
    (classification_submodel / regression_submodel /
    regression_dim_submodel); backbone and FPN layers sit at the top of
    ``model_weights`` like a Keras full-model save.
    """
    import h5py
    import torch

    if isinstance(variables, torch.nn.Module):
        from .weights import export_jax_params

        variables = export_jax_params(variables)
    if "params" not in variables:
        variables = unflatten_variables(variables)
    if "classification" not in variables["params"]:
        raise ValueError(
            "h5 export writes the split heads of the reference; got "
            f"{sorted(variables['params'])} (a fused-towers detector?)")
    if stage_sizes is None:
        if backbone not in _KNOWN_STAGES:
            raise ValueError(
                f"h5 export supports the resnet family {sorted(_KNOWN_STAGES)}"
                f" (or explicit stage_sizes); got {backbone!r}")
        stage_sizes = _KNOWN_STAGES[backbone]

    params = variables["params"]
    frozen = variables.get("frozen", {})

    top = _backbone_layers(params["backbone"], frozen["backbone"],
                           backbone, stage_sizes)
    for ours, ref in _FPN_NAMES:
        top[ref] = _conv_entry(params["fpn"][ours])

    cls_p = params["classification"]
    box_p = params["regression"]
    dim_p = params["regression_dim"]
    submodels = {
        "classification_submodel": {
            **{f"pyramid_classification_{i}": _conv_entry(cls_p[f"cls_{i}"])
               for i in range(4)},
            "pyramid_classification": _conv_entry(cls_p["cls_out"]),
        },
        "regression_submodel": {
            **{f"pyramid_regression_{i}": _conv_entry(box_p[f"box_{i}"])
               for i in range(4)},
            **_split_regression_out(_conv_entry(box_p["box_out"]),
                                    num_anchors),
        },
        "regression_dim_submodel": {
            **{f"pyramid_regression_dim_{i}": _conv_entry(dim_p[f"dim_{i}"])
               for i in range(4)},
            "pyramid_regression_dim": _conv_entry(dim_p["dim_out"]),
        },
    }

    with h5py.File(path, "w") as f:
        # Keras 2.2 metadata attrs: layer_names at the root of
        # model_weights, weight_names per layer group — what
        # keras' load_weights (legacy h5 path) requires to read the file.
        f.attrs["keras_version"] = np.bytes_("2.2.4")
        f.attrs["backend"] = np.bytes_("tensorflow")
        mw = f.create_group("model_weights")

        def write_group(group_name, weight_items):
            """weight_items: list of (sub-path, array) in layer order."""
            g = mw.create_group(group_name)
            g.attrs["weight_names"] = np.array(
                [np.bytes_(f"{p}:0") for p, _ in weight_items])
            for p, arr in weight_items:
                g.create_dataset(f"{p}:0", data=arr)

        for name, weights in top.items():
            write_group(name, [(f"{name}/{w}", a)
                               for w, a in weights.items()])
        for sub_name, layers in submodels.items():
            write_group(sub_name, [(f"{lname}/{w}", a)
                                   for lname, weights in layers.items()
                                   for w, a in weights.items()])
        mw.attrs["layer_names"] = np.array(
            [np.bytes_(n) for n in (*top, *submodels)])
        mw.attrs["backend"] = np.bytes_("tensorflow")
        mw.attrs["keras_version"] = np.bytes_("2.2.4")
