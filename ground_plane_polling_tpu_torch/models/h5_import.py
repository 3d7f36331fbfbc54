"""Import Keras h5 checkpoints of the Keras reference (port of
ground_plane_polling_tpu/models/h5_import.py, numpy and h5py only).

The Keras reference trains and distributes Keras 2.2 h5 models and
initialises backbones from keras_resnet ImageNet h5 weights
(models/imagenet.py fetches those). This module reads such a file with
h5py (imported only when a file is read: no Keras or TF needed), maps the
reference's layer names onto the JAX package's parameter tree, and returns
that ``{"params", "frozen"}`` tree of numpy arrays, exactly as the JAX
package's importer does. `flatten_variables` turns it into the flat
`.npz` keys that models/weights.py::load_jax_params maps onto the port's
modules (`read_weights`, `load_state`), so an h5 file is one more carrier
of the same weights and no second name mapping exists.

Name mapping (reference name -> JAX tree path):

  backbone (keras_resnet caffe-style names):
    conv1 / bn_conv1                 -> backbone.conv1 / backbone.bn1
    res{S}{B}_branch2a/2b/2c         -> backbone.stage{S-1}_block{i}.conv1/2/3
    res{S}{B}_branch1                -> backbone.stage{S-1}_block{i}.conv_proj
    bn{S}{B}_branch*                 -> matching FrozenBatchNorm ("frozen")
    (B is a letter 'a','b','c',... for resnet50, or 'a','b1','b2',... in
     keras_resnet's numerical_names mode used by resnet101/152 mid stages;
     both spellings are probed.)
  keras.applications VGG, MobileNet v1 and DenseNet names for the other
  families (their BN epsilons folded into the variance).

  FPN:
    C5_reduced/P5/C4_reduced/P4/C3_reduced/P3/P6/P7
      -> fpn.c5_reduce/p5/c4_reduce/p4/c3_reduce/p3/p6/p7

  heads:
    pyramid_classification_{0..3}    -> classification.cls_{0..3}
    pyramid_classification           -> classification.cls_out
    pyramid_regression_{0..3}        -> regression.box_{0..3}
    pyramid_regression_op{1..5}      -> fused into regression.box_out
    pyramid_regression_dim_{0..3}    -> regression_dim.dim_{0..3}
    pyramid_regression_dim           -> regression_dim.dim_out

The reference's five parallel regression output convs (4+2+2+2+2 channels,
each reshaped to (-1, k) and concatenated) are one conv with interleaved
output channels; `_fuse_regression_out` orders their kernels and biases
into the single A*12-channel conv so that its output is the reference's
concatenation.

Keras h5 kernels are (kh, kw, in, out), the layout of the JAX tree; the
port's load transposes them to (out, in, kh, kw).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = [
    "read_keras_h5",
    "load_reference_h5",
    "merge_backbone",
    "flatten_variables",
    "unflatten_variables",
    "h5_num_classes",
]

_KNOWN_STAGES = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}

LayerWeights = Dict[str, Dict[str, np.ndarray]]


def read_keras_h5(path: str) -> LayerWeights:
    """Read every weight in a Keras 2.x h5 file, keyed by layer name.

    Handles both full-model saves (weights under ``model_weights/``) and
    ``save_weights`` files (layer groups at the root), including nested
    submodels (the reference's classification/regression submodels store
    their inner layers one group deeper). A dataset at ``.../X/kernel:0``
    belongs to layer ``X``; the trailing ``:0`` is stripped from weight names.
    """
    import h5py

    layers: LayerWeights = {}

    def visit(name, obj):
        if not isinstance(obj, h5py.Dataset):
            return
        parts = name.split("/")
        if len(parts) < 2:
            return
        weight = parts[-1].split(":")[0]
        arr = np.asarray(obj)
        # primary key: immediate parent group (flat layer names, nested
        # submodels). Slashed layer names (keras densenet 'conv1/conv')
        # additionally register under 'grandparent/parent'.
        layers.setdefault(parts[-2], {})[weight] = arr
        if len(parts) >= 3:
            layers.setdefault(f"{parts[-3]}/{parts[-2]}", {})[weight] = arr

    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        root.visititems(visit)
    return layers


def _get(layers: LayerWeights, name: str, *candidates: str):
    for cand in (name,) + candidates:
        if cand in layers:
            return layers[cand]
    raise KeyError(
        f"layer {name!r} (also tried {list(candidates)}) not found in h5; "
        f"available layers include {sorted(layers)[:12]}...")


def _conv(entry) -> Dict[str, np.ndarray]:
    out = {"kernel": np.asarray(entry["kernel"], np.float32)}
    if "bias" in entry:
        out["bias"] = np.asarray(entry["bias"], np.float32)
    return out


def _bn(entry, eps_adjust: float = 0.0) -> Dict[str, np.ndarray]:
    """BN weights -> FrozenBatchNorm tree.

    eps_adjust pre-folds a source-epsilon difference into the variance:
    our FrozenBatchNorm uses eps=1e-5, keras.applications mobilenet uses
    1e-3 and densenet 1.001e-5; storing var + (eps_src - 1e-5) reproduces
    the source network bit-for-bit without touching the modules.
    """
    return {
        "scale": np.asarray(entry["gamma"], np.float32),
        "bias": np.asarray(entry["beta"], np.float32),
        "mean": np.asarray(entry["moving_mean"], np.float32),
        "var": np.asarray(entry["moving_variance"],
                          np.float32) + np.float32(eps_adjust),
    }


def _resnet_trees(layers: LayerWeights, stage_sizes):
    """Backbone params + frozen trees from keras_resnet layer names."""
    params = {"conv1": _conv(_get(layers, "conv1"))}
    frozen = {"bn1": _bn(_get(layers, "bn_conv1"))}

    for stage, n_blocks in enumerate(stage_sizes):  # our stage1..4 = keras 2..5
        stage_char = str(stage + 2)
        for block in range(n_blocks):
            letter = chr(ord("a") + block)
            numerical = f"b{block}" if block > 0 else letter
            ours = f"stage{stage + 1}_block{block + 1}"

            def res(branch, _l=letter, _n=numerical, _s=stage_char):
                return _conv(_get(layers, f"res{_s}{_l}_{branch}",
                                  f"res{_s}{_n}_{branch}"))

            def bnw(branch, _l=letter, _n=numerical, _s=stage_char):
                return _bn(_get(layers, f"bn{_s}{_l}_{branch}",
                                f"bn{_s}{_n}_{branch}"))

            p = {"conv1": res("branch2a"), "conv2": res("branch2b"),
                 "conv3": res("branch2c")}
            z = {"bn1": bnw("branch2a"), "bn2": bnw("branch2b"),
                 "bn3": bnw("branch2c")}
            if block == 0:
                p["conv_proj"] = res("branch1")
                z["bn_proj"] = bnw("branch1")
            params[ours] = p
            frozen[ours] = z
    return params, frozen


_VGG_BLOCKS = {"vgg16": (2, 2, 3, 3, 3), "vgg19": (2, 2, 4, 4, 4)}
_DENSENET_BLOCKS = {"densenet121": (6, 12, 24, 16),
                    "densenet169": (6, 12, 32, 32),
                    "densenet201": (6, 12, 48, 32)}


def _vgg_trees(layers: LayerWeights, blocks):
    """keras.applications VGG names match our module names exactly."""
    params = {}
    for b, n in enumerate(blocks, start=1):
        for i in range(1, n + 1):
            name = f"block{b}_conv{i}"
            params[name] = _conv(_get(layers, name))
    return params, {}


def _mobilenet_trees(layers: LayerWeights, n_blocks: int = 13):
    """keras.applications MobileNet v1 (BN eps 1e-3, pre-folded).

    Depthwise kernels are stored (kh, kw, ch, 1); flax grouped conv wants
    (kh, kw, 1, ch).
    """
    eps = 1e-3 - 1e-5
    params = {"conv0": _conv(_get(layers, "conv1"))}
    frozen = {"bn0": _bn(_get(layers, "conv1_bn"), eps)}
    for i in range(1, n_blocks + 1):
        dw = np.asarray(_get(layers, f"conv_dw_{i}")["depthwise_kernel"],
                        np.float32)
        params[f"dw{i}"] = {"kernel": dw.transpose(0, 1, 3, 2)}
        params[f"pw{i}"] = _conv(_get(layers, f"conv_pw_{i}"))
        frozen[f"dw{i}_bn"] = _bn(_get(layers, f"conv_dw_{i}_bn"), eps)
        frozen[f"pw{i}_bn"] = _bn(_get(layers, f"conv_pw_{i}_bn"), eps)
    return params, frozen


def _densenet_trees(layers: LayerWeights, block_sizes):
    """keras.applications DenseNet (BN eps 1.001e-5, pre-folded).

    Stem layers are the slashed 'conv1/conv' names in Keras 2 h5 files
    (Keras 3 renamed them 'conv1_conv'; both are probed). Block b layer i
    maps from conv{b+1}_block{i}_{0_bn,1_conv,1_bn,2_conv}; transition b
    from pool{b+1}_{bn,conv}.
    """
    eps = 1.001e-5 - 1e-5
    params = {"stem_conv": _conv(_get(layers, "conv1/conv", "conv1_conv"))}
    frozen = {"stem_bn": _bn(_get(layers, "conv1/bn", "conv1_bn"), eps)}
    for b, n in enumerate(block_sizes, start=1):
        for i in range(1, n + 1):
            k = f"conv{b + 1}_block{i}"
            ours = f"block{b}_layer{i}"
            params[ours] = {"conv1": _conv(_get(layers, f"{k}_1_conv")),
                            "conv2": _conv(_get(layers, f"{k}_2_conv"))}
            frozen[ours] = {"bn1": _bn(_get(layers, f"{k}_0_bn"), eps),
                            "bn2": _bn(_get(layers, f"{k}_1_bn"), eps)}
        if b < len(block_sizes):
            params[f"trans{b}_conv"] = _conv(
                _get(layers, f"pool{b + 1}_conv"))
            frozen[f"trans{b}_bn"] = _bn(
                _get(layers, f"pool{b + 1}_bn"), eps)
    return params, frozen


_FPN_NAMES = [
    ("C5_reduced", "c5_reduce"), ("P5", "p5"),
    ("C4_reduced", "c4_reduce"), ("P4", "p4"),
    ("C3_reduced", "c3_reduce"), ("P3", "p3"),
    ("P6", "p6"), ("P7", "p7"),
]


def _fpn_tree(layers: LayerWeights):
    return {ours: _conv(_get(layers, ref)) for ref, ours in _FPN_NAMES}


def _fuse_regression_out(layers: LayerWeights, num_anchors: int):
    """Concatenate the five op convs into one (kh, kw, cin, A*12) conv.

    Reference op_i outputs (kh, kw, cin, A*k_i) with per-anchor channel
    blocks; after reshape-to-(-1, k_i) + concat the per-anchor layout is
    [op1(4) | op2(2) | op3(2) | op4(2) | op5(2)]. Our fused conv reshapes
    (..., A*12) to (-1, 12), so fused[..., a*12 + off_i + j] must equal
    op_i[..., a*k_i + j].
    """
    widths = [4, 2, 2, 2, 2]
    first = _get(layers, "pyramid_regression_op1")["kernel"]
    kh, kw, cin, _ = first.shape
    kernel = np.zeros((kh, kw, cin, num_anchors, 12), np.float32)
    bias = np.zeros((num_anchors, 12), np.float32)
    offset = 0
    for i, k_i in enumerate(widths, start=1):
        entry = _get(layers, f"pyramid_regression_op{i}")
        k = np.asarray(entry["kernel"], np.float32)
        b = np.asarray(entry["bias"], np.float32)
        kernel[..., offset:offset + k_i] = k.reshape(kh, kw, cin,
                                                     num_anchors, k_i)
        bias[:, offset:offset + k_i] = b.reshape(num_anchors, k_i)
        offset += k_i
    return {"kernel": kernel.reshape(kh, kw, cin, num_anchors * 12),
            "bias": bias.reshape(num_anchors * 12)}


def _head_trees(layers: LayerWeights, num_anchors: int):
    cls = {f"cls_{i}": _conv(_get(layers, f"pyramid_classification_{i}"))
           for i in range(4)}
    cls["cls_out"] = _conv(_get(layers, "pyramid_classification"))

    box = {f"box_{i}": _conv(_get(layers, f"pyramid_regression_{i}"))
           for i in range(4)}
    box["box_out"] = _fuse_regression_out(layers, num_anchors)

    dim = {f"dim_{i}": _conv(_get(layers, f"pyramid_regression_dim_{i}"))
           for i in range(4)}
    dim["dim_out"] = _conv(_get(layers, "pyramid_regression_dim"))
    return cls, box, dim


def load_reference_h5(path: str, backbone: str = "resnet50",
                      num_anchors: int = 12,
                      backbone_only: bool = False,
                      stage_sizes=None):
    """Load a reference h5 checkpoint as a ``{"params", "frozen"}`` dict.

    Args
      path: Keras 2.x h5 file (full save or save_weights layout).
      backbone: one of resnet50/101/152 (keras_resnet naming).
      num_anchors: anchors per position (12 for the reference config).
      backbone_only: only map the backbone (for keras_resnet ImageNet
        weights, which carry no FPN/head layers); merge the result over
        freshly initialised variables with `merge_backbone`.

    The classification/dim head output widths (and so num_classes) are
    whatever the file contains; shapes are taken verbatim from the h5.
    """
    layers = read_keras_h5(path)
    if stage_sizes is not None:
        bb_params, bb_frozen = _resnet_trees(layers, stage_sizes)
    elif backbone in _KNOWN_STAGES:
        bb_params, bb_frozen = _resnet_trees(layers, _KNOWN_STAGES[backbone])
    elif backbone in _VGG_BLOCKS:
        bb_params, bb_frozen = _vgg_trees(layers, _VGG_BLOCKS[backbone])
    elif backbone.startswith("mobilenet"):
        bb_params, bb_frozen = _mobilenet_trees(layers)
    elif backbone in _DENSENET_BLOCKS:
        bb_params, bb_frozen = _densenet_trees(layers,
                                               _DENSENET_BLOCKS[backbone])
    else:
        known = (sorted(_KNOWN_STAGES) + sorted(_VGG_BLOCKS)
                 + sorted(_DENSENET_BLOCKS) + ["mobilenet*"])
        raise ValueError(f"h5 import supports {known}; got {backbone!r}")
    params = {"backbone": bb_params}
    if not backbone_only:
        params["fpn"] = _fpn_tree(layers)
        cls, box, dim = _head_trees(layers, num_anchors)
        params["classification"] = cls
        params["regression"] = box
        params["regression_dim"] = dim
    out = {"params": params}
    if bb_frozen:  # VGG has no BN -> no frozen collection at all
        out["frozen"] = {"backbone": bb_frozen}
    return out


def merge_backbone(variables, imported):
    """Overlay an imported backbone onto freshly-initialised variables.

    The reference's ImageNet-init path: backbone weights come from the
    file, FPN/heads keep their fresh initialisation.
    """
    params = dict(variables["params"])
    params["backbone"] = imported["params"]["backbone"]
    out = {**variables, "params": params}
    if "frozen" in imported:
        frozen = dict(variables.get("frozen", {}))
        frozen["backbone"] = imported["frozen"]["backbone"]
        out["frozen"] = frozen
    return out


def flatten_variables(variables) -> Dict[str, np.ndarray]:
    """A ``{"params", "frozen"}`` tree -> the flat `params/...` and
    `frozen/...` arrays of the JAX package's `.npz` export."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        else:
            flat[prefix[:-1]] = np.asarray(node)

    walk({"params": variables["params"],
          "frozen": variables.get("frozen", {})}, "")
    return flat


def unflatten_variables(flat) -> dict:
    """Flat `.npz` arrays -> a ``{"params", "frozen"}`` tree (the inverse of
    `flatten_variables`)."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value)
    return {"params": tree.get("params", {}), "frozen": tree.get("frozen", {})}


def h5_num_classes(variables) -> int:
    """num_classes of an imported detector (a direct h5 has no sidecar):
    the anchor count from the box out conv (A * 12 channels), then the
    classes from the classification out conv (A * 8 * C channels). Only
    the reference's 12-anchor layout is mapped, so anything else raises."""
    box_out_ch = variables["params"]["regression"]["box_out"][
        "bias"].shape[0]
    cls_out_ch = variables["params"]["classification"]["cls_out"][
        "bias"].shape[0]
    num_anchors = box_out_ch // 12
    if (box_out_ch % 12 or num_anchors != 12
            or cls_out_ch % (num_anchors * 8)):
        raise ValueError(
            f"cannot infer num_classes from h5 head shapes "
            f"(box_out={box_out_ch}, cls_out={cls_out_ch}); the h5 "
            f"import path supports the reference's 12-anchor layout "
            f"(box 12*12=144, cls 12*8*C channels) only")
    return cls_out_ch // (num_anchors * 8)

