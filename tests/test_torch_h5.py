"""The port's Keras .h5 interop (models/h5_import.py, models/h5_export.py)
against the JAX package's, with h5py only: this file imports neither keras
nor tensorflow, so it does not depend on what another test file left in
sys.modules.

Fixtures are written by JAX's `export_reference_h5` from JAX-initialised
variables of a ResNet detector at stage_sizes (1, 1, 1, 1) with a 64-channel
FPN (tests/test_torch_model.py's shrunk model, random frozen-BN statistics).
The other families (VGG, DenseNet, MobileNet) have no JAX exporter: their
backbones are written here in the keras.applications layout that the
importers read, from the seeded variables of tests/test_torch_backbones.py
at its shrunk depths (VGG blocks (1,1,1,1,1), DenseNet (1,2,1,1), with the
importers' block tables patched to those depths; MobileNet at alpha 0.25).

Tolerances:
  * import, export, round trip: exact (array for array, dataset for
    dataset, attributes included);
  * forward on imported weights against JAX's forward on JAX's import:
    test_torch_model.py's rtol 1e-4 / atol 1e-4 for the ResNet detector,
    test_torch_backbones.py's rtol 1e-4 / atol 1e-4 of max |JAX| for the
    other families.
"""

import h5py
import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.models import h5_import as jax_h5_import
from ground_plane_polling_tpu.models.h5_export import (
    export_reference_h5 as jax_export)
from ground_plane_polling_tpu_torch.models import (GPPRetinaNet,
                                                   export_jax_params,
                                                   load_state)
from ground_plane_polling_tpu_torch.models import h5_import
from ground_plane_polling_tpu_torch.models.h5_export import export_reference_h5
from ground_plane_polling_tpu_torch.models.resnet import ResNetBackbone

from .test_torch_backbones import (_close, jax_detector, numpy_variables,
                                   torch_detector)
from .test_torch_model import (SHRUNK, randomized_variables,
                               shrunk_jax_model, shrunk_torch_model)

torch.set_num_threads(2)


def h5_datasets(path):
    """{name: array} of every dataset and {name: attrs} of every group and
    dataset of an h5 file."""
    data, attrs = {}, {}

    def visit(name, obj):
        attrs[name] = {k: np.asarray(v).tolist() for k, v in obj.attrs.items()}
        if isinstance(obj, h5py.Dataset):
            data[name] = np.asarray(obj)

    with h5py.File(path, "r") as f:
        attrs["/"] = {k: np.asarray(v).tolist() for k, v in f.attrs.items()}
        f.visititems(visit)
    return data, attrs


def assert_same_h5(got, want):
    (gd, ga), (wd, wa) = h5_datasets(got), h5_datasets(want)
    assert sorted(gd) == sorted(wd)
    for name, w in wd.items():
        assert gd[name].dtype == w.dtype and gd[name].shape == w.shape, name
        np.testing.assert_array_equal(gd[name], w, err_msg=name)
    assert ga == wa


def load_h5(model, path):
    """The port's h5 load of a shrunk detector: import, flatten, strict
    load (as models/weights.py::read_weights with the shrunk stages)."""
    return load_state(model, h5_import.flatten_variables(
        h5_import.load_reference_h5(path, stage_sizes=SHRUNK)), path)


def assert_same_tree(got, want):
    g, w = (h5_import.flatten_variables(t) for t in (got, want))
    assert sorted(g) == sorted(w)
    for key, value in w.items():
        assert g[key].dtype == value.dtype, key
        np.testing.assert_array_equal(g[key], value, err_msg=key)


@pytest.fixture(scope="module")
def resnet(tmp_path_factory):
    """(JAX model, its variables, the JAX-exported h5)."""
    model = shrunk_jax_model()
    variables = randomized_variables(model, seed=3)
    path = str(tmp_path_factory.mktemp("h5") / "resnet.h5")
    jax_export(variables, path, stage_sizes=SHRUNK)
    return model, variables, path


def test_read_keras_h5_equals_jax(resnet):
    _, _, path = resnet
    got, want = h5_import.read_keras_h5(path), jax_h5_import.read_keras_h5(
        path)
    assert sorted(got) == sorted(want)
    for layer, weights in want.items():
        assert sorted(got[layer]) == sorted(weights), layer
        for name, w in weights.items():
            np.testing.assert_array_equal(got[layer][name], w)


@pytest.mark.parametrize("backbone_only", [False, True],
                         ids=["detector", "backbone_only"])
def test_resnet_import_equals_jax(resnet, backbone_only):
    _, variables, path = resnet
    got = h5_import.load_reference_h5(path, stage_sizes=SHRUNK,
                                      backbone_only=backbone_only)
    want = jax_h5_import.load_reference_h5(path, stage_sizes=SHRUNK,
                                           backbone_only=backbone_only)
    assert_same_tree(got, want)
    if not backbone_only:  # the export's own arrays come back
        assert_same_tree(got, variables)


@pytest.mark.parametrize("image_shape", [(128, 160), (96, 128)],
                         ids=["c5_even_x_odd", "c5_odd_x_even"])
def test_forward_on_imported_weights_matches_jax(resnet, image_shape):
    jax_model, _, path = resnet
    images = np.random.RandomState(1).uniform(
        -128, 128, (2, *image_shape, 3)).astype(np.float32)
    want = jax_model.apply(
        jax_h5_import.load_reference_h5(path, stage_sizes=SHRUNK), images)
    model = load_h5(shrunk_torch_model(), path).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(images).permute(0, 3, 1, 2))
    for key in ("regression", "regression_dim", "classification"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("given", ["tree", "flat", "model"])
def test_export_equals_jax(resnet, tmp_path, given):
    """The port's export of one set of weights, handed over as the JAX
    tree, its flat .npz arrays or a port detector, writes JAX's datasets
    for the same weights (a detector's through export_jax_params: its
    frozen BN is scale and shift with mean 0, var 1 - eps)."""
    _, variables, path = resnet
    flat = h5_import.flatten_variables(variables)
    if given == "model":
        model = load_h5(shrunk_torch_model(), path)
        arg = model
        same = h5_import.unflatten_variables(export_jax_params(model))
    else:
        arg = variables if given == "tree" else flat
        same = variables
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "theirs.h5")
    export_reference_h5(arg, ours, stage_sizes=SHRUNK)
    jax_export(same, theirs, stage_sizes=SHRUNK)
    assert_same_h5(ours, theirs)
    if given != "model":
        assert_same_h5(ours, path)


def test_round_trip_is_exact(resnet, tmp_path):
    """detector -> h5 -> detector gives the same module state, and the h5's
    arrays are the detector's export."""
    _, _, path = resnet
    model = load_h5(shrunk_torch_model(), path)
    out = str(tmp_path / "again.h5")
    export_reference_h5(model, out, stage_sizes=SHRUNK)
    again = load_h5(shrunk_torch_model(), out)
    want = model.state_dict()
    for key, value in again.state_dict().items():
        torch.testing.assert_close(value, want[key], rtol=0, atol=0,
                                   msg=key)
    assert_same_tree(h5_import.load_reference_h5(out, stage_sizes=SHRUNK),
                     h5_import.unflatten_variables(export_jax_params(model)))


def test_backbone_only_merge_matches_jax(resnet):
    """The ImageNet-init path: an h5's backbone over fresh variables; the
    FPN and heads keep theirs."""
    jax_model, _, path = resnet
    fresh = randomized_variables(jax_model, seed=7)
    imported = (h5_import.load_reference_h5(path, stage_sizes=SHRUNK,
                                            backbone_only=True),
                jax_h5_import.load_reference_h5(path, stage_sizes=SHRUNK,
                                                backbone_only=True))
    got = h5_import.merge_backbone(fresh, imported[0])
    want = jax_h5_import.merge_backbone(fresh, imported[1])
    assert_same_tree(got, want)
    assert_same_tree({"params": {"backbone": got["params"]["backbone"]},
                      "frozen": {"backbone": got["frozen"]["backbone"]}},
                     imported[1])
    np.testing.assert_array_equal(got["params"]["fpn"]["p3"]["kernel"],
                                  fresh["params"]["fpn"]["p3"]["kernel"])


def test_num_classes_from_the_heads(resnet):
    _, variables, _ = resnet
    assert h5_import.h5_num_classes(variables) == 1
    bad = h5_import.unflatten_variables(h5_import.flatten_variables(
        variables))
    bad["params"]["regression"]["box_out"]["bias"] = np.zeros(9 * 12)
    with pytest.raises(ValueError, match="12-anchor"):
        h5_import.h5_num_classes(bad)


def test_fused_or_other_family_export_is_refused(tmp_path):
    fused = GPPRetinaNet(ResNetBackbone(SHRUNK), feature_size=64,
                         fuse_cls_dim=True)
    with pytest.raises(ValueError, match="split heads"):
        export_reference_h5(fused, str(tmp_path / "f.h5"),
                            stage_sizes=SHRUNK)
    with pytest.raises(ValueError, match="resnet family"):
        export_reference_h5(torch_detector("tiny"), str(tmp_path / "t.h5"),
                            backbone="tiny")


# --- the other families: keras.applications layout ---------------------------

# the importers' block tables, patched to the depths of FAMILY_CASES
SHRUNK_BLOCKS = {"vgg16": (1, 1, 1, 1, 1), "densenet121": (1, 2, 1, 1)}
FAMILY_CASES = {"vgg": "vgg16", "densenet": "densenet121",
                "mobilenet_0.25": "mobilenet224_0.25"}
# keras.applications BN epsilons, folded into the variance by the import
EPS_FOLD = {"densenet": 1.001e-5 - 1e-5, "mobilenet_0.25": 1e-3 - 1e-5}


def _keras_bn(z):
    return {"gamma": z["scale"], "beta": z["bias"],
            "moving_mean": z["mean"], "moving_variance": z["var"]}


def keras_applications_layers(family, variables):
    """The JAX backbone tree -> keras.applications layer names and weights
    (the inverse of the importers' maps)."""
    p = variables["params"]["backbone"]
    z = variables.get("frozen", {}).get("backbone", {})
    layers = {}
    if family == "vgg":
        layers.update({name: dict(conv) for name, conv in p.items()})
    elif family == "mobilenet_0.25":
        layers["conv1"] = dict(p["conv0"])
        layers["conv1_bn"] = _keras_bn(z["bn0"])
        for i in range(1, 14):
            layers[f"conv_dw_{i}"] = {"depthwise_kernel": p[f"dw{i}"][
                "kernel"].transpose(0, 1, 3, 2)}
            layers[f"conv_dw_{i}_bn"] = _keras_bn(z[f"dw{i}_bn"])
            layers[f"conv_pw_{i}"] = dict(p[f"pw{i}"])
            layers[f"conv_pw_{i}_bn"] = _keras_bn(z[f"pw{i}_bn"])
    else:  # densenet: the Keras 2 slashed stem names
        layers["conv1/conv"] = dict(p["stem_conv"])
        layers["conv1/bn"] = _keras_bn(z["stem_bn"])
        for b, n in enumerate(SHRUNK_BLOCKS["densenet121"], start=1):
            for i in range(1, n + 1):
                k, ours = f"conv{b + 1}_block{i}", f"block{b}_layer{i}"
                layers[f"{k}_1_conv"] = dict(p[ours]["conv1"])
                layers[f"{k}_2_conv"] = dict(p[ours]["conv2"])
                layers[f"{k}_0_bn"] = _keras_bn(z[ours]["bn1"])
                layers[f"{k}_1_bn"] = _keras_bn(z[ours]["bn2"])
            if b < 4:
                layers[f"pool{b + 1}_conv"] = dict(p[f"trans{b}_conv"])
                layers[f"pool{b + 1}_bn"] = _keras_bn(z[f"trans{b}_bn"])
    return layers


def write_keras_h5(path, layers):
    """A Keras 2 full-model save: model_weights/<layer>/<layer>/<w>:0."""
    with h5py.File(path, "w") as f:
        mw = f.create_group("model_weights")
        for name, weights in layers.items():
            g = mw.create_group(name)
            for w, a in weights.items():
                g.create_dataset(f"{name}/{w}:0", data=np.asarray(a))


@pytest.fixture
def shrunk_tables(monkeypatch):
    for mod in (h5_import, jax_h5_import):
        monkeypatch.setitem(mod._VGG_BLOCKS, "vgg16",
                            SHRUNK_BLOCKS["vgg16"])
        monkeypatch.setitem(mod._DENSENET_BLOCKS, "densenet121",
                            SHRUNK_BLOCKS["densenet121"])


@pytest.mark.parametrize("family", sorted(FAMILY_CASES))
def test_other_family_backbone_import_matches_jax(family, tmp_path,
                                                  shrunk_tables):
    """A keras.applications backbone file: the port's import equals JAX's
    array for array (the BN epsilons folded alike), and each side's
    detector with that backbone merged over the same fresh weights gives
    the same heads."""
    jax_model = jax_detector(family)
    source = numpy_variables(jax_model, seed=11)
    path = str(tmp_path / f"{family}.h5")
    write_keras_h5(path, keras_applications_layers(family, source))
    name = FAMILY_CASES[family]
    got = h5_import.load_reference_h5(path, backbone=name,
                                      backbone_only=True)
    want = jax_h5_import.load_reference_h5(path, backbone=name,
                                           backbone_only=True)
    assert_same_tree(got, want)
    if family in EPS_FOLD:
        var = source["frozen"]["backbone"]
        first = "bn0" if family.startswith("mobilenet") else "stem_bn"
        np.testing.assert_array_equal(
            got["frozen"]["backbone"][first]["var"],
            var[first]["var"] + np.float32(EPS_FOLD[family]))

    fresh = numpy_variables(jax_model, seed=12)
    jax_vars = jax_h5_import.merge_backbone(fresh, want)
    model = load_state(torch_detector(family),
                       h5_import.flatten_variables(fresh))
    merged = h5_import.merge_backbone(
        h5_import.unflatten_variables(export_jax_params(model)), got)
    model = load_state(model, h5_import.flatten_variables(merged)).eval()
    images = np.random.RandomState(2).uniform(
        -128, 128, (1, 64, 224, 3)).astype(np.float32)
    out = jax_model.apply(jax_vars, images)
    with torch.no_grad():
        mine = model(torch.from_numpy(images).permute(0, 3, 1, 2))
    for key in ("regression", "regression_dim", "classification"):
        _close(mine[key].numpy(), out[key], key)


def test_unknown_backbone_is_refused(resnet):
    _, _, path = resnet
    for load in (h5_import.load_reference_h5,
                 jax_h5_import.load_reference_h5):
        with pytest.raises(ValueError, match="h5 import supports"):
            load(path, backbone="tiny")
