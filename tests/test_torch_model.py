"""The port's detector against the JAX package's flax GPPRetinaNet with the
same weights, carried across by the .npz export (`export_params` ->
`load_jax_params`). A shrunk ResNet (one block per stage) with a 64-channel
FPN runs in float32 at two canvases whose C5 grids are even x odd and
odd x even, which exercises the SAME-padding hazards (stem max-pool, P6,
P7). Head outputs must agree at rtol 1e-4 / atol 1e-4. A separate case
checks that loading full ResNet-50 weights is strict."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.models.resnet import ResNetBackbone as JaxResNet
from ground_plane_polling_tpu.models.retinanet import (
    GPPRetinaNet as JaxRetinaNet)
from ground_plane_polling_tpu.training.checkpoint import export_params
from ground_plane_polling_tpu_torch.models import (
    GPPRetinaNet, build_detector, export_jax_params, init_detector,
    load_jax_params, load_weights)
from ground_plane_polling_tpu_torch.models.resnet import ResNetBackbone

torch.set_num_threads(2)

SHRUNK = (1, 1, 1, 1)
FEATURES = 64


def shrunk_jax_model(num_classes=1):
    backbone = functools.partial(JaxResNet, stage_sizes=SHRUNK,
                                 name="backbone")
    return JaxRetinaNet(backbone_fn=backbone, num_classes=num_classes,
                        feature_size=FEATURES)


def shrunk_torch_model(num_classes=1):
    return GPPRetinaNet(ResNetBackbone(SHRUNK), num_classes=num_classes,
                        feature_size=FEATURES)


def randomized_variables(model, seed=0, image_shape=(64, 64)):
    """flax init, then random frozen-BN statistics and a random
    classification out kernel, so every weight kind is non-trivial."""
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, *image_shape, 3), jnp.float32))
    rng = np.random.RandomState(seed)
    frozen = jax.tree_util.tree_map(np.asarray, variables["frozen"])

    def perturb(tree):
        for key, node in tree.items():
            if "scale" in node:
                c = node["scale"].shape
                node["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                node["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                node["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                node["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            else:
                perturb(node)

    perturb(frozen)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    out = params["classification"]["cls_out"]
    out["kernel"] = rng.normal(0, 0.05, out["kernel"].shape).astype(
        np.float32)
    return {"params": params, "frozen": frozen}


@pytest.fixture(scope="module")
def shrunk_weights(tmp_path_factory):
    model = shrunk_jax_model()
    variables = randomized_variables(model)
    path = str(tmp_path_factory.mktemp("weights") / "shrunk.npz")
    export_params(path, variables)
    return model, variables, path


@pytest.mark.parametrize("image_shape", [(128, 160), (96, 128)],
                         ids=["c5_even_x_odd", "c5_odd_x_even"])
def test_heads_match_jax(shrunk_weights, image_shape):
    jax_model, variables, path = shrunk_weights
    images = np.random.RandomState(1).uniform(
        -128, 128, (2, *image_shape, 3)).astype(np.float32)
    want = jax_model.apply(variables, images)
    model = load_weights(shrunk_torch_model(), path).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(images).permute(0, 3, 1, 2))
    for key in ("regression", "regression_dim", "classification"):
        assert got[key].dtype == torch.float32
        assert tuple(got[key].shape) == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_export_roundtrip(shrunk_weights):
    """export_jax_params(load(npz)) loads back to the same module state."""
    _, _, path = shrunk_weights
    model = load_weights(shrunk_torch_model(), path)
    again = load_jax_params(export_jax_params(model))
    for key, value in model.state_dict().items():
        np.testing.assert_allclose(again[key].numpy(), value.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=key)


def _full_resnet50_flat():
    """Zero arrays with the exact shapes of the JAX ResNet-50 detector's
    export (shapes from eval_shape: no weights are computed)."""
    from ground_plane_polling_tpu.models import build_detector as jax_build

    shapes = jax.eval_shape(
        jax_build("resnet50").init, jax.random.PRNGKey(0),
        jnp.zeros((1, 64, 64, 3), jnp.float32))
    flat = {}

    def walk(tree, prefix):
        for key, node in tree.items():
            if isinstance(node, dict):
                walk(node, f"{prefix}{key}/")
            else:
                flat[f"{prefix}{key}"] = np.zeros(node.shape, np.float32)

    walk({"params": shapes["params"], "frozen": shapes["frozen"]}, "")
    return flat


@pytest.fixture(scope="module")
def resnet50_flat():
    return _full_resnet50_flat()


def _save(tmp_path, flat):
    path = str(tmp_path / "w.npz")
    np.savez(path, **flat)
    return path


def test_full_resnet50_load_is_strict(tmp_path, resnet50_flat):
    model = build_detector("resnet50")
    load_weights(model, _save(tmp_path, resnet50_flat))
    assert all(float(p.detach().abs().sum()) == 0
               for p in model.parameters())


@pytest.mark.parametrize("edit", ["drop_key", "extra_key", "wrong_shape",
                                  "unknown_leaf"])
def test_full_resnet50_load_rejects_mismatch(tmp_path, resnet50_flat, edit):
    flat = dict(resnet50_flat)
    key = "params/regression/box_out/kernel"
    if edit == "drop_key":
        del flat[key]
    elif edit == "extra_key":
        flat["params/regression/box_9/kernel"] = flat[key]
    elif edit == "wrong_shape":
        flat[key] = flat[key][..., :-1]
    else:
        flat["params/fpn/p3/weight_scale"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError):
        load_weights(build_detector("resnet50"), _save(tmp_path, flat))


def test_build_detector_names_supported_backbones():
    with pytest.raises(ValueError, match="resnet101"):
        build_detector("vgg16")


def test_seeded_init_semantics():
    """init_detector: same seed, same weights; zero cls_out kernel with the
    prior-probability bias; N(0, 0.01) towers; unit-variance trunk."""
    a = init_detector(shrunk_torch_model(), 3)
    b = init_detector(shrunk_torch_model(), 3)
    for (ka, va), (_, vb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(va, vb), ka
    out = a.classification.cls_out
    assert float(out.weight.abs().max()) == 0.0
    assert torch.allclose(out.bias, torch.full_like(out.bias,
                                                    -np.log(99.0)))
    tower = a.regression.box_0.weight
    assert 0.008 < float(tower.std()) < 0.012
    stem = a.backbone.conv1.weight  # fan_in 7 * 7 * 3
    assert 0.8 < float(stem.std()) * np.sqrt(147) < 1.2
