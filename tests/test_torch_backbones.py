"""The port's other backbone families (tiny, VGG, DenseNet, MobileNet)
against the JAX package's flax modules, weights carried across by the
.npz export (`export_params` -> `load_weights`).

  * Each family at a shrunk depth (VGG blocks (1,1,1,1,1), DenseNet
    block sizes (1,2,1,1), MobileNet at alpha 0.25 and 0.75, tiny as it
    is) in a detector with a 64-channel FPN, float32, random frozen-BN
    statistics, at a 64x224 canvas and at 72x232, where stride-2 stages
    see odd sizes (VGG's SAME max-pool pads -inf at the end, DenseNet's
    SAME avg-pool counts a padded zero, MobileNet's stride-2 depthwise
    convs pad asymmetrically). C3, C4, C5 and the head outputs agree
    within rtol 1e-4 and atol 1e-4 of the largest |JAX| value of each
    (float32 convolutions sum in another order, through up to 28 layers).
  * Every one of the 13 names of JAX's backbone_registry: the port's
    parameter tree has JAX's keys and shapes (JAX's from jax.eval_shape
    of init, no real init), loads them strictly and exports them back;
    init_detector gives finite weights with Flax's fan-in.
  * One float32 train step of a tiny and a MobileNet detector against
    JAX's, with test_torch_train_step.py's tolerances.
  * run_network --backbone mobilenet224_0.25 --device cpu against the JAX
    CLI on the synthetic KITTI fixture, with test_torch_run_network.py's
    tolerances.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from ground_plane_polling_tpu.bin.run_network import main as jax_run_network
from ground_plane_polling_tpu.models import backbone_registry as jax_registry
from ground_plane_polling_tpu.models import build_detector as jax_build
from ground_plane_polling_tpu.models.densenet import (
    DenseNetBackbone as JaxDenseNet)
from ground_plane_polling_tpu.models.mobilenet import (
    MobileNetBackbone as JaxMobileNet)
from ground_plane_polling_tpu.models.retinanet import (
    GPPRetinaNet as JaxRetinaNet)
from ground_plane_polling_tpu.models.tiny import TinyBackbone as JaxTiny
from ground_plane_polling_tpu.models.vgg import VGGBackbone as JaxVGG
from ground_plane_polling_tpu.training.checkpoint import export_params
from ground_plane_polling_tpu.training.train import (
    compute_losses as jax_compute_losses)
from ground_plane_polling_tpu_torch.bin.run_network import main as run_network
from ground_plane_polling_tpu_torch.models import (
    GPPRetinaNet, backbone_registry, build_detector, export_jax_params,
    init_detector, load_jax_params, load_weights)
from ground_plane_polling_tpu_torch.models.densenet import DenseNetBackbone
from ground_plane_polling_tpu_torch.models.mobilenet import MobileNetBackbone
from ground_plane_polling_tpu_torch.models.tiny import TinyBackbone
from ground_plane_polling_tpu_torch.models.vgg import VGGBackbone
from ground_plane_polling_tpu_torch.training.train import (
    create_train_state, make_optimizer, make_train_step)

from .fixtures import make_synthetic_kitti
from .test_torch_run_network import ROUND, _angle_gap, _fields
from .test_torch_train_step import (SHAPE, TERMS, _batch_t, _flatten,
                                    _prepared_batch, _to_torch_name)

torch.set_num_threads(2)

FEATURES = 64
# family -> (JAX backbone, the port's), each at its shrunk depth
FAMILIES = {
    "tiny": (functools.partial(JaxTiny, name="backbone"), TinyBackbone),
    "vgg": (functools.partial(JaxVGG, blocks=(1,) * 5, name="backbone"),
            functools.partial(VGGBackbone, (1,) * 5)),
    "densenet": (functools.partial(JaxDenseNet, block_sizes=(1, 2, 1, 1),
                                   name="backbone"),
                 functools.partial(DenseNetBackbone, (1, 2, 1, 1))),
    "mobilenet_0.25": (functools.partial(JaxMobileNet, alpha=0.25,
                                         name="backbone"),
                       functools.partial(MobileNetBackbone, 0.25)),
    "mobilenet_0.75": (functools.partial(JaxMobileNet, alpha=0.75,
                                         name="backbone"),
                       functools.partial(MobileNetBackbone, 0.75)),
}
CANVASES = {"64x224": (64, 224), "72x232_odd": (72, 232)}


def jax_detector(family):
    return JaxRetinaNet(backbone_fn=FAMILIES[family][0],
                        feature_size=FEATURES)


def torch_detector(family):
    net = FAMILIES[family][1]()
    return GPPRetinaNet(net, backbone_channels=net.channels,
                        feature_size=FEATURES)


def numpy_variables(model, seed):
    """Seeded numpy weights in the tree of `model.init` (its shapes from
    jax.eval_shape, nothing compiled): kernels N(0, 1 / fan-in), biases
    N(0, 0.1), random frozen-BN statistics, the classification out kernel
    N(0, 0.05)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        shape = leaf.shape
        name = path[-1].key
        if path[0].key == "frozen":
            if name == "scale":
                return rng.uniform(0.5, 1.5, shape)
            if name == "var":
                return rng.uniform(0.5, 2.0, shape)
            return rng.normal(0, 0.1, shape)
        if name == "bias":
            return rng.normal(0, 0.1, shape)
        std = 0.05 if path[-2].key == "cls_out" else \
            1.0 / np.sqrt(np.prod(shape[:-1]))
        return rng.normal(0, std, shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, leaf: draw(p, leaf).astype(np.float32), dict(shapes))


def _jax_forward(model):
    """Jitted model.apply that also returns the backbone's (C3, C4, C5)."""
    def fn(variables, images):
        out, state = model.apply(
            variables, images, mutable=["intermediates"],
            capture_intermediates=lambda mdl, method: (
                mdl.name == "backbone" and method == "__call__"))
        return out, state["intermediates"]["backbone"]["__call__"][0]
    return jax.jit(fn)


@pytest.fixture(scope="module")
def family_weights(tmp_path_factory):
    """family -> (JAX variables, .npz path, jitted JAX forward), made once
    per family."""
    cache = {}

    def get(family):
        if family not in cache:
            model = jax_detector(family)
            variables = numpy_variables(model, seed=len(family))
            path = str(tmp_path_factory.mktemp("bb") / f"{family}.npz")
            export_params(path, variables)
            cache[family] = variables, path, _jax_forward(model)
        return cache[family]

    return get


def _close(got, want, what):
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("canvas", sorted(CANVASES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_backbone_and_heads_match_jax(family_weights, family, canvas):
    variables, path, forward = family_weights(family)
    images = np.random.RandomState(2).uniform(
        -128, 128, (1, *CANVASES[canvas], 3)).astype(np.float32)
    want, want_c = forward(variables, images)
    model = load_weights(torch_detector(family), path).eval()
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    with torch.no_grad():
        got_c = model.backbone(x)
        got = model(x)
    for name, g, w in zip(("C3", "C4", "C5"), got_c, want_c):
        _close(g.permute(0, 2, 3, 1).numpy(), w, name)
    for key in ("regression", "regression_dim", "classification"):
        _close(got[key].numpy(), want[key], key)


def _jax_shapes(name):
    shapes = jax.eval_shape(jax_build(name).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    return {"/".join(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                dict(shapes))[0]}


@pytest.mark.parametrize("name", sorted(jax_registry()))
def test_param_tree_matches_jax(name):
    """JAX's keys and shapes load strictly into build_detector(name) and
    export back unchanged; init_detector's weights are finite."""
    assert sorted(backbone_registry()) == sorted(jax_registry())
    want = _jax_shapes(name)
    with torch.device("meta"):  # no default init: the load fills it
        model = build_detector(name)
    model.load_state_dict(load_jax_params(
        {k: np.zeros(s, np.float32) for k, s in want.items()}), strict=True,
        assign=True)
    got = {k: v.shape for k, v in export_jax_params(model).items()}
    assert got == want
    init_detector(model, 0)
    assert all(bool(torch.isfinite(v).all())
               for v in model.state_dict().values())


def test_init_detector_uses_flax_fan_in():
    """lecun_normal's fan-in is kh kw Cin / groups: 9 for a depthwise
    kernel; tiny's and VGG's conv biases start at zero."""
    model = init_detector(build_detector("mobilenet224_1.0"), 0)
    dw = model.backbone.dw13.weight  # (1024, 1, 3, 3)
    assert tuple(dw.shape) == (1024, 1, 3, 3)
    assert 0.9 < float(dw.std()) * 3.0 < 1.1
    pw = model.backbone.pw13.weight  # fan-in 1024
    assert 0.9 < float(pw.std()) * 32.0 < 1.1
    for name, conv in (("tiny", "conv0"), ("vgg16", "block1_conv1")):
        net = init_detector(build_detector(name), 1)
        assert float(getattr(net.backbone, conv).bias.abs().max()) == 0.0


@pytest.mark.parametrize("family", ["tiny", "mobilenet_0.25"])
def test_one_f32_step_matches_jax(family_weights, family):
    """Loss terms (rtol 1e-4) and post-clip gradients (each tensor within
    1e-3 of its norm) of one step from the same weights and batch."""
    variables, path, _ = family_weights(family)
    batch = _prepared_batch()
    model = jax_detector(family)
    grads, terms = jax.jit(jax.grad(
        lambda p: jax_compute_losses(model, p, variables.get("frozen", {}),
                                     batch),
        has_aux=True))(variables["params"])
    clip = jax.tree_util.tree_map(
        lambda g: g * jnp.minimum(1.0, 1e-3 / jnp.maximum(
            jnp.linalg.norm(g), 1e-30)), grads)
    port = load_weights(torch_detector(family), path)
    state = create_train_state(port, make_optimizer(port, 1e-3))
    state, metrics = make_train_step()(state, _batch_t(batch))
    for k in TERMS:
        assert float(metrics[k]) == pytest.approx(float(terms[k]),
                                                  rel=1e-4), k
    got = {n: p.grad.numpy() for n, p in state.model.named_parameters()}
    clipped = _flatten(clip)
    assert len(got) == len(clipped)
    for key, g in clipped.items():
        name, g = _to_torch_name(key, g)
        norm = float(np.linalg.norm(g))
        np.testing.assert_allclose(got[name], g, rtol=0,
                                   atol=1e-3 * norm + 1e-30, err_msg=name)
    assert SHAPE == (64, 64)


@pytest.fixture(scope="module")
def mobilenet_cli(tmp_path_factory):
    """Both run_network CLIs with one seeded mobilenet224_0.25 .npz whose
    classification out kernel is N(0, 0.05) with a zero bias."""
    tmp = tmp_path_factory.mktemp("mcli")
    root = make_synthetic_kitti(str(tmp / "kitti"), n_images=3)
    name = "mobilenet224_0.25"
    variables = jax.jit(jax_build(name).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    out = variables["params"]["classification"]["cls_out"]
    out["kernel"] = np.random.RandomState(0).normal(
        0, 0.05, out["kernel"].shape).astype(np.float32)
    out["bias"] = np.zeros_like(out["bias"])
    weights = str(tmp / "model.npz")
    export_params(weights, variables)
    with open(weights + ".json", "w") as f:
        json.dump({"backbone": "resnet50", "num_classes": 1}, f)
    common = [weights, os.path.join(root, "train", "images"),
              os.path.join(root, "train", "calibs"),
              os.path.join(root, "road_planes_database.mat")]
    flags = ["--kitti", "--no-bf16", "--image-min-side", "64",
             "--image-max-side", "224", "--backbone", name]
    outputs = {}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    try:
        for run, fn, extra in (("jax", jax_run_network, []),
                               ("torch", run_network, ["--device", "cpu"])):
            odir = str(tmp / run)
            fn(common + [odir] + flags + extra)
            base = os.path.join(odir, "model", "outputs")
            outputs[run] = {
                n: (open(os.path.join(base, "kitti", n)).read().splitlines(),
                    scipy.io.loadmat(os.path.join(
                        base, "full", n.replace(".txt", ".mat"))))
                for n in sorted(os.listdir(os.path.join(base, "kitti")))}
    finally:  # --no-bf16 turns TF32 off process-wide
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    return outputs


def test_mobilenet_run_network_matches_jax_cli(mobilenet_cli):
    """--backbone over the sidecar's resnet50: the same frames, rows and
    types; 2D boxes and scores within the txt's rounding; 3D fields
    within tests/test_e2e.py's conditioning-aware bound."""
    ref, got = mobilenet_cli["jax"], mobilenet_cli["torch"]
    assert sorted(got) == sorted(ref) == ["000000.txt", "000001.txt"]
    n_rows = 0
    for fn, (rows, _) in ref.items():
        rows_t = got[fn][0]
        assert len(rows_t) == len(rows), fn
        n_rows += len(rows)
        want, have = np.array(_fields(rows)), np.array(_fields(rows_t))
        if not len(rows):
            continue
        assert (have[:, 0] == want[:, 0]).all()
        w2 = want[:, [4, 5, 6, 7, 15]].astype(float)
        g2 = have[:, [4, 5, 6, 7, 15]].astype(float)
        np.testing.assert_allclose(g2, w2, rtol=0, atol=ROUND, err_msg=fn)
        w3 = want[:, 8:14].astype(float)
        g3 = have[:, 8:14].astype(float)
        assert (np.abs(g3 - w3) <= 0.5 + 2e-3 * np.abs(w3) + ROUND).all()
        wa = want[:, [14, 3]].astype(float)
        ga = have[:, [14, 3]].astype(float)
        assert (_angle_gap(ga, wa) <= 2e-2 + ROUND).all(), fn
    assert n_rows > 0
