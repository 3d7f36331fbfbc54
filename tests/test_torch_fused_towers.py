"""Fused classification + dimension towers (`--fuse-towers`) in the port,
against the JAX package's FusedClsDimHead / fuse_cls_dim_params /
fuse_detector_params on the same weights, and against the port's own split
heads.

Tolerances: the weight transform is exact (equal arrays); head outputs of
the port against JAX use test_torch_model.py's rtol 1e-4 / atol 1e-4, the
atol scaled by the largest magnitude of a detector output (float32
convolutions summed in another order); fused against
split inside the port is atol 1e-5 (the zero blocks add exact zeros, but
a wider convolution may sum in another order).
"""

import functools

import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.models import (
    fuse_detector_params as jax_fuse_detector_params)
from ground_plane_polling_tpu.models.heads import (
    FusedClsDimHead as JaxFusedHead, fuse_cls_dim_params as jax_fuse_params)
from ground_plane_polling_tpu.models.resnet import ResNetBackbone as JaxResNet
from ground_plane_polling_tpu.models.retinanet import (
    GPPRetinaNet as JaxRetinaNet)
from ground_plane_polling_tpu.training.checkpoint import import_params
from ground_plane_polling_tpu_torch.inference import GPPDetector
from ground_plane_polling_tpu_torch.models import (
    GPPRetinaNet, build_detector, export_jax_params, fuse_detector_params,
    init_detector, load_jax_params, load_weights)
from ground_plane_polling_tpu_torch.models.common import PRIOR_PROB_BIAS
from ground_plane_polling_tpu_torch.models.heads import (
    ClassificationHead, DimRegressionHead, FusedClsDimHead,
    fuse_cls_dim_params)
from ground_plane_polling_tpu_torch.models.resnet import ResNetBackbone

torch.set_num_threads(2)

SHRUNK = (1, 1, 1, 1)
FEATURES = 64
CIN, CLS_W, DIM_W, ANCHORS = 16, 8, 4, 3


def _randomize(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return module


def _split_heads(num_classes, seed=0):
    cls = _randomize(ClassificationHead(CIN, num_classes, ANCHORS, CLS_W),
                     seed)
    dim = _randomize(DimRegressionHead(CIN, num_classes, ANCHORS, DIM_W),
                     seed + 1)
    return cls, dim


def _to_flax(state, prefix):
    """OIHW state dict of one head -> the flax params tree of that head."""
    tree = {}
    for key, value in state.items():
        layer, leaf = key.split(".")
        v = value.numpy()
        tree.setdefault(layer, {})[
            "kernel" if leaf == "weight" else "bias"] = (
            v.transpose(2, 3, 1, 0) if leaf == "weight" else v)
    assert all(k.startswith(prefix) for k in tree)
    return tree


def _features(shape=(2, CIN, 6, 10), seed=3):
    return np.random.RandomState(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("num_classes", [1, 2])
def test_fuse_cls_dim_params_matches_jax(num_classes):
    cls, dim = _split_heads(num_classes)
    got = fuse_cls_dim_params(cls.state_dict(), dim.state_dict())
    want = jax_fuse_params(_to_flax(cls.state_dict(), "cls"),
                           _to_flax(dim.state_dict(), "dim"))
    assert set(got) == {f"clsdim_{i}.{leaf}" for i in (0, 1, 2, 3, "out")
                        for leaf in ("weight", "bias")}
    for layer, leaves in want.items():
        np.testing.assert_array_equal(
            got[f"{layer}.weight"].numpy().transpose(2, 3, 1, 0),
            np.asarray(leaves["kernel"]))
        np.testing.assert_array_equal(got[f"{layer}.bias"].numpy(),
                                      np.asarray(leaves["bias"]))


@pytest.mark.parametrize("num_classes", [1, 2])
def test_fused_head_matches_jax_fused_head(num_classes):
    cls, dim = _split_heads(num_classes)
    fused = FusedClsDimHead(CIN, num_classes, ANCHORS, CLS_W, DIM_W)
    fused.load_state_dict(fuse_cls_dim_params(cls.state_dict(),
                                              dim.state_dict()))
    x = _features()
    with torch.no_grad():
        got = fused(torch.from_numpy(x))
    jax_head = JaxFusedHead(num_classes=num_classes, num_anchors=ANCHORS,
                            cls_width=CLS_W, dim_width=DIM_W)
    params = _to_flax(fused.state_dict(), "clsdim")
    want = jax_head.apply({"params": params}, x.transpose(0, 2, 3, 1))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("num_classes", [1, 2])
def test_fused_head_matches_split_heads(num_classes):
    cls, dim = _split_heads(num_classes, seed=5)
    fused = FusedClsDimHead(CIN, num_classes, ANCHORS, CLS_W, DIM_W)
    fused.load_state_dict(fuse_cls_dim_params(cls.state_dict(),
                                              dim.state_dict()))
    x = torch.from_numpy(_features(seed=4))
    with torch.no_grad():
        got_cls, got_dim = fused(x)
        np.testing.assert_allclose(got_cls.numpy(), cls(x).numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got_dim.numpy(), dim(x).numpy(),
                                   rtol=0, atol=1e-5)


def shrunk_jax_model(fuse_cls_dim=False):
    backbone = functools.partial(JaxResNet, stage_sizes=SHRUNK,
                                 name="backbone")
    return JaxRetinaNet(backbone_fn=backbone, feature_size=FEATURES,
                        fuse_cls_dim=fuse_cls_dim)


def shrunk_torch_model(fuse_cls_dim=False):
    return GPPRetinaNet(ResNetBackbone(SHRUNK), feature_size=FEATURES,
                        fuse_cls_dim=fuse_cls_dim)


@pytest.fixture(scope="module")
def split_weights(tmp_path_factory):
    """A shrunk split detector's export (seeded init, then every head
    weight perturbed by N(0, 0.01) so that the zero-init kernels and
    biases matter, as tests/test_model.py does), and the JAX package's
    variables read from it."""
    model = init_detector(shrunk_torch_model(), 0)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith(("classification.", "regression.",
                                "regression_dim.")):
                p.add_(torch.randn(p.shape, generator=gen) * 0.01)
    path = str(tmp_path_factory.mktemp("fused") / "split.npz")
    np.savez(path, **export_jax_params(model))
    return import_params(path), path


def _assert_heads_close(got, want):
    """rtol 1e-4, atol 1e-4 of the largest magnitude of each output."""
    for key in ("regression", "regression_dim", "classification"):
        w = np.asarray(want[key])
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(w).max()),
                                   err_msg=key)


def _images(shape=(2, 96, 128), seed=1):
    return np.random.RandomState(seed).uniform(
        -128, 128, (*shape, 3)).astype(np.float32)


def _run(model, images):
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(images).permute(0, 3, 1, 2))
    return {k: v.numpy() for k, v in out.items()}


def test_fused_detector_matches_jax_fused(split_weights):
    variables, path = split_weights
    images = _images()
    want = shrunk_jax_model(fuse_cls_dim=True).apply(
        jax_fuse_detector_params(variables), images)
    _assert_heads_close(
        _run(load_weights(shrunk_torch_model(True), path), images), want)


def test_fused_detector_matches_split(split_weights):
    _, path = split_weights
    images = _images(seed=2)
    split = _run(load_weights(shrunk_torch_model(), path), images)
    fused = _run(load_weights(shrunk_torch_model(True), path), images)
    for key, want in split.items():
        np.testing.assert_allclose(fused[key], want, rtol=0, atol=1e-5,
                                   err_msg=key)


def test_fused_export_loads_into_jax_fused_model(split_weights, tmp_path):
    """export_jax_params of a fused model writes the params/clsdim tree
    that the JAX package's fuse_cls_dim=True model reads."""
    _, path = split_weights
    model = load_weights(shrunk_torch_model(True), path)
    flat = export_jax_params(model)
    assert any(k.startswith("params/clsdim/clsdim_out/") for k in flat)
    assert not any(k.startswith(("params/classification/",
                                 "params/regression_dim/")) for k in flat)
    out_path = str(tmp_path / "fused.npz")
    np.savez(out_path, **flat)
    images = _images(seed=3)
    want = shrunk_jax_model(fuse_cls_dim=True).apply(
        import_params(out_path), images)
    _assert_heads_close(_run(model, images), want)
    # and the fused export loads strictly back into a fused model
    again = load_weights(shrunk_torch_model(True), out_path)
    for key, value in model.state_dict().items():
        np.testing.assert_allclose(again.state_dict()[key].numpy(),
                                   value.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=key)


def test_split_model_refuses_fused_weights(split_weights, tmp_path):
    _, path = split_weights
    fused_path = str(tmp_path / "fused.npz")
    np.savez(fused_path, **export_jax_params(
        load_weights(shrunk_torch_model(True), path)))
    with pytest.raises(ValueError, match="clsdim"):
        load_weights(shrunk_torch_model(), fused_path)


def test_fuse_detector_params_idempotent(split_weights):
    _, path = split_weights
    state = load_weights(shrunk_torch_model(), path).state_dict()
    fused = fuse_detector_params(state)
    assert not any(k.startswith(("classification.", "regression_dim."))
                   for k in fused)
    again = fuse_detector_params(fused)
    assert set(again) == set(fused)
    for key, value in fused.items():
        assert torch.equal(again[key], value), key
    # the other entries pass through untouched
    for key in ("regression.box_out.weight", "fpn.p3.weight"):
        assert torch.equal(fused[key], state[key])


def test_fuse_detector_params_validates():
    with pytest.raises(ValueError, match="head entries"):
        fuse_detector_params({"backbone.conv1.weight": torch.zeros(1)})
    cls, dim = _split_heads(1)
    partial = {f"classification.{k}": v for k, v in cls.state_dict().items()}
    partial.update({f"regression_dim.{k}": v
                    for k, v in dim.state_dict().items()
                    if not k.startswith("dim_out")})
    with pytest.raises(ValueError, match="dim_out"):
        fuse_detector_params(partial)


def test_fused_init_semantics():
    """init_detector on a fused model means what the JAX fused init means:
    N(0, 0.01) tower; out conv with the prior bias and a zero kernel on the
    classification channels, N(0, 0.01) on the dimension block (dimension
    outputs from the dimension tower's channels), zero elsewhere."""
    model = init_detector(shrunk_torch_model(True), 0)
    head = model.clsdim
    cls_ch = head.cls_ch
    out = head.clsdim_out
    bias = out.bias.detach()
    assert torch.allclose(bias[:cls_ch],
                          torch.full((cls_ch,), PRIOR_PROB_BIAS))
    assert float(bias[cls_ch:].abs().max()) == 0.0
    w = out.weight.detach()
    assert float(w[:cls_ch].abs().max()) == 0.0
    assert float(w[cls_ch:, :head.cls_width].abs().max()) == 0.0
    assert 0.008 < float(w[cls_ch:, head.cls_width:].std()) < 0.012
    assert 0.008 < float(head.clsdim_1.weight.detach().std()) < 0.012


def test_fresh_fused_model_scores_the_prior():
    """Counterpart of tests/test_model.py's fused prior test: on a zero
    image a freshly initialised fused model scores 0.01 and regresses 0."""
    model = init_detector(shrunk_torch_model(True), 1)
    out = _run(model, np.zeros((1, 64, 64, 3), np.float32))
    np.testing.assert_allclose(out["classification"], 0.01, rtol=1e-5)
    np.testing.assert_allclose(out["regression_dim"], 0.0, atol=1e-6)


@pytest.fixture(scope="module")
def resnet50_weights(tmp_path_factory):
    model = init_detector(build_detector("resnet50"), 0)
    with torch.no_grad():
        out = model.classification.cls_out
        out.weight.copy_(torch.randn(out.weight.shape,
                                     generator=torch.Generator()
                                     .manual_seed(0)) * 0.01)
        out.bias.zero_()
    path = str(tmp_path_factory.mktemp("r50") / "model.npz")
    np.savez(path, **export_jax_params(model))
    return path


def test_gpp_detector_fuse_towers_matches_split(resnet50_weights):
    """GPPDetector(fuse_towers=True) converts a standard .npz on load and
    detects what the split detector detects."""
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (1, 64, 96, 3)).astype(np.uint8)
    P = np.array([[200.0, 0.0, 48.0, 1.2], [0.0, 200.0, 32.0, 0.1],
                  [0.0, 0.0, 1.0, 0.002]])
    P_inv = np.linalg.pinv(P)[None].astype(np.float32)
    planes = np.array([[0.0, 1.0, 0.0, -1.65], [0.01, 1.0, 0.0, -1.5]],
                      np.float32)[None]
    outs = {}
    for fuse in (False, True):
        det = GPPDetector(fuse_towers=fuse)
        det.load(resnet50_weights)
        assert hasattr(det.model, "clsdim") == fuse
        outs[fuse] = {k: v.numpy() for k, v in
                      det(images, P_inv, planes)._asdict().items()
                      if v is not None}
    np.testing.assert_array_equal(outs[True]["labels"], outs[False]["labels"])
    for key in ("scores", "boxes", "dims"):
        np.testing.assert_allclose(outs[True][key], outs[False][key],
                                   rtol=0, atol=1e-4, err_msg=key)
    assert (outs[True]["scores"] > 0).sum() > 0


def test_fused_state_dict_roundtrip_through_flat_export():
    """load_jax_params(export_jax_params(fused)) is the fused state."""
    model = init_detector(shrunk_torch_model(True), 2)
    again = load_jax_params(export_jax_params(model))
    for key, value in model.state_dict().items():
        np.testing.assert_allclose(again[key].numpy(), value.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=key)
