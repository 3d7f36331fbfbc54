"""Packed pyramid levels (`build_detector(pack_levels=True)`: P4..P7 in one
canvas per head, the gap pixels re-zeroed after every tower ReLU) in the
port, against its unpacked model and the JAX package's packed model.

Tolerances:
  * `_pack_tail`: canvas, mask and layout equal to JAX's;
  * packed against unpacked in the port, float32, head biases perturbed
    so that the gap's re-zeroing is load-bearing: rtol 1e-5 / atol 1e-5
    (JAX's own bound for its two schedules, tests/test_model.py);
  * the port's packed model against JAX's on the same weights: rtol 1e-4
    and atol 1e-4 of the largest |JAX| value of each output
    (tests/test_torch_backbones.py's bound for two float32 trunks; the
    perturbed 512-wide box tower reaches |20| and sums 4,608 products a
    layer);
  * site counts equal to JAX's (ResNet-50 at 416x1344: 91, 81 fused);
  * int8: calibration scales within rtol 1e-5 of JAX's, and the forward
    on JAX's scales within 1e-6 of max|JAX| of JAX's int8 program run op
    by op (tests/test_torch_quantize.py's bounds and reasons).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.models import build_detector as jax_build
from ground_plane_polling_tpu.models import fuse_detector_params as jax_fuse
from ground_plane_polling_tpu.models import quantize as jq
from ground_plane_polling_tpu.models.resnet import ResNetBackbone as JaxResNet
from ground_plane_polling_tpu.models.retinanet import (
    GPPRetinaNet as JaxRetinaNet, _pack_tail as jax_pack_tail)
from ground_plane_polling_tpu.training.checkpoint import _flatten
from ground_plane_polling_tpu_torch.models import (
    GPPRetinaNet, build_detector, fuse_detector_params, load_jax_params,
    load_state)
from ground_plane_polling_tpu_torch.models import quantize as tq
from ground_plane_polling_tpu_torch.models.resnet import ResNetBackbone
from ground_plane_polling_tpu_torch.models.retinanet import _pack_tail

from .test_torch_model import FEATURES, SHRUNK, randomized_variables

torch.set_num_threads(2)

IMAGE = (128, 192)  # P4..P7: 8x12, 4x6, 2x3, 1x2 (odd tail shapes)
HEADS = ("classification", "regression", "regression_dim")


def _perturbed(variables, seed):
    """`variables` with every head parameter moved by N(0, 0.05), biases
    included (the heads' init biases are zero or constant)."""
    rng = np.random.RandomState(seed)
    params = dict(variables["params"])
    for head in HEADS:
        params[head] = jax.tree_util.tree_map(
            lambda p: (np.asarray(p) + rng.normal(0, 0.05, p.shape)).astype(
                np.float32), params[head])
    return {**variables, "params": params}


@functools.lru_cache(maxsize=None)
def _tiny_weights():
    """Perturbed tiny-detector variables (JAX init) and their flat .npz
    arrays."""
    model = jax_build("tiny")
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, *IMAGE, 3), jnp.float32))
    variables = _perturbed(jax.tree_util.tree_map(np.asarray, variables), 1)
    return variables, _flatten(variables)


def _port(backbone="tiny", fuse=False, pack=False, flat=None):
    model = build_detector(backbone, fuse_cls_dim=fuse, pack_levels=pack)
    if flat is not None:
        load_state(model, flat)
    return model.eval()


def _images(b=2, seed=0):
    return np.random.RandomState(seed).uniform(
        -1, 1, (b, *IMAGE, 3)).astype(np.float32)


def _run(model, images):
    with torch.no_grad():
        out = model(torch.from_numpy(images).permute(0, 3, 1, 2))
    return {k: v.numpy() for k, v in out.items()}


def test_pack_tail_matches_jax():
    rng = np.random.RandomState(0)
    shapes = [(8, 12), (4, 6), (2, 3), (1, 2)]
    feats = [rng.normal(0, 1, (2, h, w, 5)).astype(np.float32)
             for h, w in shapes]
    want_canvas, want_mask, want_layout = jax_pack_tail(
        [jnp.asarray(f) for f in feats])
    canvas, mask, layout = _pack_tail(
        [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    assert layout == [tuple(t) for t in want_layout]
    assert canvas.shape == (2, 5, 9, 19)
    np.testing.assert_array_equal(canvas.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want_canvas))
    np.testing.assert_array_equal(mask.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want_mask))


def test_pack_tail_keeps_channels_last():
    feats = [torch.randn(1, 8, h, w).contiguous(
        memory_format=torch.channels_last) for h, w in [(8, 12), (4, 6)]]
    canvas, _, _ = _pack_tail(feats)
    assert canvas.is_contiguous(memory_format=torch.channels_last)
    assert _pack_tail([f.contiguous() for f in feats])[0].is_contiguous()


@pytest.mark.parametrize("fuse", [False, True], ids=["split", "fused"])
def test_packed_matches_unpacked(fuse):
    _, flat = _tiny_weights()
    images = _images()
    want = _run(_port(flat=flat), images)
    model = _port(fuse=fuse, pack=True)
    state = _port(flat=flat).state_dict()
    model.load_state_dict(fuse_detector_params(state) if fuse else state)
    got = _run(model, images)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("fuse", [False, True], ids=["split", "fused"])
def test_packed_matches_jax_packed(fuse):
    variables, flat = _tiny_weights()
    images = _images(seed=1)
    jmodel = jax_build("tiny", pack_levels=True, fuse_cls_dim=fuse)
    want = jmodel.apply(jax_fuse(variables) if fuse else variables,
                        jnp.asarray(images))
    got = _run(_port(fuse=fuse, pack=True, flat=flat), images)
    for k in got:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("fuse", [False, True], ids=["split", "fused"])
def test_packed_site_count_matches_jax(fuse):
    """ResNet-50, FPN 512 at 416x1344: 91 sites packed (136 unpacked), 81
    with fused towers (111)."""
    jmodel = jax_build("resnet50", fuse_cls_dim=fuse, pack_levels=True)
    image = jax.ShapeDtypeStruct((1, 416, 1344, 3), jnp.float32)
    variables = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), image)
    want = jq.count_convs(lambda v, im: jmodel.apply(v, im), variables,
                          image)
    model = _port("resnet50", fuse=fuse, pack=True).to("meta")
    got = tq.count_convs(model, torch.empty(1, 3, 416, 1344, device="meta"))
    assert got == want == (81 if fuse else 91)


def test_packed_int8_matches_jax():
    """The shrunk ResNet packed, int8: calibration (which reads the packed
    canvas, gap zeros included) and the forward on JAX's scales."""
    canvas = (64, 224)
    jmodel = JaxRetinaNet(
        backbone_fn=functools.partial(JaxResNet, stage_sizes=SHRUNK,
                                      name="backbone"),
        feature_size=FEATURES, pack_levels=True)
    variables = _perturbed(randomized_variables(jmodel, seed=0), 2)
    model = GPPRetinaNet(ResNetBackbone(SHRUNK), feature_size=FEATURES,
                         pack_levels=True)
    model.load_state_dict(load_jax_params(_flatten(variables)))
    model.eval()
    rng = np.random.RandomState(0)
    ims = [rng.uniform(-128, 128, (1, *canvas, 3)).astype(np.float32)
           for _ in range(2)]
    fn = lambda v, im: jmodel.apply(v, im)  # noqa: E731
    scales = jq.collect_scales(fn, [(variables, jnp.asarray(im))
                                    for im in ims])
    nchw = [torch.from_numpy(im).permute(0, 3, 1, 2) for im in ims]
    got_scales = tq.collect_scales(model, nchw)
    # 25 trunk and FPN sites, 2 x 5 a head
    assert len(got_scales) == len(scales) == 55
    np.testing.assert_allclose(got_scales, np.asarray(scales), rtol=1e-5)
    want = jq.quantize_apply(fn, scales)(variables, jnp.asarray(ims[0]))
    with torch.inference_mode():
        got = tq.quantize_apply(model, scales)(nchw[0])
    for k in want:
        w = np.asarray(want[k])
        gap = np.abs(got[k].numpy() - w).max() / max(np.abs(w).max(), 1e-6)
        assert gap < 1e-6, (k, gap)
