"""int8 depthwise convolution in the port (ops/int8_conv.py's grouped
plain version behind kernels/int8_depthwise_cuda.py, models/quantize.py's
depthwise sites) against the JAX package's models/quantize.py, on the CPU.

Tolerances:
  * one depthwise conv (feature_group_count = C) fed the same float32 or
    bf16 x, w and s_x: int8 operands, per-channel weight scales (over
    kh, kw, 1), int32 accumulators and dequantized (+ bias) outputs equal
    to JAX's bit for bit;
  * site counts equal; a MobileNet block is two sites, dw then pw;
  * a MobileNet detector (alpha 0.25, FPN 64, 64x224, float32):
    calibration scales rtol 1e-5 (the float trunks differ in about the
    sixth digit) and the int8 forward on JAX's scales against JAX's int8
    program run op by op (unjitted) within rtol 1e-6 of max|JAX|, as
    tests/test_torch_quantize.py holds the ResNet detector.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ground_plane_polling_tpu.models import build_detector as jax_build
from ground_plane_polling_tpu.models import quantize as jq
from ground_plane_polling_tpu_torch import inference
from ground_plane_polling_tpu_torch.kernels import (int8_conv_cuda,
                                                    int8_depthwise_cuda)
from ground_plane_polling_tpu_torch.models import build_detector
from ground_plane_polling_tpu_torch.models import quantize as tq
from ground_plane_polling_tpu_torch.models.resnet import same_padding
from ground_plane_polling_tpu_torch.ops import int8_conv

from .test_torch_backbones import (FAMILIES, jax_detector,
                                   numpy_variables, torch_detector)
from ground_plane_polling_tpu.training.checkpoint import export_params
from ground_plane_polling_tpu_torch.models import load_weights

torch.set_num_threads(2)

CANVAS = (64, 224)
# (channels, stride, h, w, with bias)
DW_CASES = {
    "c8_s1_even": (8, 1, 8, 14, False),
    "c24_s2_even": (24, 2, 8, 14, False),
    "c24_s2_odd": (24, 2, 9, 13, True),
    "c32_s1_odd": (32, 1, 7, 11, True),
    "c3_s2_odd": (3, 2, 7, 9, False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DW_CASES))
def test_depthwise_bitwise_equal_to_jax(case, dtype):
    """One depthwise 3x3 SAME site: the port's int8 operands, scales,
    accumulators and output equal JAX's interceptor's bit for bit."""
    c, s, h, w, with_bias = DW_CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    x = rng.normal(0, 2.0, (2, h, w, c)).astype(np.float32)
    kernel = rng.normal(0, 0.3, (3, 3, 1, c)).astype(np.float32)
    bias = rng.normal(0, 0.5, c).astype(np.float32)
    s_x = np.float32(np.abs(x).max() / 127.0 * 0.9)  # some clamp at 127
    jdt = jnp.dtype(dtype)
    xj, kj, bj = (jnp.asarray(a).astype(jdt) for a in (x, kernel, bias))
    dn = ("NHWC", "HWIO", "NHWC")

    def conv(xx, kk):
        y = lax.conv_general_dilated(xx, kk, (s, s), "SAME",
                                     dimension_numbers=dn,
                                     feature_group_count=c)
        return y + bj if with_bias else y

    want = np.asarray(jq.quantize_apply(conv, [s_x])(xj, kj), np.float32)
    x8j = jnp.clip(jnp.round(xj.astype(jnp.float32) / float(s_x)), -127,
                   127).astype(jnp.int8)
    s_wj = jnp.maximum(jnp.max(jnp.abs(kj.astype(jnp.float32)),
                               axis=(0, 1, 2)), 1e-8) / 127.0
    w8j = jnp.clip(jnp.round(kj.astype(jnp.float32) / s_wj), -127,
                   127).astype(jnp.int8)
    accj = lax.conv_general_dilated(x8j, w8j, (s, s), "SAME",
                                    dimension_numbers=dn,
                                    feature_group_count=c,
                                    preferred_element_type=jnp.int32)

    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(tdt)
    xt = xt.permute(0, 3, 1, 2)
    wt = torch.from_numpy(np.asarray(kj.astype(jnp.float32))).to(tdt)
    wt = wt.permute(3, 2, 0, 1)  # the weight bridge's HWIO -> OIHW
    assert tuple(wt.shape) == (c, 1, 3, 3)
    bt = torch.from_numpy(bias).to(tdt) if with_bias else None
    padding = same_padding(h, w, 3, s)
    x8 = int8_conv_cuda.quantize(xt, float(s_x))
    w8, s_w = int8_conv.quantize_weight(wt)
    np.testing.assert_array_equal(x8.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(x8j))
    np.testing.assert_array_equal(w8.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(w8j))
    np.testing.assert_array_equal(s_w.numpy(), np.asarray(s_wj))
    before = int8_depthwise_cuda.DEPTHWISE_LAUNCHES
    acc = int8_depthwise_cuda.depthwise2d_accumulate(x8, w8, s, padding)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(accj))
    got = int8_depthwise_cuda.depthwise2d(x8, w8, float(s_x), s_w, bt, s,
                                          padding, tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(
        got.float().permute(0, 2, 3, 1).numpy(), want)
    # CPU tensors take the plain version: the kernel is not launched
    assert int8_depthwise_cuda.DEPTHWISE_LAUNCHES == before


def test_conv_padding_takes_depthwise_and_refuses_other_groups():
    x = torch.zeros(1, 8, 9, 13)
    dw = torch.nn.Conv2d(8, 8, 3, stride=2, groups=8, bias=False)
    assert tq.conv_padding(dw, x) == ((0, 0), (0, 0))
    grouped = torch.nn.Conv2d(8, 16, 3, groups=2)
    with pytest.raises(ValueError, match="plain or depthwise convs"):
        tq.conv_padding(grouped, x)
    assert int8_depthwise_cuda.is_depthwise(8, (8, 1, 3, 3))
    assert not int8_depthwise_cuda.is_depthwise(8, (16, 1, 3, 3))


@pytest.mark.parametrize("name,sites", [("mobilenet224_1.0", 110),
                                        ("densenet121", 203),
                                        ("tiny", 88), ("vgg16", 96)])
def test_full_width_site_count_matches_jax(name, sites):
    """Conv sites of the full-width detector (FPN 512, split heads): JAX
    traced on abstract inputs, the port on the meta device."""
    jmodel = jax_build(name)
    image = jax.ShapeDtypeStruct((1, 416, 1344, 3), jnp.float32)
    variables = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), image)
    want = jq.count_convs(lambda v, im: jmodel.apply(v, im), variables,
                          image)
    model = build_detector(name).to("meta")
    got = tq.count_convs(model, torch.empty(1, 3, 416, 1344, device="meta"))
    assert got == want == sites


@pytest.fixture(scope="module")
def mobilenet(tmp_path_factory):
    model = jax_detector("mobilenet_0.25")
    variables = numpy_variables(model, seed=11)
    path = str(tmp_path_factory.mktemp("dwq") / "mobilenet.npz")
    export_params(path, variables)
    port = inference.place_model(
        load_weights(torch_detector("mobilenet_0.25"), path), "cpu")
    rng = np.random.RandomState(3)
    ims = [rng.uniform(-128, 128, (1, *CANVAS, 3)).astype(np.float32)
           for _ in range(2)]
    scales = jq.collect_scales(lambda v, im: model.apply(v, im),
                               [(variables, jnp.asarray(im)) for im in ims])
    return model, variables, port, ims, scales


def _nchw(im):
    return torch.from_numpy(im).permute(0, 3, 1, 2)


def test_mobilenet_sites_and_scales_match_jax(mobilenet):
    """Calibration gives JAX's scales in JAX's site order (conv0, then dw
    and pw of each block, then the FPN and the heads); 13 sites are
    depthwise, each directly before its pointwise site."""
    _, _, port, ims, want = mobilenet
    got = tq.collect_scales(port, [_nchw(im) for im in ims])
    assert got.shape == want.shape == (110,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    kinds = []
    with tq._intercept(port, lambda site, conv, x: (
            kinds.append(conv.groups != 1), type(conv).forward(conv, x))[1]):
        with torch.no_grad():
            port(_nchw(ims[0]))
    dw = [i for i, k in enumerate(kinds) if k]
    assert dw == list(range(1, 27, 2))


def test_mobilenet_int8_forward_matches_jax(mobilenet):
    """The int8 forward of MobileNet's trunk (its 27 sites hold all 13
    depthwise ones; the FPN's and heads' int8 sites are held against JAX
    in tests/test_torch_quantize.py) on JAX's scales against JAX's int8
    program run op by op: C3, C4 and C5 within rtol 1e-6 of max|JAX|, and
    within JAX's own int8 bound of the float trunk."""
    model, variables, port, ims, scales = mobilenet
    trunk = FAMILIES["mobilenet_0.25"][0]()
    trunk_vars = {"params": variables["params"]["backbone"],
                  "frozen": variables["frozen"]["backbone"]}
    image = jnp.asarray(ims[0])
    want = jq.quantize_apply(lambda v, im: trunk.apply(v, im),
                             scales[:27])(trunk_vars, image)
    ref = trunk.apply(trunk_vars, image)
    before = int8_depthwise_cuda.DEPTHWISE_LAUNCHES
    with torch.inference_mode():
        got = tq.quantize_apply(port.backbone, scales[:27])(_nchw(ims[0]))
    assert int8_depthwise_cuda.DEPTHWISE_LAUNCHES == before
    for name, g, w, r in zip(("C3", "C4", "C5"), got, want, ref):
        g = g.permute(0, 2, 3, 1).numpy()
        w, r = np.asarray(w, np.float32), np.asarray(r, np.float32)
        gap = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-6))
        assert gap < 1e-6, (name, gap)
        err = float(np.abs(g - r).max() / max(np.abs(r).max(), 1e-6))
        assert err < 0.08, (name, err)
