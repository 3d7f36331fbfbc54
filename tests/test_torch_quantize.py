"""int8 post-training quantization in the port (models/quantize.py,
ops/int8_conv.py, kernels/int8_conv_cuda.py) against the JAX package's
models/quantize.py, on the CPU, where the int8 kernels' plain versions run.

The shrunk detector of tests/test_torch_model.py (ResNet (1,1,1,1), FPN 64)
runs at 64x224 with the same weights in both packages. Tolerances:
  * site counts equal; the full-width counts (136 split, 111 fused) come
    from tracing (JAX) and a meta-device forward (port);
  * calibration scales rtol 1e-5 in float32 (the float trunks of the two
    frameworks differ in about the sixth digit);
  * one conv, fed the same float32 or bf16 x, w and s_x: int8 operands,
    int32 accumulators and dequantized outputs bitwise equal;
  * whole forward on the same scales, against JAX's int8 program run op
    by op (jq.quantize_apply unjitted): every float operation between the
    int8 convs (dequantize, bias, frozen BN, ReLU, adds, upsampling) is one
    correctly rounded IEEE operation in both packages, so the forwards
    agree to the last bits (rtol 1e-6 of max|JAX|; only the sigmoid's exp
    differs), in float32 and bf16; both lie within JAX's own int8 bound,
    0.08 of max|float| (tests/test_quantize.py). XLA's jit fuses those
    operations and rounds otherwise, so that a site whose x / s_x lands
    near a half-way point can round the other way there (one quantization
    step of one input, which propagates): the jitted program is compared
    through the detect call below;
  * detect: against JAX's jitted int8 detect fn, equal detection counts,
    scores within 5e-3 (JAX's int8 against float bound).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ground_plane_polling_tpu.inference import make_detect_fn as jax_detect_fn
from ground_plane_polling_tpu.models import build_detector as jax_build
from ground_plane_polling_tpu.models import fuse_detector_params as jax_fuse
from ground_plane_polling_tpu.models import quantize as jq
from ground_plane_polling_tpu.models.resnet import ResNetBackbone as JaxResNet
from ground_plane_polling_tpu.models.retinanet import (
    GPPRetinaNet as JaxRetinaNet)
from ground_plane_polling_tpu.training.checkpoint import export_params
from ground_plane_polling_tpu_torch import inference
from ground_plane_polling_tpu_torch.kernels import int8_conv_cuda
from ground_plane_polling_tpu_torch.models import (GPPRetinaNet,
                                                   build_detector,
                                                   load_weights)
from ground_plane_polling_tpu_torch.models import quantize as tq
from ground_plane_polling_tpu_torch.models.resnet import (ResNetBackbone,
                                                          same_padding)
from ground_plane_polling_tpu_torch.ops import int8_conv

from .test_polling import P_INV
from .test_torch_model import FEATURES, SHRUNK, randomized_variables

torch.set_num_threads(2)

CANVAS = (64, 224)
JAX_INT8_BOUND = 0.08


def _jax_model(dtype=jnp.float32, fuse=False):
    backbone = functools.partial(JaxResNet, stage_sizes=SHRUNK, dtype=dtype,
                                 name="backbone")
    return JaxRetinaNet(backbone_fn=backbone, feature_size=FEATURES,
                        dtype=dtype, fuse_cls_dim=fuse)


def _torch_model(path, dtype=torch.float32, fuse=False):
    model = GPPRetinaNet(ResNetBackbone(SHRUNK), feature_size=FEATURES,
                         fuse_cls_dim=fuse)
    return inference.place_model(load_weights(model, path), "cpu", dtype)


def _images(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-128, 128, (1, *CANVAS, 3)).astype(np.float32)
            for _ in range(n)]


def _nchw(im):
    return torch.from_numpy(im).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Randomized shrunk weights (split) as JAX variables and an .npz."""
    variables = randomized_variables(_jax_model(), seed=0)
    path = str(tmp_path_factory.mktemp("q") / "shrunk.npz")
    export_params(path, variables)
    return variables, path


def _jax_fn(model):
    return lambda v, im: model.apply(v, im)


@pytest.mark.parametrize("fuse", [False, True], ids=["split", "fused"])
def test_full_width_site_count_matches_jax(fuse):
    """ResNet-50, FPN 512: 136 sites split, 111 fused, in both packages
    (JAX traced on abstract inputs, the port on the meta device)."""
    jmodel = jax_build("resnet50", fuse_cls_dim=fuse)
    image = jax.ShapeDtypeStruct((1, 416, 1344, 3), jnp.float32)
    variables = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), image)
    want = jq.count_convs(_jax_fn(jmodel), variables, image)
    model = build_detector("resnet50", fuse_cls_dim=fuse).to("meta")
    got = tq.count_convs(model, torch.empty(1, 3, 416, 1344, device="meta"))
    assert got == want == (111 if fuse else 136)


@pytest.mark.parametrize("percentile", [100.0, 99.9], ids=["absmax", "p999"])
def test_site_scales_match_jax(weights, percentile):
    """Per-site calibration on the same weights and images: equal in count
    and value (rtol 1e-5), which holds only if the sites come in the same
    order."""
    variables, path = weights
    jmodel = _jax_model()
    ims = _images()
    want = jq.collect_scales(_jax_fn(jmodel),
                             [(variables, jnp.asarray(im)) for im in ims],
                             percentile=percentile)
    got = tq.collect_scales(_torch_model(path), [_nchw(im) for im in ims],
                            percentile=percentile)
    assert got.dtype == np.float32 and got.shape == want.shape == (100,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_collect_scales_uint8_matches_jax(weights):
    """Raw uint8 BGR canvases (the BGR mean subtracted in calibration) and
    a float canvas taken as it is."""
    variables, path = weights
    rng = np.random.RandomState(5)
    canvases = [rng.randint(0, 256, CANVAS + (3,)).astype(np.uint8),
                rng.randint(0, 256, (1,) + CANVAS + (3,)).astype(np.uint8),
                _images(1, seed=6)[0]]
    want = jq.collect_scales_uint8(_jax_model(), variables, canvases)
    got = tq.collect_scales_uint8(_torch_model(path), canvases)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


# (kernel, stride, padding as lax takes it, cin, cout, h, w, with bias)
CONV_CASES = {
    "1x1_s1": (1, 1, ((0, 0), (0, 0)), 32, 64, 9, 14, False),
    "1x1_s2": (1, 2, ((0, 0), (0, 0)), 32, 64, 9, 14, False),
    "3x3_p1": (3, 1, ((1, 1), (1, 1)), 32, 48, 8, 13, True),
    "3x3_s2_same_even": (3, 2, "SAME", 64, 32, 8, 14, True),
    "3x3_s2_same_odd": (3, 2, "SAME", 64, 32, 7, 13, True),
    "stem_7x7_s2_p3_cin3": (7, 2, ((3, 3), (3, 3)), 3, 64, 20, 34, False),
    "out_cout36": (3, 1, ((1, 1), (1, 1)), 32, 36, 6, 10, True),
    "out_cout96": (3, 1, ((1, 1), (1, 1)), 32, 96, 6, 10, True),
    "out_cout144": (3, 1, ((1, 1), (1, 1)), 32, 144, 6, 10, True),
}


def _jax_padding(pad, k, s, h, w):
    if pad == "SAME":
        return same_padding(h, w, k, s)
    return pad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_one_conv_bitwise_equal_to_jax(case, dtype):
    """One conv site: the port's int8 operands, accumulators and
    dequantized (+ bias) output equal the JAX package's bit for bit; in
    bf16 the weight scales come from the bf16 kernel, as in JAX."""
    k, s, pad, cin, cout, h, w, with_bias = CONV_CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    x = rng.normal(0, 2.0, (2, h, w, cin)).astype(np.float32)
    kernel = rng.normal(0, 0.1, (k, k, cin, cout)).astype(np.float32)
    bias = rng.normal(0, 0.5, cout).astype(np.float32)
    s_x = np.float32(np.abs(x).max() / 127.0 * 0.9)  # some clamp at 127
    jdt = jnp.dtype(dtype)
    xj, kj, bj = (jnp.asarray(a).astype(jdt) for a in (x, kernel, bias))
    dn = ("NHWC", "HWIO", "NHWC")

    def conv(xx, kk):
        y = lax.conv_general_dilated(xx, kk, (s, s), pad,
                                     dimension_numbers=dn)
        return y + bj if with_bias else y

    want = np.asarray(jq.quantize_apply(conv, [s_x])(xj, kj), np.float32)
    # JAX's operands and accumulator, as its conv callback makes them
    x8j = jnp.clip(jnp.round(xj.astype(jnp.float32) / float(s_x)), -127,
                   127).astype(jnp.int8)
    s_wj = jnp.maximum(jnp.max(jnp.abs(kj.astype(jnp.float32)),
                               axis=(0, 1, 2)), 1e-8) / 127.0
    w8j = jnp.clip(jnp.round(kj.astype(jnp.float32) / s_wj), -127,
                   127).astype(jnp.int8)
    accj = lax.conv_general_dilated(x8j, w8j, (s, s), pad,
                                    dimension_numbers=dn,
                                    preferred_element_type=jnp.int32)

    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(tdt)
    xt = xt.permute(0, 3, 1, 2)
    wt = torch.from_numpy(np.asarray(kj.astype(jnp.float32))).to(tdt)
    wt = wt.permute(3, 2, 0, 1)
    bt = torch.from_numpy(bias).to(tdt) if with_bias else None
    padding = _jax_padding(pad, k, s, h, w)
    x8 = int8_conv_cuda.quantize(xt, float(s_x))
    w8, s_w = int8_conv.quantize_weight(wt)
    np.testing.assert_array_equal(x8.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(x8j))
    np.testing.assert_array_equal(w8.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(w8j))
    np.testing.assert_array_equal(s_w.numpy(), np.asarray(s_wj))
    acc = int8_conv_cuda.conv2d_accumulate(x8, w8, s, padding)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(accj))
    got = int8_conv_cuda.conv2d(x8, w8, float(s_x), s_w, bt, s, padding, tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(
        got.float().permute(0, 2, 3, 1).numpy(), want)


def _forward_gap(got, want, ref):
    out = {}
    for key in want:
        w = np.asarray(want[key], np.float32)
        g = got[key].float().numpy()
        r = np.asarray(ref[key], np.float32)
        scale = max(float(np.abs(r).max()), 1e-6)
        out[key] = (float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-6)),
                    float(np.abs(g - r).max() / scale),
                    float(np.abs(w - r).max() / scale))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_forward_matches_jax(weights, dtype):
    """quantize_apply forward of the port on JAX's scales against JAX's
    (see the module docstring for the tolerances)."""
    variables, path = weights
    jmodel = _jax_model(jnp.dtype(dtype))
    ims = _images()
    scales = jq.collect_scales(_jax_fn(jmodel),
                               [(variables, jnp.asarray(im)) for im in ims])
    image = jnp.asarray(ims[0])
    want = jq.quantize_apply(_jax_fn(jmodel), scales)(variables, image)
    ref = jmodel.apply(variables, image)
    model = _torch_model(path, getattr(torch, dtype))
    with torch.inference_mode():
        got = tq.quantize_apply(model, scales)(_nchw(ims[0]))
    for key, (gap, port_err, jax_err) in _forward_gap(got, want,
                                                      ref).items():
        assert gap < 1e-6, (key, gap)
        assert max(port_err, jax_err) < JAX_INT8_BOUND, (key, port_err)


def test_quantized_fused_towers_match_jax(weights):
    """int8 composes with fused towers: the fused forward (75 sites here,
    111 at full width) against JAX's fused int8 forward, op by op, on
    JAX's fused scales, which the port's calibration also gives."""
    variables, path = weights
    jmodel = _jax_model(fuse=True)
    fused_vars = jax_fuse(variables)
    ims = _images()
    scales = jq.collect_scales(_jax_fn(jmodel),
                               [(fused_vars, jnp.asarray(im)) for im in ims])
    assert scales.shape == (75,)
    image = jnp.asarray(ims[0])
    want = jq.quantize_apply(_jax_fn(jmodel), scales)(fused_vars, image)
    ref = jmodel.apply(fused_vars, image)
    model = _torch_model(path, fuse=True)
    np.testing.assert_allclose(
        tq.collect_scales(model, [_nchw(im) for im in ims]), scales,
        rtol=1e-5)
    with torch.inference_mode():
        got = tq.quantize_apply(model, scales)(_nchw(ims[0]))
    for key, (gap, port_err, jax_err) in _forward_gap(got, want,
                                                      ref).items():
        assert gap < 1e-6, (key, gap)
        assert max(port_err, jax_err) < JAX_INT8_BOUND, (key, port_err)


def _detect_inputs(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (2, *CANVAS, 3)).astype(np.uint8)
    P_inv = np.tile(P_INV[None], (2, 1, 1)).astype(np.float32)
    planes = np.stack([rng.uniform(-0.05, 0.05, 10), np.ones(10),
                       rng.uniform(-0.05, 0.05, 10),
                       rng.uniform(-2.2, -1.2, 10)], axis=1)
    planes = np.tile(planes[None], (2, 1, 1)).astype(np.float32)
    return images, P_inv, planes


def test_int8_detect_matches_jax(weights):
    """make_detect_fn(quant_scales=JAX's scales) against JAX's int8 detect
    fn: equal detection counts and labels, scores within 5e-3."""
    variables, path = weights
    jmodel = _jax_model()
    images, P_inv, planes = _detect_inputs()
    scales = jq.collect_scales_uint8(jmodel, variables, list(images))
    kw = dict(with_pose=True, device_preprocess=True, quant_scales=scales)
    want = jax_detect_fn(jmodel, CANVAS, **kw)(
        variables, jnp.asarray(images), jnp.asarray(P_inv),
        jnp.asarray(planes))
    got = inference.make_detect_fn(_torch_model(path), CANVAS, **kw)(
        images, P_inv, planes)
    w_scores = np.asarray(want.scores)
    g_scores = got.scores.numpy()
    assert ((g_scores > -1).sum(1) == (w_scores > -1).sum(1)).all()
    assert (w_scores > 0).sum() > 10
    np.testing.assert_allclose(g_scores, w_scores, atol=5e-3, rtol=0)
    keep = w_scores > -1
    np.testing.assert_array_equal(got.labels.numpy()[keep],
                                  np.asarray(want.labels)[keep])


def test_detector_quantize_api(weights, tmp_path):
    """GPPDetector.quantize calibrates (JAX's scales) and drops the cached
    detect fns; assigning None drops them again and gives back the float
    outputs; a new load keeps the scales and re-quantizes the weights."""
    from ground_plane_polling_tpu.inference import GPPDetector as JaxDetector

    variables, path = weights
    det = inference.GPPDetector(device="cpu", score_threshold=1e-4)
    det.model = _torch_model(path)
    det.ready = True
    jdet = JaxDetector(score_threshold=1e-4)
    jdet.model = _jax_model()
    jdet.variables = variables
    images, P_inv, planes = _detect_inputs(1)
    calib = [im[None].astype(np.float32) - np.array(
        [103.939, 116.779, 123.68], np.float32) for im in images]

    out_f = det(images, P_inv, planes)
    assert det._fns
    scales = det.quantize(calib)
    assert det._fns == {}
    np.testing.assert_allclose(scales, jdet.quantize(calib), rtol=1e-5)
    out_q = det(images, P_inv, planes)
    assert out_q.scores.shape == out_f.scores.shape
    assert len(scales) == tq.count_convs(det.model, _nchw(calib[0]))

    other = randomized_variables(_jax_model(), seed=3)
    other_path = str(tmp_path / "other.npz")
    export_params(other_path, other)
    conv, qm = det.model.backbone.conv1, tq.quantize_apply(det.model, scales)
    w8_before = qm.int8_weight(conv)[0]
    det.load(other_path)
    assert det.quant_scales is scales
    out_q2 = det(images, P_inv, planes)
    assert not torch.equal(qm.int8_weight(conv)[0], w8_before)
    fresh = inference.make_detect_fn(
        load_weights(_torch_model(path), other_path), CANVAS,
        score_threshold=1e-4, device_preprocess=True,
        quant_scales=scales)(images, P_inv, planes)
    np.testing.assert_array_equal(out_q2.scores.numpy(),
                                  fresh.scores.numpy())

    det.load(path)
    det.quant_scales = None
    assert det._fns == {}
    np.testing.assert_array_equal(det(images, P_inv, planes).scores.numpy(),
                                  out_f.scores.numpy())


def test_intercept_restores_the_float_forward(weights):
    """After a quantized call, and after one that raised, every conv runs
    its float forward again: the model gives its float outputs."""
    _, path = weights
    model = _torch_model(path)
    x = _nchw(_images(1)[0])
    with torch.inference_mode():
        ref = model(x)
        n = tq.count_convs(model, x)
        tq.quantize_apply(model, np.full(n, 0.05, np.float32))(x)
        with pytest.raises(ValueError, match="conv sites"):
            tq.quantize_apply(model, np.full(n - 1, 0.05, np.float32))(x)
        with pytest.raises(ValueError, match="conv sites"):
            tq.quantize_apply(model, np.full(n + 1, 0.05, np.float32))(x)
        again = model(x)
    assert not any("forward" in m.__dict__ for m in model.modules())
    for key in ref:
        assert torch.equal(ref[key], again[key]), key


@pytest.mark.parametrize("n,q", [(1, 99.9), (2, 50.0), (1001, 99.9),
                                 (4099, 0.0), (4099, 100.0), (65537, 37.5)])
def test_percentile_matches_numpy(n, q):
    values = np.random.RandomState(n).lognormal(0, 2, n).astype(np.float32)
    got = float(tq.percentile_of(torch.from_numpy(values), q))
    np.testing.assert_allclose(got, np.percentile(values, q), rtol=1e-6)


def test_percentile_above_torch_quantile_limit():
    """More than 2^24 values, where torch.quantile refuses: numpy's value
    within the gap of the order statistics around its rank (the port's
    float32 rank, as jnp.percentile's, may land one order statistic off
    numpy's float64 rank at this size)."""
    n = 2**24 + 1001
    values = np.random.RandomState(7).uniform(0, 1, n).astype(np.float32)
    with pytest.raises(RuntimeError):
        torch.quantile(torch.from_numpy(values), 0.999)
    got = float(tq.percentile_of(torch.from_numpy(values), 99.9))
    want = np.percentile(values, 99.9)
    rank = int(0.999 * (n - 1))
    around = np.partition(values, (rank - 1, rank + 2))[[rank - 1, rank + 2]]
    assert around[0] <= got <= around[1]
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("bad", ["x_float64", "x_int8_3d", "w_nchw_memory",
                                 "channels_differ", "s_w_float64",
                                 "bias_dtype", "cpu_tensors"])
def test_kernel_launch_checks_inputs_before_building(bad):
    """The kernels' launch paths refuse what the kernels do not take before
    they build or launch anything (here, on CPU tensors, the last check
    refuses the CPU itself)."""
    x8 = torch.zeros(1, 4, 4, 32, dtype=torch.int8).permute(0, 3, 1, 2)
    w8 = torch.zeros(8, 3, 3, 32, dtype=torch.int8).permute(0, 3, 1, 2)
    s_w, bias = torch.ones(8), torch.zeros(8)
    pad = ((1, 1), (1, 1))
    before = (int8_conv_cuda.QUANTIZE_LAUNCHES, int8_conv_cuda.CONV_LAUNCHES)
    args = [x8, w8, 0.1, s_w, bias, 1, pad, torch.float32]
    match = {"x_float64": "quantize takes", "x_int8_3d": "quantize takes",
             "w_nchw_memory": "channels-last", "channels_differ": "takes int8",
             "s_w_float64": "s_w", "bias_dtype": "bias",
             "cpu_tensors": "CUDA device"}[bad]
    with pytest.raises(ValueError, match=match):
        if bad == "x_float64":
            int8_conv_cuda._quantize(torch.zeros(1, 2, 3, 4).double(), 0.1)
        elif bad == "x_int8_3d":
            int8_conv_cuda._quantize(torch.zeros(2, 3, 4), 0.1)
        else:
            if bad == "w_nchw_memory":
                args[1] = w8.contiguous()
            elif bad == "channels_differ":
                args[1] = w8[:, :16]
            elif bad == "s_w_float64":
                args[3] = s_w.double()
            elif bad == "bias_dtype":
                args[4] = bias.bfloat16()
            int8_conv_cuda._launch(*args)
    assert (int8_conv_cuda.QUANTIZE_LAUNCHES,
            int8_conv_cuda.CONV_LAUNCHES) == before


def test_plain_int8_conv_is_exact_at_the_largest_sum():
    """K = 3 * 3 * 512 of +-127 x +-127 sums to 74,321,928 > 2^24: the
    float64 accumulation is exact where float32 would round."""
    x8 = torch.full((1, 512, 3, 3), 127, dtype=torch.int8)
    w8 = torch.full((2, 512, 3, 3), 127, dtype=torch.int8)
    w8[1] = -127
    x8[0, 0, 0, 0] = 126
    acc = int8_conv.conv2d_int8(x8, w8, 1, ((0, 0), (0, 0)))
    want = 127 * 127 * 4608 - 127
    assert acc.flatten().tolist() == [want, -want]
