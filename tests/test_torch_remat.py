"""--remat in the port (models/resnet.py): each bottleneck block is
recomputed on the backward pass (torch.utils.checkpoint), which changes no
number. Held against the port without remat (float32 and bf16 autocast,
bit for bit) and against the JAX package's remat=True model (nn.remat), at
the shrunk size and tolerances of test_torch_train_step.py: loss terms
rtol 1e-4, each gradient tensor within 1e-3 of its norm."""

import functools

import jax
import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.models import build_detector as jax_build
from ground_plane_polling_tpu.models.resnet import ResNetBackbone as JaxResNet
from ground_plane_polling_tpu.models.retinanet import (
    GPPRetinaNet as JaxRetinaNet)
from ground_plane_polling_tpu.training.checkpoint import export_params
from ground_plane_polling_tpu.training.train import (
    compute_losses as jax_compute_losses)
from ground_plane_polling_tpu_torch.models import build_detector, load_weights
from ground_plane_polling_tpu_torch.training.train import compute_losses

from .test_torch_model import (FEATURES, SHRUNK, randomized_variables,
                               shrunk_jax_model, shrunk_torch_model)
from .test_torch_train_step import (SHAPE, TERMS, _batch_t, _flatten,
                                    _prepared_batch, _to_torch_name)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    variables = randomized_variables(shrunk_jax_model(), image_shape=SHAPE)
    path = str(tmp_path_factory.mktemp("remat") / "shrunk.npz")
    export_params(path, variables)
    return variables, path, _prepared_batch()


def _grads(path, batch, remat, bf16=False):
    model = load_weights(shrunk_torch_model(remat=remat), path)
    calls = []
    # a pre-hook: the recompute stops once it has what backward needs
    model.backbone.stage1_block1.register_forward_pre_hook(
        lambda *_: calls.append(1))
    total, terms = compute_losses(model, _batch_t(batch), bf16=bf16)
    total.backward()
    return ({k: float(v) for k, v in terms.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()},
            len(calls))


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_remat_gradients_equal_without_remat(weights, bf16):
    """The same terms and gradients, bit for bit; with remat the block's
    forward runs again in the backward pass."""
    _, path, batch = weights
    terms, grads, calls = _grads(path, batch, remat=False, bf16=bf16)
    r_terms, r_grads, r_calls = _grads(path, batch, remat=True, bf16=bf16)
    assert (calls, r_calls) == (1, 2)
    assert r_terms == terms
    for name, g in grads.items():
        assert torch.equal(r_grads[name], g), name


def test_remat_gradients_match_jax_remat(weights):
    """JAX's ResNet with remat=True (nn.remat on each block) against the
    port's with remat: loss terms and gradients of one float32 step."""
    variables, path, batch = weights
    model = JaxRetinaNet(backbone_fn=functools.partial(
        JaxResNet, stage_sizes=SHRUNK, remat=True, name="backbone"),
        feature_size=FEATURES)
    grads, want = jax.jit(jax.grad(
        lambda p: jax_compute_losses(model, p, variables["frozen"], batch),
        has_aux=True))(variables["params"])
    terms, got, _ = _grads(path, batch, remat=True)
    for k in TERMS:
        assert terms[k] == pytest.approx(float(want[k]), rel=1e-4), k
    for p, g in _flatten(grads).items():
        name, g = _to_torch_name(p, g)
        norm = float(np.linalg.norm(g))
        np.testing.assert_allclose(got[name].numpy(), g, rtol=0,
                                   atol=1e-3 * norm + 1e-30, err_msg=name)


def test_remat_changes_no_inference_output(weights):
    """Without gradients nothing is recomputed: the outputs of a remat
    model equal the plain model's."""
    _, path, batch = weights
    x = torch.from_numpy(batch["image"]).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = load_weights(shrunk_torch_model(), path)(x)
        got = load_weights(shrunk_torch_model(remat=True), path)(x)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_remat_outside_the_resnet_family_raises():
    """The JAX package's error, word for word."""
    with pytest.raises(ValueError) as jax_err:
        jax_build("vgg16", remat=True)
    with pytest.raises(ValueError) as err:
        build_detector("vgg16", remat=True)
    assert str(err.value) == str(jax_err.value) == \
        "remat is implemented for the resnet family"
    assert build_detector("resnet50", remat=True).backbone.remat
