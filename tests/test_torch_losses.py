"""The port's losses (training/losses.py) against the JAX package's on the
same seeded numpy inputs: values within rtol 1e-6, gradients with respect
to the predictions against jax.grad within rtol 1e-5 (float32 sums taken in
another order). The focal loss is also held where probabilities lie exactly
on the clip bounds 1e-7 and 1 - 1e-7, where jnp.clip's gradient is 0.5 (and
torch.clamp's would be 1.0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.training import losses as jax_losses
from ground_plane_polling_tpu_torch.training import losses

torch.set_num_threads(2)

LO = np.float32(1e-7)
HI = np.float32(1 - 1e-7)


def _labels(rng, b, n, c, positives=True):
    """(B, N, 8C) labels: rows of -1 (ignored), 0 (negative) and one-hot
    positives, some split 0.5 / 0.5 across the sign halves."""
    labels = np.zeros((b, n, 8 * c), np.float32)
    kind = rng.randint(0, 4 if positives else 2, (b, n))
    labels[kind == 1] = -1.0
    for bi, ni in zip(*np.nonzero(kind >= 2)):
        slot = rng.randint(4 * c)
        if kind[bi, ni] == 2:
            labels[bi, ni, slot + 4 * c * rng.randint(2)] = 1.0
        else:
            labels[bi, ni, slot] = labels[bi, ni, slot + 4 * c] = 0.5
    return labels


def _probs(rng, shape, edges=False):
    p = rng.uniform(0, 1, shape).astype(np.float32)
    if edges:  # exactly on the clip bounds, and beyond them
        flat = p.reshape(-1)
        k = flat.size // 8
        flat[:k] = LO
        flat[k:2 * k] = HI
        flat[2 * k:3 * k] = 0.0
        flat[3 * k:4 * k] = 1.0
    return p


def _value_and_grad_jax(fn, *args):
    value, grad = jax.value_and_grad(fn, argnums=len(args) - 1)(*args)
    return float(value), np.asarray(grad)


def _value_and_grad_port(fn, *args):
    t = [torch.from_numpy(a) for a in args]
    t[-1].requires_grad_(True)
    value = fn(*t)
    value.backward()
    return float(value.detach()), t[-1].grad.numpy()


def _assert_match(got, want):
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5,
                               atol=1e-5 * float(np.abs(want[1]).max()))


@pytest.mark.parametrize("c,edges", [(1, False), (2, False), (1, True)],
                         ids=["c1", "c2", "clip_bounds"])
def test_focal_matches_jax(c, edges):
    rng = np.random.RandomState(c + 10 * edges)
    labels = _labels(rng, 2, 300, c)
    probs = _probs(rng, labels.shape, edges)
    want = _value_and_grad_jax(jax_losses.focal, labels, probs)
    got = _value_and_grad_port(losses.focal, labels, probs)
    _assert_match(got, want)
    if edges:  # JAX's clip gradient, 0.5 exactly on a bound
        p = torch.tensor([LO, HI, 0.5], requires_grad=True)
        losses._clip(p, 1e-7, 1 - 1e-7).sum().backward()
        assert p.grad.tolist() == [0.5, 0.5, 1.0]
        jgrad = jax.grad(lambda x: jnp.clip(x, 1e-7, 1 - 1e-7).sum())(
            np.array([LO, HI, 0.5], np.float32))
        assert np.asarray(jgrad).tolist() == [0.5, 0.5, 1.0]


def test_focal_no_positives_normalizer_one():
    rng = np.random.RandomState(3)
    labels = _labels(rng, 2, 100, 1, positives=False)
    assert not (labels == 1).any()
    probs = _probs(rng, labels.shape)
    want = _value_and_grad_jax(jax_losses.focal, labels, probs)
    got = _value_and_grad_port(losses.focal, labels, probs)
    _assert_match(got, want)
    # the sum itself: the normalizer is 1, not 0
    assert got[0] > 0


def _regression(rng, b, n, cols, state_col):
    y = rng.normal(0, 0.5, (b, n, cols + 1)).astype(np.float32)
    y[..., state_col] = rng.choice([-1.0, 0.0, 1.0], (b, n))
    return y


@pytest.mark.parametrize("masked", [False, True], ids=["mixed", "no_rows"])
def test_smooth_l1_matches_jax(masked):
    rng = np.random.RandomState(4)
    y_true = _regression(rng, 2, 200, 12, 12)
    if masked:
        y_true[..., 12] = 0.0
    # predictions on both sides of |x| = 1 / sigma^2
    y_pred = (y_true[..., :12]
              + rng.normal(0, 0.3, (2, 200, 12))).astype(np.float32)
    want = _value_and_grad_jax(jax_losses.smooth_l1, y_true, y_pred)
    got = _value_and_grad_port(losses.smooth_l1, y_true, y_pred)
    _assert_match(got, want)
    if masked:
        assert got[0] == 0.0


@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("height_only", [False, True],
                         ids=["all_dims", "compat_height_only"])
def test_smooth_l1_dim_matches_jax(c, height_only):
    rng = np.random.RandomState(5 + c)
    n = 150
    y_true = _regression(rng, 2, n * c, 3, 3)
    y_pred = rng.normal(0, 0.5, (2, n, 3 * c)).astype(np.float32)

    def jax_fn(t, p):
        return jax_losses.smooth_l1_dim(t, p, compat_height_only=height_only)

    def port_fn(t, p):
        return losses.smooth_l1_dim(t, p, compat_height_only=height_only)

    _assert_match(_value_and_grad_port(port_fn, y_true, y_pred),
                  _value_and_grad_jax(jax_fn, y_true, y_pred))
    if height_only:
        g = _value_and_grad_port(port_fn, y_true, y_pred)[1]
        assert not g.reshape(2, -1, 3)[..., 1:].any()
