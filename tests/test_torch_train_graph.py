"""The parts of the captured train step (training/train.py,
CapturedTrainStep) that run on the CPU, where the step itself is eager:
three steps against JAX's jitted step with an lr change between them, the
lr tensor written in place, restore_checkpoint writing the live tensors in
place, `step.eager is step`, and the autocast cache, which capture needs
off. The shrunk detector of tests/test_torch_train_step.py (one block per
ResNet stage, FPN 64), float32 on a 64x64 canvas, weights carried across
by the .npz export.

Tolerances (those of tests/test_torch_train_step.py):
  * loss terms: rtol 1e-4, at each of the three steps and after the last
    (a fourth forward, which reads the third step's lr). Adam moves a
    weight whose gradient sits near eps by its float32 rounding, so the
    two trajectories part a little with each step: at lr 1e-3 the third
    step's loss was 1.07e-4 of itself apart from JAX's, at lr 1e-4 the
    terms after three steps were at most 4.2e-5 apart. So the steps run at
    lr 1e-4, then 2.5e-5, which moves the loss after the third step by
    about a tenth against keeping 1e-4;
  * the port against itself (a restored state, the dispatch of a CPU
    state): bit for bit.
"""

import jax.numpy as jnp
import pytest
import torch

from ground_plane_polling_tpu.training.checkpoint import export_params
from ground_plane_polling_tpu.training.train import (
    compute_losses as jax_compute_losses,
    create_train_state as jax_create_train_state,
    make_optimizer as jax_optimizer, make_train_step as jax_make_train_step)
from ground_plane_polling_tpu_torch.models import load_weights
from ground_plane_polling_tpu_torch.parallel import data_parallel_mesh
from ground_plane_polling_tpu_torch.training import checkpoint
from ground_plane_polling_tpu_torch.training import train as port_train
from ground_plane_polling_tpu_torch.training.train import (
    CapturedTrainStep, TrainState, compute_losses, create_train_state,
    make_fused_train_step, make_optimizer, make_train_step)

from .test_torch_model import (randomized_variables, shrunk_jax_model,
                               shrunk_torch_model)
from .test_torch_train_step import SHAPE, TERMS, _batch_t, _prepared_batch

torch.set_num_threads(2)

LR, LR_STEP3 = 1e-4, 2.5e-5  # the lr of steps 1-2, then of step 3


@pytest.fixture(scope="module")
def shrunk(tmp_path_factory):
    """The shrunk JAX detector's variables, their .npz export and a
    prepared batch (numpy)."""
    model = shrunk_jax_model()
    variables = randomized_variables(model, image_shape=SHAPE)
    path = str(tmp_path_factory.mktemp("w") / "shrunk.npz")
    export_params(path, variables)
    return {"model": model, "variables": variables, "path": path,
            "batch": _prepared_batch()}


def _state(path, lr=LR):
    model = load_weights(shrunk_torch_model(), path)
    return create_train_state(model, make_optimizer(model, lr))


def test_three_steps_with_an_lr_change_match_jax(shrunk):
    """Three steps of the port's step and of JAX's jitted make_train_step
    from the same weights on the same batch, the lr lowered between steps
    2 and 3 on both sides (JAX's is a traced scalar of the state, the
    port's a tensor written in place): the loss terms of each step and of
    the weights after the last."""
    tx = jax_optimizer()
    jax_state = jax_create_train_state(shrunk["variables"], tx,
                                       learning_rate=LR)
    jax_step = jax_make_train_step(shrunk["model"], tx)
    state, step = _state(shrunk["path"]), make_train_step()
    lr_tensor = state.optimizer.param_groups[0]["lr"]
    batch = _batch_t(shrunk["batch"])
    for i in range(3):
        if i == 2:
            jax_state = jax_state._replace(
                lr=jnp.asarray(LR_STEP3, jnp.float32))
            state.lr = LR_STEP3
        jax_state, want = jax_step(jax_state, shrunk["batch"])
        state, got = step(state, batch)
        for k in TERMS:
            assert float(got[k]) == pytest.approx(float(want[k]),
                                                  rel=1e-4), (i, k)
    assert state.step == int(jax_state.step) == 3
    assert state.optimizer.param_groups[0]["lr"] is lr_tensor
    assert float(lr_tensor) == LR_STEP3
    _, want = jax_compute_losses(shrunk["model"], jax_state.params,
                                 jax_state.frozen, shrunk["batch"])
    with torch.no_grad():
        _, got = compute_losses(state.model, batch)
    for k in TERMS:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-4), k


def test_lr_setter_writes_the_tensor_in_place(shrunk):
    """The lr is a tensor in the param groups; setting it fills that
    tensor (the one a captured graph reads) and never replaces it.
    Reading it returns the host's copy and does not read the tensor, which
    on a card would wait for it."""
    state = _state(shrunk["path"])
    lr = state.optimizer.param_groups[0]["lr"]
    assert torch.is_tensor(lr) and lr.dtype == torch.float64
    assert not state.optimizer.param_groups[0]["capturable"]
    state.lr = 3e-4
    assert state.optimizer.param_groups[0]["lr"] is lr
    assert float(lr) == 3e-4 and state.lr == 3e-4
    lr.fill_(7.0)  # behind the state's back: the getter does not read it
    assert state.lr == 3e-4


def _moments(state):
    return {(id(p), k): t for p, s in state.optimizer.state.items()
            for k, t in s.items()}


def _assert_params_equal(a, b):
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n


def test_restore_keeps_the_live_tensors(shrunk, tmp_path):
    """restore_checkpoint into a state that has stepped writes its
    moments, step counts and lr tensor in place (the same objects after),
    with the checkpoint's values: the next step equals the next step of
    the state that was saved."""
    batch, step = _batch_t(shrunk["batch"]), make_train_step()
    saved = _state(shrunk["path"])
    for _ in range(2):
        saved, _ = step(saved, batch)
    saved.lr = 4e-4
    path = checkpoint.save_checkpoint(str(tmp_path / "ckpt"), saved)

    state = _state(shrunk["path"], lr=1e-2)
    state, _ = step(state, batch)
    live, lr = _moments(state), state.optimizer.param_groups[0]["lr"]
    container = state.optimizer.state
    state = checkpoint.restore_checkpoint(path, state)
    assert state.optimizer.state is container
    assert state.optimizer.param_groups[0]["lr"] is lr
    assert float(lr) == state.lr == 4e-4 and state.step == 2
    now = _moments(state)
    assert now.keys() == live.keys() and len(now) == len(_moments(saved))
    assert all(now[k] is live[k] for k in live)
    by_name = {id(p): n for n, p in state.model.named_parameters()}
    saved_params = dict(saved.model.named_parameters())
    for p, s in state.optimizer.state.items():
        for k, t in s.items():
            other = saved.optimizer.state[saved_params[by_name[id(p)]]][k]
            assert torch.equal(t, other), (by_name[id(p)], k)
    state, m_state = step(state, batch)
    saved, m_saved = step(saved, batch)
    assert all(torch.equal(m_state[k], m_saved[k]) for k in TERMS)
    _assert_params_equal(state, saved)


def test_restore_of_an_old_checkpoint(shrunk, tmp_path):
    """A checkpoint of an optimizer with a float lr and CPU step counts
    (what the port wrote before its lr became a tensor) loads into the
    live tensors; one saved before any step zeroes the live moments, so
    the next step is a first step."""
    batch, step = _batch_t(shrunk["batch"]), make_train_step()
    model = load_weights(shrunk_torch_model(), shrunk["path"])
    old = TrainState(model, torch.optim.Adam(
        model.parameters(), lr=5e-4, betas=(0.9, 0.999), eps=1e-8))
    old, _ = step(old, batch)
    assert isinstance(old.optimizer.param_groups[0]["lr"], float)
    path = checkpoint.save_checkpoint(str(tmp_path / "old"), old)

    state = _state(shrunk["path"])
    state, _ = step(state, batch)
    live, lr = _moments(state), state.optimizer.param_groups[0]["lr"]
    state = checkpoint.restore_checkpoint(path, state)
    assert state.optimizer.param_groups[0]["lr"] is lr
    assert lr.dtype == torch.float64 and float(lr) == 5e-4
    assert all(_moments(state)[k] is t for k, t in live.items())
    state, m_state = step(state, batch)
    old, m_old = step(old, batch)
    assert all(torch.equal(m_state[k], m_old[k]) for k in TERMS)
    _assert_params_equal(state, old)

    fresh = _state(shrunk["path"])
    path = checkpoint.save_checkpoint(str(tmp_path / "fresh"), fresh)
    state = checkpoint.restore_checkpoint(path, state)
    assert state.step == 0
    assert all(_moments(state)[k] is t for k, t in live.items())
    assert all(not t.any() for t in live.values())
    state, m_state = step(state, batch)
    fresh, m_fresh = step(fresh, batch)
    assert all(torch.equal(m_state[k], m_fresh[k]) for k in TERMS)
    _assert_params_equal(state, fresh)


def test_cpu_step_is_its_own_eager_step():
    """Without a card, and with a mesh, the step is eager: step.eager is
    step."""
    mesh = data_parallel_mesh(device="cpu")
    steps = [make_train_step(), make_train_step(mesh=mesh),
             make_fused_train_step(num_classes=1),
             make_fused_train_step(num_classes=1, mesh=mesh)]
    for step in steps:
        assert not isinstance(step, CapturedTrainStep)
        assert step.eager is step


def test_captured_step_takes_a_cpu_state_to_the_eager_step(shrunk,
                                                           monkeypatch):
    """On a machine with a card the step is a CapturedTrainStep; a state
    whose parameters lie on the CPU goes to its eager step, bit for bit,
    and captures nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    step = make_train_step()
    monkeypatch.undo()
    assert isinstance(step, CapturedTrainStep)
    batch = _batch_t(shrunk["batch"])
    a, b = _state(shrunk["path"]), _state(shrunk["path"])
    a, m_a = step(a, batch)
    b, m_b = step.eager(b, batch)
    assert not step.graphs and a.step == b.step == 1
    assert all(torch.equal(m_a[k], m_b[k]) for k in TERMS)
    _assert_params_equal(a, b)


def test_autocast_without_its_cache_changes_no_loss_term(shrunk,
                                                         monkeypatch):
    """compute_losses runs autocast with its cast cache off (capture needs
    it off); with the cache on, every bf16 loss term is the same."""
    model = load_weights(shrunk_torch_model(), shrunk["path"])
    batch = _batch_t(shrunk["batch"])
    real, seen = torch.autocast, []

    def autocast(*args, cache_enabled=None, **kw):
        seen.append(cache_enabled)
        return real(*args, cache_enabled=cache, **kw)

    monkeypatch.setattr(port_train.torch, "autocast", autocast)
    terms = {}
    for cache in (False, True):
        _, terms[cache] = compute_losses(model, batch, bf16=True)
    assert seen[0] is False
    for k in TERMS:
        assert torch.equal(terms[False][k], terms[True][k]), k
