"""The port's train step (training/train.py) against the JAX package's, at a
small size: a shrunk ResNet (one block per stage) with a 64-channel FPN, in
float32 on a 64x64 canvas, weights carried across by the .npz export.

Tolerances:
  * loss terms: rtol 1e-4 (float32 convolutions summed in another order);
  * post-clip gradients: each tensor's largest difference within 1e-3 of
    that tensor's norm;
  * Adam fed the same gradients: updates within atol 1e-7 (at lr 1e-3
    Adam moves each weight by about 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ground_plane_polling_tpu.training.checkpoint import export_params
from ground_plane_polling_tpu.training.train import (
    clip_per_tensor_norm as jax_clip, compute_losses as jax_compute_losses,
    make_optimizer as jax_optimizer)
from ground_plane_polling_tpu_torch.data.kitti import KittiDataset
from ground_plane_polling_tpu_torch.data.pipeline import (KittiLoader,
                                                          prepare_batch)
from ground_plane_polling_tpu_torch.models import load_weights
from ground_plane_polling_tpu_torch.training.train import (
    clip_per_tensor_norm, compute_losses, create_train_state,
    make_fused_train_step, make_optimizer, make_train_step)

from .fixtures import make_synthetic_kitti
from .test_torch_model import (randomized_variables, shrunk_jax_model,
                               shrunk_torch_model)
from .test_torch_targets import _annotations, _ignores

torch.set_num_threads(2)

SHAPE = (64, 64)
TERMS = ("loss", "regression", "regression_dim", "classification")


def _prepared_batch(seed=0, b=2):
    """A prepared batch (numpy) from random annotations, no augmentation."""
    rng = np.random.RandomState(seed)
    anns, ams = zip(*(_annotations(rng, 3, 5, shape=SHAPE)
                      for _ in range(b)))
    igs, ims = zip(*(_ignores(rng, 1, 2, shape=SHAPE) for _ in range(b)))
    raw = {"images": rng.randint(0, 256, (b, *SHAPE, 3)).astype(np.uint8),
           "annotations": np.stack(anns), "ann_mask": np.stack(ams),
           "ignores": np.stack(igs), "ignore_mask": np.stack(ims),
           "valid": np.ones(b, bool),
           "sizes": np.tile(np.asarray(SHAPE, np.float32), (b, 1))}
    out = prepare_batch({k: torch.from_numpy(v) for k, v in raw.items()},
                        num_classes=1, augment=False, device="cpu")
    return {k: v.numpy() for k, v in out.items()}


def _flatten(tree, prefix=""):
    out = {}
    for key, node in tree.items():
        if isinstance(node, dict):
            out.update(_flatten(node, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(node)
    return out


def _to_torch_name(path, value):
    """params path -> (state-dict name, value in the port's layout)."""
    parts = path.split("/")
    name = ".".join(parts[:-1])
    if parts[-1] == "kernel":
        return name + ".weight", value.transpose(3, 2, 0, 1)
    return name + ".bias", value


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Shrunk JAX detector, its export, a batch, and three JAX steps of
    (raw gradients, loss terms) with the Adam updates of each."""
    model = shrunk_jax_model()
    variables = randomized_variables(model, image_shape=SHAPE)
    path = str(tmp_path_factory.mktemp("w") / "shrunk.npz")
    export_params(path, variables)
    batch = _prepared_batch()

    grad_fn = jax.jit(jax.grad(
        lambda p: jax_compute_losses(model, p, variables["frozen"], batch),
        has_aux=True))
    lr = 1e-3
    tx = jax_optimizer()

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        updates = jax.tree_util.tree_map(lambda u: -lr * u, updates)
        clipped, _ = jax_clip(1e-3).update(grads, None)
        return updates, opt_state, optax.apply_updates(params, updates), \
            clipped

    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    opt_state = jax.jit(tx.init)(params)
    steps = []
    for _ in range(3):
        grads, terms = grad_fn(params)
        updates, opt_state, params, clipped = update(grads, opt_state,
                                                     params)
        steps.append({"grads": _flatten(grads), "clipped": _flatten(clipped),
                      "terms": {k: float(v) for k, v in terms.items()},
                      "updates": _flatten(updates)})
    return {"path": path, "batch": batch, "steps": steps, "lr": lr}


def _port_state(path, lr=1e-3, freeze_backbone=False):
    model = load_weights(shrunk_torch_model(), path)
    opt = make_optimizer(model, lr, freeze_backbone=freeze_backbone)
    return create_train_state(model, opt)


def _batch_t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_one_f32_step_matches_jax(jax_side):
    """Loss terms and post-clip gradients of one step from the same
    weights and batch."""
    state = _port_state(jax_side["path"])
    state, metrics = make_train_step()(state, _batch_t(jax_side["batch"]))
    want = jax_side["steps"][0]["terms"]
    for k in TERMS:
        assert float(metrics[k]) == pytest.approx(want[k], rel=1e-4), k
    grads = {n: p.grad.numpy() for n, p in state.model.named_parameters()}
    clipped = jax_side["steps"][0]["clipped"]
    assert len(grads) == len(clipped)
    for path, g in clipped.items():
        name, g = _to_torch_name(path, g)
        norm = float(np.linalg.norm(g))
        assert norm <= 1e-3 * (1 + 1e-5), (name, norm)
        np.testing.assert_allclose(grads[name], g, rtol=0,
                                   atol=1e-3 * norm + 1e-30, err_msg=name)
    assert state.step == 1


def test_adam_fed_jax_gradients_gives_jax_updates(jax_side):
    """Three steps of clip + Adam on JAX's raw gradients: the port's
    parameter moves equal optax's clip + scale_by_adam + (-lr * u)."""
    state = _port_state(jax_side["path"], lr=jax_side["lr"])
    params = dict(state.model.named_parameters())
    # Adam's update does not depend on the weights: from zero weights the
    # moves are read without the rounding of a weight's own magnitude
    with torch.no_grad():
        for p in params.values():
            p.zero_()
    for step in jax_side["steps"]:
        before = {n: p.detach().clone() for n, p in params.items()}
        for path, g in step["grads"].items():
            name, g = _to_torch_name(path, g)
            params[name].grad = torch.from_numpy(np.array(g))
        clip_per_tensor_norm([p.grad for p in params.values()], 1e-3)
        state.optimizer.step()
        for path, u in step["updates"].items():
            name, u = _to_torch_name(path, u)
            moved = (params[name].detach() - before[name]).numpy()
            np.testing.assert_allclose(moved, u, rtol=0, atol=1e-7,
                                       err_msg=name)


def test_clip_per_tensor_norm():
    """Keras clipnorm: each tensor on its own (mirrors the JAX test)."""
    grads = [torch.ones(100) * 10.0, torch.full((4,), 1e-6), None]
    clip_per_tensor_norm(grads, 0.001)
    assert float(grads[0].norm()) == pytest.approx(0.001, rel=1e-5)
    torch.testing.assert_close(grads[1], torch.full((4,), 1e-6))


def test_freeze_backbone_leaves_backbone_bit_equal(jax_side):
    state = _port_state(jax_side["path"], freeze_backbone=True)
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    opt_params = {id(p) for g in state.optimizer.param_groups
                  for p in g["params"]}
    state, _ = make_train_step()(state, _batch_t(jax_side["batch"]))
    changed = []
    for n, p in state.model.named_parameters():
        if n.startswith("backbone."):
            assert torch.equal(p, before[n]), n
            assert not p.requires_grad and id(p) not in opt_params
        elif not torch.equal(p, before[n]):
            changed.append(n)
    assert any(n.startswith("regression.") for n in changed)
    # the backbone still goes into the model's state dict (checkpoints)
    assert any(k.startswith("backbone.") for k in state.model.state_dict())


def test_lr_change_takes_effect(jax_side):
    state = _port_state(jax_side["path"])
    step = make_train_step()
    batch = _batch_t(jax_side["batch"])
    state.lr = 0.0
    assert all(g["lr"] == 0.0 for g in state.optimizer.param_groups)
    before = [p.detach().clone() for p in state.model.parameters()]
    state, _ = step(state, batch)
    assert all(torch.equal(a, p) for a, p in zip(before,
                                                 state.model.parameters()))
    state.lr = 1e-3
    state, _ = step(state, batch)
    assert not all(torch.equal(a, p) for a, p in
                   zip(before, state.model.parameters()))
    assert state.lr == 1e-3 and state.step == 2


def test_loss_falls_over_six_steps(jax_side):
    state = _port_state(jax_side["path"], lr=2e-4)
    step = make_train_step()
    batch = _batch_t(jax_side["batch"])
    losses = []
    for _ in range(6):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert min(losses[-3:]) < losses[0], losses
    assert state.step == 6


def test_fused_prepare_equals_two_stage(jax_side, tmp_path):
    """Augmentation and targets inside the step (raw batches) give the
    same losses and parameters as the loader's two-stage preparation:
    the same seed draws the same augmentation."""
    root = make_synthetic_kitti(str(tmp_path / "kitti"))
    ds = KittiDataset(root, "train")
    mk = dict(batch_size=2, image_min_side=48, image_max_side=128,
              augment=True, shuffle=False, device="cpu")
    two = KittiLoader(ds, **mk)
    raw = KittiLoader(ds, raw_batches=True, **mk)
    s_two = _port_state(jax_side["path"])
    s_raw = _port_state(jax_side["path"])
    step_two = make_train_step()
    step_raw = make_fused_train_step(loader=raw)
    n = 0
    for b_two, b_raw in zip(two.epoch(prefetch=2), raw.epoch(prefetch=0)):
        assert b_raw["images"].dtype == torch.uint8
        assert "transform" in b_raw and b_two["image"].dtype == torch.float32
        s_two, m_two = step_two(s_two, b_two)
        s_raw, m_raw = step_raw(s_raw, b_raw)
        for k in TERMS:
            assert float(m_two[k]) == float(m_raw[k]), k
        n += 1
    assert n >= 1
    for a, b in zip(s_two.model.parameters(), s_raw.model.parameters()):
        assert torch.equal(a, b)


def test_fused_step_refuses_mixed_configuration(tmp_path):
    root = make_synthetic_kitti(str(tmp_path / "kitti"))
    ds = KittiDataset(root, "train")
    with pytest.raises(ValueError, match="raw_batches"):
        make_fused_train_step(loader=KittiLoader(ds, device="cpu"))
    with pytest.raises(ValueError, match="EITHER"):
        make_fused_train_step(num_classes=1, loader=KittiLoader(
            ds, raw_batches=True, device="cpu"))
    with pytest.raises(TypeError, match="data_parallel_mesh"):
        make_fused_train_step(num_classes=1, mesh=object())


def test_compute_losses_under_bf16_autocast_stays_float32(jax_side):
    """bf16 autocast: the trunk runs in bf16 (FrozenBatchNorm keeps the
    conv's dtype), the loss terms come out float32 and finite."""
    model = load_weights(shrunk_torch_model(), jax_side["path"])
    seen = []
    hook = model.backbone.register_forward_hook(
        lambda m, i, o: seen.extend(t.dtype for t in o))
    total, terms = compute_losses(model, _batch_t(jax_side["batch"]),
                                  bf16=True)
    hook.remove()
    assert set(seen) == {torch.bfloat16}
    assert all(v.dtype == torch.float32 and torch.isfinite(v)
               for v in terms.values())
