"""The train step: loss assembly, Keras-style clipping, Adam (port of
ground_plane_polling_tpu/training/train.py).

As in the Keras reference, the three losses are summed (focal
classification + smooth-L1 box/keypoint + smooth-L1 dimensions) and
minimized with Adam (lr 1e-5) after clipping each gradient tensor to norm
0.001 on its own (Keras `clipnorm`; not a global norm, so not
`torch.nn.utils.clip_grad_norm_`).

Adam is `torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`: the update
-lr * m_hat / (sqrt(v_hat) + eps) of the JAX package's
`optax.scale_by_adam()` followed by `-lr * u`, with no weight decay. The lr
lives in the optimizer's param groups (`TrainState.lr`), so the plateau
schedule changes it without a rebuild. The optimizer updates the
parameters in place, which takes the place of JAX's buffer donation.

`bf16` runs the forward and backward under `torch.autocast` in bfloat16
with float32 parameters (`--bf16` of the JAX CLI: bf16 compute, f32
params); the losses are computed in float32. A frozen backbone is left out
of the optimizer with requires_grad off, so a step leaves it bit-unchanged.

Data parallel (`mesh=`, `make_sharded_train_step`; parallel/mesh.py): each
rank steps on its rows of the batch with the model wrapped in
DistributedDataParallel (buffers not broadcast: FrozenBN's never change),
the loss normalizers counted over the whole batch (losses.global_terms).
The clip runs after backward(), on the reduced gradients, and the
returned metrics are the global loss terms. `state.model` stays the
unwrapped module, so checkpoints keep its parameter names.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..data.pipeline import prepare_batch
from ..parallel.mesh import check_mesh
from . import losses

__all__ = ["TrainState", "clip_per_tensor_norm", "make_optimizer",
           "create_train_state", "compute_losses", "make_train_step",
           "make_sharded_train_step", "make_fused_train_step"]


class TrainState:
    """step (int), model (its parameters, updated in place), optimizer and
    lr; setting `lr` writes it into the optimizer's param groups."""

    def __init__(self, model, optimizer, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.step = step

    @property
    def lr(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    @lr.setter
    def lr(self, value: float):
        for group in self.optimizer.param_groups:
            group["lr"] = float(value)


def clip_per_tensor_norm(grads, max_norm: float):
    """Scale each gradient tensor in place to L2 norm <= max_norm (Keras
    clipnorm): g *= min(1, max_norm / max(|g|, 1e-12)). No host sync."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return
    norms = torch.stack(torch._foreach_norm(grads))
    scales = (max_norm / norms.clamp(min=1e-12)).clamp(max=1.0)
    torch._foreach_mul_(grads, list(scales.unbind()))


def make_optimizer(model, learning_rate: float = 1e-5,
                   freeze_backbone: bool = False) -> torch.optim.Adam:
    """Adam over the model's trainable parameters. With freeze_backbone
    the backbone's parameters get requires_grad off and stay out of the
    optimizer (the reference's --freeze-backbone)."""
    if freeze_backbone:
        model.backbone.requires_grad_(False)
    params = [p for p in model.parameters() if p.requires_grad]
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.0)


def create_train_state(model, optimizer,
                       learning_rate: Optional[float] = None) -> TrainState:
    state = TrainState(model, optimizer)
    if learning_rate is not None:
        state.lr = learning_rate
    return state


def compute_losses(model, batch, compat_height_only: bool = False,
                   bf16: bool = False, mesh=None):
    """(total, dict of components) for a prepared batch: image (B, H, W, 3)
    mean-subtracted, regression, regression_dim, labels (ops.targets).

    With a `mesh`, `batch` is this rank's rows: the components are the
    global loss terms and `total` the rank's share to differentiate
    (losses.global_terms)."""
    images = batch["image"].permute(0, 3, 1, 2)
    device_type = images.device.type
    with torch.autocast(device_type, torch.bfloat16, enabled=bf16):
        out = model(images)
    with torch.autocast(device_type, enabled=False):
        parts = {
            "regression": losses.smooth_l1_parts(
                batch["regression"], out["regression"].float()),
            "regression_dim": losses.smooth_l1_dim_parts(
                batch["regression_dim"], out["regression_dim"].float(),
                compat_height_only=compat_height_only),
            "classification": losses.focal_parts(
                batch["labels"], out["classification"].float()),
        }
        if mesh is None:
            terms = {k: losses.normalized(v) for k, v in parts.items()}
            total = sum(terms.values())
            return total, {"loss": total, **terms}
        local, terms = losses.global_terms(parts, mesh)
    return sum(local.values()), {"loss": sum(terms.values()), **terms}


class _Replicas:
    """The DistributedDataParallel wrapper of the state's model over a
    mesh's group, made at the first step (its construction broadcasts rank
    0's parameters) and again if the state's model changes."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._model = self._ddp = None

    def __call__(self, model):
        if self.mesh.group is None:  # one rank, no process group
            return model
        if model is not self._model:
            from torch.nn.parallel import DistributedDataParallel

            device = self.mesh.device
            self._ddp = DistributedDataParallel(
                model, device_ids=[device] if device.type == "cuda" else None,
                process_group=self.mesh.group, broadcast_buffers=False)
            self._model = model
        return self._ddp


def _step_body(state: TrainState, batch, compat_height_only: bool,
               bf16: bool, clipnorm: float, replicas=None):
    """Loss, gradients, per-tensor clip and the Adam update, in place.
    Metrics are detached device tensors (read back by the caller when it
    chooses); the clipped gradients stay in each parameter's .grad."""
    state.optimizer.zero_grad(set_to_none=True)
    model, mesh = ((state.model, None) if replicas is None
                   else (replicas(state.model), replicas.mesh))
    total, metrics = compute_losses(model, batch, compat_height_only, bf16,
                                    mesh)
    total.backward()
    clip_per_tensor_norm([p.grad for group in state.optimizer.param_groups
                          for p in group["params"]], clipnorm)
    state.optimizer.step()
    state.step += 1
    return state, {k: v.detach() for k, v in metrics.items()}


def make_train_step(compat_height_only: bool = False, bf16: bool = False,
                    clipnorm: float = 1e-3, mesh=None):
    """train_step(state, batch) -> (state, metrics) for prepared batches
    (the two-stage loader); with a `mesh`, batches of this rank's rows."""
    replicas = None if check_mesh(mesh) is None else _Replicas(mesh)

    def train_step(state: TrainState, batch):
        return _step_body(state, batch, compat_height_only, bf16, clipnorm,
                          replicas)

    return train_step


def make_sharded_train_step(mesh, compat_height_only: bool = False,
                            bf16: bool = False, clipnorm: float = 1e-3):
    """Data-parallel train step over `mesh` (parallel.data_parallel_mesh):
    each rank passes its rows of the batch (KittiLoader(mesh=...) or
    parallel.make_global_batch); the gradients are all-reduced in
    backward()."""
    if mesh is None:
        raise ValueError("make_sharded_train_step needs a mesh")
    return make_train_step(compat_height_only, bf16, clipnorm, mesh)


def make_fused_train_step(num_classes: Optional[int] = None,
                          augment: Optional[bool] = None,
                          compat_height_only: bool = False,
                          bf16: bool = False, clipnorm: float = 1e-3,
                          mesh=None, loader=None):
    """train_step(state, raw) -> (state, metrics) that runs `prepare_batch`
    (upload, augmentation, mean subtraction, anchor targets) inside the
    step, on the device of the model's parameters, for the raw batches of
    KittiLoader(raw_batches=True). Pass either `loader` (num_classes and
    augment come from it) or `num_classes` and `augment`. With a `mesh`,
    raw batches of this rank's rows (KittiLoader(mesh=...))."""
    replicas = None if check_mesh(mesh) is None else _Replicas(mesh)
    if loader is not None:
        if not loader.raw_batches:
            raise ValueError(
                "make_fused_train_step(loader=...) needs "
                "KittiLoader(raw_batches=True); this loader would yield "
                "already-prepared batches")
        if num_classes is not None or augment is not None:
            raise ValueError(
                "make_fused_train_step: pass EITHER loader= (config "
                "derived from it) OR explicit num_classes/augment — not both")
        num_classes, augment = loader.ds.num_classes, loader.augment
    if num_classes is None:
        raise ValueError("pass num_classes (or loader=) to "
                         "make_fused_train_step")
    augment = True if augment is None else augment

    def train_step(state: TrainState, raw):
        batch = prepare_batch(raw, num_classes, augment,
                              next(state.model.parameters()).device)
        return _step_body(state, batch, compat_height_only, bf16, clipnorm,
                          replicas)

    return train_step
