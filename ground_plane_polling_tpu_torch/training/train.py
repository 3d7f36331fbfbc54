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
is a tensor in the optimizer's param groups, as JAX's is a traced scalar:
`TrainState.lr` writes it in place, so the plateau schedule changes it
without a rebuild or a new capture. On a card Adam is `capturable`, its
step counts and bias corrections on the device. The optimizer updates the
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

Compiled form: where JAX jits the step (with a mesh, one XLA program with
the gradient all-reduce inside), `make_train_step`,
`make_sharded_train_step` and `make_fused_train_step` return a
`CapturedTrainStep`: one CUDA graph per batch signature, replayed for a
state on the card (a state on the CPU takes the eager step). Without a
mesh that is so on a machine with a card; with a mesh, where
`parallel.mesh.capturable` says so: on a card, with an NCCL group (the
normalizers' all-reduce and every DDP bucket's gradient all-reduce
captured inside the graph) or none. A gloo mesh and the CPU run the step
eagerly. `step.eager` is the eager step either way (`step.eager is step`
where there is no graph).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..data.pipeline import prepare_batch
from ..parallel.mesh import capturable, check_mesh
from . import losses

__all__ = ["TrainState", "clip_per_tensor_norm", "make_optimizer",
           "create_train_state", "compute_losses", "make_train_step",
           "make_sharded_train_step", "make_fused_train_step",
           "CapturedTrainStep"]


class TrainState:
    """step (int), model (its parameters, updated in place), optimizer and
    lr. Setting `lr` writes it into the optimizer's param groups: into the
    lr tensor in place where make_optimizer put one (a captured step's
    graph reads that tensor), else as a float. Reading `lr` returns the
    host's copy of the value the groups hold (float32 on a card, as JAX's
    lr), so neither waits for the card."""

    def __init__(self, model, optimizer, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.step = step
        self._lr = float(optimizer.param_groups[0]["lr"])  # once, at set-up

    @property
    def lr(self) -> float:
        return self._lr

    @lr.setter
    def lr(self, value: float):
        value = held = float(value)
        for group in self.optimizer.param_groups:
            lr = group["lr"]
            if torch.is_tensor(lr):
                lr.fill_(value)
                held = float(torch.tensor(value, dtype=lr.dtype))  # host
            else:
                group["lr"] = value
        self._lr = held


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
    """Adam over the model's trainable parameters, with the lr in a tensor
    on their device. On a card Adam is `capturable` (its step counts on
    the device, the lr float32 as JAX's); on the CPU, where capturable
    Adam is refused, the lr is float64, which computes the step size as
    from a Python float. With freeze_backbone the backbone's parameters
    get requires_grad off and stay out of the optimizer (the reference's
    --freeze-backbone)."""
    if freeze_backbone:
        model.backbone.requires_grad_(False)
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device
    on_card = device.type == "cuda"
    lr = torch.tensor(learning_rate, device=device,
                      dtype=torch.float32 if on_card else torch.float64)
    optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.0, capturable=on_card)
    # capturable Adam also steps uncaptured on purpose (a capture's first
    # step, the DDP step): no warning for that
    optimizer._warned_capturable_if_run_uncaptured = True
    return optimizer


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
    # no cache of the weights' bf16 casts: CUDA-graph capture needs it
    # off, and the casts are the same either way
    with torch.autocast(device_type, torch.bfloat16, enabled=bf16,
                        cache_enabled=False):
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


# eager DDP iterations before the first capture of a DDP step: DDP
# rebuilds its buckets after the first and reads back the timing events of
# its first 10 (PyTorch's notes on CUDA graphs with DDP ask for 11)
DDP_WARMUP = 11


class _Replicas:
    """The DistributedDataParallel wrapper of the state's model over a
    mesh's group, made at the first step (its construction broadcasts rank
    0's parameters, on the stream current then) and again if the state's
    model changes. Each step object has its own (a captured step and its
    eager step each wrap the model of the state they are given)."""

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
            # no timing events past the first 10 iterations: a capture at a
            # sampled iteration would record them into the graph. The
            # setter is DDP's own, private (torch 1.10 to 2.13 have it)
            setter = getattr(self._ddp,
                             "_set_ddp_runtime_logging_sample_rate", None)
            if setter is None:
                raise RuntimeError(
                    f"torch {torch.__version__}'s DistributedDataParallel "
                    "has no _set_ddp_runtime_logging_sample_rate: a captured "
                    "DDP step would record DDP's timing events into its "
                    "graph")
            setter(2**31 - 1)
            self._model = model
        return self._ddp


def _step_body(state: TrainState, batch, compat_height_only: bool,
               bf16: bool, clipnorm: float, replicas=None):
    """Loss, gradients, per-tensor clip and the Adam update, in place; the
    metrics as detached device tensors (read back by the caller when it
    chooses). The clipped gradients stay in each parameter's .grad. The
    step count is the caller's to advance: a capture runs this body again
    without taking a step."""
    state.optimizer.zero_grad(set_to_none=True)
    model, mesh = ((state.model, None) if replicas is None
                   else (replicas(state.model), replicas.mesh))
    total, metrics = compute_losses(model, batch, compat_height_only, bf16,
                                    mesh)
    total.backward()
    clip_per_tensor_norm([p.grad for group in state.optimizer.param_groups
                          for p in group["params"]], clipnorm)
    state.optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


def _compiled(body, mesh):
    """The step of `body(state, batch, replicas) -> metrics`: a
    CapturedTrainStep where `capturable` says so (without a mesh: a
    machine with a card; it takes a state on the CPU to the eager step),
    else eager."""
    replicas = None if mesh is None else _Replicas(mesh)

    def train_step(state: TrainState, batch):
        metrics = body(state, batch, replicas)
        state.step += 1
        return state, metrics

    train_step.eager = train_step
    device = (mesh.device if mesh is not None else
              "cuda" if torch.cuda.is_available() else "cpu")
    if not capturable(mesh, device):
        return train_step
    return CapturedTrainStep(train_step, body, mesh)


def make_train_step(compat_height_only: bool = False, bf16: bool = False,
                    clipnorm: float = 1e-3, mesh=None):
    """train_step(state, batch) -> (state, metrics) for prepared batches
    (the two-stage loader); with a `mesh`, batches of this rank's rows."""
    def body(state: TrainState, batch, replicas):
        return _step_body(state, batch, compat_height_only, bf16, clipnorm,
                          replicas)

    return _compiled(body, check_mesh(mesh))


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
    check_mesh(mesh)
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

    def body(state: TrainState, raw, replicas):
        batch = prepare_batch(raw, num_classes, augment,
                              next(state.model.parameters()).device)
        return _step_body(state, batch, compat_height_only, bf16, clipnorm,
                          replicas)

    return _compiled(body, mesh)


class _StepGraph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: dict          # static batch buffers, by key
    keys: tuple           # the metrics' names, in the order of `metrics`
    metrics: torch.Tensor  # the metrics stacked, rewritten by each replay
    grads: list           # the .grad of each parameter a replay writes
    probe: int            # a parameter whose replayed .grad is not None


class CapturedTrainStep:
    """The train step of a state on a card as captured CUDA graphs, one per
    batch signature (the batch's keys with each entry's shape and dtype: a
    new canvas shape of the loader's buckets is a new signature, as under
    JAX's jit).

    The first call of a signature copies the batch into static buffers on
    the card and runs the step eagerly on the stream it then captures on.
    That is the call's step: it copies the constants to the card, creates
    Adam's moments outside the graphs' memory pool and settles cuDNN's
    choices. Then it captures the same body on the static buffers, which
    takes no step. Every later call copies the batch into the buffers
    (asynchronously from the loader's pinned memory), replays the graph on
    the caller's stream, advances `state.step` and returns a copy of the
    metrics made after the replay, so a step's metrics stay its own while
    later steps run. All graphs share one memory pool and one side stream.
    A capture that fails raises (an operation that syncs the host, a copy
    from pageable memory): the step never carries on eagerly. The warm-up
    step it took stays taken.

    With a `mesh` whose group is NCCL, the body is the DDP step: its
    DistributedDataParallel wrapper is built on the side stream at the
    first call, and the first DDP_WARMUP calls are eager DDP steps on that
    stream (each a real step, with its own metrics), the last of them
    followed by the first capture; a later signature takes one eager step,
    as without a mesh. The graph holds the loss normalizers' all-reduce and
    every bucket's gradient all-reduce: every rank captures the same
    collectives in the same order and replays them in step. DDP's buckets
    stay where its last rebuild (after its first step) put them. On more
    than one rank NCCL's communicator waits, as it is destroyed, for every
    graph that holds its collectives: end the group with
    `parallel.shutdown(step)`, which calls `release()` first.

    The graphs read the live tensors of the state they were captured for:
    the parameters, Adam's moments and step counts, and the lr tensor.
    `TrainState.lr` and `restore_checkpoint` write those in place, so the
    next replay sees them; an optimizer whose state or lr tensor was
    replaced otherwise (its own `load_state_dict`) makes the step raise.
    After a step each parameter's .grad holds that step's clipped (and,
    with a mesh, reduced) gradient, as after the eager step.

    `eager` is the eager step (for comparisons; it advances the same state
    when given it, through a DDP wrapper of its own). A state on the CPU
    takes it too."""

    def __init__(self, eager, body, mesh=None):
        self.eager = eager
        self._body = body
        self._replicas = None if mesh is None else _Replicas(mesh)
        # eager steps on the side stream before the first capture
        self._warmup = (DDP_WARMUP if mesh is not None
                        and mesh.group is not None else 1)
        self._eager_steps = 0
        self.graphs = {}
        self._pool = self._stream = None
        self._owner = None  # (model, optimizer, its state, lr tensor)
        self._params = []

    def _check(self, state):
        opt = state.optimizer
        owner = (state.model, opt, opt.state, opt.param_groups[0]["lr"])
        if self._owner is None:
            self._owner = owner
            self._params = [p for g in opt.param_groups for p in g["params"]]
        elif any(a is not b for a, b in zip(owner, self._owner)):
            raise RuntimeError(
                "this captured train step steps the model, optimizer state "
                "and lr tensor it was captured for; a new state needs a new "
                "step, and a checkpoint loads through restore_checkpoint, "
                "which writes the live tensors in place")

    def _eager_step(self, state, batch, device):
        """This call's step, eagerly on the side stream (made at the first
        call, with the graphs' pool), which the caller's stream waits
        for."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device)
        caller = torch.cuda.current_stream(device)
        self._stream.wait_stream(caller)
        try:
            with torch.cuda.stream(self._stream):
                metrics = self._body(state, batch, self._replicas)
        finally:
            caller.wait_stream(self._stream)
        state.step += 1
        self._eager_steps += 1
        return metrics

    def _capture(self, state, batch, device):
        """A signature's first call once the warm-up steps are taken: the
        batch into static buffers, this call's step eagerly on the side
        stream, then the capture of the same body there."""
        static = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                  for k, v in batch.items()}
        for k, s in static.items():
            s.copy_(batch[k], non_blocking=True)
        metrics = self._eager_step(state, static, device)
        warm = [p.grad for p in self._params]
        caller = torch.cuda.current_stream(device)
        self._stream.wait_stream(caller)
        try:
            with torch.cuda.stream(self._stream):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self._pool,
                                      stream=self._stream,
                                      capture_error_mode="thread_local"):
                    out = self._body(state, static, self._replicas)
                    keys = tuple(out)
                    stacked = torch.stack([out[k] for k in keys])
                grads = [p.grad for p in self._params]
                # the step's gradients, where the replays will write them
                for g, w in zip(grads, warm):
                    if g is not None:
                        g.copy_(w)
        finally:
            caller.wait_stream(self._stream)
        probe = next(i for i, g in enumerate(grads) if g is not None)
        return _StepGraph(graph, static, keys, stacked, grads, probe), metrics

    def release(self):
        """Wait for the card, then free every graph (and with them the
        NCCL collectives they hold); the state keeps its tensors, and a later
        call captures anew."""
        if self.graphs:
            torch.cuda.synchronize(self._stream.device)
            for g in self.graphs.values():
                g.graph.reset()
            self.graphs.clear()

    def __call__(self, state: TrainState, batch):
        device = next(state.model.parameters()).device
        if device.type != "cuda":
            return self.eager(state, batch)
        self._check(state)
        key = tuple(sorted((k, tuple(v.shape), v.dtype)
                           for k, v in batch.items()))
        with torch.cuda.device(device):
            g = self.graphs.get(key)
            if g is None:
                if self._eager_steps + 1 < self._warmup:  # DDP's warm-up
                    return state, self._eager_step(state, batch, device)
                g, metrics = self._capture(state, batch, device)
                self.graphs[key] = g
                return state, metrics
            for k, s in g.inputs.items():
                s.copy_(batch[k], non_blocking=True)
            g.graph.replay()
            state.step += 1
            if self._params[g.probe].grad is not g.grads[g.probe]:
                for p, grad in zip(self._params, g.grads):
                    p.grad = grad
            values = g.metrics.clone()
            return state, dict(zip(g.keys, values.unbind()))
