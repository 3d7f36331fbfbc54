"""The port's data parallelism on two real ranks: two processes over gloo on
the CPU, launched once for the module, each running every check below and
writing what it saw; the tests then hold it against JAX's sharded step on
a 2-device mesh (the conftest's virtual CPU devices) and against the
port's single process, at the shrunk size of test_torch_train_step.py: a
(1, 1, 1, 1) ResNet with FPN 64, 64x64 to 64x224.

The ranks import the port only (never JAX): this file runs as each rank's
script (`python tests/test_torch_distributed.py RANK PORT DIR`) and imports
JAX only inside the fixtures, in the pytest process. Every rank has a
timeout, as has the process group (GPP_DIST_INIT_TIMEOUT), so a rank that
hangs fails the tests instead of stalling the run.

Tolerances:
  * loss terms: rtol 1e-4 against JAX and against one process;
  * gradients: each tensor within 1e-3 of that tensor's norm;
  * parameters after 2 steps of plain gradient descent at lr 1e-3 with no
    clip (the JAX package's 2-process test: optax.identity at lr 1e-3):
    rtol 1e-5, atol 5e-7;
  * sweeps and detections: equal to the single process's at batch 1,
    which is what each rank runs.

Which comparisons run in float64 (the port's model in double; JAX's
built with dtype float64 under jax.enable_x64; the loss terms stay
float32 in both): the post-clip gradients against JAX, and the
parameters after 2 steps. In float32 a rank's convolutions at 2 rows
round otherwise than one process's at 4 (and the port's otherwise than
XLA's), and a ReLU input that lands on the other side of 0 moves its
gradient by a step: on these batches the FPN's P4 bias differs from
JAX's by 1.6e-3 of its norm in the port's single process as in its two
ranks, and the parameters after 2 steps by up to 2.4e-6. In float64 every
gradient tensor agrees with JAX's within 5e-8 of its norm.
"""

import ast
import contextlib
import hashlib
import io
import os
import socket
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
RANK_TIMEOUT = 600     # seconds for the whole launch
GROUP_TIMEOUT = 60     # seconds, the process group's (GPP_DIST_INIT_TIMEOUT)
SHRUNK, FEATURES = (1, 1, 1, 1), 64
SHAPE = (64, 64)
BATCH_KEYS = ("image", "labels", "regression", "regression_dim")
# rows with annotations: in "unbalanced", rank 1's two rows have none
BATCHES = {"balanced": (True, True, True, True),
           "unbalanced": (True, True, False, False)}
TERMS = ("loss", "regression", "regression_dim", "classification")
SIDES = ["--image-min-side", "64", "--image-max-side", "224"]
FIT_LOSSES = ((1.0, 1.0, 1.0), (1.0, 0.5, 0.25))  # per rank, per epoch


# --- the rank processes (port only) ----------------------------------------

def _shrunk(num_classes=1, remat=False, **_):
    from ground_plane_polling_tpu_torch.models import GPPRetinaNet
    from ground_plane_polling_tpu_torch.models.resnet import ResNetBackbone

    return GPPRetinaNet(ResNetBackbone(SHRUNK, remat=remat),
                        num_classes=num_classes, feature_size=FEATURES)


def _sgd_state(weights, dtype="float32"):
    """The shrunk detector from `weights` with plain gradient descent at
    lr 1e-3."""
    from ground_plane_polling_tpu_torch.models import load_weights
    from ground_plane_polling_tpu_torch.training.train import (
        create_train_state)

    model = load_weights(_shrunk(), weights).to(getattr(torch, dtype))
    return create_train_state(model, torch.optim.SGD(model.parameters(),
                                                     lr=1e-3))


NO_CLIP = float("inf")
DTYPES = ("float32", "float64")


def run_steps(state, step, batch, keep=True):
    """Terms and gradients of one step, and the parameters after a
    second; the values where `keep`, the parameters' in float64 only
    (the tests compare them there)."""
    state, m = step(state, batch)
    res = {"terms": {k: float(v) for k, v in m.items()},
           "grads": _record(((n, p.grad) for n, p in
                             state.model.named_parameters()), keep),
           "positives": float((batch["regression"][..., 12] == 1).sum()),
           "rows": int(batch["image"].shape[0])}
    step(state, batch)
    float64 = next(state.model.parameters()).dtype == torch.float64
    res["params"] = _record(state.model.named_parameters(), keep and float64)
    return res


def _record(named, keep=True):
    """Tensors by name: each one's SHA-1 (the ranks are held bit-equal by
    them) and, where `keep`, its values in float32, which the tolerances
    here allow and which keeps the ranks' files small."""
    named = [(n, t.detach()) for n, t in named]
    out = {"sha1": {n: hashlib.sha1(t.numpy().tobytes()).hexdigest()
                    for n, t in named}}
    if keep:
        out["values"] = {n: t.float().numpy().copy() for n, t in named}
    return out


def _rank_steps(mesh, work):
    """On each prepared global batch of 4 (2 rows a rank), with no clip:
    terms, gradients and the parameters after 2 steps, in float32 and in
    float64."""
    from ground_plane_polling_tpu_torch.parallel import make_global_batch
    from ground_plane_polling_tpu_torch.training.train import make_train_step

    data = np.load(os.path.join(work, "batches.npz"))
    out = {}
    for name in BATCHES:
        batch = {k: data[f"{name}/{k}"] for k in BATCH_KEYS}
        out[name] = {dtype: run_steps(
            _sgd_state(os.path.join(work, "shrunk.npz"), dtype),
            make_train_step(clipnorm=NO_CLIP, mesh=mesh),
            make_global_batch(mesh, {k: v.astype(dtype)
                                     for k, v in batch.items()}),
            keep=mesh.rank == 0) for dtype in DTYPES}
    return out


def fused_loader(root, mesh=None):
    from ground_plane_polling_tpu_torch.data.kitti import KittiDataset
    from ground_plane_polling_tpu_torch.data.pipeline import KittiLoader

    return KittiLoader(KittiDataset(root, "train"), batch_size=4,
                       image_min_side=64, image_max_side=224, augment=True,
                       raw_batches=True, seed=3, device="cpu", mesh=mesh)


def _rank_fused(mesh, work):
    """The fused step with augmentation over the loader's epoch (two
    groups of 4, one rank's half of the second all filler rows), the
    model in float64."""
    from ground_plane_polling_tpu_torch.training.train import (
        make_fused_train_step)

    loader = fused_loader(os.path.join(work, "kitti"), mesh)
    state = _sgd_state(os.path.join(work, "model.npz"), "float64")
    step = make_fused_train_step(loader=loader, clipnorm=NO_CLIP, mesh=mesh)
    terms, rows = [], []
    for raw in loader.epoch(prefetch=0):
        rows.append(int(raw["images"].shape[0]))
        state, m = step(state, raw)
        terms.append({k: float(v) for k, v in m.items()})
    return {"terms": terms, "rows": rows,
            "params": _record(state.model.named_parameters(),
                              keep=mesh.rank == 0)}


def eval_setup(work):
    from ground_plane_polling_tpu_torch.data.kitti import KittiDataset
    from ground_plane_polling_tpu_torch.data.pipeline import KittiLoader
    from ground_plane_polling_tpu_torch.inference import place_model
    from ground_plane_polling_tpu_torch.models import load_weights

    model = place_model(load_weights(_shrunk(), os.path.join(work,
                                                             "model.npz")),
                        "cpu")
    loader = KittiLoader(KittiDataset(os.path.join(work, "kitti"), "val"),
                         image_min_side=64, image_max_side=224, device="cpu")
    return model, loader


def _rank_sweep(mesh, work):
    """evaluate_model in groups of 2 (5 images: a short group padded)."""
    from ground_plane_polling_tpu_torch.training.loop import evaluate_model

    model, loader = eval_setup(work)
    return {kind: evaluate_model(model, loader, mesh=mesh, int8_calib=calib)
            for kind, calib in (("float", 0), ("int8", 2))}


def eval_pair(loader):
    """The first two eval images of one padded shape, as one batch."""
    items = list(loader.eval_inputs())[:2]
    return [np.concatenate([it[k] for it in items])
            for k in ("image", "P_inv", "planes")]


def _rank_detect(mesh, work):
    from ground_plane_polling_tpu_torch.inference import make_detect_fn

    model, loader = eval_setup(work)
    images, P_inv, planes = eval_pair(loader)
    out = make_detect_fn(model, images.shape[1:3], device_preprocess=True,
                         mesh=mesh, with_pose=True)(images, P_inv, planes)
    return {k: v.numpy() for k, v in out._asdict().items()}


class _OneStepLoader:
    def __len__(self):
        return 1

    def epoch(self):
        return iter([None])


def _toy_state(lr=0.1):
    from ground_plane_polling_tpu_torch.training.train import TrainState

    model = torch.nn.Linear(1, 1)
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=lr))


def _rank_fit_plateau(mesh, work):
    """Each rank's step reports its own loss: rank 0 on a plateau (alone
    it would cut the lr), rank 1 falling; fit decides on their mean."""
    from ground_plane_polling_tpu_torch.training.loop import fit
    from ground_plane_polling_tpu_torch.training.schedule import (
        ReduceLROnPlateau)

    losses = FIT_LOSSES[mesh.rank]

    def step(state, _):
        loss = torch.tensor(losses[state.step])
        state.step += 1
        return state, {"loss": loss}

    state = fit(None, _toy_state(), step, _OneStepLoader(),
                epochs=len(losses), lr_schedule=ReduceLROnPlateau(patience=1),
                verbose=False, eval_mesh=mesh)
    return {"lr": state.lr, "step": state.step}


def _rank_fit_nan(mesh, work):
    """A non-finite loss on rank 1 alone stops both ranks."""
    from ground_plane_polling_tpu_torch.training.loop import fit

    def step(state, _):
        state.step += 1
        return state, {"loss": torch.tensor(
            float("nan") if mesh.rank == 1 else 1.0)}

    try:
        fit(None, _toy_state(), step, _OneStepLoader(), epochs=2,
            verbose=False, eval_mesh=mesh)
    except FloatingPointError as e:
        return {"raised": str(e)}
    return {"raised": None}


@contextlib.contextmanager
def _shrunk_detector():
    """The CLIs build the shrunk detector (as test_torch_train_loop.py's
    CLI test does)."""
    from ground_plane_polling_tpu_torch import models

    real = models.build_detector
    models.build_detector = lambda backbone, num_classes=1, **kw: _shrunk(
        num_classes, **kw)
    try:
        yield
    finally:
        models.build_detector = real


def train_cli_args(work, tag, extra=()):
    return (["--device", "cpu", "--weights", os.path.join(work, "model.npz"),
             "--batch-size", "2", "--epochs", "1", "--steps", "2",
             "--random-transform", "--remat",
             "--tensorboard-dir", os.path.join(work, tag, "tb"),
             "--log-path", os.path.join(work, tag, "log.jsonl"),
             "--snapshot-path", os.path.join(work, tag, "snaps")]
            + list(extra) + SIDES + ["kitti", os.path.join(work, "kitti")])


def _printed_record(text):
    return ast.literal_eval(text.strip().splitlines()[-1])


def _rank_train_cli(mesh, work):
    """bin/train --data-parallel --remat --tensorboard-dir: 1 epoch of 2
    steps (1 row a rank), the validation sweep, a checkpoint."""
    from ground_plane_polling_tpu_torch.bin import train

    buf = io.StringIO()
    with _shrunk_detector(), contextlib.redirect_stdout(buf):
        state = train.main(train_cli_args(work, "dp", ["--data-parallel"]))
    return {"step": state.step, "record": _printed_record(buf.getvalue())}


def evaluate_cli_args(work, extra=()):
    return ([os.path.join(work, "model.npz"), os.path.join(work, "kitti"),
             "--device", "cpu"] + list(extra) + SIDES)


def _rank_evaluate_cli(mesh, work):
    from ground_plane_polling_tpu_torch.bin import evaluate

    out = {}
    for kind, extra in (("float", []), ("int8", ["--int8", "2"])):
        with _shrunk_detector(), contextlib.redirect_stdout(io.StringIO()):
            out[kind] = evaluate.main(evaluate_cli_args(
                work, ["--data-parallel"] + extra))
    return out


def _rank_restore(mesh, work):
    """A single process's checkpoint restores on every rank."""
    from ground_plane_polling_tpu_torch.training.checkpoint import (
        latest_checkpoint, restore_checkpoint)
    from ground_plane_polling_tpu_torch.training.train import (
        create_train_state, make_optimizer)

    model = _shrunk()
    state = restore_checkpoint(
        latest_checkpoint(os.path.join(work, "one_process")),
        create_train_state(model, make_optimizer(model)))
    return {"step": state.step, "lr": state.lr,
            "params": _record(model.named_parameters(), keep=False)}


def _rank_slices(mesh, work):
    from ground_plane_polling_tpu_torch.parallel import (
        initialize, is_multi_host, local_batch_slice, make_global_batch,
        make_global_raw_batch, make_replicated)

    initialize()  # the group is up: a no-op
    raw = make_global_raw_batch(mesh, {"images": np.arange(8).reshape(4, 2)})
    return {"slice": local_batch_slice(4), "odd_slice": local_batch_slice(5),
            "multi": is_multi_host(), "rows": make_global_batch(
                mesh, {"x": np.arange(4)})["x"].tolist(),
            "raw_images": raw["images"].tolist(),
            "replicated": make_replicated(mesh, np.arange(3)).tolist()}


SECTIONS = (("steps", _rank_steps), ("fused", _rank_fused),
            ("sweep", _rank_sweep), ("detect", _rank_detect),
            ("fit_plateau", _rank_fit_plateau), ("fit_nan", _rank_fit_nan),
            ("train_cli", _rank_train_cli),
            ("evaluate_cli", _rank_evaluate_cli), ("restore", _rank_restore),
            ("slices", _rank_slices))


def rank_main(rank, port, work):
    import torch.distributed as dist

    from ground_plane_polling_tpu_torch.parallel import (data_parallel_mesh,
                                                         initialize)

    initialize(f"localhost:{port}", WORLD, rank, device="cpu")
    mesh = data_parallel_mesh(device="cpu")
    out = {"rank": mesh.rank, "size": mesh.size, "errors": {}}
    for name, fn in SECTIONS:
        t0 = time.perf_counter()
        try:
            out[name] = fn(mesh, work)
        except Exception:  # recorded: the tests of this section fail
            out["errors"][name] = traceback.format_exc()
        print(f"rank {rank}: {name} {time.perf_counter() - t0:.1f} s",
              flush=True)
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()


# --- the pytest side --------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _prepared_batch(rows_with_boxes, seed=0):
    """A prepared global batch (numpy) from random annotations; rows given
    False get no annotation, so no positive anchor."""
    from ground_plane_polling_tpu_torch.data.pipeline import prepare_batch
    from tests.test_torch_targets import _annotations, _ignores

    rng = np.random.RandomState(seed)
    b = len(rows_with_boxes)
    anns, ams = zip(*(_annotations(rng, 3, 5, shape=SHAPE)
                      for _ in range(b)))
    ams = [m & keep for m, keep in zip(ams, rows_with_boxes)]
    igs, ims = zip(*(_ignores(rng, 1, 2, shape=SHAPE) for _ in range(b)))
    raw = {"images": rng.randint(0, 256, (b, *SHAPE, 3)).astype(np.uint8),
           "annotations": np.stack(anns), "ann_mask": np.stack(ams),
           "ignores": np.stack(igs), "ignore_mask": np.stack(ims),
           "valid": np.ones(b, bool),
           "sizes": np.tile(np.asarray(SHAPE, np.float32), (b, 1))}
    out = prepare_batch({k: torch.from_numpy(v) for k, v in raw.items()},
                        num_classes=1, augment=False, device="cpu")
    return {k: v.numpy() for k, v in out.items()}


def _one_process_checkpoint(work):
    """One fused step of a single process, checkpointed (for the ranks to
    restore)."""
    from ground_plane_polling_tpu_torch.models import load_weights
    from ground_plane_polling_tpu_torch.training.checkpoint import (
        save_checkpoint)
    from ground_plane_polling_tpu_torch.training.train import (
        create_train_state, make_fused_train_step, make_optimizer)

    loader = fused_loader(os.path.join(work, "kitti"))
    model = load_weights(_shrunk(), os.path.join(work, "model.npz"))
    state = create_train_state(model, make_optimizer(model, 2e-4))
    state, _ = make_fused_train_step(loader=loader)(
        state, next(iter(loader.epoch(prefetch=0))))
    state.lr = 3e-5
    save_checkpoint(os.path.join(work, "one_process"), state)
    return _record(model.named_parameters(), keep=False)["sha1"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The ranks' inputs: JAX-exported shrunk weights, two prepared global
    batches, a prepared split (train and val) labelled by a seeded shrunk
    detector and its weights, and a single process's checkpoint."""
    from ground_plane_polling_tpu.training.checkpoint import export_params
    from ground_plane_polling_tpu_torch.models import init_detector
    from ground_plane_polling_tpu_torch.training.checkpoint import (
        export_params as port_export)
    from tests.test_torch_fixtures import CLS_STD, make_prepared_split
    from tests.test_torch_model import randomized_variables, shrunk_jax_model

    work = str(tmp_path_factory.mktemp("dist"))
    variables = randomized_variables(shrunk_jax_model(), image_shape=SHAPE)
    export_params(os.path.join(work, "shrunk.npz"), variables)
    batches = {name: _prepared_batch(rows) for name, rows in BATCHES.items()}
    np.savez(os.path.join(work, "batches.npz"),
             **{f"{n}/{k}": v for n, b in batches.items()
                for k, v in b.items()})
    model = init_detector(_shrunk(), 0)
    out = model.classification.cls_out
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out.weight.copy_(torch.randn(out.weight.shape, generator=gen)
                         * CLS_STD)
        out.bias.zero_()
    port_export(os.path.join(work, "model.npz"), model)
    for subset in ("train", "val"):
        make_prepared_split(os.path.join(work, "kitti"), model.eval(),
                            subset=subset)
    restored = _one_process_checkpoint(work)
    return {"work": work, "variables": variables, "batches": batches,
            "restored": restored}


@pytest.fixture(scope="module")
def ranks(inputs):
    """Launch the two ranks once; each one's record of every section."""
    work, port = inputs["work"], _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               GPP_DIST_INIT_TIMEOUT=str(GROUP_TIMEOUT),
               COORDINATOR_ADDRESS=f"localhost:{port}",
               NUM_PROCESSES=str(WORLD))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(port), work],
        env=dict(env, PROCESS_ID=str(r)), cwd=work, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        with open(os.path.join(work, f"rank{r}.log"), "w") as f:
            f.write(log)
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    out = []
    for r in range(WORLD):
        path = os.path.join(work, f"rank{r}.pt")
        out.append(torch.load(path, weights_only=False))
        os.remove(path)
    return out


def _section(ranks, name):
    for r in ranks:
        assert name not in r["errors"], r["errors"][name]
    return [r[name] for r in ranks]


@pytest.fixture(scope="module")
def jax_steps(inputs):
    """JAX's make_sharded_train_step over data_parallel_mesh(2) on each
    batch, in float32 (loss terms) and in float64 (loss terms and the
    clipped gradients, which an optimizer of the clip and a pass-through
    that keeps its input as its state hands back)."""
    import functools

    import jax
    import jax.numpy as jnp
    import optax

    from ground_plane_polling_tpu.models.resnet import ResNetBackbone
    from ground_plane_polling_tpu.models.retinanet import GPPRetinaNet
    from ground_plane_polling_tpu.parallel import (data_parallel_mesh,
                                                   make_global_batch)
    from ground_plane_polling_tpu.training.train import (
        clip_per_tensor_norm, create_train_state, make_sharded_train_step)

    keep = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    tx = optax.chain(clip_per_tensor_norm(1e-3), keep)
    mesh = data_parallel_mesh(2)
    out = {name: {} for name in BATCHES}
    for dtype in (np.float32, np.float64):
        with jax.enable_x64(dtype == np.float64):
            model = GPPRetinaNet(
                backbone_fn=functools.partial(
                    ResNetBackbone, stage_sizes=SHRUNK, name="backbone",
                    dtype=dtype),
                feature_size=FEATURES, dtype=dtype)
            variables = jax.tree_util.tree_map(
                lambda a: np.asarray(a, dtype), inputs["variables"])
            step = make_sharded_train_step(model, tx, mesh)
            for name, batch in inputs["batches"].items():
                state, metrics = step(
                    create_train_state(variables, tx),
                    make_global_batch(mesh, {k: batch[k].astype(dtype)
                                             for k in BATCH_KEYS}))
                out[name][np.dtype(dtype).name] = {
                    "terms": {k: float(v) for k, v in metrics.items()},
                    "clipped": _flat(jax.device_get(state.opt_state[1]))}
    return out


def _flat(tree, prefix=""):
    out = {}
    for key, node in tree.items():
        if isinstance(node, dict):
            out.update(_flat(node, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.array(node)
    return out


@pytest.fixture(scope="module")
def one_process(inputs):
    """The port's single process on the same inputs."""
    from ground_plane_polling_tpu_torch.training.train import (
        make_fused_train_step, make_train_step)

    work = inputs["work"]
    out = {}
    for name, batch in inputs["batches"].items():
        out[name] = {dtype: run_steps(
            _sgd_state(os.path.join(work, "shrunk.npz"), dtype),
            make_train_step(clipnorm=NO_CLIP),
            {k: torch.from_numpy(batch[k].astype(dtype))
             for k in BATCH_KEYS}) for dtype in DTYPES}
    loader = fused_loader(os.path.join(work, "kitti"))
    state = _sgd_state(os.path.join(work, "model.npz"), "float64")
    step = make_fused_train_step(loader=loader, clipnorm=NO_CLIP)
    terms = []
    for raw in loader.epoch(prefetch=0):
        state, m = step(state, raw)
        terms.append({k: float(v) for k, v in m.items()})
    out["fused"] = {"terms": terms,
                    "params": _record(state.model.named_parameters())}
    return out


def _to_torch_name(path, value):
    parts = path.split("/")
    name = ".".join(parts[:-1])
    if parts[-1] == "kernel":
        return name + ".weight", value.transpose(3, 2, 0, 1)
    return name + ".bias", value


def _assert_terms(got, want):
    for k in TERMS:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k


def _assert_grads(got, want):
    assert set(got) == set(want)
    for name, g in want.items():
        norm = float(np.linalg.norm(g))
        np.testing.assert_allclose(got[name], g, rtol=0,
                                   atol=1e-3 * norm + 1e-30, err_msg=name)


def _assert_params(got, want):
    assert set(got) == set(want)
    for name, p in want.items():
        np.testing.assert_allclose(got[name], p, rtol=1e-5, atol=5e-7,
                                   err_msg=name)


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_two_ranks_step_matches_jax_sharded_step(ranks, jax_steps, name):
    """The 2-rank step against JAX's make_sharded_train_step over a
    2-device mesh: loss terms in float32 and float64, post-clip gradients
    (the port's clip of its gradients) in float64 (see the module's
    docstring)."""
    from ground_plane_polling_tpu_torch.training.train import (
        clip_per_tensor_norm)

    want = jax_steps[name]
    for got in _section(ranks, "steps"):
        for dtype in DTYPES:
            _assert_terms(got[name][dtype]["terms"], want[dtype]["terms"])
    got = _section(ranks, "steps")[0]  # rank 1's are bit-equal (below)
    grads = {n: torch.from_numpy(g.astype(np.float64)) for n, g in
             got[name]["float64"]["grads"]["values"].items()}
    clip_per_tensor_norm(list(grads.values()), 1e-3)
    clipped = dict(_to_torch_name(k, v) for k, v in
                   want["float64"]["clipped"].items())
    for norm in map(np.linalg.norm, clipped.values()):
        assert norm <= 1e-3 * (1 + 1e-6)
    _assert_grads({n: g.numpy() for n, g in grads.items()}, clipped)


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_two_ranks_step_matches_one_process(ranks, one_process, name):
    """float32: loss terms (each rank) and gradients (rank 0's; rank 1's
    are bit-equal) of the 2-rank step."""
    want = one_process[name]["float32"]
    for got in _section(ranks, "steps"):
        _assert_terms(got[name]["float32"]["terms"], want["terms"])
    got = _section(ranks, "steps")[0][name]["float32"]
    _assert_grads(got["grads"]["values"], want["grads"]["values"])


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_two_ranks_parameters_after_two_steps(ranks, one_process, name):
    """float64: the loss terms and the parameters after 2 steps (rank
    0's; rank 1's are bit-equal)."""
    want = one_process[name]["float64"]
    for got in _section(ranks, "steps"):
        _assert_terms(got[name]["float64"]["terms"], want["terms"])
    got = _section(ranks, "steps")[0][name]["float64"]
    _assert_params(got["params"]["values"], want["params"]["values"])


def test_ranks_step_on_two_rows_and_hold_one_gradient(ranks):
    """Each rank steps on 2 of the 4 rows; DDP leaves the same reduced
    gradients and parameters on both."""
    r0, r1 = _section(ranks, "steps")
    for name in BATCHES:
        for dtype in DTYPES:
            a, b = r0[name][dtype], r1[name][dtype]
            assert a["rows"] == b["rows"] == 2
            for key in ("grads", "params"):
                assert a[key]["sha1"] == b[key]["sha1"], (name, dtype, key)


def test_unbalanced_batch_leaves_one_rank_without_positives(ranks,
                                                            one_process):
    """The batch that holds a local normalizer to account: rank 1 sees no
    positive anchor, rank 0 all of them."""
    r0, r1 = (r["unbalanced"]["float32"] for r in _section(ranks, "steps"))
    assert r1["positives"] == 0
    assert r0["positives"] == \
        one_process["unbalanced"]["float32"]["positives"] > 0


def test_fused_augmented_steps_match_one_process(ranks, one_process):
    """Raw batches of KittiLoader(mesh=...) (2 rows a rank, augmentation
    drawn for the whole batch) through the fused step: the single
    process's terms and parameters after the epoch's 2 steps."""
    want = one_process["fused"]
    ranks = _section(ranks, "fused")
    for got in ranks:
        assert got["rows"] == [2, 2]
        assert len(got["terms"]) == len(want["terms"]) == 2
        for g, w in zip(got["terms"], want["terms"]):
            _assert_terms(g, w)
        assert got["params"]["sha1"] == ranks[0]["params"]["sha1"]
    _assert_params(ranks[0]["params"]["values"], want["params"]["values"])


@pytest.fixture(scope="module")
def batch_1_sweeps(inputs):
    from ground_plane_polling_tpu_torch.training.loop import evaluate_model

    model, loader = eval_setup(inputs["work"])
    return {kind: evaluate_model(model, loader, eval_batch=1,
                                 int8_calib=calib)
            for kind, calib in (("float", 0), ("int8", 2))}


def _assert_sweep(got, want):
    (ap, errors, aps), (want_ap, want_errors, want_aps) = got, want
    assert ap == want_ap and 0.0 < ap <= 1.0
    assert errors == pytest.approx(want_errors, rel=1e-6, abs=1e-9)
    assert sorted(aps) == sorted(want_aps)


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_two_rank_sweep_equals_batch_1_sweep(ranks, batch_1_sweeps, kind):
    """5 images in two padded shapes, groups of 2: a short group padded
    by repeating its last image; every rank returns the batch-1 sweep's
    mAP and errors."""
    for got in _section(ranks, "sweep"):
        _assert_sweep(got[kind], batch_1_sweeps[kind])


def test_detect_fn_gathers_the_whole_batch(ranks, inputs):
    """make_detect_fn(mesh=...): each rank runs one image, and both return
    the single process's outputs for the two images."""
    from ground_plane_polling_tpu_torch.inference import make_detect_fn

    model, loader = eval_setup(inputs["work"])
    images, P_inv, planes = eval_pair(loader)
    detect = make_detect_fn(model, images.shape[1:3], device_preprocess=True,
                            with_pose=True)
    rows = [detect(images[i:i + 1], P_inv[i:i + 1], planes[i:i + 1])
            for i in range(2)]
    for got in _section(ranks, "detect"):
        for k in rows[0]._fields:
            want = np.concatenate([getattr(r, k).numpy() for r in rows])
            assert got[k].dtype == want.dtype, k
            np.testing.assert_array_equal(got[k], want, k)


def test_fit_ranks_take_one_plateau_decision(ranks):
    """Alone, rank 0's flat loss would cut the lr after epoch 1; fit
    reduces the ranks' metrics once an epoch, so both follow their mean
    (falling) and keep the lr."""
    r0, r1 = _section(ranks, "fit_plateau")
    assert r0["step"] == r1["step"] == 3
    assert r0["lr"] == r1["lr"] == pytest.approx(0.1)


def test_fit_nan_on_one_rank_stops_every_rank(ranks):
    for got in _section(ranks, "fit_nan"):
        assert got["raised"] and "non-finite loss in epoch 0" in \
            got["raised"]


@pytest.fixture(scope="module")
def train_cli_one_process(inputs):
    """The same bin/train run in one process (2 rows a step)."""
    from ground_plane_polling_tpu_torch.bin import train

    buf = io.StringIO()
    with _shrunk_detector(), contextlib.redirect_stdout(buf):
        state = train.main(train_cli_args(inputs["work"], "one"))
    return {"step": state.step, "record": _printed_record(buf.getvalue())}


def test_train_cli_two_ranks_match_one_process(ranks, train_cli_one_process):
    """bin/train --data-parallel (--remat, --tensorboard-dir, augmentation,
    the validation sweep): both ranks log the single process's loss terms
    and one mAP."""
    want = train_cli_one_process["record"]
    got = [g["record"] for g in _section(ranks, "train_cli")]
    for record in got:
        assert record["step"] == 2 and record["epoch"] == 0
        _assert_terms(record, want)
    assert got[0]["mAP"] == got[1]["mAP"] and 0.0 <= got[0]["mAP"] <= 1.0
    assert got[0]["checkpoint"] == got[1]["checkpoint"]


def test_only_rank_0_writes_files(ranks, inputs):
    """Both ranks were given the same paths: one log line, one event file,
    one checkpoint."""
    _section(ranks, "train_cli")
    run = os.path.join(inputs["work"], "dp")
    with open(os.path.join(run, "log.jsonl")) as f:
        assert len(f.read().splitlines()) == 1
    assert len(os.listdir(os.path.join(run, "tb"))) == 1
    assert os.listdir(os.path.join(run, "snaps")) == ["step_00000002.pt"]


def test_two_rank_checkpoint_restores_in_one_process(ranks, inputs):
    """The checkpoint holds the unwrapped module's names (no `module.`),
    restores strictly into one process, and bin/train --snapshot auto goes
    on from it there."""
    from ground_plane_polling_tpu_torch.bin import train
    from ground_plane_polling_tpu_torch.training.checkpoint import (
        restore_checkpoint)
    from ground_plane_polling_tpu_torch.training.train import (
        create_train_state, make_optimizer)

    _section(ranks, "train_cli")
    work = inputs["work"]
    path = os.path.join(work, "dp", "snaps", "step_00000002.pt")
    names = torch.load(path, weights_only=True)["model"]
    assert not [k for k in names if k.startswith("module.")]
    model = _shrunk(remat=True)
    state = restore_checkpoint(path, create_train_state(
        model, make_optimizer(model)))
    assert state.step == 2
    args = train_cli_args(work, "dp", ["--snapshot", "auto",
                                       "--no-evaluation", "--steps", "1"])
    with _shrunk_detector(), contextlib.redirect_stdout(io.StringIO()):
        assert train.main(args).step == 3


def test_one_process_checkpoint_restores_on_every_rank(ranks, inputs):
    for got in _section(ranks, "restore"):
        assert got["step"] == 1 and got["lr"] == pytest.approx(3e-5)
        assert got["params"]["sha1"] == inputs["restored"]


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_evaluate_cli_data_parallel_equals_one_process(ranks, inputs, kind):
    """bin/evaluate --data-parallel on two ranks: the single process's
    --eval-batch 1 results."""
    from ground_plane_polling_tpu_torch.bin import evaluate

    extra = ["--int8", "2"] if kind == "int8" else []
    with _shrunk_detector(), contextlib.redirect_stdout(io.StringIO()):
        want_ap, want_errors = evaluate.main(evaluate_cli_args(
            inputs["work"], ["--eval-batch", "1"] + extra))
    for got_ap, got_errors in (g[kind] for g in
                               _section(ranks, "evaluate_cli")):
        assert got_ap == want_ap
        assert got_errors == pytest.approx(want_errors, rel=1e-6, abs=1e-9)


def test_batch_slices_on_two_ranks(ranks):
    """local_batch_slice's (start, size) (floored, as JAX's), the rows
    make_global_batch and make_global_raw_batch keep, a replicated value
    whole, rank by rank."""
    for rank, got in enumerate(_section(ranks, "slices")):
        assert got["multi"] is True
        assert tuple(got["slice"]) == (2 * rank, 2)
        assert tuple(got["odd_slice"]) == (2 * rank, 2)
        assert got["rows"] == [2 * rank, 2 * rank + 1]
        assert got["raw_images"] == [[4 * rank, 4 * rank + 1],
                                     [4 * rank + 2, 4 * rank + 3]]
        assert got["replicated"] == [0, 1, 2]


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
