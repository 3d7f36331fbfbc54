"""Checkpoint save/restore and the portable weight export (port of
ground_plane_polling_tpu/training/checkpoint.py).

A checkpoint is one file `step_{step:08d}.pt` written by `torch.save`: a
dict of the step, the model's state dict, the optimizer's state dict and
the lr. The JAX package's orbax checkpoint directories do not load here:
the format the two packages share is the flat `.npz` of `export_params` /
`import_params` (models/weights.py), into which the JAX package's
convert_model (`ground_plane_polling_tpu/bin/convert_model.py`) turns an
orbax checkpoint: `convert_model <dir> out.npz`.

Files hold the unwrapped module's parameter names: a model wrapped in
DistributedDataParallel is saved, exported and restored through its
`.module`, so a data-parallel checkpoint restores in one process and the
reverse.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch

from ..models.weights import (export_jax_params, load_jax_params, load_npz,
                              state_to_jax_params)
from .train import TrainState

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_checkpoint",
           "prune_checkpoints", "export_params", "import_params",
           "checkpoint_params", "checkpoint_path", "AsyncCheckpointSaver"]


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    """The file of the checkpoint at `step` under `ckpt_dir`."""
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{int(step):08d}.pt")


def _unwrapped(model):
    """The module inside a DistributedDataParallel wrapper (its state dict
    would prefix every name with `module.`)."""
    from torch.nn.parallel import DistributedDataParallel

    return model.module if isinstance(model, DistributedDataParallel) \
        else model


def _steps(ckpt_dir: str):
    return sorted(f for f in os.listdir(ckpt_dir)
                  if f.startswith("step_") and f.endswith(".pt"))


def _tree(fn, value):
    """fn applied to every tensor of a nest of dicts, lists and tuples."""
    if isinstance(value, torch.Tensor):
        return fn(value)
    if isinstance(value, dict):
        return {k: _tree(fn, v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_tree(fn, v) for v in value)
    return value


def _snapshot(state: TrainState) -> dict:
    """The state as a dict of tensors, copied on their device, that share
    no storage with the live model and optimizer: the next step updates
    those in place."""
    def copy(value):
        return _tree(lambda t: t.detach().clone(), value)

    return {"step": int(state.step), "lr": state.lr,
            "model": copy(_unwrapped(state.model).state_dict()),
            "optimizer": copy(state.optimizer.state_dict())}


def _to_cpu(snapshot: dict) -> dict:
    return _tree(lambda t: t.cpu(), snapshot)


def _write(path: str, snapshot: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(snapshot, tmp)
    os.replace(tmp, path)  # a crash mid-write leaves no torn checkpoint


def save_checkpoint(ckpt_dir: str, state: TrainState) -> str:
    path = checkpoint_path(ckpt_dir, int(state.step))
    _write(path, _to_cpu(_snapshot(state)))
    return path


class AsyncCheckpointSaver:
    """Write checkpoints on a thread while training goes on.

    save() copies the state on its device before it returns (the optimizer
    updates the live parameters and moments in place at the next step, so
    they cannot be read later) and hands the copy to a writer thread that
    moves it to the host and writes it. The copies are enqueued on the
    device's default stream, before any later step's kernels. One save is
    in flight at a time: a second save() (or wait()) joins the first, and a
    writer failure is re-raised there.
    """

    def __init__(self):
        self._thread = None
        self._error = None
        self._path = None

    def save(self, ckpt_dir: str, state: TrainState) -> str:
        self.wait()
        path = checkpoint_path(ckpt_dir, int(state.step))
        snapshot = _snapshot(state)

        def _run():
            try:
                _write(path, _to_cpu(snapshot))
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, name="gpp-ckpt-writer",
                                        daemon=True)
        self._thread.start()
        self._path = path
        return path

    def wait(self) -> Optional[str]:
        """Join the save in flight, if any; returns its path."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            # a failed save is not the last good checkpoint
            self._path = None
            raise RuntimeError("async checkpoint save failed") from err
        return self._path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return os.path.join(os.path.abspath(ckpt_dir), steps[-1]) if steps else None


def prune_checkpoints(ckpt_dir: str, keep: int = 5) -> int:
    """Delete all but the newest `keep` checkpoints; returns the count
    removed. keep <= 0 disables pruning."""
    if keep <= 0 or not os.path.isdir(ckpt_dir):
        return 0
    old = _steps(ckpt_dir)[:-keep]
    for f in old:
        os.remove(os.path.join(ckpt_dir, f))
    return len(old)


def _load_optimizer(optimizer, saved: dict) -> None:
    """Load the optimizer state dict `saved` into `optimizer` in place: the
    live moments, step counts and lr tensors keep their identity (a
    captured train step's graphs read them), and so do the live groups'
    settings (capturable, the lr's device and dtype), so a checkpoint from
    another device or with a float lr and a CPU step count loads. Moments
    the checkpoint lacks start afresh (zeros)."""
    live_state, live_groups = optimizer.state, optimizer.param_groups
    optimizer.load_state_dict(dict(saved, param_groups=[
        {**group, **{k: v for k, v in live.items() if k != "params"}}
        for group, live in zip(saved["param_groups"], live_groups,
                               strict=True)]))
    for group, live in zip(optimizer.param_groups, live_groups):
        group["lr"] = live["lr"]
    for p, loaded in optimizer.state.items():
        kept = live_state[p]
        for k, v in loaded.items():
            if torch.is_tensor(kept.get(k)):
                kept[k].copy_(v)
            else:
                kept[k] = v
    for p, kept in live_state.items():
        if p not in optimizer.state:
            for t in kept.values():
                t.zero_()
    optimizer.state = live_state


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint file into `state` (its model and optimizer, on
    their devices, written in place) and return it."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (a JAX orbax checkpoint?): orbax "
            "checkpoints do not load here; the JAX package's convert_model "
            "(ground_plane_polling_tpu/bin/convert_model.py) turns one into "
            f"an .npz: convert_model {path} out.npz, which import_params "
            "loads")
    model = _unwrapped(state.model)
    device = next(model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(ckpt["model"], strict=True)
    _load_optimizer(state.optimizer, ckpt["optimizer"])
    state.step = int(ckpt["step"])
    state.lr = float(ckpt["lr"])
    return state


def export_params(path: str, model) -> None:
    """Write the model's weights as the JAX package's flat .npz."""
    np.savez(path, **export_jax_params(_unwrapped(model)))


def checkpoint_params(path: str) -> dict:
    """The model of a `step_*.pt` checkpoint as the JAX package's flat
    .npz arrays (what `export_params` writes for the live model)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return state_to_jax_params(ckpt["model"])


def import_params(path: str) -> dict:
    """The JAX package's .npz -> a state dict for the port's detector."""
    return load_jax_params(load_npz(path))
