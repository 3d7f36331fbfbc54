"""Training orchestration and the validation sweep (port of
ground_plane_polling_tpu/training/loop.py).

`fit` runs the epochs: steps over the loader, a NaN guard, the validation
sweep (`evaluate_model`: per-bucket VOC AP, mean AP over the buckets that
hold annotations, keypoint/h/w/l L1 errors), reduce-on-plateau on the
epoch's mean loss, checkpoints, a JSONL log and, optionally, TensorBoard
event files.

Data parallel (a mesh from parallel.data_parallel_mesh): every rank runs
`fit` and the sweep; the epoch's metrics are all-reduced once an epoch,
so the NaN guard and the plateau schedule decide alike on every rank; the
sweep runs mesh-sized groups, each rank its rows; only rank 0 writes the
log, the events and the checkpoints.
"""

from __future__ import annotations

import itertools
import json
import os
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..inference import make_detect_fn
from ..models.quantize import collect_scales_uint8
from ..parallel.mesh import check_mesh
from ..utils.eval import (bucket_annotations, bucket_detections,
                          evaluate_detections)
from .checkpoint import (AsyncCheckpointSaver, checkpoint_path,
                         prune_checkpoints, save_checkpoint)
from .schedule import ReduceLROnPlateau
from .train import TrainState

__all__ = ["evaluate_model", "fit"]


def evaluate_model(model, loader, num_classes: int = 1,
                   score_threshold: float = 0.05, max_detections: int = 100,
                   iou_threshold: float = 0.5, mesh=None,
                   eval_batch: int = 1, int8_calib: int = 0,
                   int8_percentile: float = 100.0, **detect_kwargs):
    """Full validation sweep of `model` (models.GPPRetinaNet, placed on its
    device) over `loader.eval_inputs()` -> (mean_ap, errors dict,
    per-bucket APs).

    Images of one padded shape are grouped `eval_batch` at a time; a short
    last group is padded by repeating its last item, and the padding rows
    are discarded. One group stays in flight: the next group is dispatched
    before the previous one is read back. Results equal the batch-1 sweep.

    `int8_calib` > 0 calibrates int8 activation scales on the first that
    many eval images (absmax, or `int8_percentile` of |x|) and runs every
    conv int8 (models/quantize.py).

    With `mesh`, groups are mesh-sized (`eval_batch` is ignored): each
    rank runs its rows of a group and every rank gathers the whole group
    and returns the same results (int8 on rank 0's scales).
    """
    check_mesh(mesh)
    if int8_calib:
        canvases = [item["image"] for item in
                    itertools.islice(loader.eval_inputs(), int8_calib)]
        scales = collect_scales_uint8(model, canvases,
                                      percentile=int8_percentile)
        if mesh is not None:
            scales = mesh.broadcast(torch.as_tensor(
                scales, device=mesh.device)).cpu().numpy()
        detect_kwargs["quant_scales"] = scales
    detect_fns = {}
    # device_preprocess defaults to the image dtype: uint8 images get the
    # cast and mean subtraction on the device, float images are taken as
    # already preprocessed; an explicit caller kwarg wins
    device_preprocess = detect_kwargs.pop("device_preprocess", None)

    def get_detect(shape, image_dtype):
        dp = device_preprocess
        if dp is None:
            dp = np.dtype(image_dtype) == np.uint8
            if not dp:
                warnings.warn(
                    "evaluate_model: float eval images are assumed to be "
                    "already preprocessed (device-side BGR-mean "
                    "subtraction disabled). If your loader yields RAW "
                    "float BGR images, pass device_preprocess=True.",
                    stacklevel=3)
        key = (shape, dp)
        if key not in detect_fns:
            detect_fns[key] = make_detect_fn(
                model, shape, num_classes=num_classes,
                score_threshold=score_threshold,
                max_detections=max_detections, device_preprocess=dp,
                mesh=mesh, **detect_kwargs)
        return detect_fns[key]

    group_size = mesh.size if mesh is not None else max(int(eval_batch), 1)
    detections, annotations = [], []

    def dispatch(shape, items):
        n = len(items)
        items = items + [items[-1]] * (group_size - n)
        out = get_detect(shape, items[0]["image"].dtype)(
            torch.from_numpy(np.concatenate([it["image"] for it in items])),
            torch.from_numpy(np.concatenate([it["P_inv"] for it in items])),
            torch.from_numpy(np.concatenate([it["planes"] for it in items])))
        return n, items, out

    def finalize(flight):
        n, items, out = flight
        boxes, dims, scores, labels, orients = (
            t.cpu().numpy() for t in (out.boxes, out.dims, out.scores,
                                      out.labels, out.orientations))
        for j in range(n):
            scale = items[j]["scale"]
            detections.append(bucket_detections(
                boxes[j] / scale, dims[j], scores[j], labels[j], orients[j],
                num_classes))
            annotations.append(bucket_annotations(
                np.asarray(items[j]["annotations"]) /
                np.array([scale] * 12 + [1.0] * 5), num_classes))

    in_flight = None

    def process(shape, items):
        nonlocal in_flight
        dispatched = dispatch(shape, items)
        if in_flight is not None:
            finalize(in_flight)
        in_flight = dispatched

    pending = {}
    for item in loader.eval_inputs():
        shape = tuple(item["image"].shape[1:3])
        pending.setdefault(shape, []).append(item)
        if len(pending[shape]) == group_size:
            process(shape, pending.pop(shape))
    for shape, items in pending.items():
        process(shape, items)
    if in_flight is not None:
        finalize(in_flight)

    aps, kp_err, h_err, w_err, l_err = evaluate_detections(
        detections, annotations, 4 * num_classes, iou_threshold)
    present = [ap for ap, n in aps.values() if n > 0]
    mean_ap = float(np.mean(present)) if present else 0.0
    errors = {"keypoint_error": kp_err, "height_error": h_err,
              "width_error": w_err, "length_error": l_err}
    return mean_ap, errors, aps


def _six_digits(record: dict) -> dict:
    """Floats to 6 significant digits (a fixed number of decimals would
    print a reduced lr of 1e-6 as 0.0)."""
    return {k: (float(f"{v:.6g}") if isinstance(v, float) else v)
            for k, v in record.items()}


def fit(model, state: TrainState, train_step: Callable, train_loader,
        epochs: int = 50, steps_per_epoch: Optional[int] = None,
        val_loader=None, num_classes: int = 1,
        checkpoint_dir: Optional[str] = None,
        log_path: Optional[str] = None,
        tensorboard_dir: Optional[str] = None,
        lr_schedule: Optional[ReduceLROnPlateau] = None,
        verbose: bool = True,
        nan_guard: bool = True,
        keep_checkpoints: int = 5,
        checkpoint_every: int = 1,
        eval_mesh=None,
        async_checkpoints: bool = True):
    """Run the training loop; returns the final TrainState.

    Each step's metrics stay device tensors, read back once per epoch.
    nan_guard: a non-finite loss aborts the run (after logging) before
    anything is checkpointed. The last epoch always checkpoints; with
    async_checkpoints the save in flight is joined, and old checkpoints
    pruned (keep_checkpoints <= 0 keeps all), before the next one and
    before fit returns. The validation sweep runs the model as it is, in
    float32 (also after bf16 training steps, which autocast).
    tensorboard_dir mirrors each epoch's scalars into TensorBoard event
    files (utils/tensorboard.py).

    Data parallel: `eval_mesh` is the train step's mesh: the sweep runs
    on it and the epoch's metrics are reduced over it; rank 0 alone writes
    files, and every rank waits at a barrier after a save.
    """
    mesh = check_mesh(eval_mesh)
    lead = mesh is None or mesh.rank == 0  # the rank that writes files
    lr_schedule = lr_schedule or ReduceLROnPlateau()
    saver = AsyncCheckpointSaver() if async_checkpoints and lead else None
    if log_path and lead and os.path.dirname(log_path):
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
    log_f = open(log_path, "a") if log_path and lead else None
    tb_writer = None
    if tensorboard_dir and lead:
        from ..utils.tensorboard import TensorBoardWriter
        tb_writer = TensorBoardWriter(tensorboard_dir)

    def log(record):
        if tb_writer and "epoch" in record:
            tb_writer.add_scalars(
                {k: v for k, v in record.items() if k != "epoch"},
                record["epoch"])
            tb_writer.flush()
        record = _six_digits(record)
        if log_f:
            log_f.write(json.dumps(record) + "\n")
            log_f.flush()
        if verbose:
            print(record, flush=True)

    try:
        for epoch in range(epochs):
            t0 = time.time()
            metrics = []
            it = iter(train_loader.epoch())
            step_count = steps_per_epoch or len(train_loader)
            for _ in range(step_count):
                try:
                    batch = next(it)
                except StopIteration:
                    it = iter(train_loader.epoch())
                    try:
                        batch = next(it)
                    except StopIteration:
                        raise RuntimeError(
                            "training loader yielded no batches — empty "
                            "dataset or a failed input pipeline") from None
                state, m = train_step(state, batch)
                metrics.append(m)
            if not metrics:
                raise RuntimeError(
                    "epoch ran zero steps (steps_per_epoch=0 or empty "
                    "loader) — nothing to train on")
            # one read-back per epoch (and, data parallel, one reduction:
            # every rank then decides alike below)
            keys = list(metrics[0])
            values = torch.stack([torch.stack([m[k] for k in keys])
                                  for m in metrics]).float()
            if mesh is not None:
                values = mesh.all_reduce(values) / mesh.size
            values = values.cpu().numpy()
            per_step = {k: values[:, i].tolist() for i, k in enumerate(keys)}
            if nan_guard and not np.isfinite(per_step["loss"]).all():
                bad = int(np.argmax(~np.isfinite(per_step["loss"])))
                log({"epoch": epoch, "error": "non-finite loss",
                     "first_bad_step": bad,
                     "loss_values": per_step["loss"]})
                raise FloatingPointError(
                    f"non-finite loss in epoch {epoch} (first at step "
                    f"{bad}); aborting before checkpointing corrupt state")
            losses = {k: float(np.mean(v)) for k, v in per_step.items()}
            record = {"epoch": epoch, "step": state.step, "lr": state.lr,
                      "seconds": round(time.time() - t0, 2), **losses}

            if val_loader is not None:
                mean_ap, errors, _ = evaluate_model(model, val_loader,
                                                    num_classes=num_classes,
                                                    mesh=mesh)
                record.update({"mAP": mean_ap, **errors})

            state, reduced = lr_schedule.update(state, losses["loss"])
            if reduced:
                record["lr_reduced_to"] = state.lr

            if checkpoint_dir and ((epoch + 1) % max(checkpoint_every, 1) == 0
                                   or epoch == epochs - 1):
                if not lead:
                    record["checkpoint"] = checkpoint_path(checkpoint_dir,
                                                           state.step)
                elif saver is not None:
                    # join the last save and prune BEFORE the next one: a
                    # crash mid-write leaves the last complete checkpoint
                    saver.wait()
                    prune_checkpoints(checkpoint_dir, keep=keep_checkpoints)
                    record["checkpoint"] = saver.save(checkpoint_dir, state)
                else:
                    record["checkpoint"] = save_checkpoint(checkpoint_dir,
                                                           state)
                    prune_checkpoints(checkpoint_dir, keep=keep_checkpoints)
                if mesh is not None:
                    mesh.barrier()
            log(record)
    finally:
        if saver is not None:
            saver.wait()
            if checkpoint_dir:  # the last save skipped its own prune
                prune_checkpoints(checkpoint_dir, keep=keep_checkpoints)
        if log_f:
            log_f.close()
        if tb_writer:
            tb_writer.close()
    if mesh is not None:  # rank 0's last checkpoint is on disk for all
        mesh.barrier()
    return state
