"""Process-group start-up and global batches for data-parallel runs (port
of ground_plane_polling_tpu/parallel/distributed.py).

One process drives one device. Launch one process per card, each with
the JAX package's variables:

    COORDINATOR_ADDRESS=host:port NUM_PROCESSES=N PROCESS_ID=r \
        python -m ground_plane_polling_tpu_torch.bin.train --data-parallel ...

`initialize()` then starts torch.distributed (NCCL for a CUDA device,
gloo for the CPU) and rank r uses cuda:(r % the cards it sees). Without
a coordinator it does nothing, so training code calls it unconditionally.

"Global" batches: every rank is handed the same full batch (built from a
shared seed or a shared filesystem) and keeps its `local_batch_slice`
rows; replicated values stay whole.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import rank_device, replicated_sharding, shard_batch

__all__ = ["initialize", "is_multi_host", "local_batch_slice",
           "make_global_batch", "make_replicated", "make_global_raw_batch"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device="cuda") -> None:
    """torch.distributed.init_process_group with env-var fallbacks
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID); a no-op when they
    are unset, for a single process, or when a group is already up.

    `backend` defaults to NCCL for a CUDA `device` and gloo for the CPU
    (two ranks that share one card need gloo: NCCL refuses them).
    GPP_DIST_INIT_TIMEOUT (seconds, default 900) bounds the start-up."""
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if coordinator_address is None or dist.is_initialized():
        return
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", 1))
    process_id = process_id if process_id is not None else int(
        os.environ.get("PROCESS_ID", 0))
    if num_processes <= 1:
        if process_id:
            # coordinator + nonzero rank but num_processes<=1 is a broken
            # launch (NUM_PROCESSES forgotten): silently proceeding would
            # train N independent copies clobbering each other's output
            raise ValueError(
                f"COORDINATOR_ADDRESS={coordinator_address} and "
                f"PROCESS_ID={process_id} are set but num_processes is "
                f"{num_processes} — set NUM_PROCESSES on every host")
        return
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(rank_device(device, process_id))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(
            seconds=int(os.environ.get("GPP_DIST_INIT_TIMEOUT", 900))))


def is_multi_host() -> bool:
    """More than one process in the default group."""
    return dist.is_initialized() and dist.get_world_size() > 1


def local_batch_slice(global_batch: int):
    """(start, size) of this rank's rows of a global batch."""
    if not dist.is_initialized():
        return 0, global_batch
    per_host = global_batch // dist.get_world_size()
    return dist.get_rank() * per_host, per_host


def make_global_batch(mesh, batch):
    """This rank's rows of every array of `batch` (each rank passes the
    FULL global batch), on the mesh's device."""
    return shard_batch(mesh, batch)


def make_replicated(mesh, x):
    """`x` (the same full array on every rank), whole, on the mesh's
    device."""
    return replicated_sharding(mesh).place(x)


def make_global_raw_batch(mesh, raw):
    """Global placement of a raw batch (KittiLoader(raw_batches=True)
    layout, the full batch on every rank): every array keeps this rank's
    rows. (JAX's raw batch also carries a replicated PRNG key; the port's
    draws each row's augmentation on the host, so it has none.)"""
    return shard_batch(mesh, raw)
