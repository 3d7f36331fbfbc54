"""The data-parallel mesh: the ranks of one torch.distributed process group
that share each batch (port of ground_plane_polling_tpu/parallel/mesh.py).

JAX runs one SPMD program over a 1-D 'data' mesh of devices, the batch
sharded over it and the parameters replicated; XLA inserts the gradient
all-reduce. Here one process drives one device: `data_parallel_mesh()`
holds the process group, its size, this process's rank and its device.
Every rank is handed the same full batch and keeps its rows (`shard_batch`);
replicated values stay whole. The training step wraps the model in
DistributedDataParallel over the mesh's group (training/train.py).

A mesh made without an initialized process group is one rank with no
collectives: the single-process path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

__all__ = ["DataParallelMesh", "Sharding", "data_parallel_mesh",
           "batch_sharding", "replicated_sharding", "shard_batch",
           "check_mesh", "rank_device"]


def rank_device(device="cuda", rank: Optional[int] = None) -> torch.device:
    """The device of this process: rank r drives cuda:(r % cards) when
    `device` is "cuda" without an index; an indexed device or the CPU is
    kept. A missing card raises."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for, but CUDA is not "
                           "available")
    if device.index is not None:
        return device
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


class DataParallelMesh(NamedTuple):
    """`size` ranks of process group `group` (None: no process group, one
    rank) share a batch; this process is `rank` and runs on `device`."""
    group: Optional[object]
    size: int
    rank: int
    device: torch.device

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of n (n must divide by the size)."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not divide over "
                             f"{self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place; enqueued on the device's
        stream with NCCL (the host does not wait)."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' `t` (each this rank's rows of a batch) concatenated
        in rank order, on every rank: each rank writes its rows into a
        zeroed batch and the batches are summed (exact: every entry adds
        zeros), one collective for any backend and dtype."""
        if self.group is None:
            return t
        n = t.shape[0]
        out = t.new_zeros((n * self.size, *t.shape[1:]))
        out[self.rank * n:(self.rank + 1) * n] = t
        return self.all_reduce(out)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """`t` of the mesh's rank 0 on every rank, in place."""
        if self.group is not None:
            dist.broadcast(t, src=dist.get_global_rank(self.group, 0),
                           group=self.group)
        return t

    def barrier(self) -> None:
        if self.group is None:
            return
        if dist.get_backend(self.group) == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def data_parallel_mesh(n_devices: Optional[int] = None, device="cuda",
                       group=None) -> DataParallelMesh:
    """The mesh of `group` (default: the initialized default group, else
    one rank without collectives) on this rank's `device` (rank_device).
    `n_devices`, if given, must be the group's size: one process drives
    one device, so a mesh of n devices is a launch of n processes."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    size = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"a mesh of {n_devices} devices was asked for, but the process "
            f"group has {size} ranks: one process drives one device, so "
            f"launch NUM_PROCESSES={n_devices} processes")
    return DataParallelMesh(group, size, rank, rank_device(device))


def check_mesh(mesh) -> Optional[DataParallelMesh]:
    if mesh is not None and not isinstance(mesh, DataParallelMesh):
        raise TypeError(f"mesh must come from data_parallel_mesh(), got "
                        f"{type(mesh).__name__}")
    return mesh


class Sharding(NamedTuple):
    """How a value lies on the mesh: its rows split over the ranks
    (`batch`), or whole on every rank."""
    mesh: DataParallelMesh
    batch: bool

    def place(self, x) -> torch.Tensor:
        """This rank's part of x (a tensor or array) on the mesh's device."""
        x = torch.as_tensor(x)
        if self.batch:
            x = x[self.mesh.rows(x.shape[0])]
        return x.to(self.mesh.device, non_blocking=True)


def batch_sharding(mesh: DataParallelMesh) -> Sharding:
    """Leading axis split over the ranks."""
    return Sharding(check_mesh(mesh), True)


def replicated_sharding(mesh: DataParallelMesh) -> Sharding:
    return Sharding(check_mesh(mesh), False)


def _tree_map(fn, tree):
    """fn on every leaf of a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: DataParallelMesh, batch):
    """Every array of `batch` (the full batch, the same on every rank)
    with this rank's rows on the mesh's device."""
    return _tree_map(batch_sharding(mesh).place, batch)
