"""The port's parallel/ package in one process: the launch guards of
initialize() (counterpart of test_distributed_guards.py), the mesh without
a process group, batch slices against the JAX package's local_batch_slice,
the global-batch placements, and KittiLoader(mesh=...) whose ranks' rows
together are the single process's batch, augmentation included. The 2-rank
runs are in test_torch_distributed.py."""

import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.parallel import distributed as jax_distributed
from ground_plane_polling_tpu_torch.data.kitti import KittiDataset
from ground_plane_polling_tpu_torch.data.pipeline import KittiLoader
from ground_plane_polling_tpu_torch.parallel import (
    batch_sharding, data_parallel_mesh, initialize, is_multi_host,
    local_batch_slice, make_global_batch, make_global_raw_batch,
    make_replicated, replicated_sharding, shard_batch)
from ground_plane_polling_tpu_torch.parallel import distributed
from ground_plane_polling_tpu_torch.parallel.mesh import (DataParallelMesh,
                                                          check_mesh)
from ground_plane_polling_tpu_torch.training import losses

from .test_torch_fixtures import make_prepared_split
from .test_torch_model import shrunk_torch_model

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _rank(rank, size):
    """A rank of a `size`-rank mesh, without a process group (enough for
    everything that only slices)."""
    return DataParallelMesh(None, size, rank, CPU)


def test_initialize_rejects_broken_multihost_env(monkeypatch):
    """COORDINATOR_ADDRESS and a nonzero PROCESS_ID without NUM_PROCESSES
    is a broken launch: it raises, as the JAX package's initialize does."""
    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:9999")
    monkeypatch.setenv("PROCESS_ID", "1")
    monkeypatch.delenv("NUM_PROCESSES", raising=False)
    with pytest.raises(ValueError, match="NUM_PROCESSES"):
        initialize(device="cpu")
    with pytest.raises(ValueError, match="NUM_PROCESSES"):
        jax_distributed.initialize()


@pytest.mark.parametrize("env", [
    {}, {"COORDINATOR_ADDRESS": "127.0.0.1:9999"},
    {"COORDINATOR_ADDRESS": "127.0.0.1:9999", "NUM_PROCESSES": "1",
     "PROCESS_ID": "0"}], ids=["nothing", "coordinator", "one-process"])
def test_initialize_without_a_launch_is_a_no_op(monkeypatch, env):
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    initialize(device="cpu")
    assert not torch.distributed.is_initialized() and not is_multi_host()


def test_mesh_without_a_process_group():
    mesh = data_parallel_mesh(device="cpu")
    assert mesh == DataParallelMesh(None, 1, 0, CPU)
    t = torch.arange(3.0)
    assert mesh.all_reduce(t) is t and mesh.gather_rows(t) is t
    mesh.barrier()
    with pytest.raises(ValueError, match="NUM_PROCESSES=2"):
        data_parallel_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            data_parallel_mesh()
    with pytest.raises(TypeError, match="data_parallel_mesh"):
        check_mesh(object())


class _Group:
    """torch.distributed's queries of an initialized group of `size`."""

    def __init__(self, size, rank):
        self.size, self.rank = size, rank

    def is_initialized(self):
        return True

    def get_world_size(self):
        return self.size

    def get_rank(self):
        return self.rank


@pytest.mark.parametrize("global_batch,size", [(4, 2), (8, 4), (6, 3),
                                               (5, 2), (2, 1)])
def test_local_batch_slice_matches_jax(monkeypatch, global_batch, size):
    """(start, size) for every rank, as the JAX package's local_batch_slice
    gives for the same process count and index; a mesh's rows are the
    same where the batch divides."""
    assert local_batch_slice(global_batch) == (0, global_batch)
    for rank in range(size):
        monkeypatch.setattr(jax_distributed.jax, "process_count",
                            lambda: size)
        monkeypatch.setattr(jax_distributed.jax, "process_index",
                            lambda: rank)
        monkeypatch.setattr(distributed, "dist", _Group(size, rank))
        want = jax_distributed.local_batch_slice(global_batch)
        assert local_batch_slice(global_batch) == want
        if global_batch % size == 0:
            rows = _rank(rank, size).rows(global_batch)
            assert (rows.start, rows.stop - rows.start) == want


def test_global_batch_placements():
    batch = {"x": np.arange(12).reshape(6, 2), "y": [torch.arange(6)]}
    for rank in range(3):
        mesh = _rank(rank, 3)
        got = make_global_batch(mesh, batch)
        assert got["x"].tolist() == batch["x"][2 * rank:2 * rank + 2].tolist()
        assert got["y"][0].tolist() == [2 * rank, 2 * rank + 1]
        assert shard_batch(mesh, batch)["x"].tolist() == got["x"].tolist()
        raw = make_global_raw_batch(mesh, {"images": batch["x"]})
        assert raw["images"].tolist() == got["x"].tolist()
        assert make_replicated(mesh, batch["x"]).shape == (6, 2)
        assert replicated_sharding(mesh).place(batch["x"]).shape == (6, 2)
        assert batch_sharding(mesh).batch
    with pytest.raises(ValueError, match="does not divide over 4 ranks"):
        shard_batch(_rank(0, 4), batch)


def test_global_terms_of_one_rank_are_the_losses():
    """A mesh of one rank without a process group: the global terms are
    the plain normalized losses and the differentiated share is the same
    number."""
    rng = np.random.RandomState(0)
    parts = {"a": (torch.tensor(3.5, requires_grad=True), torch.tensor(0.0)),
             "b": (torch.tensor(float(rng.rand())), torch.tensor(7.0))}
    local, terms = losses.global_terms(parts, data_parallel_mesh(
        device="cpu"))
    for k, v in parts.items():
        assert float(terms[k]) == float(losses.normalized(v))
        assert float(local[k]) == float(terms[k])
    local["a"].backward()
    assert float(parts["a"][0].grad) == 1.0  # count floored at 1


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    make_prepared_split(root, shrunk_torch_model().eval(), subset="train")
    return root


@pytest.mark.parametrize("raw_batches", [True, False],
                         ids=["raw", "prepared"])
@pytest.mark.parametrize("world", [2, 4])
def test_ranks_rows_make_the_single_process_batch(kitti_root, raw_batches,
                                                  world):
    """Every rank builds the same groups and seeds; its rows (augmentation
    drawn for the whole group) concatenate to the single process's
    batches, bit for bit, filler rows included."""
    ds = KittiDataset(kitti_root, "train")
    kw = dict(batch_size=4, image_min_side=64, image_max_side=224,
              augment=True, raw_batches=raw_batches, seed=5, device="cpu")
    want = list(KittiLoader(ds, **kw).epoch(prefetch=0))
    ranks = [list(KittiLoader(ds, mesh=_rank(r, world), **kw).epoch(
        prefetch=0)) for r in range(world)]
    assert len(want) == 2 and all(len(r) == len(want) for r in ranks)
    for i, batch in enumerate(want):
        for key, value in batch.items():
            parts = [r[i][key] for r in ranks]
            assert all(p.shape[0] == 4 // world for p in parts)
            assert torch.equal(torch.cat(parts), value), key
    # 5 frames in two padded shapes: groups of 3 and 2 frames, 3 filler rows
    fillers = sum(int((~b["valid"]).sum()) if raw_batches else
                  int((b["labels"] == -1).flatten(1).all(1).sum())
                  for b in want)
    assert fillers == 3


def test_loader_refuses_a_batch_the_ranks_do_not_divide(kitti_root):
    ds = KittiDataset(kitti_root, "train")
    with pytest.raises(ValueError, match="batch size 3 does not divide "
                                         "over the 2 data-parallel ranks"):
        KittiLoader(ds, batch_size=3, mesh=_rank(0, 2), device="cpu")
