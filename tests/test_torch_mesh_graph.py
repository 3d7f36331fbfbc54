"""The parts of the mesh paths' compiled form that run on the CPU: the
width layer's forward without a read back to the host (which a CUDA-graph
capture refuses), the choice between captured and eager mesh paths
(`parallel.mesh.capturable`), made once when a step or detect function is
built, and the eager mesh paths that gloo and the CPU keep.

Where no NCCL exists (this machine's torch.distributed has gloo only), a
stand-in group answers the backend query. The captured paths themselves
need a card: tests/test_torch_gpu.py (`gpu` marker) runs them.

Tolerances: the width-split forward on one rank against the unsplit
model, float64, within rtol 1e-12 / atol 1e-12 (its convs run on windows
padded apart from the conv, which may sum in another order); a one-rank
mesh's detect call against the plain call, float64: labels and
orientations equal, every float field within 1e-9 of its largest
|value|.
"""

import re
import types

import numpy as np
import pytest
import torch

from ground_plane_polling_tpu_torch.inference import make_detect_fn
from ground_plane_polling_tpu_torch.models import GPPRetinaNet, init_detector
from ground_plane_polling_tpu_torch.models.resnet import ResNetBackbone
from ground_plane_polling_tpu_torch.models.tiny import TinyBackbone
from ground_plane_polling_tpu_torch.parallel import mesh as mesh_module
from ground_plane_polling_tpu_torch.parallel.mesh import (DataParallelMesh,
                                                          capturable)
from ground_plane_polling_tpu_torch.parallel.spatial import SpatialModel
from ground_plane_polling_tpu_torch.training import train
from ground_plane_polling_tpu_torch.training.train import (
    DDP_WARMUP, CapturedTrainStep, make_fused_train_step,
    make_sharded_train_step, make_train_step)

torch.set_num_threads(2)

# backbone -> canvas: the shrunk ResNet's FPN upsamples C5's 6 columns to
# 11 ('nearest-exact', not a repeat); tiny's P-levels double
CANVASES = {"resnet": (64, 176), "tiny": (64, 128)}


def _detector(backbone, dtype=torch.float64):
    """Seeded detector (FPN 64) with every conv bias drawn non-zero, so
    each padded column is load-bearing."""
    net = (ResNetBackbone((1, 1, 1, 1)) if backbone == "resnet"
           else TinyBackbone())
    model = init_detector(GPPRetinaNet(net, backbone_channels=net.channels,
                                       feature_size=64), 0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.uniform_(-0.1, 0.1, generator=gen)
    return model.to(dtype).eval()


def _images(canvas, b=2, dtype=torch.float64):
    rng = np.random.RandomState(0)
    return torch.from_numpy(rng.normal(0, 40, (b, 3, *canvas))).to(dtype)


def _one_rank(device="cpu", group=None):
    return DataParallelMesh(group, 1, 0, torch.device(device))


def _stand_in(monkeypatch, backend):
    """A process group whose backend query answers `backend`."""
    group = types.SimpleNamespace(backend=backend)
    monkeypatch.setattr(mesh_module.dist, "get_backend",
                        lambda g=None: g.backend)
    return group


@pytest.mark.parametrize("backbone", sorted(CANVASES))
def test_width_forward_reads_nothing_back(backbone, monkeypatch):
    """A SpatialModel on a one-rank mesh without a process group runs the
    whole width layer, the FPN's upsamplings included, from the tables
    read at set-up: with Tensor.tolist, .item, .cpu and .numpy raising,
    its head outputs equal the unsplit model's."""
    model = _detector(backbone)
    canvas = CANVASES[backbone]
    spatial = SpatialModel(model, _one_rank(), canvas)
    assert any(kind == "upsample" for kind, _ in spatial.widths)
    assert sorted(spatial.tables) == [
        i for i, (kind, _) in enumerate(spatial.widths) if kind == "upsample"]
    images = _images(canvas)
    with torch.no_grad():
        want = model(images)

    def host_read(self, *args, **kwargs):
        raise AssertionError("the width layer read a tensor back")

    for name in ("tolist", "item", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    with torch.no_grad():
        got = spatial(images[..., spatial.columns()])
    monkeypatch.undo()
    assert spatial.last.at == len(spatial.widths)
    for key, w in want.items():
        torch.testing.assert_close(got[key], w, rtol=1e-12, atol=1e-12,
                                   msg=key)


@pytest.mark.parametrize("device,backend,want", [
    ("cuda", "nccl", True), ("cuda", None, True), ("cuda", "gloo", False),
    ("cpu", "nccl", False), ("cpu", "gloo", False), ("cpu", None, False),
], ids=["card_nccl", "card_no_group", "card_gloo", "cpu_nccl", "cpu_gloo",
        "cpu_no_group"])
def test_capture_predicate(monkeypatch, device, backend, want):
    """Captured on a card with an NCCL group or none; eager with gloo
    (its collectives cannot be captured) and on the CPU. The group's
    backend is a stand-in's."""
    group = None if backend is None else _stand_in(monkeypatch, backend)
    assert capturable(_one_rank(device, group), device) is want


@pytest.mark.parametrize("device,want", [("cuda", True), ("cpu", False)])
def test_capture_predicate_without_a_mesh(device, want):
    assert capturable(None, device) is want


STEP_FACTORIES = {
    "make_train_step": lambda mesh: make_train_step(mesh=mesh),
    "make_sharded_train_step": lambda mesh: make_sharded_train_step(mesh),
    "make_fused_train_step": lambda mesh: make_fused_train_step(
        num_classes=1, mesh=mesh),
}
# a card with gloo (two ranks sharing it), and the CPU whatever its group
EAGER_MESHES = {"card_gloo": ("cuda", "gloo"), "cpu_nccl": ("cpu", "nccl"),
                "cpu_gloo": ("cpu", "gloo"), "cpu_no_group": ("cpu", None)}


@pytest.mark.parametrize("mesh_kind", sorted(EAGER_MESHES))
@pytest.mark.parametrize("factory", sorted(STEP_FACTORIES))
def test_mesh_train_step_stays_eager(monkeypatch, factory, mesh_kind):
    """make_train_step, make_sharded_train_step and make_fused_train_step
    on a gloo mesh or a CPU mesh give the eager step: step.eager is
    step, whatever torch.cuda says."""
    device, backend = EAGER_MESHES[mesh_kind]
    group = None if backend is None else _stand_in(monkeypatch, backend)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    step = STEP_FACTORIES[factory](_one_rank(device, group))
    assert not isinstance(step, CapturedTrainStep)
    assert step.eager is step


@pytest.mark.parametrize("backend,warmup", [("nccl", DDP_WARMUP),
                                            (None, 1)],
                         ids=["nccl", "no_group"])
@pytest.mark.parametrize("factory", sorted(STEP_FACTORIES))
def test_mesh_train_step_on_a_card_is_captured(monkeypatch, factory,
                                               backend, warmup):
    """On a card, an NCCL mesh (a stand-in here) or a mesh without a group
    gives a CapturedTrainStep, built without touching the card: DDP's
    eager warm-up steps before the first capture with a group, one
    without."""
    group = None if backend is None else _stand_in(monkeypatch, backend)
    step = STEP_FACTORIES[factory](_one_rank("cuda", group))
    assert isinstance(step, CapturedTrainStep) and step.eager is not step
    assert step._warmup == warmup and not step.graphs


@pytest.mark.parametrize("backend", ["nccl", "gloo", None],
                         ids=["nccl", "gloo", "no_group"])
@pytest.mark.parametrize("shard_spatial", [False, True],
                         ids=["data_parallel", "shard_spatial"])
def test_mesh_detect_on_the_cpu_stays_eager(monkeypatch, shard_spatial,
                                            backend):
    """make_detect_fn(mesh=..., shard_spatial=...) on a CPU mesh is the
    eager call (detect.eager is detect), whatever the group's backend;
    under shard_spatial detect.spatial is its SpatialModel."""
    group = None if backend is None else _stand_in(monkeypatch, backend)
    detect = make_detect_fn(_detector("tiny", torch.float32),
                            CANVASES["tiny"], mesh=_one_rank("cpu", group),
                            shard_spatial=shard_spatial)
    assert detect.eager is detect
    assert (detect.spatial is not None) is shard_spatial


@pytest.mark.parametrize("shard_spatial", [False, True],
                         ids=["data_parallel", "shard_spatial"])
@pytest.mark.parametrize("backbone", sorted(CANVASES))
def test_one_rank_mesh_detect_equals_plain(backbone, shard_spatial):
    """The eager mesh call on one rank without a process group (its rows,
    or its columns, selected, then the same call on them) against the
    plain call, float64 with pose: labels and orientations equal, every
    float field within 1e-9 of the field's largest |value| (the width
    layer's convs run on padded windows)."""
    model = _detector(backbone)
    canvas = CANVASES[backbone]
    rng = np.random.RandomState(2)
    args = (rng.randint(0, 256, (2, *canvas, 3)).astype(np.uint8),
            np.tile(np.linalg.pinv(np.array(
                [[721.5, 0, 609.6, 44.9], [0, 721.5, 172.9, 0.2],
                 [0, 0, 1, 0.003]]))[None], (2, 1, 1)).astype(np.float32),
            np.tile(np.array([[0.0, 1.0, 0.0, -1.65]] * 4, np.float32)[None],
                    (2, 1, 1)))
    kwargs = dict(with_pose=True, device_preprocess=True, device="cpu",
                  score_threshold=0.0)
    want = make_detect_fn(model, canvas, **kwargs)(*args)
    got = make_detect_fn(model, canvas, mesh=_one_rank(),
                         shard_spatial=shard_spatial, **kwargs)(*args)
    assert (want.scores > 0).any()
    for key, w in want._asdict().items():
        g = getattr(got, key)
        if key in ("labels", "orientations"):
            assert torch.equal(g, w), key
            continue
        w, g = w.double().numpy(), g.double().numpy()
        tol = 1e-9 * max(float(np.nanmax(np.abs(w))), 1.0)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=key)


def _gloo_group():
    """A 1-rank gloo group on a free localhost port."""
    import socket

    import torch.distributed as dist

    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)


@pytest.mark.parametrize("has_setter", [True, False],
                         ids=["setter", "no_setter"])
def test_replicas_stop_ddp_timing_events(has_setter):
    """The DDP wrapper of a mesh step samples no runtime timing past its
    first iterations (events recorded at a sampled iteration would land in
    a capture): the reducer's sample rate is set past any run's length
    through DDP's private setter (torch 1.10 to 2.13 have it). A torch
    without the setter makes the wrapper raise, naming the version,
    rather than capture timing events."""
    import torch.distributed as dist

    _gloo_group()
    try:
        mesh = mesh_module.data_parallel_mesh(device="cpu")
        model = torch.nn.Linear(3, 2)
        rates = []
        real = torch.nn.parallel.DistributedDataParallel

        class Spy(real):
            if has_setter:
                def _set_ddp_runtime_logging_sample_rate(self, rate):
                    rates.append(rate)
                    return super()._set_ddp_runtime_logging_sample_rate(rate)
            else:
                _set_ddp_runtime_logging_sample_rate = None

        torch.nn.parallel.DistributedDataParallel = Spy
        try:
            if has_setter:
                ddp = train._Replicas(mesh)(model)
            else:
                with pytest.raises(RuntimeError,
                                   match=re.escape(torch.__version__)):
                    train._Replicas(mesh)(model)
        finally:
            torch.nn.parallel.DistributedDataParallel = real
        if has_setter:
            assert isinstance(ddp, real) and ddp.module is model
            assert rates == [2**31 - 1]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class _Graph:
    """Stands in for a torch.cuda.CUDAGraph: records its reset."""

    def __init__(self, log):
        self.log = log

    def reset(self):
        self.log.append("reset")


def _captured(kind, log, monkeypatch):
    """A CapturedTrainStep or CapturedDetect holding two stand-in graphs,
    with torch.cuda.synchronize recorded (no card here)."""
    from ground_plane_polling_tpu_torch.inference import CapturedDetect

    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: log.append(("sync", device)))
    graphs = {k: types.SimpleNamespace(graph=_Graph(log)) for k in "ab"}
    if kind == "step":
        obj = CapturedTrainStep(lambda state, batch: None, None)
        obj._stream = types.SimpleNamespace(device="cuda:0")
    else:
        obj = CapturedDetect.__new__(CapturedDetect)
        obj.device = "cuda:0"
    obj.graphs = graphs
    return obj


@pytest.mark.parametrize("kind", ["step", "detect"])
def test_release_waits_then_frees_every_graph(kind, monkeypatch):
    """release() waits for the card, then resets every graph (which frees
    the collectives it captured) and forgets them, so a later call
    captures anew; a second release, or one with no graph, does
    nothing."""
    log = []
    obj = _captured(kind, log, monkeypatch)
    obj.release()
    assert log == [("sync", "cuda:0"), "reset", "reset"]
    assert obj.graphs == {}
    obj.release()
    assert len(log) == 3


@pytest.mark.parametrize("with_group", [True, False],
                         ids=["group", "no_group"])
def test_shutdown_releases_then_ends_the_group(with_group, monkeypatch):
    """parallel.shutdown(*captured) releases every captured step and call
    it is given (and passes over an eager one, which holds no graph), then
    destroys the default group where one is up (without one it only
    releases)."""
    import torch.distributed as dist

    from ground_plane_polling_tpu_torch.parallel import shutdown

    log = []
    step, detect = (_captured(k, log, monkeypatch)
                    for k in ("step", "detect"))
    if with_group:
        _gloo_group()
    try:
        shutdown(step, lambda *args: None, detect)
        assert not step.graphs and not detect.graphs
        assert log.count("reset") == 4
        assert not dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
