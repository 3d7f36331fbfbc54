"""The port's training orchestration on the CPU: the train-mode KittiLoader
against the JAX package's (use_native_loader=False in both, same seed), the
prefetch thread, ReduceLROnPlateau against JAX's, checkpoints (round trip,
the async saver's copy, pruning, resume), fit's NaN guard, and the
bin/train CLI on the prepared fixture split."""

import hashlib
import json
import os
import re
import shutil
import threading
import time
import urllib.error
from collections import namedtuple

import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.data.kitti import KittiDataset as JaxDataset
from ground_plane_polling_tpu.data.pipeline import KittiLoader as JaxLoader
from ground_plane_polling_tpu.training.schedule import (
    ReduceLROnPlateau as JaxPlateau)
from ground_plane_polling_tpu_torch.bin import train as train_cli
from ground_plane_polling_tpu_torch.data.kitti import KittiDataset
from ground_plane_polling_tpu_torch.data.pipeline import KittiLoader
from ground_plane_polling_tpu_torch import models
from ground_plane_polling_tpu_torch.models import (h5_export, h5_import,
                                                   imagenet, init_detector,
                                                   load_weights)
from ground_plane_polling_tpu_torch.training import checkpoint
from ground_plane_polling_tpu_torch.training.loop import fit
from ground_plane_polling_tpu_torch.training.schedule import ReduceLROnPlateau
from ground_plane_polling_tpu_torch.training.train import (
    TrainState, create_train_state, make_fused_train_step, make_optimizer)

from .fixtures import make_synthetic_kitti
from .test_torch_fixtures import CLS_STD, make_prepared_split
from .test_torch_model import shrunk_torch_model

torch.set_num_threads(2)

RAW_KEYS = ("images", "annotations", "ann_mask", "ignores", "ignore_mask",
            "valid", "sizes")
LOADER = dict(batch_size=2, image_min_side=64, image_max_side=224,
              max_annotations=4, max_ignore=2)


@pytest.fixture(scope="module")
def mixed_root(tmp_path_factory):
    """A synthetic split of 7 train frames in two padded-shape buckets:
    5 of 416x128 (the last group short) and 2 of mixed aspect ratio."""
    from PIL import Image

    root = make_synthetic_kitti(str(tmp_path_factory.mktemp("kitti")),
                                n_images=6)
    train = os.path.join(root, "train")
    src = sorted(os.listdir(os.path.join(train, "images")))[0]
    for i, size in enumerate(((300, 140), (290, 140))):
        name = f"9{i:05d}"
        Image.open(os.path.join(train, "images", src)).resize(size).save(
            os.path.join(train, "images", name + ".png"))
        for kind in ("labels", "calibs"):
            shutil.copyfile(
                os.path.join(train, kind, src.replace(".png", ".txt")),
                os.path.join(train, kind, name + ".txt"))
    return root


def _loaders(root, **kw):
    port = KittiLoader(KittiDataset(root, "train"), raw_batches=True,
                       device="cpu", use_native_loader=False, **LOADER, **kw)
    jax_ = JaxLoader(JaxDataset(root, "train"), raw_batches=True,
                     use_native_loader=False, **LOADER, **kw)
    return port, jax_


@pytest.mark.parametrize("seed", [0, 3])
def test_train_loader_matches_jax(mixed_root, seed):
    """Groups, shuffled group order over two epochs, and every raw array
    (uint8 canvas, padded annotations and ignores, masks, valid, sizes)
    equal to the JAX loader's."""
    port, jax_ = _loaders(mixed_root, seed=seed)
    assert port._groups == jax_._groups
    assert len(port) == len(jax_) == 4  # 3 groups of 5 frames, 1 of 2
    assert port.image_shape == jax_.image_shape
    assert len({port._bucket_shape[i] for i in port._bucket_shape}) == 2
    for _ in range(2):
        got = list(port.epoch(prefetch=0))
        want = list(jax_.epoch(prefetch=0))
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            for key in RAW_KEYS:
                gv = g[key].numpy()
                assert gv.dtype == w[key].dtype, key
                np.testing.assert_array_equal(gv, w[key], err_msg=key)


def test_partial_last_batch_valid(mixed_root):
    """A short group repeats its last frame; `valid` marks the filler, and
    the two-stage preparation gives it state -1 in all three targets."""
    port, _ = _loaders(mixed_root, shuffle=False)
    short = [i for i, (_, n) in enumerate(port._groups) if n < 2]
    assert short
    batches = list(port.epoch(prefetch=0))
    for i, b in enumerate(batches):
        n = port._groups[i][1]
        assert b["valid"].tolist() == [True] * n + [False] * (2 - n)
    two = KittiLoader(KittiDataset(mixed_root, "train"), device="cpu",
                      shuffle=False, **LOADER)
    prepared = list(two.epoch(prefetch=0))[short[0]]
    assert (prepared["labels"][1] == -1).all()
    assert (prepared["regression"][1, :, 12] == -1).all()
    assert (prepared["regression_dim"][1, :, 3] == -1).all()
    assert (prepared["labels"][0] != -1).any()
    seen = [i for idxs, n in port._groups for i in idxs[:n]]
    assert sorted(seen) == list(range(len(port.ds)))


def test_producer_error_propagates_and_abandoned_epoch_releases(mixed_root):
    port, _ = _loaders(mixed_root, shuffle=False)
    before = threading.active_count()
    for _ in range(3):
        it = port.epoch(prefetch=2)
        next(it)
        it.close()  # abandon mid-epoch
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "producer threads leaked"

    calls = {"n": 0}
    real = port._load_padded

    def failing(idx):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("corrupt image")
        return real(idx)

    port._load_padded = failing
    with pytest.raises(RuntimeError, match="corrupt image"):
        list(port.epoch(prefetch=2))
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_reduce_lr_on_plateau_matches_jax():
    JaxState = namedtuple("JaxState", "lr")
    losses = [10.0, 9.0, 9.2, 9.1, 5.0, 5.0, 5.00005, 5.0, 4.0, 4.5, 4.4,
              4.3, 4.2, 4.1]
    for kw in ({}, {"cooldown": 1, "min_lr": 2e-8}, {"patience": 1}):
        jax_sched, sched = JaxPlateau(**kw), ReduceLROnPlateau(**kw)
        jax_state = JaxState(lr=np.float32(1e-5))
        state = _tiny_state(lr=1e-5)
        for loss in losses:
            jax_state, jax_red = jax_sched.update(jax_state, loss)
            state, red = sched.update(state, loss)
            assert red == jax_red, (kw, loss)
            assert state.lr == pytest.approx(float(jax_state.lr), rel=1e-6)
            assert all(g["lr"] == state.lr
                       for g in state.optimizer.param_groups)


def _tiny_state(lr=1e-3):
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3),
                                torch.nn.Conv2d(4, 2, 1))
    torch.manual_seed(0)
    return create_train_state(model, torch.optim.Adam(
        model.parameters(), lr=lr), learning_rate=lr)


def _one_step(state):
    state.optimizer.zero_grad()
    state.model(torch.ones(1, 3, 5, 5)).square().sum().backward()
    state.optimizer.step()
    state.step += 1
    return state


def _assert_same_state(a, b):
    assert a.step == b.step and a.lr == b.lr
    for (k, v), (_, w) in zip(a.model.state_dict().items(),
                              b.model.state_dict().items()):
        assert torch.equal(v, w), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(sb["state"][i][k])), k


def test_checkpoint_round_trip(tmp_path):
    state = _one_step(_tiny_state())
    state.lr = 3e-4
    path = checkpoint.save_checkpoint(str(tmp_path / "ckpt"), state)
    assert os.path.basename(path) == "step_00000001.pt"
    assert checkpoint.latest_checkpoint(str(tmp_path / "ckpt")) == path
    other = _tiny_state(lr=1.0)
    restored = checkpoint.restore_checkpoint(path, other)
    _assert_same_state(restored, state)
    with pytest.raises(NotImplementedError,
                       match=r"JAX package's convert_model "
                       r"\(ground_plane_polling_tpu/bin/convert_model\.py\) "
                       r"turns one into an \.npz: convert_model "
                       + re.escape(str(tmp_path)) + r" out\.npz, which "
                       r"import_params loads"):
        checkpoint.restore_checkpoint(str(tmp_path), other)
    # the weights' .npz export round trip
    model = shrunk_torch_model()
    npz = str(tmp_path / "w.npz")
    checkpoint.export_params(npz, model)
    again = checkpoint.import_params(npz)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(again[k], v, rtol=1e-6, atol=1e-7)


def test_async_saver_copies_before_the_next_step(tmp_path, monkeypatch):
    """save() copies the state before it returns: the writer, held back
    until the live weights have been updated in place again, still writes
    the values of the moment of save()."""
    state = _one_step(_tiny_state())
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    go = threading.Event()
    real = checkpoint._to_cpu

    def held(value):
        assert go.wait(10)
        return real(value)

    monkeypatch.setattr(checkpoint, "_to_cpu", held)
    saver = checkpoint.AsyncCheckpointSaver()
    path = saver.save(str(tmp_path / "ckpt"), state)
    _one_step(state)  # the next in-place step
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    go.set()
    assert saver.wait() == path
    saved = torch.load(path, weights_only=True)
    assert saved["step"] == 1
    for k, v in want.items():
        assert torch.equal(saved["model"][k], v), k
    # a writer failure is raised on wait(), and its path forgotten
    blocker = tmp_path / "blocked"
    blocker.write_text("a file, not a directory")
    saver.save(str(blocker / "sub"), state)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        saver.wait()
    assert saver.wait() is None


def test_prune_checkpoints(tmp_path):
    d = tmp_path / "snaps"
    d.mkdir()
    for s in (10, 20, 30):
        (d / f"step_{s:08d}.pt").write_bytes(b"x")
    (d / "step_00000040.pt.tmp").write_bytes(b"x")  # a write in progress
    assert checkpoint.prune_checkpoints(str(d), keep=2) == 1
    assert checkpoint.prune_checkpoints(str(d), keep=0) == 0
    assert checkpoint.prune_checkpoints(str(d), keep=-3) == 0
    assert sorted(os.listdir(d)) == ["step_00000020.pt", "step_00000030.pt",
                                     "step_00000040.pt.tmp"]
    assert checkpoint.latest_checkpoint(str(d)).endswith("step_00000030.pt")


def _shrunk_fit_state(weights):
    model = load_weights(shrunk_torch_model(), weights)
    return create_train_state(model, make_optimizer(model, 1e-4))


@pytest.fixture(scope="module")
def shrunk_weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "shrunk.npz")
    checkpoint.export_params(path, init_detector(shrunk_torch_model(), 1))
    return path


def test_resume_two_plus_two_equals_four(mixed_root, shrunk_weights,
                                         tmp_path):
    """fit for 4 steps equals fit for 2, a checkpoint, a restore into fresh
    objects and 2 more (the loader repeats its batches: no shuffle, no
    augmentation)."""
    def loader():
        return KittiLoader(KittiDataset(mixed_root, "train"), shuffle=False,
                           raw_batches=True, device="cpu", **LOADER)

    def run(state, epochs, ckpt):
        ldr = loader()
        return fit(state.model, state, make_fused_train_step(loader=ldr),
                   ldr, epochs=epochs, steps_per_epoch=2,
                   checkpoint_dir=ckpt, verbose=False)

    four = run(_shrunk_fit_state(shrunk_weights), 2, None)
    ckpt = str(tmp_path / "ckpt")
    run(_shrunk_fit_state(shrunk_weights), 1, ckpt)
    resumed = checkpoint.restore_checkpoint(
        checkpoint.latest_checkpoint(ckpt), _shrunk_fit_state(shrunk_weights))
    assert resumed.step == 2
    two_two = run(resumed, 1, ckpt)
    assert two_two.step == four.step == 4
    for (k, a), b in zip(four.model.named_parameters(),
                         two_two.model.parameters()):
        assert torch.equal(a, b), k
    assert os.path.basename(checkpoint.latest_checkpoint(ckpt)) == \
        "step_00000004.pt"


def test_nan_guard_aborts_before_checkpointing(tmp_path):
    state = _tiny_state()

    class Loader:
        def __len__(self):
            return 3

        def epoch(self):
            return iter([{}] * 3)

    def step(state, batch):
        state.step += 1
        bad = torch.tensor(float("nan") if state.step == 2 else 1.0)
        return state, {"loss": bad, "regression": bad}

    log = tmp_path / "log.jsonl"
    with pytest.raises(FloatingPointError, match="first at step 1"):
        fit(state.model, state, step, Loader(), epochs=2,
            checkpoint_dir=str(tmp_path / "ckpt"), log_path=str(log),
            verbose=False)
    assert not (tmp_path / "ckpt").exists()
    record = json.loads(log.read_text().splitlines()[-1])
    assert record["error"] == "non-finite loss"
    assert record["first_bad_step"] == 1

    class Empty(Loader):
        def epoch(self):
            return iter([])

    with pytest.raises(RuntimeError, match="no batches"):
        fit(state.model, state, step, Empty(), epochs=1, verbose=False)


@pytest.fixture(scope="module")
def cli_split(tmp_path_factory):
    """The prepared fixture split with train and val subsets, labels from
    the detections of a seeded shrunk detector (classification out kernel
    redrawn as `resnet50_weights` does, so scores pass the threshold), and
    that detector's .npz."""
    tmp = tmp_path_factory.mktemp("cli")
    weights = str(tmp / "model.npz")
    model = init_detector(shrunk_torch_model(), 0)
    out = model.classification.cls_out
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out.weight.copy_(torch.randn(out.weight.shape, generator=gen)
                         * CLS_STD)
        out.bias.zero_()
    checkpoint.export_params(weights, model)
    root = str(tmp / "kitti")
    for subset in ("train", "val"):
        make_prepared_split(root, model.eval(), subset=subset)
    return weights, root


SIDES = ["--image-min-side", "64", "--image-max-side", "224"]


def test_train_cli_one_epoch_then_resume(cli_split, tmp_path, monkeypatch):
    """bin/train --device cpu: one epoch of 2 steps with augmentation and
    the validation sweep, a checkpoint, then --snapshot auto carries the
    step count on. The CLI builds the shrunk detector here (the full
    ResNet-50 runs on the card in chip_smoke.py's phase 7d)."""
    monkeypatch.setattr(models, "build_detector",
                        lambda backbone, num_classes=1, remat=False:
                        shrunk_torch_model(num_classes, remat))
    weights, root = cli_split
    snaps, log = str(tmp_path / "snaps"), str(tmp_path / "log.jsonl")
    common = ["--weights", weights, "--device", "cpu", "--snapshot-path",
              snaps, "--log-path", log, "--epochs", "1", "--batch-size", "2"]
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        state = train_cli.main(["--steps", "2", "--random-transform"]
                               + common + SIDES + ["kitti", root])
        assert state.step == 2
        assert os.path.basename(checkpoint.latest_checkpoint(snaps)) == \
            "step_00000002.pt"
        record = json.loads(open(log).read().splitlines()[0])
        assert record["epoch"] == 0 and np.isfinite(record["loss"])
        assert 0.0 <= record["mAP"] <= 1.0 and "keypoint_error" in record
        state = train_cli.main(["--steps", "1", "--no-evaluation",
                                "--no-fused-prepare", "--snapshot", "auto"]
                               + common + SIDES + ["kitti", root])
        assert state.step == 3
        assert os.path.basename(checkpoint.latest_checkpoint(snaps)) == \
            "step_00000003.pt"
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


@pytest.mark.parametrize("flag,item", [
    pytest.param("--backbone-h5", "backbone", id="flag3-A10b"),
    pytest.param("--imagenet-weights", "backbone", id="flag4-A17"),
    pytest.param("--weights", "all", id="flag5-A10b")])
def test_train_cli_unported_options_raise(cli_split, tmp_path, monkeypatch,
                                          flag, item):
    """The weight options that raised before the h5 import was ported:
    --weights x.h5 loads the whole detector from a reference Keras h5,
    --backbone-h5 lays an h5's backbone over the seeded init (FPN and heads
    keep it), and --imagenet-weights does the same with the md5-checked
    file of the weights cache, fetching nothing; without a cached file and
    without network it raises and names --backbone-h5. The CLI builds the
    shrunk detector (and the h5 tables take its stages); the model that
    reaches fit is checked exactly."""
    monkeypatch.setattr(models, "build_detector",
                        lambda backbone, num_classes=1, remat=False:
                        shrunk_torch_model(num_classes, remat))
    monkeypatch.setitem(h5_import._KNOWN_STAGES, "resnet50", (1, 1, 1, 1))
    weights, root = cli_split
    source = load_weights(shrunk_torch_model(), weights)
    h5 = str(tmp_path / "ResNet-50-model.keras.h5")
    h5_export.export_reference_h5(source, h5)

    def no_network(url, dest):
        raise urllib.error.URLError("no route to host")

    monkeypatch.setattr(imagenet, "_fetch", no_network)
    monkeypatch.setenv("GPP_WEIGHTS_CACHE", str(tmp_path / "cache"))
    argv = {"--backbone-h5": ["--backbone-h5", h5],
            "--imagenet-weights": ["--imagenet-weights"],
            "--weights": ["--weights", h5]}[flag]
    if flag == "--imagenet-weights":
        with pytest.raises(RuntimeError, match="backbone-h5"):
            train_cli.main(["--device", "cpu"] + argv + ["kitti", root])
        assert os.listdir(tmp_path / "cache") == []  # no partial file left
        shutil.copyfile(h5, tmp_path / "cache" / os.path.basename(h5))
        monkeypatch.setitem(imagenet._CHECKSUMS, "resnet50", hashlib.md5(
            open(h5, "rb").read()).hexdigest())
    seen = {}

    def fake_fit(model, state, *args, **kwargs):
        seen["state"] = {k: v.detach().clone()
                         for k, v in model.state_dict().items()}
        return state

    monkeypatch.setattr("ground_plane_polling_tpu_torch.training.loop.fit",
                        fake_fit)
    train_cli.main(["--device", "cpu", "--no-evaluation"] + argv
                   + ["kitti", root])
    want = source.state_dict()
    init = init_detector(shrunk_torch_model(), 0).state_dict()
    for key, value in seen["state"].items():
        ref = want if item == "all" or key.startswith("backbone.") else init
        torch.testing.assert_close(value, ref[key], rtol=0, atol=0, msg=key)


@pytest.mark.parametrize("backbone", ["tiny", "mobilenet224_0.25"])
def test_train_cli_takes_other_backbones(cli_split, tmp_path, backbone):
    """--backbone builds any name of the registry: one step from the
    seeded init, without the validation sweep."""
    _, root = cli_split
    state = train_cli.main(
        ["--backbone", backbone, "--device", "cpu", "--steps", "1",
         "--epochs", "1", "--batch-size", "2", "--no-evaluation",
         "--no-snapshots", "--log-path", str(tmp_path / "log.jsonl")]
        + SIDES + ["kitti", root])
    assert state.step == 1
    assert type(state.model.backbone).__module__.endswith(
        "tiny" if backbone == "tiny" else "mobilenet")


def test_train_cli_refuses_a_missing_card(tmp_path):
    """The default device is the card; without one the CLI raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["kitti", str(tmp_path)])


def test_train_state_lr_writes_param_groups():
    state = TrainState(torch.nn.Linear(2, 2), torch.optim.Adam(
        torch.nn.Linear(2, 2).parameters(), lr=1e-5))
    state.lr = 2e-3
    assert state.optimizer.param_groups[0]["lr"] == 2e-3 and state.lr == 2e-3


def test_convert_model_takes_a_training_checkpoint(shrunk_weights, tmp_path):
    """convert_model on a step_*.pt writes the .npz that export_params
    writes for the same model (the train -> convert -> infer route)."""
    from ground_plane_polling_tpu_torch.bin.convert_model import \
        main as convert

    state = _shrunk_fit_state(shrunk_weights)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(0.01)
    path = checkpoint.save_checkpoint(str(tmp_path / "ckpt"), state)
    want = str(tmp_path / "want.npz")
    checkpoint.export_params(want, state.model)
    got = str(tmp_path / "got.npz")
    convert([path, got])
    with np.load(want) as w, np.load(got) as g:
        assert sorted(w.files) == sorted(g.files)
        for k in w.files:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert json.loads(open(got + ".json").read())["num_classes"] == 1
    model = load_weights(shrunk_torch_model(), got)
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=1e-6,
                                   atol=1e-7)
