"""The port's evaluation slice against the JAX package's: the KITTI dataset
layer, the eval loader, utils/eval.py, training/loop.py::evaluate_model and
the evaluate CLI, on a 5-frame prepared split with two padded shapes
(tests/test_torch_fixtures.py: seeded ResNet-50 weights, labels taken from
their detections), float32, canvases 64x224 and 64x192.

Tolerances:
  * loader: bit for bit against the JAX KittiLoader, both with the native
    C++ loader off (cv2) here, and both on in
    tests/test_torch_native_loader.py and below;
  * per-bucket AP: abs 1e-6 (the detections' scores agree to about 1e-6
    and are far apart, so the ranking is the same and AP is equal);
  * mean L1 errors: abs 1e-4 (keypoints in pixels, dims in metres: the
    float32 detections of the two frameworks agree to about 1e-4).
Both CLIs normally take their native loader, whose float bilinear resize
differs from cv2 by up to one count; random weights move individual
detections for such a change (mAP 0.312 against 0.270 on this split), so
most CLI comparisons switch both native loaders off, as the constructor's
`use_native_loader=False` does, and one compares the two defaults, native
loader on in both.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import ground_plane_polling_tpu.training.loop as jax_loop
from ground_plane_polling_tpu.bin.evaluate import main as jax_evaluate
from ground_plane_polling_tpu.data import native_loader as jax_native_loader
from ground_plane_polling_tpu.data.kitti import KittiDataset as JaxDataset
from ground_plane_polling_tpu.data.kitti import (
    parse_modified_label as jax_parse_label)
from ground_plane_polling_tpu.data.pipeline import KittiLoader as JaxLoader
from ground_plane_polling_tpu.utils import eval as jax_eval
from ground_plane_polling_tpu_torch.bin.evaluate import main as evaluate
from ground_plane_polling_tpu_torch.data import native_loader
from ground_plane_polling_tpu_torch.data.kitti import (KittiDataset,
                                                       parse_modified_label)
from ground_plane_polling_tpu_torch.data.pipeline import KittiLoader
from ground_plane_polling_tpu_torch.inference import place_model
from ground_plane_polling_tpu_torch.models import build_detector, load_weights
from ground_plane_polling_tpu_torch.training.loop import evaluate_model
from ground_plane_polling_tpu_torch.utils import eval as port_eval

from .test_torch_fixtures import make_prepared_split, resnet50_weights

torch.set_num_threads(2)

SIDES = ["--image-min-side", "64", "--image-max-side", "224"]
AP_TOL, ERR_TOL = 1e-6, 1e-4


@contextlib.contextmanager
def _tf32_restored():
    """evaluate runs float32 with TF32 off, process-wide."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def _captured(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(argv)
    return result, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    weights = str(tmp / "model.npz")
    model = resnet50_weights(weights)
    root = make_prepared_split(str(tmp / "kitti"), model)
    return weights, root


@pytest.fixture(scope="module")
def jax_run(split):
    """One JAX evaluate CLI run (native loader off); its evaluate_model
    result is kept from inside the CLI."""
    weights, root = split
    seen = {}
    real = jax_loop.evaluate_model

    def spy(*args, **kwargs):
        seen["result"] = real(*args, **kwargs)
        return seen["result"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native_loader, "available", lambda: False)
        mp.setattr(jax_loop, "evaluate_model", spy)
        (mean_ap, errors), lines = _captured(jax_evaluate,
                                             [weights, root] + SIDES)
    return {"mAP": mean_ap, "errors": errors, "lines": lines,
            "aps": seen["result"][2]}


@pytest.fixture(scope="module")
def port_runs(split):
    """The port's evaluate CLI (native loader off), three ways."""
    weights, root = split
    runs = {}
    with _tf32_restored(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_loader, "available", lambda: False)
        for name, extra in (("b4", []), ("b1", ["--eval-batch", "1"]),
                            ("fused", ["--fuse-towers"])):
            (mean_ap, errors), lines = _captured(
                evaluate, [weights, root, "--device", "cpu"] + SIDES + extra)
            runs[name] = {"mAP": mean_ap, "errors": errors, "lines": lines}
    return runs


@pytest.fixture(scope="module")
def default_runs(split):
    """Both evaluate CLIs as a user runs them: native loader on (the JAX
    run's evaluate_model result kept from inside its CLI)."""
    if not (native_loader.available() and jax_native_loader.available()):
        pytest.skip("native loader toolchain unavailable")
    weights, root = split
    seen = {}
    real = jax_loop.evaluate_model

    def spy(*args, **kwargs):
        seen["result"] = real(*args, **kwargs)
        return seen["result"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop, "evaluate_model", spy)
        (mean_ap, errors), lines = _captured(jax_evaluate,
                                             [weights, root] + SIDES)
    jax_ = {"mAP": mean_ap, "errors": errors, "lines": lines,
            "aps": seen["result"][2]}
    with _tf32_restored():
        (mean_ap, errors), lines = _captured(
            evaluate, [weights, root, "--device", "cpu"] + SIDES)
    return {"port": {"mAP": mean_ap, "errors": errors, "lines": lines},
            "jax": jax_}


def _assert_same_metrics(got, want):
    assert got["mAP"] == pytest.approx(want["mAP"], abs=AP_TOL)
    assert set(got["errors"]) == set(want["errors"])
    for key, value in want["errors"].items():
        assert got["errors"][key] == pytest.approx(value, abs=ERR_TOL), key


# --- dataset and loader ----------------------------------------------------

def test_dataset_matches_jax(split):
    _, root = split
    got, want = KittiDataset(root, "val"), JaxDataset(root, "val")
    assert len(got) == len(want) == 5
    assert got.image_paths == want.image_paths
    assert got.label_paths == want.label_paths
    assert got.calib_paths == want.calib_paths
    assert got.num_classes == want.num_classes
    np.testing.assert_array_equal(got.planes, want.planes)
    for i in range(len(got)):
        for a, b in zip(got.load_annotations(i), want.load_annotations(i)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.load_calibration(i),
                                      want.load_calibration(i))
        np.testing.assert_array_equal(got.load_image(i), want.load_image(i))
        assert got.aspect_ratio(i) == want.aspect_ratio(i)


def test_parse_modified_label_matches_jax(tmp_path):
    """Car and Van are class 0, DontCare and Misc ignore regions, other
    types and lines without 20 fields are skipped."""
    kp = " ".join(f"{v:.2f}" for v in range(8))
    rows = [f"Car 0.00 0 0.10 10 20 30 40 {kp} 1.5 1.6 4.0 2",
            f"Van 0.10 1 -0.5 11 21 31 41 {kp} 2.0 1.9 5.0 3",
            f"DontCare -1 -1 -10 0 0 50 60 {kp} -1 -1 -1 0",
            f"Misc -1 -1 -10 1 2 3 4 {kp} -1 -1 -1 0",
            f"Pedestrian 0 0 0 5 5 9 9 {kp} 1.7 0.6 0.8 1",
            "Car 0 0 0 1 2 3 4"]
    path = str(tmp_path / "label.txt")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    (anns, ignores), (want_anns, want_ignores) = (parse_modified_label(path),
                                                  jax_parse_label(path))
    assert anns.shape == (2, 17) and ignores.shape == (2, 4)
    np.testing.assert_array_equal(anns, want_anns)
    np.testing.assert_array_equal(ignores, want_ignores)


@pytest.mark.parametrize("sides", [(64, 224), (100, 300)],
                         ids=["64x224", "100x300"])
def test_eval_inputs_equal_jax_bit_for_bit(split, sides):
    _, root = split
    got = list(KittiLoader(KittiDataset(root, "val"), image_min_side=sides[0],
                           image_max_side=sides[1],
                           use_native_loader=False).eval_inputs())
    want = list(JaxLoader(JaxDataset(root, "val"), image_min_side=sides[0],
                          image_max_side=sides[1], shuffle=False,
                          use_native_loader=False).eval_inputs())
    assert len(got) == len(want) == 5
    assert len({g["image"].shape for g in got}) == 2  # two buckets
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["index"] == w["index"] and g["scale"] == w["scale"]
        for key in ("image", "P_inv", "planes", "annotations"):
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("sides,pad", [((64, 224), 32), ((100, 300), 32),
                                       ((64, 224), 48)],
                         ids=["64x224", "100x300", "pad48"])
def test_loader_buckets_equal_jax(split, sides, pad):
    _, root = split
    got = KittiLoader(KittiDataset(root, "val"), image_min_side=sides[0],
                      image_max_side=sides[1], pad_multiple=pad)
    want = JaxLoader(JaxDataset(root, "val"), image_min_side=sides[0],
                     image_max_side=sides[1], pad_multiple=pad,
                     shuffle=False, use_native_loader=False)
    assert got._bucket_shape == want._bucket_shape
    assert len(set(got._bucket_shape.values())) == 2


def test_training_batches_are_not_ported(split):
    """Training batches through the native C++ loader, which raised before
    it was ported: the port's default loader is native, as the JAX
    package's, and its unaugmented raw batches of this split equal JAX's
    bit for bit (more cases: tests/test_torch_native_loader.py)."""
    if not (native_loader.available() and jax_native_loader.available()):
        pytest.skip("native loader toolchain unavailable")
    _, root = split
    kw = dict(batch_size=2, image_min_side=64, image_max_side=224,
              raw_batches=True, shuffle=False)
    port = KittiLoader(KittiDataset(root, "val"), device="cpu", **kw)
    jax_ = JaxLoader(JaxDataset(root, "val"), **kw)
    assert port.native
    got, want = list(port.epoch(prefetch=0)), list(jax_.epoch(prefetch=0))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for key in ("images", "annotations", "ann_mask", "sizes", "valid"):
            np.testing.assert_array_equal(g[key].numpy(), w[key],
                                          err_msg=key)


# --- utils/eval.py -----------------------------------------------------------

def test_average_precision_matches_jax():
    rng = np.random.RandomState(0)
    for n in (1, 5, 40):
        recall = np.sort(rng.uniform(0, 1, n))
        precision = rng.uniform(0, 1, n)
        assert port_eval.average_precision(recall, precision) == \
            jax_eval.average_precision(recall, precision)


def _random_sweep(rng, n_images=6, num_classes=2):
    dets, anns = [], []
    for _ in range(n_images):
        k, g = rng.randint(0, 12), rng.randint(0, 6)
        boxes = np.zeros((k, 12))
        xy = rng.uniform(0, 200, (k, 2))
        wh = rng.uniform(10, 60, (k, 2))
        boxes[:, :2], boxes[:, 2:4] = xy, xy + wh
        boxes[:, 4:] = rng.uniform(0, 260, (k, 8))
        scores = rng.uniform(0, 1, k)
        scores[rng.uniform(size=k) < 0.2] = -1.0  # padding rows
        dets.append((boxes, rng.uniform(1, 5, (k, 3)), scores,
                     rng.randint(0, num_classes, k), rng.randint(0, 4, k)))
        ann = np.zeros((g, 17))
        pick = rng.randint(0, max(k, 1), g)
        ann[:, :12] = (boxes[pick] + rng.normal(0, 5, (g, 12))
                       if k else rng.uniform(0, 200, (g, 12)))
        ann[:, 12:15] = rng.uniform(1, 5, (g, 3))
        ann[:, 15] = rng.randint(0, num_classes, g)
        ann[:, 16] = rng.randint(0, 4, g)
        anns.append(ann)
    return dets, anns


@pytest.mark.parametrize("num_classes", [1, 2])
def test_evaluate_detections_matches_jax(num_classes):
    dets, anns = _random_sweep(np.random.RandomState(num_classes),
                               num_classes=num_classes)
    results = []
    for mod in (port_eval, jax_eval):
        d = [mod.bucket_detections(*x, num_classes) for x in dets]
        a = [mod.bucket_annotations(x, num_classes) for x in anns]
        for iou in (0.5, 0.1):
            results.append(mod.evaluate_detections(d, a, 4 * num_classes,
                                                   iou))
    got, want = results[:2], results[2:]
    assert got == want
    assert any(ap > 0 for ap, _ in got[1][0].values())


# --- evaluate_model and the CLI ------------------------------------------------

def test_evaluate_model_matches_jax(split, jax_run):
    weights, root = split
    loader = KittiLoader(KittiDataset(root, "val"), image_min_side=64,
                         image_max_side=224, use_native_loader=False)
    model = place_model(load_weights(build_detector("resnet50"), weights),
                        "cpu")
    mean_ap, errors, aps = evaluate_model(model, loader, eval_batch=2)
    want = jax_run["aps"]
    assert sorted(aps) == sorted(want) == [0, 1, 2, 3]
    for bucket, (ap, n) in want.items():
        assert aps[bucket][1] == n
        assert aps[bucket][0] == pytest.approx(ap, abs=AP_TOL), bucket
    assert 0.0 < mean_ap < 1.0
    _assert_same_metrics({"mAP": mean_ap, "errors": errors}, jax_run)


def test_evaluate_cli_matches_jax_cli(port_runs, jax_run):
    got = port_runs["b4"]
    _assert_same_metrics(got, jax_run)
    # the per-bucket lines print AP to 4 decimals and the annotation count
    assert got["lines"][:-1] == jax_run["lines"][:-1]
    assert len(got["lines"]) == 5
    printed = json.loads(got["lines"][-1])
    assert set(printed) == {"mAP", "keypoint_error", "height_error",
                            "width_error", "length_error"}
    assert printed["mAP"] == got["mAP"]


def test_default_evaluate_matches_jax_default(default_runs, jax_run):
    """Both CLIs with their defaults, native loader on: the same per-bucket
    AP lines, mAP and errors (the native loader moves this split's mAP
    off the cv2 runs' in both packages alike)."""
    got, want = default_runs["port"], default_runs["jax"]
    _assert_same_metrics(got, want)
    assert got["lines"][:-1] == want["lines"][:-1]
    assert len(got["lines"]) == 5
    assert got["mAP"] != pytest.approx(jax_run["mAP"], abs=1e-3)


def test_eval_batch_1_equals_batch_4(port_runs):
    _assert_same_metrics(port_runs["b1"], port_runs["b4"])
    assert port_runs["b1"]["lines"][:-1] == port_runs["b4"]["lines"][:-1]


def test_fuse_towers_equals_split(port_runs):
    _assert_same_metrics(port_runs["fused"], port_runs["b4"])
    assert port_runs["fused"]["lines"][:-1] == port_runs["b4"]["lines"][:-1]


def test_float_images_are_taken_as_preprocessed(split, port_runs):
    """Float eval images skip the device-side mean subtraction (with a
    warning), as in the JAX package: host-preprocessed float images give
    the uint8 sweep's metrics."""
    weights, root = split
    loader = KittiLoader(KittiDataset(root, "val"), image_min_side=64,
                         image_max_side=224, use_native_loader=False)

    class FloatLoader:
        def eval_inputs(self):
            for item in loader.eval_inputs():
                image = item["image"].astype(np.float32)
                item["image"] = image - np.array(
                    [103.939, 116.779, 123.68], np.float32)
                yield item

    model = place_model(load_weights(build_detector("resnet50"), weights),
                        "cpu")
    with pytest.warns(UserWarning, match="already preprocessed"):
        mean_ap, errors, _ = evaluate_model(model, FloatLoader(),
                                            eval_batch=4)
    _assert_same_metrics({"mAP": mean_ap, "errors": errors},
                         port_runs["b4"])


def test_data_parallel_in_one_process_runs_single_device(split, port_runs,
                                                         capsys, monkeypatch):
    """--data-parallel without a multi-process launch: a note (as the JAX
    CLI's) and the single-device sweep's results, --eval-batch 4's (native
    loader off, as in port_runs)."""
    weights, root = split
    monkeypatch.setattr(native_loader, "available", lambda: False)
    with _tf32_restored():
        (mean_ap, errors), lines = _captured(
            evaluate, [weights, root, "--device", "cpu", "--data-parallel"]
            + SIDES)
    assert "only one device is visible" in capsys.readouterr().err
    assert lines == port_runs["b4"]["lines"]
    _assert_same_metrics({"mAP": mean_ap, "errors": errors},
                         port_runs["b4"])


def test_cuda_is_refused_without_a_card(split):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    weights, root = split
    with _tf32_restored(), pytest.raises(RuntimeError, match="CUDA"):
        evaluate([weights, root] + SIDES)
