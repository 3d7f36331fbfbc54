"""The port's KITTI AP_2D / AP_BEV / AP_3D / AOS evaluation (utils/eval3d.py,
bin/evaluate_3d.py) against the JAX package's, on one shared directory of
ground truth and detections: 12 frames of Cars, Vans, Pedestrians,
Cyclists and DontCare regions, the detections jittered copies of the
ground truth plus false positives, one detection file missing.

Both packages take their C++ core when it builds (eval3d_native, the same
source with the same flags). Tolerances: the two C++ cores equal exactly,
and so do the two numpy paths; one package's C++ core against a numpy path
within abs 1e-6 (APs in percent; the two paths compute the same overlaps
to about 1e-12, and a score threshold lands on a different side only on an
exact tie).
"""

import json
import math
import os

import numpy as np
import pytest

from ground_plane_polling_tpu.bin.evaluate_3d import main as jax_cli
from ground_plane_polling_tpu.utils import eval3d as jax_eval3d
from ground_plane_polling_tpu.utils import eval3d_native as jax_eval3d_native
from ground_plane_polling_tpu_torch.bin.evaluate_3d import main as port_cli
from ground_plane_polling_tpu_torch.utils import eval3d, eval3d_native

CLASSES = ["Car", "Pedestrian", "Cyclist"]
N_FRAMES = 12


def _row(typ, trunc, occ, alpha, bbox, dims, loc, ry, score=None):
    text = (f"{typ} {trunc:.2f} {occ} {alpha:.4f} "
            + " ".join(f"{v:.2f}" for v in (*bbox, *dims, *loc))
            + f" {ry:.4f}")
    return text if score is None else f"{text} {score:.4f}"


def _object(rng, typ):
    x1, y1 = rng.uniform(0, 1000), rng.uniform(100, 250)
    w, h = rng.uniform(20, 220), rng.uniform(20, 120)
    dims = {"Car": (1.5, 1.6, 4.0), "Van": (2.0, 1.9, 5.0),
            "Pedestrian": (1.7, 0.6, 0.8), "Cyclist": (1.7, 0.6, 1.8),
            "DontCare": (-1, -1, -1)}[typ]
    dims = np.asarray(dims) * rng.uniform(0.9, 1.1)
    loc = (rng.uniform(-15, 15), rng.uniform(1.4, 1.8), rng.uniform(5, 50))
    return dict(typ=typ, trunc=rng.uniform(0, 0.6), occ=int(rng.randint(3)),
                alpha=rng.uniform(-np.pi, np.pi),
                bbox=(x1, y1, x1 + w, y1 + h), dims=tuple(dims), loc=loc,
                ry=rng.uniform(-np.pi, np.pi))


def _jitter(rng, obj):
    out = dict(obj)
    out["bbox"] = tuple(np.asarray(obj["bbox"]) + rng.normal(0, 4, 4))
    out["loc"] = tuple(np.asarray(obj["loc"]) + rng.normal(0, 0.3, 3))
    out["ry"] = obj["ry"] + rng.normal(0, 0.2)
    out["alpha"] = obj["alpha"] + rng.normal(0, 0.2)
    return out


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval3d")
    gt_dir, det_dir = tmp / "gt", tmp / "det"
    gt_dir.mkdir()
    det_dir.mkdir()
    rng = np.random.RandomState(0)
    types = ["Car"] * 5 + ["Van", "Pedestrian", "Pedestrian", "Cyclist",
                           "DontCare"]
    for i in range(N_FRAMES):
        gts = [_object(rng, types[rng.randint(len(types))])
               for _ in range(rng.randint(2, 9))]
        dets = [_jitter(rng, g) for g in gts
                if g["typ"] != "DontCare" and rng.uniform() < 0.8]
        dets += [_object(rng, CLASSES[rng.randint(3)])
                 for _ in range(rng.randint(0, 4))]
        (gt_dir / f"{i:06d}.txt").write_text(
            "\n".join(_row(**{k: g[k] for k in g}) for g in gts) + "\n")
        if i == N_FRAMES - 1:
            continue  # a missing result file scores as empty
        (det_dir / f"{i:06d}.txt").write_text("".join(
            _row(**{k: d[k] for k in d}, score=rng.uniform(0.05, 1)) + "\n"
            for d in dets))
    return str(gt_dir), str(det_dir)


def _load(module, dirs):
    gt_dir, det_dir = dirs
    ids = sorted(f[:-4] for f in os.listdir(gt_dir))
    return module.load_label_dir(gt_dir, ids), module.load_label_dir(det_dir,
                                                                     ids)


def _assert_results_close(got, want, tol):
    assert set(got) == set(want)
    for cls in want:
        assert set(got[cls]) == set(want[cls]), cls
        for metric in want[cls]:
            for diff, w in want[cls][metric].items():
                g = got[cls][metric][diff]
                if w is None or (isinstance(w, float) and math.isnan(w)):
                    assert g is None or math.isnan(g), (cls, metric, diff)
                else:
                    assert g == pytest.approx(w, abs=tol), (cls, metric,
                                                             diff)


def test_port_has_no_native_core(dirs, monkeypatch):
    """The port had the numpy path only; now it takes its own C++ core as
    the JAX package does: the cores' overlaps and results are equal
    exactly, and the core equals the numpy path (GPP_EVAL3D_NATIVE=0)
    within abs 1e-6."""
    if not (eval3d_native.available() and jax_eval3d_native.available()):
        pytest.skip("native eval3d core unavailable: "
                    f"{eval3d_native.build_error()}")
    assert eval3d._native() is eval3d_native
    gt, det = _load(eval3d, dirs)
    for g, d in zip(gt, det):
        for fn in ("bev_overlap", "overlap_3d"):
            np.testing.assert_array_equal(getattr(eval3d_native, fn)(d, g),
                                          getattr(jax_eval3d_native, fn)(d,
                                                                         g))
    got = eval3d.evaluate_kitti_3d(gt, det, classes=CLASSES)
    want = jax_eval3d.evaluate_kitti_3d(*_load(jax_eval3d, dirs),
                                        classes=CLASSES)
    _assert_results_close(got, want, 0.0)
    monkeypatch.setenv("GPP_EVAL3D_NATIVE", "0")
    assert eval3d._native() is None
    _assert_results_close(
        got, eval3d.evaluate_kitti_3d(gt, det, classes=CLASSES), 1e-6)


def test_oversized_image_takes_the_numpy_path(tmp_path, monkeypatch):
    """More than 4,096 detections in one image exceed the C++ core's buffer:
    that image takes the numpy path (as in the JAX package), with the
    numpy path's result."""
    if not eval3d_native.available():
        pytest.skip("native eval3d core unavailable")
    rng = np.random.RandomState(11)
    car = dict(typ="Car", trunc=0.0, occ=0, alpha=0.3,
               bbox=(400, 150, 520, 230), dims=(1.5, 1.6, 4.0),
               loc=(1.0, 1.65, 20.0), ry=0.2)
    (tmp_path / "gt.txt").write_text(_row(**car) + "\n")
    (tmp_path / "det.txt").write_text("\n".join(
        [_row(**car, score=0.95)]
        + [_row(**_object(rng, "Car"), score=rng.uniform(0.05, 0.9))
           for _ in range(4100)]) + "\n")
    gts = [eval3d.parse_label_file(str(tmp_path / "gt.txt"))]
    dets = [eval3d.parse_label_file(str(tmp_path / "det.txt"))]
    calls = []
    real = eval3d_native.compute_stats
    monkeypatch.setattr(eval3d_native, "compute_stats",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = eval3d.evaluate_kitti_3d(gts, dets, metrics=("bbox",),
                                   ap_mode="11")
    assert not calls
    monkeypatch.setenv("GPP_EVAL3D_NATIVE", "0")
    want = eval3d.evaluate_kitti_3d(gts, dets, metrics=("bbox",),
                                    ap_mode="11")
    _assert_results_close(got, want, 0.0)
    assert got["Car"]["bbox"]["moderate"] > 0


def test_label_dirs_parse_as_in_jax(dirs):
    for got, want in zip(_load(eval3d, dirs), _load(jax_eval3d, dirs)):
        assert len(got) == len(want) == N_FRAMES
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert len(_load(eval3d, dirs)[1][-1]["type"]) == 0  # missing file


@pytest.mark.parametrize("ap_mode", ["11", "40"])
def test_evaluate_kitti_3d_matches_jax(dirs, ap_mode):
    gt, det = _load(eval3d, dirs)
    got = eval3d.evaluate_kitti_3d(gt, det, classes=CLASSES, ap_mode=ap_mode)
    want = jax_eval3d.evaluate_kitti_3d(*_load(jax_eval3d, dirs),
                                        classes=CLASSES, ap_mode=ap_mode)
    _assert_results_close(got, want, 1e-6)
    assert not math.isnan(got["Car"]["3d"]["moderate"])
    assert 0.0 < got["Car"]["bbox"]["moderate"] < 100.0


def test_evaluate_kitti_3d_equals_jax_numpy_path(dirs, monkeypatch):
    monkeypatch.setenv("GPP_EVAL3D_NATIVE", "0")
    got = eval3d.evaluate_kitti_3d(*_load(eval3d, dirs), classes=CLASSES)
    want = jax_eval3d.evaluate_kitti_3d(*_load(jax_eval3d, dirs),
                                        classes=CLASSES)
    _assert_results_close(got, want, 0.0)


@pytest.mark.parametrize("which", ["bev", "3d", "bbox"])
def test_overlap_matrices_match_jax(dirs, which):
    (gt, det), (jgt, jdet) = _load(eval3d, dirs), _load(jax_eval3d, dirs)
    for g, d, jg, jd in zip(gt, det, jgt, jdet):
        if which == "bev":
            got = eval3d.bev_overlap_matrix(d, g)
            want = jax_eval3d.bev_overlap_matrix(jd, jg)
        elif which == "3d":
            got = eval3d.overlap_3d_matrix(d, g)
            want = jax_eval3d.overlap_3d_matrix(jd, jg)
        else:
            got = eval3d.bbox_overlap_matrix(d["bbox"], g["bbox"])
            want = jax_eval3d.bbox_overlap_matrix(jd["bbox"], jg["bbox"])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_format_results_matches_jax(dirs):
    results = eval3d.evaluate_kitti_3d(*_load(eval3d, dirs), classes=CLASSES)
    assert eval3d.format_results(results) == \
        jax_eval3d.format_results(results)


def test_cli_matches_jax_cli(dirs, tmp_path, capsys):
    gt_dir, det_dir = dirs
    flags = ["--classes", *CLASSES, "--ap-mode", "11"]
    got = port_cli([gt_dir, det_dir, *flags, "--json",
                    str(tmp_path / "port.json")])
    port_out = capsys.readouterr()
    want = jax_cli([gt_dir, det_dir, *flags, "--json",
                    str(tmp_path / "jax.json")])
    jax_out = capsys.readouterr()
    _assert_results_close(got, want, 1e-6)
    assert "1/12 result files missing" in port_out.err
    assert port_out.out.splitlines()[-1].startswith("wrote ")
    assert len(port_out.out.splitlines()) == len(jax_out.out.splitlines())
    _assert_results_close(json.loads((tmp_path / "port.json").read_text()),
                          json.loads((tmp_path / "jax.json").read_text()),
                          1e-6)


def test_cli_json_is_valid_with_empty_buckets(tmp_path):
    """An empty difficulty bucket is NaN in the result and null in the
    JSON (a bare NaN token is not JSON)."""
    gt_dir, det_dir = tmp_path / "gt", tmp_path / "det"
    gt_dir.mkdir()
    det_dir.mkdir()
    # a 30 px tall Car: no valid easy object (40 px minimum)
    car = dict(typ="Car", trunc=0.0, occ=0, alpha=0.0,
               bbox=(100, 100, 140, 130), dims=(1.5, 1.6, 4.0),
               loc=(0.0, 1.65, 20.0), ry=0.0)
    (gt_dir / "000000.txt").write_text(_row(**car) + "\n")
    (det_dir / "000000.txt").write_text(_row(**car, score=0.9) + "\n")
    out = tmp_path / "r.json"
    res = port_cli([str(gt_dir), str(det_dir), "--metrics", "bbox",
                    "--json", str(out)])
    assert math.isnan(res["Car"]["bbox"]["easy"])
    text = out.read_text()
    assert "NaN" not in text
    parsed = json.loads(text)
    assert parsed["Car"]["bbox"]["easy"] is None
    want = jax_cli([str(gt_dir), str(det_dir), "--metrics", "bbox"])
    _assert_results_close(parsed, want, 1e-6)


def test_cli_refuses_a_directory_without_labels(tmp_path):
    with pytest.raises(SystemExit):
        port_cli([str(tmp_path), str(tmp_path)])
