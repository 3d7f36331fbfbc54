"""`--int8 2` in the port's run_network, serve and evaluate CLIs against the
JAX package's, on the 5-frame prepared split of tests/test_torch_fixtures.py
(seeded ResNet-50, two padded shapes, 64x224 canvases), float32, on the CPU.

Two things make int8 outputs of two programs differ wholesale where their
float outputs agree, and the comparison removes both:
  * an int8 network's output is a discontinuous function of its scales: an
    ulp of one s_x moves the roundings of that site's inputs, and the
    changes grow through the later sites to the size of the int8 error
    itself, enough to reorder near-equal scores. The two packages' float
    trunks (the calibration pass) differ in about the sixth digit, so their
    scales differ in the last bits. Each CLI pair therefore runs on the
    JAX CLI's own calibration: the port CLI's calibration runs too and must
    equal it within rtol 1e-5 on the same frames, then the JAX CLI's scales
    take its place;
  * XLA's jit rewrites the int8 program (division by a constant scale,
    folded scale chains) and rounds otherwise, with the same effect. The
    JAX CLIs run under jax.disable_jit(), which computes what their jaxpr
    says; the port reproduces that to the last bits
    (tests/test_torch_quantize.py).
Then the port's outputs must equal the JAX CLIs' within the tolerances of
the float CLI tests (tests/test_torch_serve.py, tests/test_torch_evaluate.py),
except where the writer recomputes a box's height and Y from its rotated
corners: as in chip_smoke.py's txt comparison, those also get 2e-2 (the
angle tolerance) times the box's h + w + l, since the int8 runs keep
detections whose closed-form pose is ill-conditioned (a length of 100 m),
where the last bits of the keypoints move the angles. Every CLI runs at
batch 1, so that the three op-by-op JAX runs share their compiled
operations.
"""

import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch

import ground_plane_polling_tpu.models.quantize as jq
from ground_plane_polling_tpu.bin.evaluate import main as jax_evaluate
from ground_plane_polling_tpu.bin.run_network import main as jax_run_network
from ground_plane_polling_tpu.bin.serve import main as jax_serve
from ground_plane_polling_tpu.data import native_loader as jax_native_loader
from ground_plane_polling_tpu_torch.data import (
    native_loader as port_native_loader)
import ground_plane_polling_tpu_torch.models.quantize as tq
import ground_plane_polling_tpu_torch.training.loop as port_loop
from ground_plane_polling_tpu_torch.bin import serve as serve_mod
from ground_plane_polling_tpu_torch.bin.evaluate import main as evaluate
from ground_plane_polling_tpu_torch.bin.run_network import main as run_network

from .test_torch_evaluate import _assert_same_metrics
from .test_torch_fixtures import make_prepared_split, resnet50_weights
from .test_torch_serve import ROUND, _angle_gap, _fields, _tf32_restored, _txts

torch.set_num_threads(2)

SIDES = ["--image-min-side", "64", "--image-max-side", "224"]
INT8 = ["--int8", "2"]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("int8_cli")
    weights = str(tmp / "model.npz")
    # seed 1, as tests/test_torch_serve.py (well-conditioned poses)
    root = make_prepared_split(str(tmp / "kitti"), resnet50_weights(weights),
                               seed=1)
    val = os.path.join(root, "val")
    return {"tmp": tmp, "weights": weights, "root": root,
            "args": [weights, os.path.join(val, "images"),
                     os.path.join(val, "calibs"),
                     os.path.join(root, "road_planes_database.mat")]}


def _quiet(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(argv)
    return result, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def runs(split):
    """For each CLI: the JAX CLI's calibration (canvases, scales) and
    outputs, the port CLI's own calibration and its outputs on the JAX
    scales."""
    tmp, args = split["tmp"], split["args"]
    jax_cli = {
        "run_network": lambda out: jax_run_network(
            args + [out, "--kitti", "--no-bf16", "--prep-threads", "1"]
            + SIDES + INT8),
        "serve": lambda out: jax_serve(
            args + [out, "--once", "--batch-size", "1", "--no-bf16"]
            + SIDES + INT8),
        "evaluate": lambda out: jax_evaluate(
            [split["weights"], split["root"], "--eval-batch", "1"] + SIDES
            + INT8),
    }
    port_cli = {
        "run_network": lambda out: run_network(
            args + [out, "--kitti", "--no-bf16", "--device", "cpu"]
            + SIDES + INT8),
        "serve": lambda out: serve_mod.main(
            args + [out, "--once", "--batch-size", "1", "--no-bf16",
                    "--device", "cpu"] + SIDES + INT8),
        "evaluate": lambda out: evaluate(
            [split["weights"], split["root"], "--eval-batch", "1",
             "--device", "cpu"] + SIDES + INT8),
    }
    results = {}
    jax_calibrate = jq.collect_scales_uint8
    port_calibrate = tq.collect_scales_uint8
    for name in jax_cli:
        seen = {}

        def jax_spy(model, variables, canvases, percentile=100.0):
            seen["jax_canvases"] = [np.asarray(c) for c in canvases]
            seen["jax"] = jax_calibrate(model, variables, canvases,
                                        percentile=percentile)
            return seen["jax"]

        def port_spy(model, canvases, percentile=100.0):
            seen["port_canvases"] = [np.asarray(torch.as_tensor(c).cpu())
                                     for c in canvases]
            seen["port"] = port_calibrate(model, canvases,
                                          percentile=percentile)
            return seen["jax"]

        out_jax, out_port = str(tmp / f"jax_{name}"), str(tmp / name)
        with pytest.MonkeyPatch.context() as mp, _tf32_restored():
            mp.setattr(jq, "collect_scales_uint8", jax_spy)
            mp.setattr(jax_native_loader, "available", lambda: False)
            with jax.disable_jit():
                seen["jax_result"], seen["jax_lines"] = _quiet(
                    jax_cli[name], out_jax)
            mp.setattr(tq, "collect_scales_uint8", port_spy)
            mp.setattr(port_loop, "collect_scales_uint8", port_spy)
            mp.setattr(port_native_loader, "available", lambda: False)
            seen["port_result"], seen["port_lines"] = _quiet(
                port_cli[name], out_port)
        seen["dirs"] = (out_jax, out_port)
        results[name] = seen
    return results


@pytest.mark.parametrize("cli", ["run_network", "serve", "evaluate"])
def test_int8_calibration_matches_jax_cli(runs, cli):
    """Both CLIs calibrate on the same first two frames (equal canvases),
    and the port's scales equal the JAX CLI's (rtol 1e-5)."""
    seen = runs[cli]
    assert len(seen["port_canvases"]) == len(seen["jax_canvases"]) == 2
    for got, want in zip(seen["port_canvases"], seen["jax_canvases"]):
        np.testing.assert_array_equal(got, want)
    assert seen["port"].shape == seen["jax"].shape == (136,)
    np.testing.assert_allclose(seen["port"], seen["jax"], rtol=1e-5, atol=0)


@pytest.mark.parametrize("cli", ["run_network", "serve"])
def test_int8_txts_match_jax_cli(runs, cli):
    """The KITTI txts of the int8 runs, within the float CLI tests'
    tolerances."""
    out_jax, out_port = runs[cli]["dirs"]
    if cli == "run_network":
        out_jax, out_port = (os.path.join(d, "model", "outputs", "kitti")
                             for d in (out_jax, out_port))
    got, want = _txts(out_port), _txts(out_jax)
    assert sorted(got) == sorted(want) and len(want) == 5
    for name, rows in want.items():
        assert len(rows) > 0 and len(got[name]) == len(rows), name
        assert [r.split()[0] for r in got[name]] == [r.split()[0]
                                                     for r in rows]
        g, w = _fields(got[name]), _fields(rows)
        # after the type: trunc occ alpha x1 y1 x2 y2 h w l X Y Z ry score
        np.testing.assert_allclose(g[:, [3, 4, 5, 6, 14]],
                                   w[:, [3, 4, 5, 6, 14]], rtol=0,
                                   atol=ROUND, err_msg=name)
        tol = 0.5 + 2e-3 * np.abs(w[:, 7:13]) + ROUND
        tol[:, [0, 4]] += 2e-2 * np.abs(w[:, 7:10]).sum(axis=1)[:, None]
        gap = np.abs(g[:, 7:13] - w[:, 7:13])
        assert (gap <= tol).all(), (name, float((gap - tol).max()))
        assert (_angle_gap(g[:, [2, 13]], w[:, [2, 13]])
                <= 2e-2 + ROUND).all(), name


def test_int8_serve_calibrates_before_serving(runs):
    """serve prints the calibration line once, before its first round (4
    frames under the intake cap of batch 1), as the JAX CLI does, and
    serves every frame."""
    seen = runs["serve"]
    for lines in (seen["port_lines"], seen["jax_lines"]):
        assert lines[0] == "int8: calibrated on 2 images"
        assert lines[1].startswith("served 4 images in ")
        assert lines[2].startswith("served 1 images in ")
        assert sum(line.startswith("int8:") for line in lines) == 1
    assert seen["port_result"] == 5


def test_int8_evaluate_matches_jax_cli(runs):
    """evaluate --int8 2: mAP and L1 errors within the float evaluate
    test's tolerances (abs 1e-6 and 1e-4)."""
    seen = runs["evaluate"]
    (mean_ap, errors), (jax_ap, jax_errors) = (seen["port_result"],
                                               seen["jax_result"])
    assert 0.0 < jax_ap <= 1.0
    _assert_same_metrics({"mAP": mean_ap, "errors": errors},
                         {"mAP": jax_ap, "errors": jax_errors})
