"""Width-sharded single-image inference (`make_detect_fn(mesh=...,
shard_spatial=True)`, parallel/spatial.py) on 2 and 3 gloo ranks on the
CPU, against the port's single process and the JAX package's
single-device detect function on the same weights.

The ranks are processes of their own: this file runs as each rank's
script (`python tests/test_torch_spatial.py RANK WORLD PORT DIR`), launched
once per world size for the module, each with a timeout, as the process
group has (GPP_DIST_INIT_TIMEOUT); they import the port only, never JAX.
Each rank runs every case below and saves its outputs and the widths of
its conv inputs.

Cases (uint8 images preprocessed on the device, pose on, 10 planes,
batch 2; `numpy_variables` of tests/test_torch_backbones.py, so every
bias is non-zero and each padded column is load-bearing):
  * tiny at 64x128 (P7 is 1 column, so some ranks hold none of it);
  * tiny at 64x160, whose width does not divide over 3 ranks (P3 20, P5
    5 columns, ...);
  * a shrunk ResNet (1, 1, 1, 1) at 64x176: C3 22, C4 11 and C5 6
    columns, so stride-2 1x1 convs realign columns between ranks and the
    FPN's 6 -> 11 upsampling is 'nearest-exact', not a repeat;
  * MobileNet alpha 0.25 at 64x160 (depthwise convs, stride-2 SAME);
each in float32, and the last three in float64 too; tiny int8 at 64x160
on one set of scales (the plain int8 versions on the CPU); tiny bf16.

Tolerances, against the single process:
  * labels and orientations equal;
  * float64: every field within rtol 1e-4 / atol 1e-4 (JAX's bound for
    its sharded detect, tests/test_sharded_inference.py); the ranks'
    convs run on other widths than the single process's, so they round
    otherwise, and float64 keeps that far below the bound everywhere;
  * float32: scores, boxes and dims within rtol 1e-4 / atol 1e-4 of the
    field's largest |value|. The polled keypoints and the pose are not
    held in float32: on these random weights they turn the convs'
    float32 rounding (about 2e-6 of the boxes) into up to 0.1 of 608 on
    a keypoint whose ray grazes its plane, and 0.09 rad of angle;
  * int8: equal (the same int8 sums on each column);
  * bf16: finite scores and a detection an image.
Against JAX's single-device detect (rank 0 of 3, float32): labels and
orientations equal, scores, boxes, dims and keyplanes within
tests/test_torch_detect.py's bounds. Every conv input of a rank is at most
its slab plus a halo (`conv_window_bound`), and narrower than every map
that is wider than that bound.
"""

import os
import socket
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 300     # seconds for a whole launch
GROUP_TIMEOUT = 60     # seconds, the process group's (GPP_DIST_INIT_TIMEOUT)
WORLDS = (2, 3)
FEATURES = 64
BATCH = 2
N_PLANES = 10
# case -> (backbone, canvas, mode)
CASES = {
    "tiny_64x128": ("tiny", (64, 128), "f32"),
    "tiny_64x160": ("tiny", (64, 160), "f32"),
    "resnet_64x176": ("resnet", (64, 176), "f32"),
    "mobilenet_64x160": ("mobilenet", (64, 160), "f32"),
    "tiny_64x160_f64": ("tiny", (64, 160), "f64"),
    "resnet_64x176_f64": ("resnet", (64, 176), "f64"),
    "mobilenet_64x160_f64": ("mobilenet", (64, 160), "f64"),
    "tiny_int8_64x160": ("tiny", (64, 160), "int8"),
    "tiny_bf16_64x160": ("tiny", (64, 160), "bf16"),
}
DTYPES = {"f32": torch.float32, "f64": torch.float64,
          "int8": torch.float32, "bf16": torch.bfloat16}
NET_FIELDS = ("scores", "boxes", "dims")
FIELDS = NET_FIELDS + ("keypoints", "keyplanes", "residuals", "locations",
                       "angles", "pose_dims")
# port against JAX: tests/test_torch_detect.py's bounds
JAX_TOLS = {"scores": (0, 1e-5), "boxes": (1e-5, 1e-3),
            "dims": (1e-5, 1e-4), "keyplanes": (1e-5, 1e-5)}


# --- both sides (port only) -------------------------------------------------

def port_detector(backbone):
    from ground_plane_polling_tpu_torch.models import GPPRetinaNet
    from ground_plane_polling_tpu_torch.models.mobilenet import (
        MobileNetBackbone)
    from ground_plane_polling_tpu_torch.models.resnet import ResNetBackbone
    from ground_plane_polling_tpu_torch.models.tiny import TinyBackbone

    net = {"tiny": TinyBackbone, "resnet": lambda: ResNetBackbone(
        (1, 1, 1, 1)), "mobilenet": lambda: MobileNetBackbone(0.25)}[
        backbone]()
    return GPPRetinaNet(net, backbone_channels=net.channels,
                        feature_size=FEATURES)


def run_case(work, name, mesh=None):
    """The case's detect outputs (numpy), in one process or on `mesh`
    with shard_spatial, and the detect function."""
    from ground_plane_polling_tpu_torch.inference import make_detect_fn
    from ground_plane_polling_tpu_torch.models import load_weights

    backbone, canvas, mode = CASES[name]
    model = load_weights(port_detector(backbone),
                         os.path.join(work, f"{backbone}.npz")).eval()
    model = model.to(DTYPES[mode])
    with np.load(os.path.join(work, f"{name}_inputs.npz")) as f:
        inputs = {k: f[k] for k in f.files}
    detect = make_detect_fn(
        model, canvas, with_pose=True, device_preprocess=True, device="cpu",
        quant_scales=inputs["scales"] if mode == "int8" else None, mesh=mesh,
        shard_spatial=mesh is not None)
    out = detect(inputs["images"], inputs["P_inv"], inputs["planes"])
    return {k: v.numpy() for k, v in out._asdict().items()}, detect


def rank_main(rank, world, port, work):
    import torch.distributed as dist

    from ground_plane_polling_tpu_torch.parallel import (data_parallel_mesh,
                                                         initialize)

    initialize(f"localhost:{port}", world, rank, device="cpu")
    mesh = data_parallel_mesh(device="cpu")
    out = {"rank": mesh.rank, "size": mesh.size, "errors": {}}
    for name in CASES:
        t0 = time.perf_counter()
        try:
            got, detect = run_case(work, name, mesh)
            out[name] = {"outputs": got,
                         "windows": detect.spatial.last.windows}
        except Exception:  # recorded: the tests of this case fail
            out["errors"][name] = traceback.format_exc()
        print(f"rank {rank}: {name} {time.perf_counter() - t0:.1f} s",
              flush=True)
    torch.save(out, os.path.join(work, f"world{world}_rank{rank}.pt"))
    dist.destroy_process_group()


# --- the pytest side ------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """JAX-made weights of each backbone (.npz), the cases' inputs, and
    the tiny int8 case's scales from the single process's calibration."""
    import jax

    from ground_plane_polling_tpu.models.retinanet import (
        GPPRetinaNet as JaxRetinaNet)
    from ground_plane_polling_tpu.training.checkpoint import export_params
    from ground_plane_polling_tpu_torch.models import load_weights
    from ground_plane_polling_tpu_torch.models.quantize import (
        collect_scales_uint8)
    from tests.test_polling import P_INV
    from tests.test_torch_backbones import FAMILIES, numpy_variables
    from tests.test_torch_model import SHRUNK
    from ground_plane_polling_tpu.models.resnet import (
        ResNetBackbone as JaxResNet)
    import functools

    path = str(tmp_path_factory.mktemp("spatial"))
    jax_backbones = {
        "tiny": FAMILIES["tiny"][0],
        "resnet": functools.partial(JaxResNet, stage_sizes=SHRUNK,
                                    name="backbone"),
        "mobilenet": FAMILIES["mobilenet_0.25"][0]}
    jax_models, variables = {}, {}
    for seed, (name, fn) in enumerate(jax_backbones.items()):
        jax_models[name] = JaxRetinaNet(backbone_fn=fn, feature_size=FEATURES)
        variables[name] = jax.tree_util.tree_map(
            np.asarray, numpy_variables(jax_models[name], seed))
        export_params(os.path.join(path, f"{name}.npz"), variables[name])
    rng = np.random.RandomState(0)
    for name, (backbone, canvas, mode) in CASES.items():
        inputs = {
            "images": rng.randint(0, 256, (BATCH, *canvas, 3)).astype(
                np.uint8),
            "P_inv": np.tile(P_INV[None], (BATCH, 1, 1)).astype(np.float32),
            "planes": np.tile(np.stack([
                rng.uniform(-0.05, 0.05, N_PLANES), np.ones(N_PLANES),
                rng.uniform(-0.05, 0.05, N_PLANES),
                rng.uniform(-2.2, -1.2, N_PLANES)], axis=1)[None],
                (BATCH, 1, 1)).astype(np.float32)}
        if mode == "int8":
            model = load_weights(port_detector(backbone), os.path.join(
                path, f"{backbone}.npz")).eval()
            inputs["scales"] = collect_scales_uint8(
                model, [inputs["images"][:1]])
        np.savez(os.path.join(path, f"{name}_inputs.npz"), **inputs)
    return {"path": path, "jax_models": jax_models, "variables": variables}


def _launch(work, world):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               GPP_DIST_INIT_TIMEOUT=str(GROUP_TIMEOUT))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(port), work], env=env, cwd=work, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        deadline = time.monotonic() + RANK_TIMEOUT
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{log[-4000:]}"
    out = []
    for r in range(world):
        f = os.path.join(work, f"world{world}_rank{r}.pt")
        out.append(torch.load(f, weights_only=False))
        os.remove(f)
    return out


@pytest.fixture(scope="module")
def ranks(work):
    """world -> each rank's record, both launches at once."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = {w: pool.submit(_launch, work["path"], w) for w in WORLDS}
        return {w: f.result() for w, f in runs.items()}


@pytest.fixture(scope="module")
def single(work):
    """case -> the single process's outputs."""
    return {name: run_case(work["path"], name)[0] for name in CASES}


def _case(ranks, world, name):
    records = ranks[world]
    for r in records:
        assert name not in r["errors"], r["errors"][name]
    return [r[name] for r in records]


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_spatial_detect_equals_one_process(ranks, single, world, name):
    want = single[name]
    assert np.isfinite(want["scores"]).all()
    assert (want["scores"] > 0).any(axis=1).all(), want["scores"]
    mode = CASES[name][2]
    for r, rec in enumerate(_case(ranks, world, name)):
        got, label = rec["outputs"], f"rank {r} of {world}"
        if mode == "bf16":
            assert np.isfinite(got["scores"]).all(), label
            assert (got["scores"] > 0).any(axis=1).all(), label
            continue
        for key in ("labels", "orientations"):
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{label} {key}")
        for key in FIELDS if mode != "f32" else NET_FIELDS:
            tol = {"int8": (0, 0), "f64": (1e-4, 1e-4),
                   "f32": (1e-4, 1e-4 * np.abs(want[key]).max())}[mode]
            np.testing.assert_allclose(got[key], want[key], rtol=tol[0],
                                       atol=tol[1], err_msg=f"{label} {key}")


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[2] == "f32"])
def test_spatial_detect_matches_jax(ranks, work, name):
    """Rank 0 of 3 against JAX's single-device detect function."""
    import jax.numpy as jnp

    from ground_plane_polling_tpu.inference import make_detect_fn

    backbone, canvas, _ = CASES[name]
    with np.load(os.path.join(work["path"], f"{name}_inputs.npz")) as f:
        inputs = [jnp.asarray(f[k]) for k in ("images", "P_inv", "planes")]
    want = make_detect_fn(work["jax_models"][backbone], canvas,
                          with_pose=True, device_preprocess=True)(
        work["variables"][backbone], *inputs)
    want = {k: np.asarray(v) for k, v in want._asdict().items()}
    got = _case(ranks, 3, name)[0]["outputs"]
    valid = want["scores"] > 0
    assert valid.any(axis=1).all()
    for key in ("labels", "orientations"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key, (rtol, atol) in JAX_TOLS.items():
        np.testing.assert_allclose(got[key][valid], want[key][valid],
                                   rtol=rtol, atol=atol, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
def test_conv_inputs_stay_within_slab_and_halo(ranks, world):
    """No rank's conv reads more than its columns and a halo, so none
    holds a whole map wider than that before the heads' gather."""
    from ground_plane_polling_tpu_torch.parallel.spatial import (
        conv_window_bound)

    for name in CASES:
        for r, rec in enumerate(_case(ranks, world, name)):
            assert rec["windows"], name
            for size, kernel, got in rec["windows"]:
                bound = conv_window_bound(size, world, kernel)
                assert got <= bound, (name, r, size, kernel, got)
                if bound < size:
                    assert got < size, (name, r, size, kernel, got)


def test_shard_spatial_without_a_mesh_raises():
    from ground_plane_polling_tpu_torch.inference import make_detect_fn

    with pytest.raises(ValueError, match="shard_spatial requires a mesh"):
        make_detect_fn(port_detector("tiny"), (64, 128), shard_spatial=True,
                       device="cpu")


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
              sys.argv[4])
