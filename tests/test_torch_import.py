"""The PyTorch port stands alone: it imports with JAX blocked, and no file
of it (nor chip_smoke.py) imports JAX or the JAX package."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "ground_plane_polling_tpu_torch"

_BLOCKED = ("jax", "jaxlib", "flax", "optax", "ground_plane_polling_tpu")


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        f"for m in {_BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        f"{_BLOCKED!r} and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def _run_blocked(body, tmp_path):
    """Run `body` in a fresh interpreter with JAX and the JAX package
    blocked; returns its stdout."""
    code = (
        "import sys\n"
        f"for m in {_BLOCKED!r}:\n"
        "    sys.modules[m] = None\n" + body)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.mark.parametrize("cli", ["serve", "evaluate", "evaluate_3d",
                                 "convert_model", "run_network", "train",
                                 "logs_to_tb", "prepare_data", "debug"])
def test_cli_help_with_jax_blocked(cli, tmp_path):
    out = _run_blocked(
        "import runpy\n"
        f"sys.argv = ['{cli}', '--help']\n"
        "try:\n"
        f"    runpy.run_module('ground_plane_polling_tpu_torch.bin.{cli}',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n", tmp_path)
    assert out.startswith("usage: ")


def test_evaluate_3d_and_convert_model_run_with_jax_blocked(tmp_path):
    """The two CLIs that need no model run end to end without JAX."""
    row = ("Car 0.00 0 0.00 100.00 100.00 200.00 180.00 1.50 1.60 4.00 "
           "0.00 1.65 20.00 0.00")
    for d in ("gt", "det"):
        (tmp_path / d).mkdir()
    (tmp_path / "gt" / "000000.txt").write_text(row + "\n")
    (tmp_path / "det" / "000000.txt").write_text(row + " 0.9\n")
    out = _run_blocked(
        "import json, numpy as np\n"
        "from ground_plane_polling_tpu_torch.bin import (convert_model,\n"
        "                                                evaluate_3d)\n"
        "res = evaluate_3d.main(['gt', 'det', '--metrics', 'bbox'])\n"
        "print('AP', res['Car']['bbox']['moderate'])\n"
        "np.savez('in.npz', **{\n"
        "    'params/regression/box_out/bias': np.zeros(144, np.float32),\n"
        "    'params/classification/cls_out/bias': np.zeros(96, np.float32)})\n"
        "convert_model.main(['in.npz', 'out.npz'])\n"
        "print('classes', json.load(open('out.npz.json'))['num_classes'])\n",
        tmp_path)
    assert "AP " in out and "classes 1" in out


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax)\b|from\s+(jax|flax)\b)|"
    r"ground_plane_polling_tpu\.|\bjax\b", re.MULTILINE)


@pytest.mark.parametrize(
    "path", sorted(list(PORT.rglob("*.py")) + list(PORT.rglob("*.cu"))
                   + list(PORT.rglob("*.cpp")) + [REPO / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_reference_in_port_sources(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


def test_polling_wrapper_has_no_fallback():
    """A CUDA tensor goes through the kernel or raises: the wrapper has no
    try/except that could fall back to the twin."""
    src = (PORT / "kernels" / "polling_cuda.py").read_text()
    assert not re.search(r"^\s*(try|except)\b", src, re.MULTILINE)


def test_int8_wrapper_has_no_fallback():
    """The int8 kernels' wrapper, too: no try/except around the launch."""
    src = (PORT / "kernels" / "int8_conv_cuda.py").read_text()
    assert not re.search(r"^\s*(try|except)\b", src, re.MULTILINE)


def test_depthwise_wrapper_has_no_fallback():
    """The int8 depthwise kernel's wrapper: no try/except around the
    launch, and no other conv in its place."""
    src = (PORT / "kernels" / "int8_depthwise_cuda.py").read_text()
    assert not re.search(r"^\s*(try|except)\b", src, re.MULTILINE)
    assert "conv2d(" not in src.replace("twin.int8_conv2d(", "")


def test_nms_wrapper_has_no_fallback():
    """The NMS kernels' wrapper: no try/except around the launch."""
    src = (PORT / "kernels" / "nms_cuda.py").read_text()
    assert not re.search(r"^\s*(try|except)\b", src, re.MULTILINE)


def test_captured_detect_has_no_eager_fallback():
    """A failed capture raises: the captured call catches nothing (its one
    try only puts the launch counters back, and re-raises)."""
    src = (PORT / "inference.py").read_text()
    assert not re.search(r"^\s*except\b", src, re.MULTILINE)


def test_backbones_and_host_tools_run_with_jax_blocked(tmp_path):
    """Every backbone family, int8 with depthwise sites, data preparation,
    profiling and the version check run without JAX."""
    out = _run_blocked(
        "import os, torch\n"
        "from ground_plane_polling_tpu_torch.models import (\n"
        "    backbone_registry, build_detector)\n"
        "from ground_plane_polling_tpu_torch.models import quantize\n"
        "from ground_plane_polling_tpu_torch.models.mobilenet import (\n"
        "    MobileNetBackbone)\n"
        "from ground_plane_polling_tpu_torch.data import (label_prep,\n"
        "                                                 prepare_split)\n"
        "from ground_plane_polling_tpu_torch.bin import prepare_data\n"
        "from ground_plane_polling_tpu_torch.utils.profiling import (\n"
        "    span, trace)\n"
        "from ground_plane_polling_tpu_torch.utils import version_check\n"
        "names = sorted(backbone_registry())\n"
        "for n in ('tiny', 'vgg16', 'densenet121', 'mobilenet224_0.25'):\n"
        "    m = build_detector(n, feature_size=16).to('meta')\n"
        "    m(torch.empty(1, 3, 64, 96, device='meta'))\n"
        "torch.manual_seed(0)\n"
        "net = MobileNetBackbone(0.25).eval()\n"
        "x = torch.randn(1, 3, 64, 64) * 50\n"
        "s = quantize.collect_scales(net, [x])\n"
        "with torch.inference_mode():\n"
        "    c3, c4, c5 = quantize.quantize_apply(net, s)(x)\n"
        "with trace('t', 'tr'), span('s'):\n"
        "    torch.ones(2) + 1\n"
        "version_check.assert_compatible('cpu')\n"
        "print(len(names), len(s), tuple(c5.shape), len(os.listdir('tr')))\n",
        tmp_path)
    assert out.strip() == "13 27 (1, 256, 2, 2) 1"


def test_int8_modules_run_with_jax_blocked(tmp_path):
    """models/quantize.py, ops/int8_conv.py and kernels/int8_conv_cuda.py
    import and calibrate, quantize and run a small detector without JAX."""
    out = _run_blocked(
        "import torch\n"
        "from ground_plane_polling_tpu_torch.kernels import int8_conv_cuda\n"
        "from ground_plane_polling_tpu_torch.models import GPPRetinaNet\n"
        "from ground_plane_polling_tpu_torch.models import quantize\n"
        "from ground_plane_polling_tpu_torch.models.resnet import (\n"
        "    ResNetBackbone)\n"
        "from ground_plane_polling_tpu_torch.ops import int8_conv\n"
        "torch.manual_seed(0)\n"
        "m = GPPRetinaNet(ResNetBackbone((1, 1, 1, 1)),\n"
        "                 feature_size=16).eval()\n"
        "x = torch.randn(1, 3, 64, 64) * 50\n"
        "s = quantize.collect_scales(m, [x])\n"
        "with torch.inference_mode():\n"
        "    y = quantize.quantize_apply(m, s)(x)\n"
        "assert int8_conv_cuda.QUANTIZE_LAUNCHES == 0\n"
        "print('sites', len(s), sorted(y))\n", tmp_path)
    assert out.strip() == ("sites 100 ['classification', 'regression', "
                           "'regression_dim']")


def test_parallel_remat_and_tensorboard_run_with_jax_blocked(tmp_path):
    """parallel/ (mesh, slices), remat and utils/tensorboard run without
    JAX."""
    out = _run_blocked(
        "import os, torch\n"
        "from ground_plane_polling_tpu_torch.parallel import (\n"
        "    data_parallel_mesh, initialize, make_global_batch)\n"
        "from ground_plane_polling_tpu_torch.models import build_detector\n"
        "from ground_plane_polling_tpu_torch.utils.tensorboard import (\n"
        "    TensorBoardWriter)\n"
        "initialize(device='cpu')\n"
        "mesh = data_parallel_mesh(device='cpu')\n"
        "rows = make_global_batch(mesh, {'x': torch.arange(4)})['x']\n"
        "w = TensorBoardWriter('tb')\n"
        "w.add_scalars({'loss': 1.0}, 0)\n"
        "w.close()\n"
        "m = build_detector('resnet50', remat=True)\n"
        "print(mesh.size, rows.tolist(), len(os.listdir('tb')),\n"
        "      m.backbone.remat)\n", tmp_path)
    assert out.strip() == "1 [0, 1, 2, 3] 1 True"


def test_host_extras_run_with_jax_blocked(tmp_path):
    """The native loader and eval3d core (built from the port's own
    sources), the h5 export and import, the ImageNet cache (fetch
    injected), the drawing functions and bin/debug run without JAX."""
    from PIL import Image

    import numpy as np

    Image.fromarray(np.full((20, 30, 3), 7, np.uint8)).save(
        tmp_path / "a.png")
    out = _run_blocked(
        "import hashlib, numpy as np, torch\n"
        "from ground_plane_polling_tpu_torch.data import native_loader\n"
        "from ground_plane_polling_tpu_torch.utils import (eval3d,\n"
        "    eval3d_native, visualization)\n"
        "from ground_plane_polling_tpu_torch.models import (\n"
        "    GPPRetinaNet, h5_export, h5_import, imagenet, init_detector,\n"
        "    load_state)\n"
        "from ground_plane_polling_tpu_torch.models.resnet import (\n"
        "    ResNetBackbone)\n"
        "from ground_plane_polling_tpu_torch.bin import debug\n"
        "if native_loader.available():\n"
        "    img = native_loader.NativeImageLoader().load_image(\n"
        "        'a.png', (32, 32), 1.0)\n"
        "    print('native', img.shape, float(img[:20, :30].mean()))\n"
        "else:\n"
        "    print('native', native_loader.build_error().splitlines()[-1])\n"
        "print('eval3d', eval3d._native() is not None)\n"
        "m = init_detector(GPPRetinaNet(ResNetBackbone((1, 1, 1, 1)),\n"
        "                               feature_size=64), 0)\n"
        "h5_export.export_reference_h5(m, 'm.h5', stage_sizes=(1,) * 4)\n"
        "load_state(m, h5_import.flatten_variables(\n"
        "    h5_import.load_reference_h5('m.h5', stage_sizes=(1,) * 4)))\n"
        "print('h5 ok')\n"
        "md5 = hashlib.md5(b'w').hexdigest()\n"
        "imagenet._CHECKSUMS['resnet50'] = md5\n"
        "def fetch(url, dest):\n"
        "    open(dest, 'wb').write(b'w')\n"
        "print('cached', imagenet.download_imagenet(\n"
        "    'resnet50', cache_dir='c', fetch=fetch).endswith('.h5'))\n"
        "c = visualization.draw_boxes(np.zeros((8, 8, 3), np.uint8),\n"
        "                             np.array([[6, 6, 1, 1]]), (0, 0, 255))\n"
        "print('drawn', int(c.sum() > 0))\n"
        "print(debug.parse_args(['kitti', 'x']).dataset_type)\n", tmp_path)
    lines = out.splitlines()
    assert lines[0] == "native (32, 32, 3) 7.0" or "png.h" in lines[0]
    assert lines[1:] == ["eval3d True", "h5 ok", "cached True", "drawn 1",
                         "kitti"]
