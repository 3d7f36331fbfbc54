"""The port's native C++ image loader (data/native_loader.py, built with g++
from its own copy of native/gpp_loader.cpp with the JAX package's flags)
against the JAX package's, and the native branch of the port's KittiLoader
against the JAX KittiLoader's default, which is native.

Every comparison is bit for bit: the same source built with the same flags
on the same machine. The tests skip, as the JAX package's
test_native_loader.py does, where g++, libpng or libjpeg is missing.
"""

import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.data import native_loader as jax_native
from ground_plane_polling_tpu.data.kitti import KittiDataset as JaxDataset
from ground_plane_polling_tpu.data.pipeline import KittiLoader as JaxLoader
from ground_plane_polling_tpu_torch.data import native_loader
from ground_plane_polling_tpu_torch.data.kitti import KittiDataset
from ground_plane_polling_tpu_torch.data.pipeline import KittiLoader
from ground_plane_polling_tpu_torch.kernels import nvcc_build

from .test_torch_train_loop import LOADER, RAW_KEYS, mixed_root  # noqa: F401

torch.set_num_threads(2)

SCALES = [1.0, 0.5, 0.731, 1.6]


@pytest.fixture(scope="module")
def loaders():
    if not (native_loader.available() and jax_native.available()):
        pytest.skip("native loader toolchain unavailable: "
                    f"{native_loader.build_error()}")
    return (native_loader.NativeImageLoader(n_threads=4),
            jax_native.NativeImageLoader(n_threads=4))


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """name -> (path, RGB array): seeded noise and a smooth gradient, as
    PNG and as JPEG."""
    from PIL import Image

    tmp = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:47, 0:81]
    arrays = {"noise": rng.randint(0, 256, (48, 80, 3), dtype=np.uint8),
              "grad": np.stack([yy * 5 % 256, xx * 3 % 256, (yy + xx) % 256],
                               axis=-1).astype(np.uint8)}
    out = {}
    for name, arr in arrays.items():
        for ext in ("png", "jpg"):
            path = str(tmp / f"{name}.{ext}")
            Image.fromarray(arr).save(path, quality=90)
            out[f"{name}.{ext}"] = (path, arr)
    return out


def test_builds_into_build_dir_with_the_jax_flags():
    """The library lies in _build/ under a name keyed by its source and the
    JAX package's g++ flags (no -march=native, no fast-math)."""
    path = native_loader.build()
    assert path.parent == nvcc_build.BUILD_DIR
    assert path.name == "libgpp_loader_" + nvcc_build.build_key(
        native_loader.SOURCE,
        native_loader.GXX_FLAGS + native_loader.GXX_LIBS) + ".so"
    assert native_loader.GXX_FLAGS + native_loader.GXX_LIBS == (
        "-O3", "-shared", "-fPIC", "-std=c++17", "-lpng", "-ljpeg",
        "-pthread")
    assert native_loader.build() == path  # built once


@pytest.mark.parametrize("name", ["noise.png", "noise.jpg", "grad.png",
                                  "grad.jpg"])
def test_decode_and_size_equal_jax(loaders, images, name):
    ours, theirs = loaders
    path, rgb = images[name]
    assert ours.image_size(path) == theirs.image_size(path) == rgb.shape[:2]
    got = ours.load_image(path, rgb.shape[:2], 1.0)
    np.testing.assert_array_equal(got, theirs.load_image(path, rgb.shape[:2],
                                                         1.0))
    if name.endswith(".png"):  # lossless: PIL's pixels, BGR
        np.testing.assert_array_equal(got.astype(np.uint8), rgb[:, :, ::-1])


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("name", ["noise.png", "grad.jpg"])
def test_load_image_equals_jax(loaders, images, name, scale):
    """Resize and pad at several scales, into a canvas larger than the
    resized image and into one that crops it."""
    ours, theirs = loaders
    path, rgb = images[name]
    for out_hw in ((96, 160), (32, 48)):
        got = ours.load_image(path, out_hw, scale)
        assert got.shape == (*out_hw, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, theirs.load_image(path, out_hw,
                                                             scale))
    h = min(int(rgb.shape[0] * scale + 0.5), 96)
    w = min(int(rgb.shape[1] * scale + 0.5), 160)
    padded = ours.load_image(path, (96, 160), scale)
    assert (padded[h:] == 0).all() and (padded[:, w:] == 0).all()


def test_load_batch_equals_jax_and_single_loads(loaders, images):
    ours, theirs = loaders
    paths = [images[n][0] for n in sorted(images)] * 2
    scales = [SCALES[i % len(SCALES)] for i in range(len(paths))]
    got = ours.load_batch(paths, (64, 96), scales)
    np.testing.assert_array_equal(got, theirs.load_batch(paths, (64, 96),
                                                         scales))
    for i, (p, s) in enumerate(zip(paths, scales)):
        np.testing.assert_array_equal(got[i], ours.load_image(p, (64, 96), s))


def test_missing_file_raises(loaders, images, tmp_path):
    ours, _ = loaders
    missing = str(tmp_path / "nope.png")
    with pytest.raises(IOError):
        ours.load_image(missing, (32, 32), 1.0)
    with pytest.raises(IOError):
        ours.image_size(missing)
    with pytest.raises(IOError, match="1/2"):
        ours.load_batch([images["noise.png"][0], missing], (32, 32),
                        [1.0, 1.0])
    with pytest.raises(ValueError, match="scales"):
        ours.load_batch([missing], (32, 32), [1.0, 1.0])


def test_build_error_is_kept(monkeypatch):
    """Without a compiler the loader is unavailable and says why; the
    KittiLoader then resizes with cv2 and says so once on stderr."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_error", None)
    monkeypatch.setattr(native_loader, "build", lambda: (_ for _ in ()).throw(
        RuntimeError("g++ failed (1): fatal error: png.h: No such file")))
    assert not native_loader.available()
    assert "png.h" in native_loader.build_error()
    with pytest.raises(RuntimeError, match="png.h"):
        native_loader.NativeImageLoader()


def test_kitti_loader_falls_back_and_says_so(mixed_root, monkeypatch,  # noqa: F811
                                             capfd):
    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(native_loader, "build_error",
                        lambda: "g++ failed\nfatal error: png.h: missing")
    kw = dict(device="cpu", raw_batches=True, shuffle=False, **LOADER)
    loader = KittiLoader(KittiDataset(mixed_root, "train"), **kw)
    assert not loader.native
    err = capfd.readouterr().err
    assert err.count("KittiLoader:") == 1 and "png.h: missing" in err
    off = KittiLoader(KittiDataset(mixed_root, "train"),
                      use_native_loader=False, **kw)
    assert not off.native and "native loader off" in capfd.readouterr().err
    np.testing.assert_array_equal(
        next(iter(loader.epoch(prefetch=0)))["images"].numpy(),
        next(iter(off.epoch(prefetch=0)))["images"].numpy())


@pytest.mark.parametrize("seed", [0, 3])
def test_train_batches_equal_jax_native(loaders, mixed_root, seed,  # noqa: F811
                                        capfd):
    """Unaugmented raw training batches of both KittiLoaders, each on its
    default (native) loader: groups, order and every array bit for bit."""
    port = KittiLoader(KittiDataset(mixed_root, "train"), raw_batches=True,
                       device="cpu", seed=seed, **LOADER)
    jax_ = JaxLoader(JaxDataset(mixed_root, "train"), raw_batches=True,
                     seed=seed, **LOADER)
    assert port.native and jax_._native is not None
    assert "native C++ image loader" in capfd.readouterr().err
    assert port._groups == jax_._groups
    assert port._bucket_shape == jax_._bucket_shape
    for _ in range(2):
        got = list(port.epoch(prefetch=0))
        want = list(jax_.epoch(prefetch=0))
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            for key in RAW_KEYS:
                gv = g[key].numpy()
                assert gv.dtype == w[key].dtype, key
                np.testing.assert_array_equal(gv, w[key], err_msg=key)


def test_eval_inputs_equal_jax_native(loaders, mixed_root):  # noqa: F811
    got = list(KittiLoader(KittiDataset(mixed_root, "train"),
                           image_min_side=64,
                           image_max_side=224).eval_inputs())
    want = list(JaxLoader(JaxDataset(mixed_root, "train"), image_min_side=64,
                          image_max_side=224, shuffle=False).eval_inputs())
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g["index"] == w["index"] and g["scale"] == w["scale"]
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["P_inv"], w["P_inv"])
        np.testing.assert_array_equal(g["annotations"], w["annotations"])


def test_native_canvas_within_one_count_of_cv2(loaders, mixed_root):  # noqa: F811
    """The native float bilinear, rounded, against cv2's uint8 bilinear on
    the same frames: within one count, on the same true sizes."""
    kw = dict(device="cpu", **LOADER)
    native = KittiLoader(KittiDataset(mixed_root, "train"), **kw)
    cv = KittiLoader(KittiDataset(mixed_root, "train"),
                     use_native_loader=False, **kw)
    for i in range(len(native.ds)):
        a, b = native._load_padded(i), cv._load_padded(i)
        np.testing.assert_array_equal(a[6], b[6])  # true (h, w)
        gap = np.abs(a[0].astype(int) - b[0].astype(int))
        assert gap.max() <= 1, (i, gap.max())
