"""The port's ImageNet weight download (models/imagenet.py) against the JAX
package's: the cases of tests/test_imagenet_download.py on both, with the
network call injected (`fetch`), so nothing here opens a socket. The egress
failure is a fetch that raises as urllib does without a route."""

import hashlib
import os
import urllib.error

import numpy as np
import pytest

from ground_plane_polling_tpu.models import imagenet as jax_imagenet
from ground_plane_polling_tpu_torch.models import imagenet

MODULES = {"port": imagenet, "jax": jax_imagenet}


@pytest.fixture(params=sorted(MODULES))
def mod(request):
    return MODULES[request.param]


@pytest.fixture
def fixture_h5(tmp_path, monkeypatch):
    """A local 'weights file' whose md5 is patched into both checksum
    tables, plus a fetch stub that copies it and counts calls."""
    payload = np.random.RandomState(0).bytes(4096)
    src = tmp_path / "weights_src.bin"
    src.write_bytes(payload)
    md5 = hashlib.md5(payload).hexdigest()
    for m in MODULES.values():
        monkeypatch.setitem(m._CHECKSUMS, "resnet50", md5)
    calls = []

    def fetch(url, dest):
        calls.append(url)
        with open(src, "rb") as f, open(dest, "wb") as g:
            g.write(f.read())

    return src, md5, fetch, calls


def test_download_verify_and_cache(mod, tmp_path, fixture_h5):
    _, _, fetch, calls = fixture_h5
    cache = str(tmp_path / "cache")
    path = mod.download_imagenet("resnet50", cache_dir=cache, fetch=fetch)
    assert os.path.exists(path) and len(calls) == 1
    assert path == os.path.join(cache, "ResNet-50-model.keras.h5")
    assert calls == ["https://github.com/fizyr/keras-models/releases/"
                     "download/v0.0.1/ResNet-50-model.keras.h5"]
    # second call: cache hit, no fetch
    assert mod.download_imagenet("resnet50", cache_dir=cache,
                                 fetch=fetch) == path
    assert len(calls) == 1


def test_cache_dir_from_the_environment(mod, tmp_path, fixture_h5,
                                        monkeypatch):
    _, _, fetch, _ = fixture_h5
    monkeypatch.setenv("GPP_WEIGHTS_CACHE", str(tmp_path / "env_cache"))
    path = mod.download_imagenet("resnet50", fetch=fetch)
    assert os.path.dirname(path) == str(tmp_path / "env_cache")


def test_corrupt_cache_redownloads(mod, tmp_path, fixture_h5):
    _, md5, fetch, calls = fixture_h5
    cache = str(tmp_path / "cache")
    os.makedirs(cache)
    with open(os.path.join(cache, "ResNet-50-model.keras.h5"), "wb") as f:
        f.write(b"truncated")
    path = mod.download_imagenet("resnet50", cache_dir=cache, fetch=fetch)
    assert len(calls) == 1  # re-downloaded over the corrupt file
    assert hashlib.md5(open(path, "rb").read()).hexdigest() == md5


def test_persistent_corruption_raises(mod, tmp_path, fixture_h5):
    _, _, _, calls = fixture_h5

    def bad_fetch(url, dest):
        calls.append(url)
        with open(dest, "wb") as f:
            f.write(b"always wrong")

    with pytest.raises(RuntimeError, match="md5"):
        mod.download_imagenet("resnet50", cache_dir=str(tmp_path / "c"),
                              fetch=bad_fetch)


def test_no_egress_clean_error(mod, tmp_path):
    def no_net(url, dest):
        with open(dest + ".part", "wb") as f:  # a partial copy is removed
            f.write(b"half")
        raise urllib.error.URLError("no route to host")

    cache = tmp_path / "c"
    with pytest.raises(RuntimeError, match="backbone-h5") as info:
        mod.download_imagenet("resnet50", cache_dir=str(cache),
                              fetch=no_net)
    assert "no network egress" in str(info.value)
    assert os.listdir(cache) == []


def test_messages_equal_jax(tmp_path):
    def no_net(url, dest):
        raise urllib.error.URLError("no route to host")

    got, want = [], []
    for m, out in ((imagenet, got), (jax_imagenet, want)):
        with pytest.raises(RuntimeError) as info:
            m.download_imagenet("resnet101", cache_dir=str(tmp_path / "c"),
                                fetch=no_net)
        out.append(str(info.value))
        with pytest.raises(ValueError) as info:
            m.download_imagenet("vgg16", cache_dir=str(tmp_path / "c"))
        out.append(str(info.value))
    assert got == want


def test_unknown_backbone_rejected(mod, tmp_path):
    with pytest.raises(ValueError, match="vgg16"):
        mod.download_imagenet("vgg16", cache_dir=str(tmp_path / "c"))


def test_checksum_table_matches_reference(mod):
    assert mod.imagenet_checksums() == {
        "resnet50": "3e9f4e4f77bbe2c9bec13b53ee1c2319",
        "resnet101": "05dc86924389e5b401a9ea0348a3213c",
        "resnet152": "6ee11ef2b135592f8031058820bb9e71",
    }
