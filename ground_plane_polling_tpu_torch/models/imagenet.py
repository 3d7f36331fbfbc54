"""ImageNet backbone weights for --imagenet-weights, md5-checked (port of
ground_plane_polling_tpu/models/imagenet.py).

The Keras reference's download path: fizyr keras-models release assets
with an md5 checksum. Same URLs, same checksums, same cache-and-verify
semantics, with urllib (no TF or Keras). A file already in the cache
(`GPP_WEIGHTS_CACHE`, else ~/.gpp_tpu/models) with the right md5 is used
as it is; a wrong md5 fetches once more. The file is keras_resnet layout,
which models/h5_import.py::load_reference_h5(..., backbone_only=True) maps
onto the backbone, and `merge_backbone` lays over fresh weights.

Nothing is fetched at import, at build time or by the tests: `fetch` is a
parameter. Without network access the fetch fails with a RuntimeError that
names the URL, the cache path and the --backbone-h5 alternative.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import urllib.error
import urllib.request

__all__ = ["download_imagenet", "imagenet_checksums"]

_RESNET_URL = ("https://github.com/fizyr/keras-models/releases/download/"
               "v0.0.1/{}")
# md5 table from the reference (models/resnet.py:46-52)
_CHECKSUMS = {
    "resnet50": "3e9f4e4f77bbe2c9bec13b53ee1c2319",
    "resnet101": "05dc86924389e5b401a9ea0348a3213c",
    "resnet152": "6ee11ef2b135592f8031058820bb9e71",
}
_TIMEOUT_SECS = 30.0


def imagenet_checksums():
    return dict(_CHECKSUMS)


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fetch(url: str, dest: str) -> None:
    """Network fetch, isolated for tests; raises on any egress failure."""
    tmp = dest + ".part"
    with urllib.request.urlopen(url, timeout=_TIMEOUT_SECS) as r, \
            open(tmp, "wb") as f:
        shutil.copyfileobj(r, f)
    os.replace(tmp, dest)


def download_imagenet(backbone: str, cache_dir: str | None = None,
                      fetch=None) -> str:
    """Return a local path to the keras_resnet ImageNet h5 for `backbone`.

    Cached-and-verified: an existing file with the right md5 is reused; a
    wrong md5 (partial/corrupt download) triggers one re-download, and a
    second mismatch raises. Without network egress, raises RuntimeError
    naming the URL and the --backbone-h5 escape hatch.
    """
    if backbone not in _CHECKSUMS:
        raise ValueError(
            f"no ImageNet weights published for backbone '{backbone}' "
            f"(available: {sorted(_CHECKSUMS)}); pass --backbone-h5 or "
            f"--weights instead")
    checksum = _CHECKSUMS[backbone]
    depth = backbone.replace("resnet", "")
    filename = f"ResNet-{depth}-model.keras.h5"
    url = _RESNET_URL.format(filename)
    cache_dir = cache_dir or os.environ.get(
        "GPP_WEIGHTS_CACHE",
        os.path.join(os.path.expanduser("~"), ".gpp_tpu", "models"))
    os.makedirs(cache_dir, exist_ok=True)
    dest = os.path.join(cache_dir, filename)
    fetch = fetch or _fetch

    for attempt in range(2):
        if os.path.exists(dest):
            got = _md5(dest)
            if got == checksum:
                return dest
            os.remove(dest)  # corrupt/partial: re-download once
            if attempt:
                raise RuntimeError(
                    f"downloaded {filename} has md5 {got}, expected "
                    f"{checksum} (source: {url})")
        try:
            fetch(url, dest)
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise RuntimeError(
                f"cannot download ImageNet weights ({url}): {e}. "
                f"This environment has no network egress — download the "
                f"file elsewhere and pass it via --backbone-h5, or place "
                f"it at {dest}") from e
        finally:
            part = dest + ".part"
            if os.path.exists(part):  # failed mid-copy: no stale partials
                os.remove(part)
    got = _md5(dest)
    if got != checksum:
        raise RuntimeError(
            f"downloaded {filename} has md5 {got}, expected {checksum} "
            f"(source: {url})")
    return dest
