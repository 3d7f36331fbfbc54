"""Training and evaluation input pipeline (port of
ground_plane_polling_tpu/data/pipeline.py).

Host: read BGR, resize by the min/max-side rule and pad into the image's
padded-shape bucket as a uint8 canvas, and pad the annotations and ignore
boxes to fixed counts with masks and the true (h, w) of each frame on its
canvas. Training draws each batch's augmentation parameters here too
(`augment.draw_augmentation`). The frames go through the native C++ loader
(data/native_loader.py: decode, float bilinear resize, pad, rounded to
uint8) by default, as in the JAX package; when it does not build, or with
`use_native_loader=False`, through cv2 (else PIL, `frames.resize_uint8`).
Each loader says once on stderr which path it takes.

Device (`prepare_batch`): cast the canvas to float32, augment each example
at its true size, subtract the BGR means, and assign the anchor targets;
the filler rows of a short last group get state -1 in all three targets.

Data parallel (`mesh`): every rank builds the same groups, order and
per-batch seeds from `seed`; `batch_size` is the global batch, and a rank
loads only its rows of each group and keeps its rows of the augmentation
drawn for the whole group, so the ranks' rows together are the batch one
process would train on.
"""

from __future__ import annotations

import sys
from typing import Iterator

import numpy as np
import torch

from ..kernels.nvcc_build import error_line
from ..ops import anchors as anchor_ops
from ..ops.targets import batched_anchor_targets
from .augment import AugmentConfig, augment_batch, draw_augmentation
from .frames import resize_uint8
from .kitti import BGR_MEAN, KittiDataset, resize_scale

__all__ = ["KittiLoader", "prepare_batch"]

_CONSTS = {}  # (what, device) -> a constant kept on that device


def _on_device(what, device, make) -> torch.Tensor:
    """The constant `make()` on `device`, copied there once: a copy from
    host memory would stall the host at every batch."""
    key = (what, str(device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.as_tensor(make(), device=device)
    return _CONSTS[key]


def _anchors(shape, device) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    return _on_device(("anchors", shape), device,
                      lambda: anchor_ops.anchors_for_shape(shape))


def prepare_batch(raw: dict, num_classes: int, augment: bool,
                  device=None) -> dict:
    """Augment, normalize and assign targets for a raw batch on `device`
    (default: where its images are).

    raw: images (B, H, W, 3) uint8, annotations (B, G, 17), ann_mask (B, G),
    ignores (B, M, 4), ignore_mask (B, M), valid (B,) false on filler rows,
    sizes (B, 2) the true (h, w) of each canvas, and with `augment` the
    transform, flip_x and photometric parameters of `draw_augmentation`.

    Returns image (B, H, W, 3) float32 mean-subtracted, labels (B, A, 8C),
    regression (B, A, 13), regression_dim (B, A*C, 4)."""
    device = raw["images"].device if device is None else torch.device(device)
    t = {k: v.to(device, non_blocking=True) for k, v in raw.items()}
    images = t["images"].to(torch.float32)
    anns, ignores = t["annotations"], t["ignores"]
    if augment:
        images, anns, ignores = augment_batch(
            images, anns, ignores, t["transform"], t["flip_x"],
            t["photometric"], image_hw=t["sizes"])
    images = images - _on_device("bgr_mean", device, lambda: BGR_MEAN)
    targets = batched_anchor_targets(
        _anchors(images.shape[1:3], device), anns, t["ann_mask"], ignores,
        t["ignore_mask"], num_classes=num_classes)
    valid = t["valid"][:, None]
    regression, regression_dim = targets["regression"], targets["regression_dim"]
    regression[..., 12] = torch.where(valid, regression[..., 12], -1.0)
    regression_dim[..., 3] = torch.where(valid, regression_dim[..., 3], -1.0)
    return {
        "image": images,
        "labels": torch.where(valid[..., None], targets["labels"], -1.0),
        "regression": regression,
        "regression_dim": regression_dim,
    }


class KittiLoader:
    """Batched loader over a KittiDataset.

    `epoch()` yields training batches: prepared on `device` (two-stage), or
    with `raw_batches` the host tensors that a fused train step prepares
    itself. `eval_inputs()` yields per-image inference inputs.
    """

    def __init__(self, dataset: KittiDataset, batch_size: int = 1,
                 image_min_side: int = 800, image_max_side: int = 1333,
                 pad_multiple: int = 32, max_annotations: int = 32,
                 max_ignore: int = 8, augment: bool = False,
                 augment_config: AugmentConfig = AugmentConfig(),
                 seed: int = 0, shuffle: bool = True,
                 use_native_loader: bool = True,
                 raw_batches: bool = False, device="cuda", mesh=None):
        if mesh is not None and batch_size % mesh.size:
            raise ValueError(
                f"batch size {batch_size} does not divide over the "
                f"{mesh.size} data-parallel ranks: each rank takes "
                "batch_size / ranks rows of every batch")
        # this rank's rows of every group (all of them on one process)
        self._rows = (slice(0, batch_size) if mesh is None
                      else mesh.rows(batch_size))
        self.ds = dataset
        self.batch_size = batch_size
        self.min_side = image_min_side
        self.max_side = image_max_side
        self.max_annotations = max_annotations
        self.max_ignore = max_ignore
        self.augment = augment
        self.augment_config = augment_config
        self.shuffle = shuffle
        self.raw_batches = raw_batches
        self.device = device
        # group order: numpy's generator, as the JAX package shuffles, so
        # that one seed gives one order in both; augmentation seeds: torch
        self._rng = np.random.RandomState(seed)
        self._gen = torch.Generator().manual_seed(seed)

        # native C++ decode/resize/pad; cv2 (else PIL) when it does not
        # build, as in the JAX package
        self._native = None
        if use_native_loader:
            from . import native_loader

            if native_loader.available():
                self._native = native_loader.NativeImageLoader()
                print("KittiLoader: native C++ image loader", file=sys.stderr)
            else:
                print("KittiLoader: native C++ image loader unavailable, "
                      "resizing with cv2 (else PIL): "
                      + error_line(native_loader.build_error()),
                      file=sys.stderr)
        else:
            print("KittiLoader: cv2 (else PIL) resize, native loader off",
                  file=sys.stderr)

        # one padded shape per distinct (post-resize, pad-rounded) size
        self._bucket_shape = {}
        self._hw = {}
        buckets = {}
        for i in range(len(dataset)):
            hw = self._image_hw(i)
            self._hw[i] = hw
            scale = resize_scale(hw, image_min_side, image_max_side)
            shape = tuple(int(np.ceil(s * scale / pad_multiple)) * pad_multiple
                          for s in hw)
            self._bucket_shape[i] = shape
            buckets.setdefault(shape, []).append(i)
        # the dominant bucket's shape
        self.image_shape = (max(buckets, key=lambda k: len(buckets[k]))
                            if buckets else None)

        # groups (indices, n_valid): per bucket, sorted by aspect ratio; a
        # short last group repeats its last index and prepare_batch masks
        # the filler rows
        self._groups = []
        for shape, idxs in sorted(buckets.items()):
            idxs = sorted(idxs, key=lambda j: self._hw[j][1] / self._hw[j][0])
            for st in range(0, len(idxs), batch_size):
                chunk = idxs[st:st + batch_size]
                n_valid = len(chunk)
                chunk = chunk + [chunk[-1]] * (batch_size - n_valid)
                self._groups.append((chunk, n_valid))

    def __len__(self):
        return len(self._groups)

    @property
    def native(self) -> bool:
        """Whether frames go through the native C++ loader."""
        return self._native is not None

    def _image_hw(self, i):
        """(h, w) of frame i, probed from its file."""
        if self._native is not None:
            return self._native.image_size(self.ds.image_paths[i])
        from PIL import Image

        with Image.open(self.ds.image_paths[i]) as im:
            return (im.height, im.width)

    def _load_padded(self, idx: int):
        """One frame: uint8 canvas of its bucket, at most max_annotations
        annotations and max_ignore ignore boxes scaled to it with their
        masks, the scale, and the true (h, w) on the canvas."""
        anns, ignores = self.ds.load_annotations(idx)
        h, w = self._bucket_shape[idx]
        if self._native is not None:
            src_hw = self._hw[idx]
            scale = resize_scale(src_hw, self.min_side, self.max_side)
            canvas = self._native.load_image(self.ds.image_paths[idx], (h, w),
                                             scale)
            # int(x + 0.5), not round(): the native resize's own size rule
            # (round() would differ on exact halves and mask a real row)
            true_hw = (min(int(src_hw[0] * scale + 0.5), h),
                       min(int(src_hw[1] * scale + 0.5), w))
            # the float bilinear rounded to the nearest count; clipped
            # first, since a uint8 cast wraps
            np.clip(canvas, 0.0, 255.0, out=canvas)
            padded = np.rint(canvas, out=canvas).astype(np.uint8)
        else:
            image = self.ds.load_image(idx)
            scale = resize_scale(image.shape[:2], self.min_side,
                                 self.max_side)
            resized = resize_uint8(image, scale)
            padded = np.zeros((h, w, 3), np.uint8)
            padded[: resized.shape[0], : resized.shape[1]] = resized[:h, :w]
            true_hw = (min(resized.shape[0], h), min(resized.shape[1], w))

        ga = np.zeros((self.max_annotations, 17), np.float32)
        gm = np.zeros(self.max_annotations, bool)
        n = min(len(anns), self.max_annotations)
        if n:
            scaled = anns[:n].copy()
            scaled[:, :12] *= scale
            ga[:n] = scaled
            gm[:n] = True
        ia = np.zeros((self.max_ignore, 4), np.float32)
        im_ = np.zeros(self.max_ignore, bool)
        m = min(len(ignores), self.max_ignore)
        if m:
            ia[:m] = ignores[:m] * scale
            im_[:m] = True
        return padded, ga, gm, ia, im_, scale, np.asarray(true_hw, np.float32)

    def _make_batch(self, group, seed: int, device: torch.device) -> dict:
        indices, n_valid = group
        rows = self._rows
        items = [self._load_padded(i) for i in indices[rows]]
        images, ga, gm, ia, im_, _, sizes = map(np.stack, zip(*items))
        raw = {k: torch.from_numpy(v) for k, v in (
            ("images", images), ("annotations", ga), ("ann_mask", gm),
            ("ignores", ia), ("ignore_mask", im_),
            ("valid", (np.arange(len(indices)) < n_valid)[rows]),
            ("sizes", sizes))}
        if self.augment:
            # drawn for the whole group (the draws do not depend on the
            # sizes, and each row's transform only on its own): rows that
            # another rank loads take the canvas size and are dropped
            all_sizes = torch.tensor(self._bucket_shape[indices[0]],
                                     dtype=torch.float32).repeat(
                                         len(indices), 1)
            all_sizes[rows] = raw["sizes"]
            drawn = draw_augmentation(torch.Generator().manual_seed(seed),
                                      all_sizes, self.augment_config)
            raw.update({k: v[rows] for k, v in drawn.items()})
        if self.raw_batches:
            # the fused train step uploads them: pinned, the copy is
            # asynchronous
            if device.type == "cuda":
                raw = {k: v.pin_memory() for k, v in raw.items()}
            return raw
        return prepare_batch(raw, self.ds.num_classes, self.augment, device)

    def epoch(self, prefetch: int = 2) -> Iterator[dict]:
        """Yield the training batches of one epoch.

        A producer thread loads the next `prefetch` batches while the
        consumer steps. Two-stage (not `raw_batches`), it also prepares
        them on the device. It launches on the device's default stream, as
        the training step in the consumer does: a batch is queued only
        after its preparation kernels are enqueued, so the step's kernels,
        enqueued later on the same stream, cannot read the batch before
        they finish (and the allocator needs no cross-stream record).
        """
        from ..inference import require_device

        device = require_device(self.device)
        groups = list(self._groups)
        if self.shuffle:
            self._rng.shuffle(groups)
        if not groups:
            return
        # one augmentation seed per batch, drawn once per epoch
        seeds = torch.randint(0, 2**62, (len(groups),),
                              generator=self._gen).tolist()

        if prefetch <= 0:
            for group, seed in zip(groups, seeds):
                yield self._make_batch(group, seed, device)
            return

        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = object()
        cancelled = threading.Event()
        error: list = []

        def _put(item) -> bool:
            # bounded put that gives up once the consumer has left
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.25)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for group, seed in zip(groups, seeds):
                    if cancelled.is_set():
                        return
                    if not _put(self._make_batch(group, seed, device)):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised below
                # carried to the consumer: a swallowed error would end the
                # epoch early without a word
                error.append(e)
            finally:
                _put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    if error:
                        raise error[0]
                    break
                yield item
        finally:
            # done, or abandoned mid-epoch (steps_per_epoch < batches):
            # release the producer rather than leave it blocked on the queue
            cancelled.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=30)

    def eval_inputs(self) -> Iterator[dict]:
        """Yield per-image inference inputs; `image` is the raw uint8 BGR
        canvas (1, H, W, 3) for a detect function with
        device_preprocess=True. Grouping images of one bucket into batches
        is the caller's (`training/loop.py::evaluate_model`)."""
        planes = self.ds.planes
        for i in range(len(self.ds)):
            padded, ga, gm, _, _, scale, _ = self._load_padded(i)
            P = self.ds.load_calibration(i)
            P_scaled = np.diag([scale, scale, 1.0]) @ P
            yield {
                "index": i,
                "scale": scale,
                "image": padded[None],
                "P_inv": np.linalg.pinv(P_scaled)[None].astype(np.float32),
                "planes": planes[None].astype(np.float32),
                "annotations": ga[gm],
            }
