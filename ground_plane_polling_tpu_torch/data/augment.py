"""Training augmentation, photometric + geometric (port of
ground_plane_polling_tpu/data/augment.py), on a batch axis.

Drawing and applying are separate. `sample_params` draws each example's
angle, translation, shear, scale, flips and photometric factors on the host
from a `torch.Generator` (a few scalars per example: no device RNG, no
sync), `draw_augmentation` turns them into 3x3 matrices and a (B, 4) factor
array that go to the device with the batch, and the functions below apply
them there. The JAX package draws with its own PRNG inside its program;
the two generators give different numbers, so the tests hand both sides the
same parameters.

Photometric chain on [0, 1] floats, in the Keras reference's order
brightness -> contrast -> saturation -> hue, then clipped:
  * brightness: x + U(-0.15, 0.15)
  * contrast:   (x - mean) * U(0.5, 1.5) + mean  (per-channel mean over the
                true pixels)
  * saturation: HSV S scaled by U(0.5, 1.5)
  * hue:        H + U(-0.2, 0.2) (mod 1)
on BGR arrays, as the reference fed BGR to RGB-assuming HSV math.

Geometric: rotation @ translation @ shear @ scale @ flip, its translation
column then scaled by (w, h) and the origin moved to the image centre.
Images are inverse-mapped with bilinear sampling and a replicate border;
annotations take the hull of their 4 transformed box corners and their 4
transformed keypoints, and an x-flip swaps the l/r keypoints and the
orientations 0<->1, 2<->3.

Padded canvases: with `image_hw` (each example's true (h, w)) the contrast
mean sees the true pixels only, sampling is clamped to the true frame, and
the padding stays exactly zero, so augmenting a padded canvas equals
augmenting the image and padding it afterwards (the reference's order).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["AugmentConfig", "sample_params", "compose_transform",
           "draw_augmentation", "photometric", "warp_image",
           "transform_annotations", "transform_boxes", "augment_batch",
           "augment_example"]


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    # defaults = the Keras reference's training defaults
    min_rotation: float = -0.1
    max_rotation: float = 0.1
    min_translation: Tuple[float, float] = (-0.1, -0.1)
    max_translation: Tuple[float, float] = (0.1, 0.1)
    min_shear: float = -0.1
    max_shear: float = 0.1
    min_scaling: Tuple[float, float] = (0.9, 0.9)
    max_scaling: Tuple[float, float] = (1.1, 1.1)
    flip_x_chance: float = 0.5
    flip_y_chance: float = 0.0
    brightness_delta: float = 0.15
    contrast_range: Tuple[float, float] = (0.5, 1.5)
    saturation_range: Tuple[float, float] = (0.5, 1.5)
    hue_delta: float = 0.2


DEFAULT = AugmentConfig()


# --------------------------------------------------------------------------
# parameters, drawn on the host
# --------------------------------------------------------------------------

def sample_params(generator: torch.Generator, n: int,
                  config: AugmentConfig = DEFAULT) -> dict:
    """Draw the augmentation parameters of n examples (CPU, float32):
    angle, shear, brightness, contrast, saturation, hue (n,); translation
    and scale (n, 2); flip_x, flip_y (n,) bool. Each is uniform over its
    AugmentConfig range; a flip happens with its chance."""
    def uniform(lo, hi, *shape):
        lo = torch.as_tensor(lo, dtype=torch.float32)
        hi = torch.as_tensor(hi, dtype=torch.float32)
        return lo + (hi - lo) * torch.rand(n, *shape, generator=generator)

    return {
        "angle": uniform(config.min_rotation, config.max_rotation),
        "translation": uniform(config.min_translation,
                               config.max_translation, 2),
        "shear": uniform(config.min_shear, config.max_shear),
        "scale": uniform(config.min_scaling, config.max_scaling, 2),
        "flip_x": torch.rand(n, generator=generator) < config.flip_x_chance,
        "flip_y": torch.rand(n, generator=generator) < config.flip_y_chance,
        "brightness": uniform(-config.brightness_delta,
                              config.brightness_delta),
        "contrast": uniform(*config.contrast_range),
        "saturation": uniform(*config.saturation_range),
        "hue": uniform(-config.hue_delta, config.hue_delta),
    }


def _mat(entries):
    """9 tensors of one shape (...) -> (..., 3, 3), row-major."""
    return torch.stack(entries, dim=-1).reshape(*entries[0].shape, 3, 3)


def compose_transform(angle, tx, shear_angle, scale, flip_x, flip_y,
                      image_hw):
    """The augmentation matrix, float32, on any leading shape (...):
    rotation @ translation @ shear @ scaling @ flip, then the composed
    translation column scaled by (w, h) (so the relative translation runs
    along the image axes, not rotated with the image) and the origin moved
    to the image centre.

    angle, shear_angle (...) radians; tx (..., 2) fractions of (w, h);
    scale (..., 2); flip_x, flip_y (...) bool; image_hw (..., 2) the true
    (h, w). Returns (..., 3, 3).
    """
    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32)

    angle, shear = f32(angle), f32(shear_angle)
    tx, scale, hw = f32(tx), f32(scale), f32(image_hw)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)

    def trans(t0, t1):
        return _mat([one, zero, t0, zero, one, t1, zero, zero, one])

    def scaling(s0, s1):
        return _mat([s0, zero, zero, zero, s1, zero, zero, zero, one])

    c, s = torch.cos(angle), torch.sin(angle)
    rot = _mat([c, -s, zero, s, c, zero, zero, zero, one])
    shear_m = _mat([one, -torch.sin(shear), zero, zero, torch.cos(shear),
                    zero, zero, zero, one])
    flip = scaling(1.0 - 2.0 * f32(flip_x), 1.0 - 2.0 * f32(flip_y))
    m = (rot @ trans(tx[..., 0], tx[..., 1]) @ shear_m
         @ scaling(scale[..., 0], scale[..., 1]) @ flip)
    h, w = hw[..., 0], hw[..., 1]
    column = torch.stack([m[..., 0, 2] * w, m[..., 1, 2] * h, m[..., 2, 2]],
                         dim=-1)
    m = torch.cat([m[..., :2], column[..., None]], dim=-1)
    return trans(0.5 * w, 0.5 * h) @ m @ trans(-(0.5 * w), -(0.5 * h))


def draw_augmentation(generator: torch.Generator, sizes: torch.Tensor,
                      config: AugmentConfig = DEFAULT) -> dict:
    """One batch's augmentation, drawn on the host for examples of true
    sizes (B, 2): {"transform": (B, 3, 3), "flip_x": (B,) bool,
    "photometric": (B, 4) brightness, contrast, saturation, hue}."""
    p = sample_params(generator, sizes.shape[0], config)
    return {
        "transform": compose_transform(p["angle"], p["translation"],
                                       p["shear"], p["scale"], p["flip_x"],
                                       p["flip_y"], sizes),
        "flip_x": p["flip_x"],
        "photometric": torch.stack([p["brightness"], p["contrast"],
                                    p["saturation"], p["hue"]], dim=1),
    }


# --------------------------------------------------------------------------
# photometric chain
# --------------------------------------------------------------------------

def _rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    rng = maxc - minc
    s = torch.where(maxc > 0, rng / maxc.clamp(min=1e-12), 0.0)
    safe = rng.clamp(min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(rng > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(x):
    h, s, v = x[..., 0], x[..., 1], x[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6).to(torch.int64)[None]
    # sector i picks (r, g, b) from (v, q, p, p, t, v), (t, v, v, q, p, p)
    # and (p, p, t, v, v, q)
    pick = [torch.stack(c).gather(0, i)[0] for c in
            ((v, q, p, p, t, v), (t, v, v, q, p, p), (p, p, t, v, v, q))]
    return torch.stack(pick, dim=-1)


def _valid_mask(shape_hw, image_hw, like):
    """(B, H, W, 1) mask of true-image pixels on padded canvases."""
    ys = torch.arange(shape_hw[0], dtype=torch.float32, device=like.device)
    xs = torch.arange(shape_hw[1], dtype=torch.float32, device=like.device)
    hw = image_hw.to(torch.float32)
    mask = ((ys[None, :, None] < hw[:, 0, None, None])
            & (xs[None, None, :] < hw[:, 1, None, None]))
    return mask[..., None].to(like.dtype)


def photometric(images, factors, image_hw=None):
    """Photometric chain on (B, H, W, 3) images in [0, 255].

    factors (B, 4): brightness delta, contrast, saturation, hue delta.
    image_hw (B, 2): the true (h, w) of each padded canvas, or None for
    unpadded images."""
    x = images / 255.0
    f = factors.to(x.dtype)[:, None, None, :]
    x = x + f[..., 0:1]
    if image_hw is None:
        mask = None
        mean = x.mean(dim=(1, 2), keepdim=True)
    else:
        mask = _valid_mask(images.shape[1:3], image_hw, x)
        count = mask.sum(dim=(1, 2, 3), keepdim=True).clamp(min=1.0)
        mean = (x * mask).sum(dim=(1, 2), keepdim=True) / count
    x = (x - mean) * f[..., 1:2] + mean
    hsv = _rgb_to_hsv(x.clamp(0.0, 1.0))
    hsv = torch.stack([torch.remainder(hsv[..., 0] + f[..., 3], 1.0),
                       (hsv[..., 1] * f[..., 2]).clamp(0.0, 1.0),
                       hsv[..., 2]], dim=-1)
    x = 255.0 * _hsv_to_rgb(hsv).clamp(0.0, 1.0)
    if mask is not None:
        x = x * mask  # padding stays exactly zero
    return x


# --------------------------------------------------------------------------
# image warp
# --------------------------------------------------------------------------

def warp_image(images, matrices, image_hw=None):
    """Apply forward homogeneous 3x3 matrices (B, 3, 3) to (B, H, W, C)
    images: output pixel (x, y) samples the input at matrix^-1 @ (x, y),
    bilinear, with a replicate border at the true frame (`image_hw`
    (B, 2)) or at the canvas edge (None); pixels outside the true frame
    stay zero."""
    b, h, w, ch = images.shape
    if image_hw is None:
        clamp_h = torch.full((b,), h - 1.0, device=images.device)
        clamp_w = torch.full((b,), w - 1.0, device=images.device)
    else:
        clamp_h, clamp_w = image_hw[:, 0] - 1.0, image_hw[:, 1] - 1.0
    # inv_ex: no error check, so no device-to-host sync
    inv = torch.linalg.inv_ex(matrices.to(torch.float32))[0].to(images.dtype)
    ys = torch.arange(h, dtype=images.dtype, device=images.device)[:, None]
    xs = torch.arange(w, dtype=images.dtype, device=images.device)[None, :]
    inv = inv[:, :, :, None, None]
    sx = inv[:, 0, 0] * xs + inv[:, 0, 1] * ys + inv[:, 0, 2]
    sy = inv[:, 1, 0] * xs + inv[:, 1, 1] * ys + inv[:, 1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    flat = images.reshape(b, h * w, ch)
    clamp_h = clamp_h.to(images.dtype)[:, None, None]
    clamp_w = clamp_w.to(images.dtype)[:, None, None]

    def sample(yi, xi):
        yi = torch.minimum(yi.clamp(min=0.0), clamp_h).to(torch.int64)
        xi = torch.minimum(xi.clamp(min=0.0), clamp_w).to(torch.int64)
        idx = (yi * w + xi).reshape(b, h * w, 1).expand(b, h * w, ch)
        return flat.gather(1, idx).reshape(b, h, w, ch)

    top = sample(y0, x0) * (1 - fx) + sample(y0, x0 + 1) * fx
    bot = sample(y0 + 1, x0) * (1 - fx) + sample(y0 + 1, x0 + 1) * fx
    out = top * (1 - fy) + bot * fy
    if image_hw is not None:
        out = out * _valid_mask((h, w), image_hw, out)
    return out


# --------------------------------------------------------------------------
# annotation transform
# --------------------------------------------------------------------------

def _hull(matrices, boxes):
    """Axis-aligned hull (..., 4) of the 4 transformed corners of boxes
    (B, G, 4) under matrices (B, 3, 3)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    corners = torch.stack([torch.stack([x1, x2, x1, x2], dim=-1),
                           torch.stack([y1, y2, y2, y1], dim=-1),
                           x1.new_ones(*x1.shape, 4)],
                          dim=-2)                              # (B, G, 3, 4)
    tc = torch.einsum("bij,bgjk->bgik", matrices.to(boxes.dtype), corners)
    return torch.stack([tc[..., 0, :].amin(-1), tc[..., 1, :].amin(-1),
                        tc[..., 0, :].amax(-1), tc[..., 1, :].amax(-1)],
                       dim=-1)


def transform_annotations(matrices, flip_x, annotations):
    """Transform padded (B, G, 17) annotations by (B, 3, 3) matrices; with
    flip_x (B,) the l/r keypoints and orientations 0<->1, 2<->3 swap."""
    b, g = annotations.shape[:2]
    kp = annotations[..., 4:12].reshape(b, g, 4, 2)
    kp_h = torch.cat([kp, torch.ones_like(kp[..., :1])], dim=-1)
    tkp = torch.einsum("bij,bgkj->bgki", matrices.to(annotations.dtype),
                       kp_h)[..., :2]
    flip = flip_x.to(torch.bool)
    # the l/r swap and the orientation swap below take no index or table:
    # either would be copied to the device, and the host would wait for it
    swapped_kp = torch.stack([tkp[:, :, 2], tkp[:, :, 1], tkp[:, :, 0],
                              tkp[:, :, 3]], dim=2)
    tkp = torch.where(flip[:, None, None, None], swapped_kp, tkp)
    orient = annotations[..., 16].to(torch.int32)
    swapped = orient.clamp(0, 3) ^ 1  # 0 <-> 1, 2 <-> 3
    orient = torch.where(flip[:, None], swapped, orient)
    return torch.cat([_hull(matrices, annotations[..., :4]),
                      tkp.reshape(b, g, 8), annotations[..., 12:16],
                      orient[..., None].to(annotations.dtype)], dim=-1)


def transform_boxes(matrices, boxes):
    """Transform padded (B, M, 4) ignore-region boxes (hull of 4 corners)."""
    return _hull(matrices, boxes)


# --------------------------------------------------------------------------
# the whole augmentation
# --------------------------------------------------------------------------

def augment_batch(images, annotations, ignore_boxes, transform, flip_x,
                  factors, image_hw=None):
    """Photometric then geometric augmentation of a batch.

    images (B, H, W, 3) float in [0, 255] (before mean subtraction);
    annotations (B, G, 17) and ignore_boxes (B, M, 4) padded; transform,
    flip_x and factors as `draw_augmentation` gives them, built from each
    example's true size; image_hw (B, 2) the true (h, w) on padded
    canvases, or None. Returns (images, annotations, ignore_boxes)."""
    images = photometric(images, factors, image_hw)
    images = warp_image(images, transform, image_hw)
    return (images, transform_annotations(transform, flip_x, annotations),
            transform_boxes(transform, ignore_boxes))


def augment_example(image, annotations, ignore_boxes, transform, flip_x,
                    factors, image_hw=None):
    """`augment_batch` for one example (no batch axis)."""
    hw = None if image_hw is None else torch.as_tensor(image_hw)[None]
    out = augment_batch(image[None], annotations[None], ignore_boxes[None],
                        transform[None], torch.as_tensor(flip_x)[None],
                        factors[None], hw)
    return tuple(t[0] for t in out)
