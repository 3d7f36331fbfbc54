"""The port's augmentation (data/augment.py) against the JAX package's.

jax.random draws cannot be reproduced in torch, so the tests draw the
parameters with jax.random exactly as the JAX functions do and hand them to
the port. Tolerances:
  * matrices: atol 1e-5 with rtol 1e-6. The translation column holds
    pixels (up to several hundred), where one float32 ulp is already
    1.5e-5 at 228, and the 3x3 products sum in another order;
  * annotations and boxes: atol 1e-4 (pixel coordinates through those
    matrices);
  * images on the 0-255 scale: atol 1e-3. The warp gathers at
    floor(inverse @ (x, y)); torch.linalg.inv and jnp.linalg.inv round
    differently, so a sample may land on the other side of an integer.
    Bilinear sampling is continuous, so that moves a pixel by the rounding
    of the sampling point times the image's gradient: the images here are
    smooth (at most about 17 levels a pixel), as photographs are, which
    keeps that under 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.data import augment as jax_aug
from ground_plane_polling_tpu_torch.data import augment

torch.set_num_threads(2)

CFG = augment.AugmentConfig()
IMG_ATOL = 1e-3


def _smooth_image(h, w, seed=0):
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.uniform(0, 6, 3)
    img = np.stack([127.5 + 120 * np.sin(xs / 9 + p) * np.cos(ys / 7 - p)
                    for p in phase], axis=-1)
    return img.astype(np.float32)


def _jax_photometric_factors(key, config=CFG):
    """The four draws of jax_aug.photometric(key, ...), in its order."""
    ks = jax.random.split(key, 4)
    return np.array([
        jax.random.uniform(ks[0], (), minval=-config.brightness_delta,
                           maxval=config.brightness_delta),
        jax.random.uniform(ks[1], (), minval=config.contrast_range[0],
                           maxval=config.contrast_range[1]),
        jax.random.uniform(ks[2], (), minval=config.saturation_range[0],
                           maxval=config.saturation_range[1]),
        jax.random.uniform(ks[3], (), minval=-config.hue_delta,
                           maxval=config.hue_delta)], np.float32)


def _jax_transform_draws(key, config=CFG):
    """The draws of jax_aug.random_transform_matrix(key, ...)."""
    ks = jax.random.split(key, 6)
    return dict(
        angle=jax.random.uniform(ks[0], (), minval=config.min_rotation,
                                 maxval=config.max_rotation),
        tx=jax.random.uniform(ks[1], (2,),
                              minval=jnp.asarray(config.min_translation),
                              maxval=jnp.asarray(config.max_translation)),
        shear=jax.random.uniform(ks[2], (), minval=config.min_shear,
                                 maxval=config.max_shear),
        scale=jax.random.uniform(ks[3], (2,),
                                 minval=jnp.asarray(config.min_scaling),
                                 maxval=jnp.asarray(config.max_scaling)),
        flip_x=jax.random.uniform(ks[4], ()) < config.flip_x_chance,
        flip_y=jax.random.uniform(ks[5], ()) < config.flip_y_chance)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("seed,hw", [(0, (64, 224)), (1, (375, 1242)),
                                     (2, (56, 88)), (3, (128, 416))])
def test_compose_transform_matches_jax(seed, hw):
    rng = np.random.RandomState(seed)
    angle, shear = rng.uniform(-0.1, 0.1, 2).astype(np.float32)
    tx = rng.uniform(-0.1, 0.1, 2).astype(np.float32)
    scale = rng.uniform(0.9, 1.1, 2).astype(np.float32)
    for flip_x, flip_y in ((False, False), (True, False), (True, True)):
        want = np.asarray(jax_aug.compose_transform(
            angle, tx, shear, scale, flip_x, flip_y, hw))
        got = augment.compose_transform(angle, tx, shear, scale, flip_x,
                                        flip_y, hw)
        assert got.dtype == torch.float32 and got.shape == (3, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_compose_transform_batched_equals_single():
    p = augment.sample_params(torch.Generator().manual_seed(5), 4)
    sizes = torch.tensor([[64, 224], [60, 200], [375, 1242], [56, 88]],
                         dtype=torch.float32)
    batched = augment.compose_transform(p["angle"], p["translation"],
                                        p["shear"], p["scale"], p["flip_x"],
                                        p["flip_y"], sizes)
    for i in range(4):
        one = augment.compose_transform(
            p["angle"][i], p["translation"][i], p["shear"][i], p["scale"][i],
            p["flip_x"][i], p["flip_y"][i], sizes[i])
        torch.testing.assert_close(batched[i], one, rtol=1e-6, atol=1e-5)


def test_hsv_round_trip_and_against_jax():
    rng = np.random.RandomState(1)
    rgb = rng.uniform(0, 1, (40, 50, 3)).astype(np.float32)
    rgb[0, :3] = [[0.5, 0.5, 0.5], [0.0, 0.0, 0.0], [1.0, 0.2, 1.0]]
    hsv = augment._rgb_to_hsv(_t(rgb))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(jax_aug._rgb_to_hsv(
        rgb)), rtol=0, atol=1e-6)
    back = augment._hsv_to_rgb(hsv)
    np.testing.assert_allclose(back.numpy(), rgb, rtol=0, atol=1e-5)
    np.testing.assert_allclose(back.numpy(), np.asarray(jax_aug._hsv_to_rgb(
        np.asarray(hsv))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "canvas"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_photometric_matches_jax(seed, padded):
    """The factors JAX draws from a key, handed to the port."""
    key = jax.random.PRNGKey(seed)
    h, w = 56, 88
    img = np.random.RandomState(seed).uniform(0, 255, (h, w, 3)).astype(
        np.float32)
    hw = None
    if padded:
        canvas = np.zeros((64, 96, 3), np.float32)
        canvas[:h, :w] = img
        img, hw = canvas, np.asarray([h, w], np.float32)
    want = np.asarray(jax_aug.photometric(key, img, CFG, image_hw=hw))
    got = augment.photometric(
        _t(img)[None], _t(_jax_photometric_factors(key))[None],
        None if hw is None else _t(hw)[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=IMG_ATOL)
    if padded:
        assert not got[h:].any() and not got[:, w:].any()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_warp_image_on_padded_canvas_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    h, w = 56, 88
    canvas = np.zeros((64, 96, 3), np.float32)
    canvas[:h, :w] = _smooth_image(h, w, seed)
    hw = np.asarray([h, w], np.float32)
    m, _ = jax_aug.random_transform_matrix(key, hw, CFG)
    m = np.asarray(m)
    want = np.asarray(jax_aug.warp_image(canvas, m, image_hw=hw))
    got = augment.warp_image(_t(canvas)[None], _t(m)[None],
                             _t(hw)[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=IMG_ATOL)
    assert not got[h:].any() and not got[:, w:].any()
    # and on the unpadded image (replicate border at the canvas edge)
    img = canvas[:h, :w]
    np.testing.assert_allclose(
        augment.warp_image(_t(img)[None], _t(m)[None])[0].numpy(),
        np.asarray(jax_aug.warp_image(img, m)), rtol=0, atol=IMG_ATOL)


def _annotations(rng, g=5, n=3):
    ann = np.zeros((g, 17), np.float32)
    for i in range(n):
        x1, y1 = rng.uniform(0, 150), rng.uniform(0, 30)
        ann[i, :4] = [x1, y1, x1 + rng.uniform(10, 60),
                      y1 + rng.uniform(10, 30)]
        ann[i, 4:12] = rng.uniform(0, 200, 8)
        ann[i, 12:15] = [1.5, 1.6, 4.0]
        ann[i, 16] = i % 4
    return ann


@pytest.mark.parametrize("flip", [False, True], ids=["no_flip", "flip_x"])
def test_transform_annotations_and_boxes_match_jax(flip):
    rng = np.random.RandomState(3 + flip)
    m = np.asarray(jax_aug.compose_transform(
        0.07, np.array([0.05, -0.03], np.float32), -0.04,
        np.array([1.05, 0.95], np.float32), flip, False, (64, 224)))
    ann = _annotations(rng)
    ann[3, 16] = 3
    boxes = ann[:, :4].copy()
    want = np.asarray(jax_aug.transform_annotations(m, flip, ann))
    got = augment.transform_annotations(_t(m)[None], torch.tensor([flip]),
                                        _t(ann)[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[:, 15:], want[:, 15:])
    if flip:  # orientations 0<->1, 2<->3
        assert got[:4, 16].tolist() == [1, 0, 3, 2]
    np.testing.assert_allclose(
        augment.transform_boxes(_t(m)[None], _t(boxes)[None])[0].numpy(),
        np.asarray(jax_aug.transform_boxes(m, boxes)), rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 7])
def test_augment_example_matches_jax(seed):
    """The whole per-example augmentation on a padded canvas, with every
    parameter drawn as JAX's augment_example draws it."""
    key = jax.random.PRNGKey(seed)
    h, w = 56, 88
    canvas = np.zeros((64, 96, 3), np.float32)
    canvas[:h, :w] = _smooth_image(h, w, seed)
    hw = np.asarray([h, w], np.float32)
    ann = _annotations(np.random.RandomState(seed))
    ig = np.array([[5, 5, 20, 18], [0, 0, 0, 0]], np.float32)
    want = jax_aug.augment_example(key, canvas, ann, ig, config=CFG,
                                   image_hw=hw)
    k_photo, k_geom = jax.random.split(key)
    d = _jax_transform_draws(k_geom)
    m = augment.compose_transform(np.asarray(d["angle"]),
                                  np.asarray(d["tx"]),
                                  np.asarray(d["shear"]),
                                  np.asarray(d["scale"]),
                                  bool(d["flip_x"]), bool(d["flip_y"]), hw)
    got = augment.augment_example(_t(canvas), _t(ann), _t(ig), m,
                                  bool(d["flip_x"]),
                                  _t(_jax_photometric_factors(k_photo)), hw)
    for g, wnt, atol in zip(got, want, (IMG_ATOL, 1e-4, 1e-4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0,
                                   atol=atol)


def test_augment_padded_canvas_matches_unpadded():
    """Augmenting a zero-padded canvas with the true size equals augmenting
    the unpadded image with the same parameters, and the padding stays
    exactly zero (the reference augments, then pads)."""
    h, w = 56, 88
    img = np.random.RandomState(0).uniform(0, 255, (h, w, 3)).astype(
        np.float32)
    ann = np.zeros((4, 17), np.float32)
    ann[0, :4] = [10, 10, 40, 40]
    ig = np.zeros((2, 4), np.float32)
    hw = torch.tensor([[h, w]], dtype=torch.float32)
    aug = augment.draw_augmentation(torch.Generator().manual_seed(7), hw)
    args = (aug["transform"], aug["flip_x"], aug["photometric"])
    out_img, out_ann, out_ig = augment.augment_batch(
        _t(img)[None], _t(ann)[None], _t(ig)[None], *args)
    canvas = np.zeros((64, 96, 3), np.float32)
    canvas[:h, :w] = img
    pad_img, pad_ann, pad_ig = augment.augment_batch(
        _t(canvas)[None], _t(ann)[None], _t(ig)[None], *args, image_hw=hw)
    np.testing.assert_allclose(pad_img[0, :h, :w].numpy(),
                               out_img[0].numpy(), rtol=1e-5, atol=1e-3)
    assert not pad_img[0, h:].any() and not pad_img[0, :, w:].any()
    torch.testing.assert_close(pad_ann, out_ann, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(pad_ig, out_ig, rtol=1e-5, atol=1e-4)


def test_sampler_draws_inside_config_ranges():
    cfg = augment.AugmentConfig(flip_x_chance=0.3)
    gen = torch.Generator().manual_seed(0)
    n = 4000
    p = augment.sample_params(gen, n, cfg)
    ranges = {"angle": (cfg.min_rotation, cfg.max_rotation),
              "shear": (cfg.min_shear, cfg.max_shear),
              "brightness": (-cfg.brightness_delta, cfg.brightness_delta),
              "contrast": cfg.contrast_range,
              "saturation": cfg.saturation_range,
              "hue": (-cfg.hue_delta, cfg.hue_delta)}
    for name, (lo, hi) in ranges.items():
        v = p[name]
        assert v.shape == (n,) and v.dtype == torch.float32, name
        assert lo <= float(v.min()) and float(v.max()) < hi, name
        # spread over the range, not stuck at one end
        assert float(v.max() - v.min()) > 0.9 * (hi - lo), name
    for name, lo, hi in (("translation", cfg.min_translation,
                          cfg.max_translation),
                         ("scale", cfg.min_scaling, cfg.max_scaling)):
        v = p[name]
        assert v.shape == (n, 2)
        for axis in range(2):
            assert lo[axis] <= float(v[:, axis].min())
            assert float(v[:, axis].max()) < hi[axis]
    assert p["flip_x"].dtype == torch.bool
    assert 0.25 < float(p["flip_x"].float().mean()) < 0.35
    assert not p["flip_y"].any()  # flip_y_chance 0
    # the same seed draws the same parameters
    again = augment.sample_params(torch.Generator().manual_seed(0), n, cfg)
    for name in p:
        assert torch.equal(p[name], again[name]), name
    aug = augment.draw_augmentation(torch.Generator().manual_seed(1),
                                    torch.tensor([[64.0, 224.0]] * 3))
    assert aug["transform"].shape == (3, 3, 3)
    assert aug["photometric"].shape == (3, 4)
    assert aug["flip_x"].shape == (3,)
