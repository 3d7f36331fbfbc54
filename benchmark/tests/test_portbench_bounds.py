"""The yardstick's frozen bound arithmetic on hand-counted shapes."""

from __future__ import annotations

import math

import pytest

from benchmark.lib.bounds import (PEAK_BYTES, PEAK_MUFU, PEAKS,
                                  int8_conv_bound_ms, poll_bound_ms)


def test_poll_bound_small_case_is_bytes():
    # 1 frame, 2 rows both valid, 3 planes: 6 pairs
    ops = 123 * 6 + 16 * 3 + 184 * 2          # 1154
    mufu = 9 * 6 + 1 * 3 + 8 * 2              # 73
    nbytes = 4 * (2 * 16 + 12 + 3 * 4 + 2 * 17)  # 360
    want = max(ops / 67e12, mufu / PEAK_MUFU, nbytes / 3.35e12) * 1e3
    assert want == pytest.approx(nbytes / PEAK_BYTES * 1e3)
    assert poll_bound_ms([2], 2, 3) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("frames, want_ms", [(1, 0.0047), (4, 0.0186)])
def test_poll_bound_main_path_is_the_mufu_pipe(frames, want_ms):
    # 100 valid detections a frame against KITTI's 21,634 planes: the
    # figures the program's smoke script gives (0.0047 / 0.0186 ms)
    got = poll_bound_ms([100] * frames, 100, 21634)
    mufu = (9 * 100 * 21634 + 21634 + 8 * 100) * frames / PEAK_MUFU * 1e3
    assert got == pytest.approx(mufu, rel=1e-12)
    assert round(got, 4) == want_ms


def test_poll_bound_counts_only_valid_pairs():
    full = poll_bound_ms([100, 100], 100, 21634)
    half = poll_bound_ms([100, 0], 100, 21634)
    assert half < full and half > full / 2 - 1e-9


def test_int8_conv_bound_hand_counted():
    x, w, y = (1, 64, 8, 8), (128, 64, 3, 3), (1, 128, 8, 8)
    ops = 2 * 64 * 128 * 64 * 9                       # 9,437,184
    nbytes = 64 * 64 + 128 * 64 * 9 + 128 * 6 + 64 * 128 * 2   # 94,976
    assert nbytes == 94976 and ops == 9437184
    got = int8_conv_bound_ms(x, w, y, 2)
    assert got == pytest.approx(max(ops / PEAKS["int8"],
                                    nbytes / PEAK_BYTES) * 1e3)
    assert got == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_int8_conv_bound_large_site_is_operations():
    # a P3 box-tower conv at b4 on 416 x 1344: 4 x 52 x 168 outputs
    x, w, y = (4, 512, 52, 168), (512, 512, 3, 3), (4, 512, 52, 168)
    m = 4 * 52 * 168
    ops = 2 * m * 512 * 512 * 9
    got = int8_conv_bound_ms(x, w, y, 2)
    assert got == pytest.approx(ops / 1979e12 * 1e3)
    assert math.isclose(got, 0.08332, rel_tol=1e-3)


def test_resnet50_census_and_flops():
    import torch

    from benchmark.reference.model import (conv_census, flops_per_frame,
                                           param_spec)
    cfg = {"backbone": "resnet50", "num_classes": 1, "num_anchors": 12,
           "feature_size": 512, "canvas": [416, 1344]}
    w = {k: torch.empty(s, device="meta")
         for k, (s, _) in param_spec(cfg).items()}
    sites = conv_census(w, torch.empty((4, 3, 416, 1344), device="meta"))
    # 53 trunk convs, 8 FPN convs, 3 heads x 5 convs x 5 levels
    assert len(sites) == 53 + 8 + 75 == 136
    per_frame = flops_per_frame(cfg)
    assert 4.8e11 < per_frame < 4.9e11
