"""The plain reference against the port's eager path, on the CPU, at the
published widths on a 64 x 224 canvas: the same weights and inputs give
the same head outputs and the same detections, polled planes and poses,
in float32 (the port's CPU path runs its kernels' plain versions)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import TINY

CFG = {"backbone": "resnet50", "num_classes": 1, "num_anchors": 12,
       "feature_size": 512, "raw_frame": [375, 1242], "max_detections": 100,
       "score_threshold": 0.05, "nms_threshold": 0.5, "pre_nms_top_k": 1024,
       "with_pose": True, "dtype": "float32", "int8": False,
       "cls_out_std": 0.01, **TINY}
SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def setup():
    from benchmark.lib import inputs, program

    weights = inputs.make_weights(CFG, SEED, "cpu", torch.float32)
    pool = inputs.make_pool(CFG, 2, SEED, "cpu")
    planes = inputs.make_planes(CFG, SEED, "cpu")
    detect = program.build(CFG, weights, pool, "cpu")
    return weights, pool, planes, detect


def test_weights_load_into_the_port_as_its_state(setup):
    from ground_plane_polling_tpu_torch.models import build_detector

    from benchmark.reference.model import param_spec
    weights = setup[0]
    state = build_detector("resnet50").state_dict()
    assert set(state) == set(weights) == set(param_spec(CFG))
    assert all(state[k].shape == weights[k].shape for k in state)


def test_head_outputs_match(setup):
    from ground_plane_polling_tpu_torch.models import build_detector

    from benchmark.reference.model import forward
    weights, pool = setup[0], setup[1]
    model = build_detector("resnet50").eval()
    model.load_state_dict(weights)
    x = (pool.frames.float() - torch.tensor((103.939, 116.779, 123.68))
         ).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = model(x)
        want = forward(weights, x)
    for key in ("regression", "regression_dim", "classification"):
        assert got[key].shape == want[key].shape
        torch.testing.assert_close(got[key], want[key], rtol=1e-4,
                                   atol=1e-4)


def test_detect_call_matches(setup):
    from benchmark.reference import pipeline as ref
    from benchmark.reference.model import forward
    weights, pool, planes, detect = setup
    out = detect(pool.frames, pool.P_inv,
                 planes[None].expand(2, *planes.shape))
    x = (pool.frames.float() - torch.tensor(ref.BGR_MEAN)).permute(0, 3, 1, 2)
    anchors = torch.from_numpy(ref.anchors_for_shape(CFG["canvas"]))
    with torch.no_grad():
        raw = forward(weights, x)
    for i in range(2):
        want = ref.detect({k: v[i] for k, v in raw.items()}, anchors,
                          pool.P_inv[i], planes, CFG)
        valid = want["labels"] >= 0
        assert int(valid.sum()) == CFG["max_detections"]
        for key, w in want.items():
            g = getattr(out, key)[i]
            if key in ("labels", "orientations"):
                assert torch.equal(g.int(), w.int())
            else:
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                           atol=1e-4, err_msg=key)
