"""The comparison that decides `correct` fails where it should: a run
whose timed path is broken underneath (the faults of lib/faults.py), past
the harness's look for a card, and each control in the program's place.
At the tiny size on the CPU (the tiny limits are set from CPU readings at
that size: conftest), and, on a card, at each cell's own size against the
configuration's own limits on three seeds."""

from __future__ import annotations

import pytest
import torch

from conftest import run_tiny

SOUND_SEED = 11
CONTROL_SEED = 21

# Each fault is checked on the bf16 b4 cell, whose configuration compares
# the filter's kept count and choice, the per-frame medians of the score
# and box gaps and the largest polling and pose gaps; the int8 cell's
# largest box gap and its dimension gaps' median are checked with a box
# and a dimension fault. The faults of the filter and of one batch
# position are checked on both b4 cells; on a card, at the cells' size,
# those that drop or misplace detections (an NMS at 0.3 keeps 100 boxes
# there and shows only on some seeds: PERF.md).
FAULTS = ["half_batch", "scores", "keypoint", "plane", "residual", "pose"]
BOTH_B4 = ["swap_position", "nms_half", "nms_threshold"]
ON_THE_CARD = ["swap_position", "nms_half"]
INT8_FAULTS = ["box", "dims"]


@pytest.mark.parametrize("workload", ["r50-bf16-b4-offline",
                                      "r50-int8-b4-offline",
                                      "r50-bf16-b1-stream"])
def test_sound_run_is_correct(tiny, workload):
    result = run_tiny(*tiny, workload, seed=SOUND_SEED)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny, fault):
    result = run_tiny(*tiny, "r50-bf16-b4-offline", seed=SOUND_SEED,
                      fault=fault)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", ["r50-bf16-b4-offline",
                                      "r50-int8-b4-offline"])
@pytest.mark.parametrize("fault", BOTH_B4)
def test_a_broken_filter_or_batch_position_is_not_correct(tiny, workload,
                                                          fault):
    result = run_tiny(*tiny, workload, seed=SOUND_SEED, fault=fault)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", INT8_FAULTS)
def test_a_broken_int8_path_is_not_correct(tiny, fault):
    result = run_tiny(*tiny, "r50-int8-b4-offline", seed=SOUND_SEED,
                      fault=fault)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload, control", [
    ("r50-bf16-b4-offline", "program-int8"),
    ("r50-bf16-b4-offline", "stage-bf16"),
    ("r50-int8-b4-offline", "reference-int4"),
])
def test_controls_are_not_correct(tiny, workload, control):
    result = run_tiny(*tiny, workload, seed=CONTROL_SEED, control=control)
    assert not result["correct"], result["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload, control", [
    ("r50-bf16-b4-offline", "program-int8"),
    ("r50-bf16-b4-offline", "stage-bf16"),
    ("r50-int8-b4-offline", "reference-int4"),
    ("r50-int8-b4-offline", "stage-bf16"),
    ("r50-bf16-b1-stream", "program-int8"),
    ("r50-bf16-b1-stream", "stage-bf16"),
])
def test_controls_fail_on_the_card_at_the_cells_size(workload, control):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' own size")
    import time

    from benchmark.run import run
    for seed in (4300000001, 4300000002, 4300000003):
        result = run(workload, seed, 2.0, False, control=control,
                     t_start=time.perf_counter())
        assert not result["correct"], (seed, result["checks"])


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["r50-bf16-b4-offline",
                                      "r50-int8-b4-offline"])
@pytest.mark.parametrize("fault", ON_THE_CARD)
def test_filter_and_position_faults_fail_on_the_card(workload, fault):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' own size")
    import time

    from benchmark.run import run
    for seed in (4400000001, 4400000002, 4400000003):
        result = run(workload, seed, 2.0, False, fault=fault,
                     t_start=time.perf_counter())
        assert not result["correct"], (seed, result["checks"])
