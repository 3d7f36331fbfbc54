"""The port's utils/profiling.py and utils/version_check.py against the
JAX package's behaviour, on the CPU (a card is simulated where a test
needs one)."""

import json
import os

import pytest
import torch

from ground_plane_polling_tpu.utils.version_check import (
    parse_version as jax_parse_version)
from ground_plane_polling_tpu_torch.utils import version_check
from ground_plane_polling_tpu_torch.utils.profiling import trace


def test_trace_noop_without_logdir(tmp_path):
    with trace("anything", logdir=None):
        assert float((torch.ones(3) + 1).sum()) == 6.0
    assert os.listdir(tmp_path) == []


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace("forward_block", logdir=logdir):
        torch.ones(16, 16) @ torch.ones(16, 16)
    (name,) = os.listdir(logdir)
    assert name.startswith("forward_block.") and name.endswith(
        ".pt.trace.json")
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "forward_block" for e in events)


@pytest.mark.parametrize("v", ["0.4.30", "2.11.0+cu128", "1.0.0rc1",
                               "2.13.0+cpu", "3"])
def test_parse_version_matches_jax(v):
    assert version_check.parse_version(v) == jax_parse_version(v)


def test_too_old_torch_raises():
    version_check.check_torch_version()
    with pytest.raises(ImportError, match="requires torch >= 99.0.0"):
        version_check.check_torch_version(minimum=(99, 0, 0))


def test_assert_compatible_on_the_cpu():
    version_check.assert_compatible("cpu")


def test_assert_compatible_needs_a_hopper_card(monkeypatch):
    """A CUDA device needs a CUDA build, a visible card and compute
    capability 9.0; the card is simulated."""
    monkeypatch.setattr(torch.version, "cuda", None)
    with pytest.raises(ImportError, match="without CUDA"):
        version_check.assert_compatible("cuda")
    monkeypatch.setattr(torch.version, "cuda", "12.8")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        version_check.assert_compatible("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "card")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda d: (8, 0))
    with pytest.raises(RuntimeError, match="sm_90a"):
        version_check.assert_compatible("cuda:0")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda d: (9, 0))
    version_check.assert_compatible("cuda:0")
