"""BENCHMARK.json and the files it names: the form the benchmark's
contract sets (keys, names, units, bounds, the run length against the
check's time), and every configuration, mix and metric found by its name."""

from __future__ import annotations

import json
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
WIDTHS = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|experts_per_token|width|"
                    r"feature_size|num_anchors|canvas)")


@pytest.fixture(scope="module")
def bench():
    text = (ROOT / "BENCHMARK.json").read_text()
    assert len(text.encode()) <= 64 * 1024
    return json.loads(text)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_command(bench):
    assert set(bench) == TOP
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])
            assert (ROOT / word).is_file()
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_run_seconds_fit_the_check_at_24_cells(bench):
    r = bench["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_unique_and_well_formed(bench, group):
    names = [e["name"] for e in bench[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == CONFIG_KEYS
        assert c["name"] in used
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key)
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))


def test_workloads(bench):
    assert 1 <= len(bench["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert set(w) == WORKLOAD_KEYS
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "configs" / f"{w['config']}.json").is_file()


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        moved = e2e[m["moves"]].get("workloads", cells)
        # every cell that reports a layer metric reports what it moves
        assert set(m.get("workloads", moved)) <= set(moved)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        name = w["name"]
        e2e = [m["name"] for m in bench["end_to_end"]
               if name in m.get("workloads", [name])]
        layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer


def test_each_config_file_states_its_check(bench):
    from benchmark.lib.program import BUILD_OPTIONS
    from benchmark.run import named_module

    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        numbers = named_module("reference", cfg["judge"]).NUMBERS
        known = set(numbers) | {n + ".p50" for n in numbers}
        assert set(cfg["limits"]) <= known
        # the exact comparisons hold at 0 in every configuration
        assert cfg["limits"]["nms_overlap"] == 0.0
        assert cfg["limits"]["short_frames"] == 0.0
        assert set(cfg["build"]) <= set(BUILD_OPTIONS)
        for key in ("canvas", "frame", "planes", "dtype", "int8",
                    "max_detections", "with_pose", "assumed"):
            assert key in cfg


def test_each_mix_names_a_generator(bench):
    from benchmark.run import named_module

    for w in bench["workloads"]:
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        gen = named_module("lib", mix["generator"])
        for fn in ("prepare", "build", "drive", "attempted", "samples",
                   "release"):
            assert callable(getattr(gen, fn))
    with pytest.raises(FileNotFoundError):
        named_module("lib", "no_such_generator")
    with pytest.raises(ValueError):
        named_module("lib", "not-a-module")


def test_found_by_name(bench):
    from benchmark.run import cell, find, load_reader, metrics_of

    for w in bench["workloads"]:
        entry, cfg, traffic = cell(bench, w["name"])
        assert entry is not None and cfg["name"] == w["config"]
        assert traffic["batch"] >= 1
        for trace in (False, True):
            for m in metrics_of(bench, w["name"], trace):
                assert callable(load_reader(m["name"]))
    with pytest.raises(FileNotFoundError):
        find("metrics", "no_such_metric", ".py")
