"""BENCHMARK.json against the rules its format keeps (names, units,
keys, limits), and every file an entry names present: CPU only, no
program import."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench.lib import cell

SPEC = cell.load_spec()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"[^\t\n\r]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    with open(os.path.join(cell.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)


def test_command_and_paths():
    cmd, paths = SPEC["command"], SPEC["paths"]
    assert 1 <= len(cmd) <= 32 and all(TEXT.match(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.match(r"[A-Za-z0-9_./-]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(cell.ROOT, p))
    for w in cmd:
        if w.endswith(".py"):
            assert any(w.startswith(p + "/") for p in paths)


def _names(group):
    return [e["name"] for e in SPEC[group]]


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_are_allowed_and_unique(group):
    names = _names(group)
    assert names and len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metric_names_unique_across_groups():
    names = _names("end_to_end") + _names("per_layer")
    assert len(names) == len(set(names))


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metric_entries(group):
    cells = set(_names("workloads"))
    e2e = set(_names("end_to_end"))
    keys = ({"name", "unit", "better", "bound", "source"} if group ==
            "end_to_end" else {"name", "unit", "better", "source", "layer",
                               "moves"})
    for m in SPEC[group]:
        assert set(m) - {"workloads"} == keys, m["name"]
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert TEXT.match(m["layer"]) and m["moves"] in e2e
            moved = next(e for e in SPEC["end_to_end"]
                         if e["name"] == m["moves"])
            assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in SPEC["end_to_end"])


def test_one_layer_name_per_layer():
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_configs_and_their_files():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        with open(os.path.join(cell.ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(
            cell.HERE, "systems", f"{body['system']}.py"))


def test_workloads_and_their_files():
    pairs = set()
    four = 0
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(
            cell.HERE, "traffic", f"{w['traffic']}.json"))
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("workload", _names("workloads"))
def test_every_cell_reports_enough(workload):
    e2e = [m["name"] for m in cell.metrics_of(SPEC, workload, False)]
    layer = cell.metrics_of(SPEC, workload, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer


@pytest.mark.parametrize("metric", _names("end_to_end") + _names("per_layer"))
def test_every_metric_has_a_reader(metric):
    assert callable(cell.reader(metric))


def test_files_are_named_from_name_characters():
    for dirpath, dirnames, filenames in os.walk(cell.HERE):
        dirnames[:] = [d for d in dirnames
                       if d not in ("_cache", "__pycache__")]
        rel = os.path.relpath(dirpath, cell.ROOT)
        for f in filenames:
            assert re.match(r"[A-Za-z0-9_./-]+$", os.path.join(rel, f))
