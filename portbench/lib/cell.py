"""A cell of `BENCHMARK.json`, found by name, and one run of it.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by the name `BENCHMARK.json` gives:

- `portbench/configs/<config>.json`, whose `system` names its module;
- `portbench/traffic/<traffic>.json`, read by that system's generator;
- `portbench/systems/<system>.py`, `run(...)` -> `lib.record.Run`;
- `portbench/metrics/<metric>.py`, `read(run)` -> a number or None.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(spec: dict, workload: str, root: str = ROOT) -> tuple:
    """-> (workload entry, configuration, traffic) of `workload`."""
    work = {w["name"]: w for w in spec["workloads"]}.get(workload)
    if work is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in spec["configs"]}[work["config"]]
    cfg = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(HERE, "traffic", f"{work['traffic']}.json"))
    return work, cfg, traffic


def metrics_of(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of `workload` reports: the end-to-end ones
    untraced, the per-layer ones traced; each where it lists the cell,
    or lists no cells."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str):
    """The `read` of `portbench/metrics/<name>.py`."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    mod_name = "portbench.metrics._" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(spec: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float, cfg=None,
             traffic=None, fault=None, cache: str = CACHE):
    """Run `workload` once on `device`. -> (Run, {metric: {value,
    unit}}). `cfg` / `traffic` replace the cell's files (the harness's
    own tests shrink them)."""
    work, cfg0, traffic0 = cell(spec, workload)
    cfg = cfg or cfg0
    traffic = traffic or traffic0
    system = importlib.import_module(f"portbench.systems.{cfg['system']}")
    run = system.run(cfg, traffic, seed, seconds, trace, device, cache,
                     t_start, fault=fault)
    metrics = {}
    for m in metrics_of(spec, workload, trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return run, metrics
