"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at a tiny size, with a fault planted where the program
produces its answers: half of each call's batch left out, and answers
altered. (The cells hold no state a step could leave unchanged and no
exchange between cards, so those faults do not apply.)"""

from __future__ import annotations

import time

import pytest

from portbench.conftest import tiny
from portbench.lib import cell

SPEC = cell.load_spec()


def _run(workload: str, fault, tmp_path, seed: int = 515):
    cfg, traffic = tiny(workload)
    # long enough for every file of a tiny pool to pass once
    seconds = 2.5 if workload.startswith("secret") else 0.5
    run, _metrics = cell.run_cell(SPEC, workload, seed, seconds, False, "cpu",
                                  time.perf_counter(), cfg=cfg,
                                  traffic=traffic, fault=fault,
                                  cache=str(tmp_path))
    return run


def _crawl_half_left_out(res):
    return res[: len(res) // 2]


def _crawl_half_unmatched(res):
    from trivy_tpu_torch.detector.engine import MatchResult

    return [MatchResult(r.query, []) if i % 2 else r
            for i, r in enumerate(res)]


def _crawl_altered(res):
    from trivy_tpu_torch.detector.engine import MatchResult

    return [MatchResult(r.query, r.adv_indices[:-1])
            if len(r.adv_indices) > 500 else r for r in res]


def _secret_half_left_out(res):
    return [s for s in res
            if int(s.file_path.rsplit("/m", 1)[1].split(".")[0]) % 2 == 0]


def _secret_altered(res):
    if res and res[0].findings:
        res[0].findings[0].start_line += 1
    return res


@pytest.mark.parametrize("workload,fault,check", [
    ("crawl.fresh", None, None),
    ("crawl.fresh", _crawl_half_left_out, "answers_wrong"),
    ("crawl.fresh", _crawl_half_unmatched, "answers_wrong"),
    ("crawl.fresh", _crawl_altered, "answers_wrong"),
    ("secret.source", None, None),
    ("secret.source", _secret_half_left_out, "files_wrong"),
    ("secret.source", _secret_altered, "files_wrong"),
])
def test_fault_makes_the_run_incorrect(workload, fault, check, tmp_path):
    run = _run(workload, fault, tmp_path)
    checks = {c.name: c for c in run.checks}
    if fault is None:
        assert run.correct, checks
    else:
        assert not run.correct
        assert not checks[check].ok


@pytest.mark.parametrize("workload", ["crawl.fresh", "secret.source"])
def test_control_is_not_correct(workload, tmp_path):
    import importlib

    cfg, traffic = tiny(workload)
    system = importlib.import_module(f"portbench.systems.{cfg['system']}")
    runs = [system.control(cfg, traffic, seed, 1.0, 3, str(tmp_path))
            for seed in (11, 12, 13)]
    assert not any(r.correct for r in runs)
