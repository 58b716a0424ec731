"""Journaled, resumable fleet scans.

One invocation scans many artifacts of the same kind:

    trivy-tpu image --targets refs.txt --journal fleet.jsonl \
        --format json --output fleet.json

Every artifact's lifecycle (pending → running → done/failed, with the
finished report embedded and digest-sealed) is checkpointed to the
journal before the run proceeds, so after a SIGKILL:

    trivy-tpu image --targets refs.txt --resume fleet.jsonl \
        --format json --output fleet.json

skips completed artifacts, re-runs in-flight/pending ones, and writes a
merged report byte-identical to an uninterrupted run (timestamps under
the fake-clock contract of utils/clock).

Copy of trivy_tpu/cli/fleet.py. Every lane scans on the device the CLI
resolved (`--device`, ``cuda:0`` by default; `--no-tpu` the host
paths), through the one engine `cli/run.py` caches for the fleet.
"""

from __future__ import annotations

import copy
import json
import os
import sys

from trivy_tpu_torch.cli.run import (
    FatalError,
    _build_cache,
    _postprocess_report,
    _scan_target,
    open_monitor_index,
)
from trivy_tpu_torch.durability import (
    ScanJournal,
    atomic_write,
    options_fingerprint,
)
from trivy_tpu_torch.durability.journal import JournalError
from trivy_tpu_torch.fanal import pipeline as analysis_pipeline
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import tracing
from trivy_tpu_torch.resilience import faults
from trivy_tpu_torch.utils import clock
from trivy_tpu_torch.utils import uuid as uuid_util
from trivy_tpu_torch.utils.pipeline import PipelineError, run_pipeline

_log = logger("fleet")

FAULT_SITE = "fleet.scan"  # kill rules here crash between artifacts


def _read_targets_file(path: str) -> list[str]:
    try:
        with open(path, encoding="utf-8") as f:
            lines = f.read().splitlines()
    except OSError as e:
        raise FatalError(f"--targets {path}: {e}")
    return [ln.strip() for ln in lines
            if ln.strip() and not ln.lstrip().startswith("#")]


def _given_targets(args) -> list[str]:
    """Positional target (if any) + --targets file lines, deduped in
    order — the fleet is the union, so the usual single-target CLI
    shape still works with a file of extras."""
    out: list[str] = []
    positional = getattr(args, "input", None) or getattr(args, "target", None)
    if positional:
        out.append(positional)
    tf = getattr(args, "targets", None)
    if tf:
        out.extend(_read_targets_file(tf))
    seen: set[str] = set()
    return [t for t in out if not (t in seen or seen.add(t))]


def run_fleet(args) -> int:
    if getattr(args, "format", "json") != "json":
        # before any journal is created: a refused run must not leave a
        # half-born journal blocking the corrected invocation
        raise FatalError("fleet scans emit a merged JSON report; "
                         "use --format json")
    fingerprint = options_fingerprint(args.command, args)
    resume_path = getattr(args, "resume", None)
    journal = None
    if resume_path:
        try:
            journal = ScanJournal.resume(resume_path)
        except JournalError as e:
            raise FatalError(str(e))
        if journal.command != args.command:
            raise FatalError(
                f"journal {resume_path} was written by "
                f"`trivy-tpu {journal.command}`, not `{args.command}`")
        if journal.fingerprint != fingerprint:
            raise FatalError(
                f"journal {resume_path} was written with different scan "
                "options; resuming would skew the merged report "
                "(re-run with the original flags, or start a fresh "
                "journal)")
        targets = journal.targets
        given = _given_targets(args)
        unknown = [t for t in given if t not in targets]
        if unknown:
            raise FatalError(
                f"targets not in journal {resume_path}: "
                f"{', '.join(unknown)} (a resume cannot grow the fleet)")
    else:
        targets = _given_targets(args)
        if not targets:
            raise FatalError("fleet scan needs at least one target "
                             "(positional and/or --targets FILE)")
        jpath = getattr(args, "journal", None)
        if jpath:
            try:
                journal = ScanJournal.create(
                    jpath, args.command, targets, fingerprint)
            except JournalError as e:
                raise FatalError(str(e))

    # ONE cache handle for every lane: layer analyses from concurrent
    # workers land in (and dedupe through) the same backend, and the
    # in-process singleflight registry sees one cache identity, so a
    # base layer shared across --fleet-parallel lanes is analyzed once
    cache = _build_cache(args)
    # --monitor-index: every completed artifact records its package
    # inventory + finding baseline into the shared durable index, so a
    # later `trivy-tpu watch` / DB promote re-scores this fleet
    # incrementally (docs/monitoring.md). Lanes share one handle —
    # updates serialize on the index lock.
    mon_index = open_monitor_index(args)
    mon_digest = None
    if mon_index is not None:
        from trivy_tpu_torch.cli.run import _db_path
        from trivy_tpu_torch.tensorize import cache as compile_cache

        # one digest for the whole fleet: the generation every lane's
        # baseline is matched against (stamped per index record)
        mon_digest = compile_cache.db_digest(_db_path(args))
        if journal is not None and resume_path:
            # artifacts already completed in the resumed journal are
            # skipped by the scan loop, so they would silently miss the
            # index: backfill from the embedded reports (null baseline,
            # like a rebuild — first re-score adopts silently) unless a
            # pre-crash record already covers them
            from trivy_tpu_torch.monitor.index import (
                packages_from_report,
            )

            for t, doc in journal.done.items():
                if mon_index.packages_of(t):
                    continue
                pkgs = packages_from_report(doc)
                if pkgs:
                    mon_index.update(t, pkgs, None)
    lane = {t: i + 1 for i, t in enumerate(targets)}  # stable fleet index
    reports: dict[str, dict] = dict(journal.done) if journal else {}
    todo = [t for t in targets if t not in reports]
    if journal and len(reports):
        _log.info("resuming fleet scan", done=len(reports), todo=len(todo),
                  layers_journaled=len(journal.layers))
    # snapshot the process-wide analysis counters so the summary line
    # reports THIS fleet's layers analyzed vs deduped
    analysis_base = (obs_metrics.LAYERS_ANALYZED.value(),
                     obs_metrics.LAYER_DEDUPE_HITS.value(),
                     obs_metrics.LAYER_DEDUPE_INFLIGHT_WAITS.value())

    def scan_one(target: str) -> None:
        # deterministic crash point for the kill-and-resume matrix
        faults.check_kill(FAULT_SITE)
        if os.environ.get("TRIVY_TPU_DETERMINISTIC_UUID") == "1":
            # per-artifact uuid lane, keyed by the stable fleet index:
            # a resumed run replays the exact ids of an uninterrupted
            # one (meaningful for sequential fleets; concurrent workers
            # share the counter after the jump)
            uuid_util.set_lane(lane[target])
        a = copy.copy(args)
        a.target = target
        if args.command == "image":
            # a fleet line that names an existing file is a tar archive,
            # anything else a registry reference
            a.input = target if os.path.exists(target) else None
        # each lane gets its own span (attached to the fleet root via
        # the pipeline's context adoption) and its own scan id, which
        # the artifact's log lines and inner spans inherit
        with tracing.scan_scope(force=True), \
                tracing.span("fleet.artifact", target=target,
                             lane=lane[target]):
            try:
                if mon_index is None:
                    report = _scan_target(a, cache)
                else:
                    from trivy_tpu_torch.monitor.capture import (
                        capture_scan,
                    )

                    with capture_scan() as cap:
                        report = _scan_target(a, cache)
                    mon_index.update(target, cap.packages, cap.findings,
                                     db_digest=mon_digest)
                _postprocess_report(a, report)
            except Exception as e:
                if journal:
                    journal.mark_failed(target, f"{type(e).__name__}: {e}")
                raise
        doc = report.to_dict()
        if journal:
            journal.mark_done(target, doc)  # fsynced before we move on
        reports[target] = doc

    on_start = None
    if journal:
        def on_start(_i, target):
            journal.mark_running(target)

    workers = max(1, int(getattr(args, "fleet_parallel", 1) or 1))
    try:
        # fleet-wide layer journal: every lane records completed layer
        # analyses, and a resumed crawl replays them as dedupe hints
        with tracing.span("fleet", artifacts=len(todo), workers=workers), \
                analysis_pipeline.journal_scope(
                    on_layer=journal.mark_layer if journal else None,
                    precompleted=set(journal.layers) if journal else None):
            run_pipeline(todo, scan_one, workers=workers,
                         on_start=on_start)
    except PipelineError as e:
        hint = (f"; completed work is journaled — re-run with "
                f"--resume {journal.path} to retry" if journal else "")
        raise FatalError(f"fleet scan: {e}{hint}")
    finally:
        if journal:
            journal.close()
        if mon_index is not None:
            mon_index.close()
        analyzed = obs_metrics.LAYERS_ANALYZED.value() - analysis_base[0]
        deduped = obs_metrics.LAYER_DEDUPE_HITS.value() - analysis_base[1]
        waits = obs_metrics.LAYER_DEDUPE_INFLIGHT_WAITS.value() \
            - analysis_base[2]
        if analyzed or deduped:
            _log.info("fleet analysis summary",
                      layers_analyzed=int(analyzed),
                      layers_deduped=int(deduped),
                      inflight_waits=int(waits),
                      dedupe_ratio=round(
                          deduped / max(analyzed + deduped, 1), 3))

    _write_fleet_report(args, targets, reports)
    # same exit-code policy as single-target scans (cli/run.py
    # _exit_code): findings first, then end-of-life OS
    if args.exit_code and any(_has_findings(reports[t]) for t in targets):
        return args.exit_code
    if getattr(args, "exit_on_eol", 0) and \
            any(_is_eosl(reports[t]) for t in targets):
        return args.exit_on_eol
    return 0


def _has_findings(doc: dict) -> bool:
    return any(
        r.get("Vulnerabilities") or r.get("Misconfigurations")
        or r.get("Secrets") or r.get("Licenses")
        for r in doc.get("Results") or [])


def _is_eosl(doc: dict) -> bool:
    return bool(((doc.get("Metadata") or {}).get("OS") or {}).get("EOSL"))


def _write_fleet_report(args, targets: list[str],
                        reports: dict[str, dict]) -> None:
    """Merged report, per-target documents in fleet order — the order
    and the embedded reports are journal-stable, so an interrupted +
    resumed fleet renders the same bytes as an uninterrupted one."""
    merged = {
        "SchemaVersion": 2,
        "CreatedAt": clock.now_rfc3339(),
        "ArtifactType": "fleet",
        "Targets": len(targets),
        "Reports": [reports[t] for t in targets],
    }
    data = json.dumps(merged, indent=2) + "\n"
    if getattr(args, "output", None):
        atomic_write(args.output, data.encode(), fault_site="report.write")
    else:
        sys.stdout.write(data)
