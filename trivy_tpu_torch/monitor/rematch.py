"""Delta re-scoring: touched keys ∩ index → re-match → events.

The correctness contract (asserted by tests and the fault matrix):
after a re-score, the index's stored finding
state is byte-identical to re-matching EVERY indexed artifact from
scratch against the new engine.  The incremental path may only skip an
artifact when none of its (space, name) keys are touched — and an
untouched key's advisory content is digest-identical across the two
generations, so its match results cannot differ (delta.py).  Every
fault rung (``monitor.rematch`` drop/error, a degraded index) widens
the re-match set up to "everything", never narrows it.

Events are the observable product: one JSON-able dict per finding edge
(introduced / resolved), deterministic order, trace-correlated via the
ambient span and scan id.

Copy of trivy_tpu/monitor/rematch.py. The re-match runs
wherever `engine.submit` does: the match kernel on the engine's card,
or the scheduler's shared micro-batches on a server. A device error
raises out of the re-score, and the state is then not advanced.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import tracing
from trivy_tpu_torch.resilience import faults

_log = logger("monitor.rematch")

FAULT_SITE = "monitor.rematch"

# rows per submit() micro-batch of the re-match sweep (matches the
# match scheduler's default micro-batch target)
BATCH_ROWS = 65536


def verify_enabled() -> bool:
    """TRIVY_TPU_DELTA_VERIFY=1: every re-score cross-checks itself
    against a from-scratch full re-match (double work; CI / paranoia)."""
    return os.environ.get("TRIVY_TPU_DELTA_VERIFY", "") == "1"


@dataclass
class RescoreReport:
    db_digest: str | None
    full: bool
    reason: str
    rematched: int = 0
    total_indexed: int = 0
    introduced: int = 0
    resolved: int = 0
    events: list[dict] = field(default_factory=list)
    shed: bool = False           # budget expired before completion
    verified: bool | None = None  # None = verify pass not run
    duration_s: float = 0.0


def _queries_of(packages: list[tuple]) -> list:
    from trivy_tpu_torch.detector.engine import PkgQuery

    return [PkgQuery(s, n, v, sch) for s, n, v, sch in packages]


# the ONE finding-identity definition (see its docstring): re-exported
# here because the re-scoring code and its tests read it from this
# module
from trivy_tpu_torch.detector.engine import finding_keys  # noqa: E402


def full_findings(engine, index) -> dict[str, set[tuple]]:
    """From-scratch oracle: every indexed artifact re-matched against
    `engine` (the zero-diff reference the incremental path is asserted
    against)."""
    ids = index.artifacts()
    out: dict[str, set[tuple]] = {}
    for batch in _batched(index, ids):
        lists = [_queries_of(index.packages_of(a)) for a in batch]
        res_lists = engine.submit(lists)
        advs = engine.cdb.advisories
        for aid, rl in zip(batch, res_lists):
            out[aid] = finding_keys(advs, rl)
    return out


def _batched(index, ids: list[str]):
    """Group artifact ids so each group's total query rows stay near
    BATCH_ROWS — one submit() micro-batch per group."""
    group: list[str] = []
    rows = 0
    for aid in ids:
        n = len(index.packages_of(aid))
        if group and rows + n > BATCH_ROWS:
            yield group
            group, rows = [], 0
        group.append(aid)
        rows += n
    if group:
        yield group


def _event(kind: str, aid: str, key: tuple, db_digest,
           ids: dict) -> dict:
    space, name, version, scheme, vuln_id = key
    ev = {"event": kind, "artifact": aid, "space": space, "name": name,
          "version": version, "scheme": scheme, "vuln_id": vuln_id,
          "db_digest": db_digest}
    ev.update(ids)
    return ev


def rescore(engine, index, plan, budget_s: float | None = None,
            verify: bool | None = None, on_event=None) -> RescoreReport:
    """Apply a DeltaPlan: re-match the affected artifacts through
    `engine.submit()` micro-batches, emit introduced/resolved events,
    advance the index's stored state to the new generation.

    `engine` may be a bare MatchEngine or the server's SchedEngine
    facade (then the re-match batches coalesce with live scans).
    `budget_s` bounds wall time; on expiry the remaining artifacts are
    left un-advanced (``shed=True``) and the state digest is NOT moved,
    so the next attempt re-plans from the same baseline.  `verify`
    (default TRIVY_TPU_DELTA_VERIFY) re-matches everything afterwards
    and asserts the incremental state equals it."""
    t0 = time.monotonic()
    full = plan.full
    reason = plan.reason
    # fault ladder: drop/error degrade the plan to a full re-score (more
    # work, same answer); delay stalls; kill crashes (replay recovers)
    rules = faults.fire(FAULT_SITE)
    faults.check_kill(FAULT_SITE, rules=rules)
    for r in rules:
        if r.action == "delay":
            time.sleep(r.param if r.param is not None else 0.002)
        elif r.action in ("drop", "error"):
            if not full:
                full = True
                reason = f"fault-{r.action}"
                obs_metrics.DELTA_FULL_RESCANS.inc(reason=reason)
    if index.degraded and not full:
        # a durable append failed earlier: stored baselines may be
        # stale in unknown ways — re-baseline everything
        full = True
        reason = "index-degraded"
        obs_metrics.DELTA_FULL_RESCANS.inc(reason=reason)
    report = RescoreReport(plan.new_digest, full, reason,
                           total_indexed=len(index.artifacts()))
    if verify is None:
        verify = verify_enabled()
    # trace correlation: the ambient span's trace id when tracing is
    # collecting, plus the scan id (which scan_scope assigns even with
    # tracing off — the same ids the JSON log lines carry)
    ids: dict = {}
    span = tracing.current()
    if span is not None and span.trace_id:
        ids["trace_id"] = span.trace_id
    scan_id = tracing.current_scan_id()
    if scan_id:
        ids["scan_id"] = scan_id
    with tracing.span("delta.rematch", full=full,
                      touched=len(plan.touched)):
        if full:
            aids = index.artifacts()
        else:
            aids = index.affected(plan.touched)
        advs = engine.cdb.advisories
        deadline = None if budget_s is None else t0 + budget_s
        completed = True
        for batch in _batched(index, aids):
            if deadline is not None and time.monotonic() > deadline:
                completed = False
                report.shed = True
                obs_metrics.DELTA_SHEDS.inc()
                _log.warn("re-score budget expired; state not advanced",
                          done=report.rematched, remaining=len(aids)
                          - report.rematched)
                break
            # snapshot-then-CAS: a live scan re-recording an artifact
            # mid-sweep must win over this sweep's computation from the
            # PRE-scan inventory (update_if refuses when the record
            # moved, and no events fire for a refused write)
            pkg_snap = {a: index.packages_of(a) for a in batch}
            fnd_snap = {a: index.findings_of(a) for a in batch}
            lists = [_queries_of(pkg_snap[a]) for a in batch]
            res_lists = engine.submit(lists)
            for aid, rl in zip(batch, res_lists):
                new_keys = finding_keys(advs, rl)
                old_keys = fnd_snap[aid]
                # every processed artifact re-stamps onto the new
                # generation (the replay staleness check keys on it),
                # and a degraded log regains a trusted copy
                if not index.update_if(aid, pkg_snap[aid], old_keys,
                                       new_keys,
                                       db_digest=plan.new_digest):
                    continue
                report.rematched += 1
                if old_keys is None or new_keys == old_keys:
                    # fresh/rebuilt record adopts its baseline silently
                    continue
                for k in sorted(new_keys - old_keys):
                    ev = _event("introduced", aid, k,
                                plan.new_digest, ids)
                    report.events.append(ev)
                    report.introduced += 1
                    if on_event is not None:
                        on_event(ev)
                for k in sorted(old_keys - new_keys):
                    ev = _event("resolved", aid, k,
                                plan.new_digest, ids)
                    report.events.append(ev)
                    report.resolved += 1
                    if on_event is not None:
                        on_event(ev)
        if completed:
            if full:
                # every record was re-baselined above: the durable log
                # holds a trusted copy again (a set_state append failure
                # below re-flags degraded and the next re-score goes
                # full once more)
                index.degraded = ""
            # the transition record: untouched artifacts keep their old
            # stamps, and the replay chain proves their baselines carry
            # to the new generation (index.py _baseline_carries)
            index.set_state(plan.new_digest, window=index.window,
                            prev=plan.old_digest,
                            touched=None if full else plan.touched)
            index.compact()
    obs_metrics.DELTA_REMATCHED.inc(report.rematched)
    obs_metrics.DELTA_EVENTS.inc(report.introduced, kind="introduced")
    obs_metrics.DELTA_EVENTS.inc(report.resolved, kind="resolved")
    report.duration_s = time.monotonic() - t0
    obs_metrics.DELTA_REMATCH_SECONDS.observe(report.duration_s)
    if verify and completed:
        oracle = full_findings(engine, index)
        diff = sum(
            1 for aid in oracle
            if (index.findings_of(aid) or set()) != oracle[aid])
        report.verified = diff == 0
        if diff:
            _log.error("delta re-score diverged from full re-match; "
                       "re-baselining", artifacts=diff)
            obs_metrics.DELTA_FULL_RESCANS.inc(reason="verify-mismatch")
            for aid, keys in oracle.items():
                index.update(aid, index.packages_of(aid), keys,
                             db_digest=plan.new_digest)
    _log.info("delta re-score complete", full=full, reason=reason,
              rematched=report.rematched, indexed=report.total_indexed,
              introduced=report.introduced, resolved=report.resolved,
              shed=report.shed,
              duration_s=round(report.duration_s, 3))
    return report
