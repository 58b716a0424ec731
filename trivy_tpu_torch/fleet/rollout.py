"""Coordinated advisory-DB rollout across a replica fleet
(docs/fleet.md "Rollout state machine").

The controller drives the generations/last-good machinery as a
staged fleet-wide hot swap, beating the reference's "quiesce requests
for the whole refresh" model: every replica keeps serving its current
generation until the instant its own guarded swap lands.

State machine (one ``run_rollout`` call)::

    plan ──► canary ──► probe ──► roll ──► rescore ──► completed
              │           │         │
              └───────────┴─────────┴──► rollback ──► rolled_back

- **plan** — every endpoint must be ready (JSON /readyz); the target
  generation is whatever ``last-good`` points at in the shared DB
  root; the previous generation (the rollback anchor) is what the
  fleet currently serves. All endpoints already on target = noop.
- **canary** — one replica reloads first. The server's own guarded
  swap rejects an unloadable/invalid candidate, quarantines it
  and keeps serving last-good; the controller sees ``serving`` stay on
  the previous generation and declares the rollout rolled back without
  ever touching the rest of the fleet.
- **probe** — a probe set (captured scan requests) replays against the
  canary and against a replica still on the previous generation. Any
  byte diff is a regression: the target generation is quarantined,
  last-good repointed at the previous generation, the canary reloaded
  back. (Probes whose packages the refresh legitimately touched WILL
  diff — build the probe set from delta-untouched artifacts, see
  docs/fleet.md.)
- **roll** — remaining replicas reload one at a time, each verified
  (serving == target, /readyz ready) before the next; a failure rolls
  every already-swapped replica back.
- **rescore** — every reload during the roll carried
  ``rescore=false``, parking each replica's advisory-delta
  re-score; the controller now consumes the parked swap on each
  monitor-enabled replica (/fleet/rescore). Monitor indexes are
  per-replica (each records the scans it served), so the fleet's
  journaled artifacts re-score once each, after the WHOLE fleet
  serves the new generation — not N uncoordinated mid-rollout sweeps
  against mixed generations.

Fault site ``fleet.rollout`` (``error`` fails the current stage — the
rollback ladder takes over; ``kill`` crashes the controller, leaving a
fleet that is EITHER fully on the old or partially on the new
generation, both serving correctly — re-running the rollout converges
it).

Copy of trivy_tpu/fleet/rollout.py. On the port each reload builds the
new generation's engine on the device the replica serves from (its
compiled-DB cache entry a hit when a sibling or `watch` compiled it),
and a replica on a distributed MeshDB resolves its host topology again
against the new generation.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request

import time
from dataclasses import dataclass, field

from trivy_tpu_torch.db import generations
from trivy_tpu_torch.fleet import slo as slo_mod
from trivy_tpu_torch.fleet.endpoints import readyz_doc
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import tracing
from trivy_tpu_torch.resilience import faults
from trivy_tpu_torch.rpc.server import SCAN_PATH

_log = logger("fleet.rollout")

ROLLOUT_SITE = "fleet.rollout"


class RolloutError(Exception):
    """A rollout stage failed in a way the ladder cannot absorb (bad
    arguments, unreachable fleet, failed rollback)."""


@dataclass
class Stage:
    name: str
    ok: bool
    detail: str
    seconds: float

    def doc(self) -> dict:
        return {"stage": self.name, "ok": self.ok,
                "detail": self.detail,
                "seconds": round(self.seconds, 3)}


@dataclass
class RolloutReport:
    outcome: str = "completed"  # completed | rolled_back | noop
    target: str | None = None
    previous: str | None = None
    canary: str | None = None
    stages: list = field(default_factory=list)
    probes: int = 0
    probe_diffs: int = 0
    rescored_on: list = field(default_factory=list)
    wall_s: float = 0.0

    def doc(self) -> dict:
        return {
            "outcome": self.outcome,
            "target": self.target,
            "previous": self.previous,
            "canary": self.canary,
            "probes": self.probes,
            "probe_diffs": self.probe_diffs,
            "rescored_on": self.rescored_on,
            "wall_s": round(self.wall_s, 3),
            "stages": [s.doc() for s in self.stages],
        }


# ------------------------------------------------------------ transport


def _post_json(url: str, token: str | None = None,
               body: dict | None = None,
               timeout: float = 300.0) -> tuple[int, dict]:
    """POST a JSON document, return (status, parsed reply). Generous
    timeout: a reload compiles the new generation's tensors."""
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Trivy-Token"] = token
    req = urllib.request.Request(
        url, data=json.dumps(body or {}).encode(), headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as exc:
        with exc:
            raw = exc.read()
        try:
            return exc.code, json.loads(raw or b"{}")
        except ValueError:
            return exc.code, {
                "error": raw.decode("utf-8", "replace")[:200]}


#: Public alias: the fleet controller drives the same /fleet/* control
#: surface (drain, reresolve) the rollout state machine does, through
#: one transport helper.
post_json = _post_json


def _replay_probe(endpoint: str, probe: dict,
                  token: str | None) -> tuple[int, bytes]:
    """Replay one captured scan request, returning the raw response
    bytes (the zero-diff comparison unit). No gzip is offered, so two
    replicas on the same generation answer byte-identically."""
    headers = {"Content-Type": "application/json",
               "X-Trivy-Tpu-Wire": "internal"}
    if token:
        headers["Trivy-Token"] = token
    req = urllib.request.Request(
        endpoint.rstrip("/") + SCAN_PATH,
        data=json.dumps(probe, sort_keys=True).encode(),
        headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=120.0) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as exc:
        with exc:
            return exc.code, exc.read()


def fleet_status(endpoints: list[str],
                 token: str | None = None) -> list[dict]:
    """JSON /readyz per endpoint (unreachable replicas report
    ready=False with an 'unreachable' status)."""
    out = []
    for ep in endpoints:
        doc = readyz_doc(ep, token=token, timeout=10.0)
        if doc is None:
            doc = {"ready": False, "status": "unreachable"}
        out.append({"endpoint": ep.rstrip("/"), **doc})
    return out


def load_probes(path: str) -> list[dict]:
    """A probe file: a JSON array (or JSONL) of captured scan-request
    documents ({"target", "artifact_id", "blob_ids", "options"} — the
    wire format)."""
    with open(path, encoding="utf-8") as f:
        text = f.read().strip()
    if not text:
        return []
    if text.startswith("["):
        return json.loads(text)
    return [json.loads(line) for line in text.splitlines() if line.strip()]


# ------------------------------------------------------------ controller


def _fire_stage_faults() -> None:
    rules = faults.fire(ROLLOUT_SITE)
    faults.check_kill(ROLLOUT_SITE, rules=rules)
    for r in rules:
        if r.action == "error":
            raise RolloutError("injected fleet.rollout error")
        if r.action == "delay":
            time.sleep(r.param if r.param is not None else 0.05)


def run_rollout(db_root: str, endpoints: list[str],
                token: str | None = None,
                probes: list[dict] | None = None,
                rescore: bool = True,
                canary: str | None = None,
                on_event=None) -> RolloutReport:
    """Drive one staged fleet rollout; returns the report (outcome
    ``completed`` / ``rolled_back`` / ``noop``). Raises RolloutError
    only when the fleet is in no state to start (not ready, no
    promoted generation) or a rollback itself failed."""
    endpoints = [e.rstrip("/") for e in endpoints]
    if not endpoints:
        raise RolloutError("no endpoints")
    report = RolloutReport()
    t_start = time.monotonic()

    def emit(name: str, ok: bool, detail: str, t0: float) -> None:
        st = Stage(name, ok, detail, time.monotonic() - t0)
        report.stages.append(st)
        obs_metrics.FLEET_ROLLOUT_STAGE_SECONDS.observe(
            st.seconds, stage=name)
        # the durable ops record of this stage (docs/fleet.md "Event
        # catalog"): journaled when the controller runs with one, so a
        # crashed rollout's last completed stage is replayable
        slo_mod.emit_event("rollout_stage", stage=name, ok=ok,
                           detail=detail, target=report.target,
                           seconds=round(st.seconds, 3))
        _log.info("rollout stage", stage=name, ok=ok, detail=detail)
        if on_event is not None:
            on_event(st.doc())

    def reload_ep(ep: str, want_rescore: bool = False) -> dict:
        status, doc = _post_json(ep + "/fleet/reload", token=token,
                                 body={"rescore": want_rescore})
        if status != 200:
            raise RolloutError(
                f"{ep}/fleet/reload -> HTTP {status}: {doc}")
        slo_mod.emit_event("db_swap", endpoint=ep,
                           serving=doc.get("serving"),
                           reloaded=bool(doc.get("reloaded")),
                           degraded=str(doc.get("degraded") or ""))
        return doc

    def rollback(target_dir: str | None, rolled: list[str],
                 quarantine: bool = False) -> None:
        """Repoint last-good at the previous generation and reload
        every replica that already swapped. The target generation is
        quarantined only when there is EVIDENCE it is bad (a probe
        diff); a controller-level failure (unreachable replica,
        injected fault) leaves it installed for a re-staged retry."""
        t0 = time.monotonic()
        if quarantine and target_dir and os.path.isdir(target_dir):
            generations.quarantine(db_root, target_dir)
        prev_dir = (os.path.join(generations.generations_root(db_root),
                                 report.previous)
                    if report.previous else None)
        if prev_dir and os.path.isdir(prev_dir):
            generations.promote(db_root, prev_dir)
        elif rolled:
            raise RolloutError(
                "cannot roll back: previous generation "
                f"{report.previous!r} is gone and "
                f"{len(rolled)} replica(s) already swapped")
        bad = []
        for ep in rolled:
            doc = reload_ep(ep, want_rescore=False)
            if report.previous and doc.get("serving") != report.previous:
                bad.append(f"{ep} serves {doc.get('serving')}")
        if bad:
            raise RolloutError("rollback incomplete: " + "; ".join(bad))
        emit("rollback", True,
             f"fleet back on {report.previous}", t0)
        report.outcome = "rolled_back"
        obs_metrics.FLEET_ROLLOUTS.inc(outcome="rolled_back")

    with tracing.span("fleet.rollout"):
        # ------------------------------------------------------- plan
        t0 = time.monotonic()
        _fire_stage_faults()
        target_dir = generations.current_generation(db_root)
        if target_dir is None:
            raise RolloutError(
                f"DB root {db_root!r} has no promoted generation "
                "(last-good): stage and promote the refresh first")
        report.target = os.path.basename(target_dir)
        status = fleet_status(endpoints, token=token)
        not_ready = [s for s in status if not s.get("ready")]
        if not_ready:
            raise RolloutError(
                "fleet not ready, refusing to start: " + "; ".join(
                    f"{s['endpoint']}: {s.get('status')}"
                    for s in not_ready))
        serving = {s["endpoint"]: s.get("generation") for s in status}
        behind = [ep for ep in endpoints
                  if serving.get(ep) != report.target]
        prev = {serving[ep] for ep in behind if serving.get(ep)}
        if not behind:
            emit("plan", True,
                 f"fleet already serving {report.target}", t0)
            report.outcome = "noop"
            obs_metrics.FLEET_ROLLOUTS.inc(outcome="noop")
            report.wall_s = time.monotonic() - t_start
            return report
        if len(prev) > 1:
            raise RolloutError(
                f"fleet serves mixed generations {sorted(prev)}; "
                "re-run after converging (a previous rollout may have "
                "been interrupted)")
        report.previous = next(iter(prev)) if prev else None
        report.canary = canary.rstrip("/") if canary else behind[0]
        if report.canary not in behind:
            raise RolloutError(
                f"canary {report.canary} is not behind "
                f"(serves {serving.get(report.canary)})")
        emit("plan", True,
             f"{len(behind)}/{len(endpoints)} replica(s) to roll "
             f"{report.previous} -> {report.target}", t0)

        # ----------------------------------------------------- canary
        t0 = time.monotonic()
        _fire_stage_faults()
        try:
            doc = reload_ep(report.canary, want_rescore=False)
        except (RolloutError, OSError) as exc:
            emit("canary", False, str(exc), t0)
            rollback(target_dir, [])
            report.wall_s = time.monotonic() - t_start
            return report
        if doc.get("serving") != report.target or doc.get("degraded"):
            # the canary's own guarded swap rejected the candidate
            # (quarantined server-side); the fleet never saw it
            emit("canary", False,
                 f"candidate rejected: serving={doc.get('serving')} "
                 f"degraded={doc.get('degraded')!r}", t0)
            rollback(target_dir, [])
            report.wall_s = time.monotonic() - t_start
            return report
        emit("canary", True,
             f"{report.canary} serving {report.target}", t0)

        # ------------------------------------------------------ probe
        t0 = time.monotonic()
        if probes:
            report.probes = len(probes)
            reference = next(
                (ep for ep in endpoints
                 if ep != report.canary
                 and serving.get(ep) == report.previous), None)
            diffs = 0
            for probe in probes:
                _fire_stage_faults()
                with tracing.span("fleet.probe"):
                    c_status, c_bytes = _replay_probe(
                        report.canary, probe, token)
                    if reference is None:
                        ok = c_status == 200
                        r_status, r_bytes = c_status, c_bytes
                    else:
                        r_status, r_bytes = _replay_probe(
                            reference, probe, token)
                        ok = (c_status == r_status == 200
                              and c_bytes == r_bytes)
                if not ok:
                    diffs += 1
            report.probe_diffs = diffs
            if diffs:
                emit("probe", False,
                     f"{diffs}/{len(probes)} probe(s) diverged on the "
                     "canary: regression", t0)
                rollback(target_dir, [report.canary],
                         quarantine=True)
                report.wall_s = time.monotonic() - t_start
                return report
            emit("probe", True,
                 f"{len(probes)} probe(s) zero-diff"
                 + ("" if reference else " (no reference replica;"
                    " status-only check)"), t0)
        else:
            emit("probe", True, "no probe set supplied", t0)

        # ------------------------------------------------------- roll
        t0 = time.monotonic()
        rolled = [report.canary]
        for ep in behind:
            if ep == report.canary:
                continue
            try:
                _fire_stage_faults()
                doc = reload_ep(ep, want_rescore=False)
                ready = readyz_doc(ep, token=token) or {}
                if doc.get("serving") != report.target \
                        or doc.get("degraded") \
                        or not ready.get("ready"):
                    raise RolloutError(
                        f"{ep} unhealthy after reload: "
                        f"serving={doc.get('serving')} "
                        f"degraded={doc.get('degraded')!r} "
                        f"ready={ready.get('ready')}")
            except (RolloutError, OSError) as exc:
                emit("roll", False, str(exc), t0)
                rollback(target_dir, rolled)
                report.wall_s = time.monotonic() - t_start
                return report
            rolled.append(ep)
        emit("roll", True, f"{len(rolled)} replica(s) on "
             f"{report.target}", t0)

        # ---------------------------------------------------- rescore
        t0 = time.monotonic()
        if rescore:
            # every reload above carried rescore=false, parking each
            # replica's delta re-score; consume the parked swap on
            # every MONITOR-ENABLED replica now. Indexes are
            # per-replica (each records the scans IT served), so this
            # re-scores each journaled artifact once fleet-wide —
            # after the whole fleet serves the new generation, instead
            # of N uncoordinated mid-rollout sweeps.
            monitored = [s["endpoint"] for s in status
                         if s.get("monitor")]
            if not monitored:
                emit("rescore", True,
                     "no monitor-enabled replica; delta re-score "
                     "skipped", t0)
            else:
                triggered, failed = [], []
                for ep in monitored:
                    rc_status, rc_doc = _post_json(
                        ep + "/fleet/rescore", token=token)
                    if rc_status == 200 and rc_doc.get("rescored"):
                        triggered.append(ep)
                    else:
                        failed.append(f"{ep}: {rc_doc}")
                report.rescored_on = triggered
                if failed:
                    # the fleet serves the new generation correctly
                    # either way — a failed re-score trigger degrades
                    # to the next promote re-planning (the monitor's ladder)
                    emit("rescore", False,
                         "re-score trigger failed on "
                         + "; ".join(failed), t0)
                else:
                    emit("rescore", True,
                         f"delta re-score triggered on "
                         f"{len(triggered)} monitor replica(s), each "
                         "covering its own journaled slice", t0)
        else:
            emit("rescore", True, "rescore disabled by caller", t0)

    report.wall_s = time.monotonic() - t_start
    obs_metrics.FLEET_ROLLOUTS.inc(outcome="completed")
    return report
