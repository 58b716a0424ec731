"""Self-driving fleet: the SLO-driven remediation/autoscaling control
loop (docs/fleet.md "Self-driving fleet").

The fleet detects everything (burn-rate SLO engine, skew detector,
durable ops event journal) and can do everything (guarded drains, the
rollout state machine, ``spawn[:N]`` DCN workers, mesh re-resolve) —
this module closes the loop: a :class:`FleetController` consumes the
probe/SLI stream and drives the existing actuators under an explicit,
journaled policy:

- **autoscale** — replicas scale up against offered load and back down
  under a cost floor (``min_replicas``) with scale-down hysteresis
  (``scale_down_holds`` consecutive calm ticks), so one quiet minute
  never collapses the fleet;
- **drain-and-replace** — a replica whose probe history crosses the
  unhealthy-streak threshold is drained (the server's graceful drain),
  retired from the routing set (the endpoint set's retire), and replaced;
- **mesh re-resolve** — a replica reporting *sustained* host
  degradation is told to re-resolve its mesh topology over the
  surviving hosts (``POST /fleet/reresolve``) instead of serving the
  coordinator's host-mask fallback indefinitely;
- **hedge tuning** — the smart-client hedge budget follows the
  measured p99/p50 probe-latency skew: a skewed fleet earns a bigger
  hedge budget, a uniform one returns to the configured baseline.

Every decision is an **action** from the closed :data:`ACTIONS`
vocabulary.  An action is journaled twice in the controller's own
append log (``durability/appendlog``): an ``intent`` record *before*
acting and an ``applied`` record after.  Replay is idempotent: every
tick, an intent without its ``applied`` record — a crash leftover or
the previous tick's failed action — is *reconciled* against the live
fleet first — if the intended state already holds, the action is
marked ``reconciled`` and never re-fired; otherwise it is re-fired
exactly once.  Each action is also emitted onto the fleet ops event
bus as a ``controller_action`` event, so one journal replay tells the
whole story.

``dry_run`` journals and emits every decision without touching the
fleet — the rehearsal contract the bench gate proves.  Fault site
``fleet.controller`` (docs/resilience.md) fires between the intent
and the act: every injected failure degrades the controller to
"observe only", and the intent/reconcile protocol guarantees an
action is never applied twice.

Copy of trivy_tpu/fleet/controller.py. The operator's ``--spawn-cmd``
starts a replica of whichever package it names (`python -m
trivy_tpu_torch server ...` for the port). ``mesh_reresolve`` goes
through POST /fleet/reresolve; against a port replica a device error
there answers 500, which fails the action (its intent stays pending)
instead of reading as "nothing to re-resolve".
"""

from __future__ import annotations

import json
import os
import subprocess

import time

from trivy_tpu_torch import fleet as fleet_mod
from trivy_tpu_torch.durability.appendlog import AppendLog, AppendLogError
from trivy_tpu_torch.fleet import slo as slo_mod
from trivy_tpu_torch.fleet import telemetry
from trivy_tpu_torch.fleet.endpoints import readyz_doc
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import tracing
from trivy_tpu_torch.resilience import faults

_log = logger("fleet.controller")

CONTROLLER_SITE = "fleet.controller"

# ----------------------------------------------------- action registry

#: The closed controller action vocabulary: (kind, what one action
#: means).  Machine-checked three ways by the ``event-kind`` lint rule
#: — every kind passed to :func:`emit_action` in code is declared
#: here, every declared kind is emitted somewhere, and docs/fleet.md's
#: action catalog lists exactly this set.
ACTIONS: tuple[tuple[str, str], ...] = (
    ("scale_up", "offered load per ready replica crossed the "
     "scale-up threshold: one replica spawned (capped at "
     "max_replicas)"),
    ("scale_down", "offered load stayed under the scale-down "
     "threshold for the full hysteresis window: one replica drained "
     "and retired (floored at min_replicas — the cost floor)"),
    ("drain_replace", "a replica's unhealthy-probe streak crossed the "
     "policy threshold: drained, retired from the routing set, and "
     "replaced by a fresh spawn"),
    ("mesh_reresolve", "a replica reported sustained host "
     "degradation: told to re-resolve its mesh topology over the "
     "surviving hosts instead of serving the host-mask fallback"),
    ("hedge_tune", "the smart-client hedge budget was retuned from "
     "the measured p99/p50 probe-latency skew"),
)

ACTION_KINDS = frozenset(k for k, _ in ACTIONS)


def controller_enabled() -> bool:
    """The ``TRIVY_TPU_CONTROLLER`` kill switch (default on): 0
    restores the pre-feature path — the loop observes and decides
    nothing, exactly as if no controller ran."""
    return os.environ.get("TRIVY_TPU_CONTROLLER", "1") != "0"


def emit_action(kind: str, **fields) -> dict | None:
    """Publish one controller action onto the fleet ops event bus as a
    ``controller_action`` event.  Validates the kind against the
    ACTIONS registry (an unknown kind is a programming error, caught
    by the event-kind lint rule before it ever fires here)."""
    if kind not in ACTION_KINDS:
        raise ValueError(
            f"unknown controller action kind {kind!r} — declare it in "
            "fleet.controller.ACTIONS (and docs/fleet.md's action "
            "catalog)")
    return slo_mod.emit_event("controller_action", action=kind, **fields)


# ------------------------------------------------------------- policy

def _parse_float(raw: str, name: str, default: float) -> float:
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        _log.warn(f"malformed {name}; using default", value=raw)
        return default


def _parse_int(raw: str, name: str, default: int) -> int:
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        _log.warn(f"malformed {name}; using default", value=raw)
        return default


def _env_defaults() -> dict:
    """The ``TRIVY_TPU_CONTROLLER_*`` knob family (docs/knobs.md),
    read as literal env lookups so the env-knob rule can hold each
    one against the registry."""
    return {
        "min_replicas": _parse_int(
            os.environ.get("TRIVY_TPU_CONTROLLER_MIN_REPLICAS", ""),
            "TRIVY_TPU_CONTROLLER_MIN_REPLICAS", 1),
        "max_replicas": _parse_int(
            os.environ.get("TRIVY_TPU_CONTROLLER_MAX_REPLICAS", ""),
            "TRIVY_TPU_CONTROLLER_MAX_REPLICAS", 4),
        "scale_up_load": _parse_float(
            os.environ.get("TRIVY_TPU_CONTROLLER_SCALE_UP_LOAD", ""),
            "TRIVY_TPU_CONTROLLER_SCALE_UP_LOAD", 4.0),
        "scale_down_load": _parse_float(
            os.environ.get("TRIVY_TPU_CONTROLLER_SCALE_DOWN_LOAD", ""),
            "TRIVY_TPU_CONTROLLER_SCALE_DOWN_LOAD", 1.0),
        "scale_down_holds": _parse_int(
            os.environ.get("TRIVY_TPU_CONTROLLER_HOLDS", ""),
            "TRIVY_TPU_CONTROLLER_HOLDS", 3),
        "cooldown_s": _parse_float(
            os.environ.get("TRIVY_TPU_CONTROLLER_COOLDOWN_S", ""),
            "TRIVY_TPU_CONTROLLER_COOLDOWN_S", 30.0),
        "unhealthy_ticks": _parse_int(
            os.environ.get("TRIVY_TPU_CONTROLLER_UNHEALTHY_TICKS", ""),
            "TRIVY_TPU_CONTROLLER_UNHEALTHY_TICKS", 3),
        "degraded_ticks": _parse_int(
            os.environ.get("TRIVY_TPU_CONTROLLER_DEGRADED_TICKS", ""),
            "TRIVY_TPU_CONTROLLER_DEGRADED_TICKS", 3),
        "hedge_skew": _parse_float(
            os.environ.get("TRIVY_TPU_CONTROLLER_HEDGE_SKEW", ""),
            "TRIVY_TPU_CONTROLLER_HEDGE_SKEW", 4.0),
    }


class ControllerPolicy:
    """The explicit policy every decision is judged against.  Defaults
    come from the ``TRIVY_TPU_CONTROLLER_*`` knobs (docs/knobs.md);
    constructor arguments win (tests, the CLI's flags)."""

    def __init__(self, min_replicas: int | None = None,
                 max_replicas: int | None = None,
                 scale_up_load: float | None = None,
                 scale_down_load: float | None = None,
                 scale_down_holds: int | None = None,
                 cooldown_s: float | None = None,
                 unhealthy_ticks: int | None = None,
                 degraded_ticks: int | None = None,
                 hedge_skew: float | None = None,
                 hedge_budget_hi: float = 0.3):
        env = _env_defaults()
        self.min_replicas = max(
            min_replicas if min_replicas is not None
            else env["min_replicas"], 1)
        self.max_replicas = max(
            max_replicas if max_replicas is not None
            else env["max_replicas"], self.min_replicas)
        self.scale_up_load = (
            scale_up_load if scale_up_load is not None
            else env["scale_up_load"])
        self.scale_down_load = (
            scale_down_load if scale_down_load is not None
            else env["scale_down_load"])
        self.scale_down_holds = max(
            scale_down_holds if scale_down_holds is not None
            else env["scale_down_holds"], 1)
        self.cooldown_s = max(
            cooldown_s if cooldown_s is not None
            else env["cooldown_s"], 0.0)
        self.unhealthy_ticks = max(
            unhealthy_ticks if unhealthy_ticks is not None
            else env["unhealthy_ticks"], 1)
        self.degraded_ticks = max(
            degraded_ticks if degraded_ticks is not None
            else env["degraded_ticks"], 1)
        self.hedge_skew = (
            hedge_skew if hedge_skew is not None
            else env["hedge_skew"])
        self.hedge_budget_hi = min(max(hedge_budget_hi, 0.0), 1.0)

    def doc(self) -> dict:
        return {k: v for k, v in vars(self).items()}


# ------------------------------------------------------ action journal

class ActionJournal:
    """The controller's own durable decision log: an fsynced append
    log (``durability/appendlog``) of ``intent``/``applied`` record
    pairs keyed by a monotonically-assigned action id.

    The two-record protocol is the crash-safety contract: the intent
    hits the disk *before* the actuator is touched, the applied record
    after, so replay can always tell "decided but maybe not done"
    (intent without applied — reconcile before re-acting) from "done"
    (never re-act)."""

    HEADER = {"log": "controller-actions", "v": 1}

    def __init__(self, log: AppendLog, past: list[dict]):
        self._log = log
        self._next_id = 1 + max(
            (int(r.get("id", 0)) for r in past), default=0)
        self._applied = {int(r["id"]) for r in past
                         if r.get("phase") == "applied" and "id" in r}
        self._intents = {int(r["id"]): r for r in past
                         if r.get("phase") == "intent" and "id" in r}

    @classmethod
    def open(cls, path: str) -> "ActionJournal":
        """Open (or create) the journal and replay it — torn tail
        truncated, mid-file rot skipped — restoring the applied-id set
        and any pending intents."""
        if os.path.exists(path):
            try:
                log, past = AppendLog.replay(path)
            except AppendLogError:
                # the create-time header write itself tore: appends
                # from the rest of that run are intact line-bounded
                # records carrying the applied-id set — salvage them
                # rather than crash-loop the controller on restart
                log, past = AppendLog.salvage(path, dict(cls.HEADER))
            if log.header.get("log") != "controller-actions":
                log.close()
                raise AppendLogError(
                    f"{path} is not a controller action journal "
                    f"(header {log.header.get('log')!r})")
            return cls(log, past)
        return cls(AppendLog.create(path, dict(cls.HEADER)), [])

    @property
    def path(self) -> str:
        return self._log.path

    def pending(self) -> list[dict]:
        """Intents with no applied record yet — the crash leftovers a
        restarted controller must reconcile before acting again."""
        return [dict(r) for i, r in sorted(self._intents.items())
                if i not in self._applied]

    def intent(self, action: str, **fields) -> int:
        """Durably record the decision BEFORE acting; returns the
        action id the applied record must carry."""
        aid = self._next_id
        self._next_id += 1
        rec = {"phase": "intent", "id": aid, "action": action,
               "ts": round(time.time(), 3), **fields}
        self._log.append(rec)
        self._intents[aid] = rec
        return aid

    def applied(self, aid: int, outcome: str, **fields) -> None:
        """Durably record the action's resolution: ``applied`` /
        ``dry_run`` / ``reconciled`` / ``dropped``."""
        self._log.append({"phase": "applied", "id": aid,
                          "outcome": outcome,
                          "ts": round(time.time(), 3), **fields})
        self._applied.add(aid)

    def records(self) -> list[dict]:
        """Read-only replay of the whole journal from disk."""
        log, past = AppendLog.replay(self.path)
        log.close()
        return past

    def compact(self, keep_last: int = 256) -> None:
        """Drop all but the newest ``keep_last`` records (atomically —
        a crash mid-compact leaves the previous journal intact).
        Pending intents always survive compaction: reconcile state
        must never be rotated away."""
        past = self.records()
        keep = past[-keep_last:] if keep_last >= 0 else past
        pending_ids = {r["id"] for r in self.pending()}
        kept_ids = {r.get("id") for r in keep}
        keep = [r for r in past
                if r.get("id") in pending_ids
                and r.get("id") not in kept_ids] + keep
        self._log.rewrite(keep)

    def close(self) -> None:
        self._log.close()


# ---------------------------------------------------------- actuators

class ActuatorError(Exception):
    """An actuator could not perform the requested fleet action."""


class LocalFleetActuator:
    """An in-process fleet the controller can really drive: replica
    servers owned by a factory callable, an optional
    :class:`~trivy_tpu_torch.fleet.endpoints.EndpointSet` kept in sync for
    routing/hedge tuning, and a pluggable offered-load signal.  The
    bench's ``--selfdrive`` rung and the controller tests run against
    this; a live deployment uses :class:`HttpFleetActuator`."""

    def __init__(self, factory, endpoint_set=None, load_fn=None,
                 token: str | None = None,
                 drain_timeout_s: float = 10.0):
        self._factory = factory
        self._servers: dict[str, object] = {}
        self._es = endpoint_set
        # no load_fn = no load signal (offered_load None): the
        # controller then never scales on load, same contract as the
        # HTTP actuator without a signal
        self._load_fn = load_fn
        self._token = token
        self._drain_timeout_s = drain_timeout_s

    # -- membership ---------------------------------------------------
    @property
    def urls(self) -> list[str]:
        return list(self._servers)

    def adopt(self, server) -> str:
        """Register an already-running replica server."""
        url = server.address
        self._servers[url] = server
        self._sync_endpoints()
        return url

    def _sync_endpoints(self) -> None:
        # an empty server map still syncs: retiring the LAST replica
        # must retire its endpoint too, not leave the set routing to
        # a dead URL
        if self._es is not None:
            self._es.set_endpoints(list(self._servers))

    # -- observation --------------------------------------------------
    def observe(self) -> dict:
        statuses = []
        for url in list(self._servers):
            t0 = time.monotonic()
            doc = readyz_doc(url, token=self._token)
            probe_s = time.monotonic() - t0
            statuses.append({
                "endpoint": url,
                "ready": bool(doc.get("ready")) if doc else False,
                "generation": doc.get("generation") if doc else None,
                "mesh": doc.get("mesh") if doc else None,
                "probe_s": probe_s,
            })
        load = (float(self._load_fn())
                if self._load_fn is not None else None)
        return {"statuses": statuses, "offered_load": load,
                "replicas": list(self._servers)}

    # -- actions ------------------------------------------------------
    def spawn_replica(self) -> str:
        srv = self._factory()
        url = srv.address
        self._servers[url] = srv
        self._sync_endpoints()
        return url

    def drain_replica(self, url: str) -> bool:
        srv = self._servers.get(url)
        if srv is None:
            return False
        try:
            srv.drain(self._drain_timeout_s)
        except Exception as exc:
            # a dead replica cannot drain; retiring it is the point
            _log.warn("drain failed; retiring anyway", url=url,
                      err=str(exc))
        return True

    def retire_replica(self, url: str) -> None:
        srv = self._servers.pop(url, None)
        self._sync_endpoints()
        if srv is not None:
            try:
                srv.shutdown()
            except Exception as exc:
                _log.warn("replica shutdown failed", url=url,
                          err=str(exc))

    def reresolve_mesh(self, url: str) -> dict:
        from trivy_tpu_torch.fleet.rollout import post_json

        status, doc = post_json(url.rstrip("/") + "/fleet/reresolve",
                                token=self._token)
        if status != 200:
            raise ActuatorError(
                f"reresolve on {url} failed: HTTP {status} {doc}")
        return doc

    def set_hedge_budget(self, budget: float) -> bool:
        if self._es is None:
            return False
        self._es.set_hedge_budget(budget)
        return True

    def close(self) -> None:
        for url in list(self._servers):
            self.retire_replica(url)


class HttpFleetActuator:
    """A live fleet behind HTTP: observation via JSON ``/readyz``,
    drains via ``POST /fleet/drain``, mesh re-resolve via
    ``POST /fleet/reresolve``, and replica spawn via an operator-
    provided shell command whose stdout's last line is the new
    replica's URL (how the controller reaches whatever supervisor
    actually owns processes — systemd, k8s, a lab script).  Hedge
    tuning is advisory here: the budget lives in the scan *clients*,
    so the emitted action carries the recommendation.

    Offered load is a **real** signal or nothing: an operator-provided
    ``load_cmd`` (stdout's last line is a number) wins; otherwise the
    in-flight scan counts the replicas report in their ``/readyz``
    JSON (``inflight``) are summed.  With neither available the
    observation carries ``offered_load=None`` and the controller
    refuses to scale on load — a proxy like "how many replicas look
    down" is *not* load, and scaling down on it would drain a healthy
    idle-looking fleet."""

    def __init__(self, urls: list[str], token: str | None = None,
                 spawn_cmd: str | None = None,
                 load_cmd: str | None = None,
                 drain_timeout_s: float = 30.0):
        self._urls = [u.rstrip("/") for u in urls]
        self._token = token
        self._spawn_cmd = spawn_cmd
        self._load_cmd = load_cmd
        self._drain_timeout_s = drain_timeout_s

    @property
    def urls(self) -> list[str]:
        return list(self._urls)

    def _command_load(self) -> float | None:
        """Run the operator's load command; its stdout's last
        non-empty line must be a number.  Any failure means "no load
        signal this tick" (None), never a fabricated zero."""
        try:
            proc = subprocess.run(
                self._load_cmd, shell=True, capture_output=True,
                text=True, timeout=60.0)
        except (subprocess.TimeoutExpired, OSError) as exc:
            _log.warn("load command failed; no load signal this tick",
                      err=str(exc))
            return None
        if proc.returncode != 0:
            _log.warn("load command failed; no load signal this tick",
                      rc=proc.returncode,
                      stderr=proc.stderr.strip()[:200])
            return None
        lines = [ln.strip() for ln in proc.stdout.splitlines()
                 if ln.strip()]
        try:
            return float(lines[-1]) if lines else None
        except ValueError:
            _log.warn("load command printed no number on its last "
                      "stdout line; no load signal this tick",
                      line=lines[-1][:80])
            return None

    def observe(self) -> dict:
        statuses = []
        inflight: list[float] = []
        for url in self._urls:
            t0 = time.monotonic()
            doc = readyz_doc(url, token=self._token)
            probe_s = time.monotonic() - t0
            if doc and doc.get("inflight") is not None:
                try:
                    inflight.append(float(doc["inflight"]))
                except (TypeError, ValueError):
                    pass
            statuses.append({
                "endpoint": url,
                "ready": bool(doc.get("ready")) if doc else False,
                "generation": doc.get("generation") if doc else None,
                "mesh": doc.get("mesh") if doc else None,
                "probe_s": probe_s,
            })
        if self._load_cmd:
            load = self._command_load()
        elif inflight:
            load = sum(inflight)
        else:
            load = None  # no genuine signal: never scale on a proxy
        return {"statuses": statuses, "offered_load": load,
                "replicas": list(self._urls)}

    def spawn_replica(self) -> str:
        if not self._spawn_cmd:
            raise ActuatorError(
                "no --spawn-cmd configured: the controller cannot "
                "create replicas on this fleet")
        try:
            proc = subprocess.run(
                self._spawn_cmd, shell=True, capture_output=True,
                text=True, timeout=300.0)
        except (subprocess.TimeoutExpired, OSError) as exc:
            # a hung or unlaunchable spawn command must degrade the
            # loop to observe-only (tick catches ActuatorError), not
            # kill it
            raise ActuatorError(
                f"spawn command did not complete: {exc}") from exc
        if proc.returncode != 0:
            raise ActuatorError(
                f"spawn command failed (rc {proc.returncode}): "
                f"{proc.stderr.strip()[:200]}")
        lines = [ln.strip() for ln in proc.stdout.splitlines()
                 if ln.strip()]
        if not lines or "://" not in lines[-1]:
            raise ActuatorError(
                "spawn command printed no replica URL on its last "
                "stdout line")
        url = lines[-1].rstrip("/")
        self._urls.append(url)
        return url

    def drain_replica(self, url: str) -> bool:
        from trivy_tpu_torch.fleet.rollout import post_json

        status, doc = post_json(
            url.rstrip("/") + "/fleet/drain", token=self._token,
            body={"timeout_s": self._drain_timeout_s},
            timeout=self._drain_timeout_s + 30.0)
        if status != 200:
            _log.warn("drain request failed; retiring anyway",
                      url=url, status=status, reply=doc)
        return True

    def retire_replica(self, url: str) -> None:
        url = url.rstrip("/")
        self._urls = [u for u in self._urls if u != url]

    def reresolve_mesh(self, url: str) -> dict:
        from trivy_tpu_torch.fleet.rollout import post_json

        status, doc = post_json(url.rstrip("/") + "/fleet/reresolve",
                                token=self._token)
        if status != 200:
            raise ActuatorError(
                f"reresolve on {url} failed: HTTP {status} {doc}")
        return doc

    def set_hedge_budget(self, budget: float) -> bool:
        return False  # client-side knob; the emitted action advises


# --------------------------------------------------------- controller

class _Decision:
    """One action the policy wants this tick, with the callable that
    performs it and the predicate replay uses to reconcile a crashed
    attempt against live state."""

    def __init__(self, action: str, fields: dict, apply_fn,
                 holds_fn=None):
        self.action = action
        self.fields = fields
        self.apply_fn = apply_fn
        self.holds_fn = holds_fn or (lambda obs: False)


class FleetController:
    """The control loop.  One :meth:`tick` = observe → reconcile any
    crash-pending intents → decide under the policy → act, with every
    action journaled (intent before, applied after) and emitted as a
    ``controller_action`` ops event.  ``dry_run`` journals and emits
    without acting."""

    def __init__(self, actuator, policy: ControllerPolicy | None = None,
                 journal_path: str | None = None, dry_run: bool = False,
                 clock=time.monotonic):
        self.actuator = actuator
        self.policy = policy or ControllerPolicy()
        self.dry_run = bool(dry_run)
        self._clock = clock
        self.journal = (ActionJournal.open(journal_path)
                        if journal_path else None)
        self._last_action_ts: dict[str, float] = {}
        self._calm_ticks = 0
        self._unhealthy: dict[str, int] = {}
        self._degraded: dict[str, int] = {}
        self._hedge_budget = fleet_mod.hedge_budget()
        self._hedge_baseline = self._hedge_budget
        self.ticks = 0

    # ----------------------------------------------------- fault site
    @staticmethod
    def _fire_site() -> str | None:
        """Run the ``fleet.controller`` fault ladder at the action
        boundary (between the journaled intent and the act): ``kill``
        crashes the controller there, ``delay`` stalls it, ``error``
        aborts the action (reconciled next tick), ``drop`` skips the
        act.  Returns the action-degrading verdict, if any."""
        rules = faults.fire(CONTROLLER_SITE)
        faults.check_kill(CONTROLLER_SITE, rules=rules)
        verdict = None
        for r in rules:
            if r.action == "delay":
                time.sleep(r.param if r.param is not None else 0.05)
            elif r.action == "error":
                verdict = "error"
            elif r.action == "drop" and verdict is None:
                verdict = "drop"
        return verdict

    # ------------------------------------------------------ execution
    def _execute(self, d: _Decision, outcome_hint: str | None = None,
                 aid: int | None = None) -> dict:
        """Run one decision through the intent → fault site → act →
        applied protocol.  ``aid`` is set when re-firing a replayed
        intent (no second intent record)."""
        kind = d.action
        if aid is None and self.journal is not None:
            aid = self.journal.intent(kind, **d.fields)
        verdict = self._fire_site()
        if verdict == "error":
            # the action is NOT applied; the intent stays pending and
            # the next tick reconciles it before any re-fire
            obs_metrics.CONTROLLER_ACTIONS.inc(kind=kind,
                                               outcome="failed")
            raise ActuatorError(
                f"injected controller error at {CONTROLLER_SITE}")
        outcome = outcome_hint
        result: dict = {}
        if verdict == "drop":
            outcome = "dropped"
        elif self.dry_run:
            outcome = "dry_run"
        elif outcome is None:
            result = d.apply_fn() or {}
            outcome = "applied"
        if self.journal is not None and aid is not None:
            self.journal.applied(aid, outcome, **result)
        # lint: allow[event-kind] dispatch funnel; every kind reaching here is a literal from a _Decision site, validated against ACTION_KINDS
        emit_action(kind, outcome=outcome, **d.fields)
        obs_metrics.CONTROLLER_ACTIONS.inc(kind=kind, outcome=outcome)
        self._last_action_ts[kind] = self._clock()
        _log.info("controller action", action=kind, outcome=outcome,
                  **d.fields)
        return {"action": kind, "outcome": outcome, **d.fields}

    def _cooled(self, kind: str) -> bool:
        last = self._last_action_ts.get(kind)
        return (last is None
                or self._clock() - last >= self.policy.cooldown_s)

    # ----------------------------------------------------- reconcile
    def _reconcile(self, obs: dict) -> list[dict]:
        """Every tick, before deciding: every intent without an
        applied record — a crashed restart's leftovers *or* the
        previous tick's failed action — is checked against the live
        fleet.  Holds already → ``reconciled`` (never re-fired);
        otherwise re-fired exactly once under the same journaled id.
        Running this each tick (not just at start) means a mid-run
        failed intent is resolved while the observation is still
        fresh, instead of lingering unsealed until an arbitrarily
        later restart re-fires it against a fleet the policy has
        legitimately moved on."""
        if self.journal is None:
            return []
        done = []
        for rec in self.journal.pending():
            d = self._rebuild_decision(rec, obs)
            if d is None:
                self.journal.applied(rec["id"], "reconciled",
                                     reason="stale intent")
                continue
            if d.holds_fn(obs):
                self.journal.applied(rec["id"], "reconciled")
                # lint: allow[event-kind] replayed intents carry kinds a _Decision site journaled; validated against ACTION_KINDS
                emit_action(rec["action"], outcome="reconciled",
                            **d.fields)
                obs_metrics.CONTROLLER_ACTIONS.inc(
                    kind=rec["action"], outcome="reconciled")
                done.append({"action": rec["action"],
                             "outcome": "reconciled", **d.fields})
            else:
                try:
                    done.append(self._execute(d, aid=rec["id"]))
                except ActuatorError as exc:
                    # still pending; the next tick reconciles again
                    _log.warn("re-fired intent failed; still pending",
                              action=rec["action"], err=str(exc))
                    done.append({"action": rec["action"],
                                 "outcome": "failed",
                                 "error": str(exc), **d.fields})
        return done

    def _rebuild_decision(self, rec: dict, obs: dict):
        kind = rec.get("action")
        fields = {k: v for k, v in rec.items()
                  if k not in ("phase", "id", "ts", "action")}
        if kind in ("scale_up", "scale_down"):
            want = int(rec.get("want", 0))
            if not want:
                return None
            up = kind == "scale_up"
            return _Decision(
                kind, fields,
                (self._apply_scale_up if up
                 else lambda: self._apply_scale_down(
                     rec.get("target") or self._pick_scale_down(obs))),
                holds_fn=lambda o: (len(o["replicas"]) >= want if up
                                    else len(o["replicas"]) <= want))
        if kind == "drain_replace":
            target = rec.get("target")
            if not target:
                return None
            return _Decision(
                kind, fields,
                lambda: self._apply_drain_replace(target),
                holds_fn=lambda o: target not in o["replicas"])
        if kind == "mesh_reresolve":
            target = rec.get("target")
            if not target:
                return None
            # the server-side re-resolve is idempotent (no degraded
            # hosts -> no-op), so re-firing is always safe
            return _Decision(
                kind, fields,
                lambda: self.actuator.reresolve_mesh(target),
                holds_fn=lambda o: not self._degraded_hosts_of(
                    o, target))
        if kind == "hedge_tune":
            budget = rec.get("budget")
            if budget is None:
                return None
            return _Decision(
                kind, fields,
                lambda: self._apply_hedge(float(budget)),
                holds_fn=lambda o: self._hedge_budget == float(budget))
        return None

    # ------------------------------------------------------- decisions
    @staticmethod
    def _degraded_hosts_of(obs: dict, url: str) -> list:
        for s in obs["statuses"]:
            if s.get("endpoint") == url:
                return list((s.get("mesh") or {}).get("degraded_hosts")
                            or ())
        return []

    def _pick_scale_down(self, obs: dict) -> str | None:
        ready = [s["endpoint"] for s in obs["statuses"]
                 if s.get("ready")]
        return ready[-1] if len(ready) > 1 else None

    def _apply_scale_up(self) -> dict:
        return {"spawned": self.actuator.spawn_replica()}

    def _apply_scale_down(self, target: str | None) -> dict:
        if not target:
            return {"skipped": "no drainable replica"}
        self.actuator.drain_replica(target)
        self.actuator.retire_replica(target)
        return {"retired": target}

    def _apply_drain_replace(self, target: str) -> dict:
        self.actuator.drain_replica(target)
        self.actuator.retire_replica(target)
        self._unhealthy.pop(target, None)
        return {"retired": target,
                "spawned": self.actuator.spawn_replica()}

    def _apply_hedge(self, budget: float) -> dict:
        applied = self.actuator.set_hedge_budget(budget)
        self._hedge_budget = budget
        return {"client_applied": bool(applied)}

    def _decide(self, obs: dict) -> list[_Decision]:
        pol = self.policy
        statuses = obs["statuses"]
        replicas = obs["replicas"]
        n = len(replicas)
        out: list[_Decision] = []

        # -- drain-and-replace: probe-history threshold ---------------
        for s in statuses:
            url = s["endpoint"]
            if s.get("ready"):
                self._unhealthy.pop(url, None)
            else:
                self._unhealthy[url] = self._unhealthy.get(url, 0) + 1
        for url, streak in list(self._unhealthy.items()):
            if url not in replicas:
                self._unhealthy.pop(url, None)
                continue
            if streak >= pol.unhealthy_ticks \
                    and self._cooled("drain_replace"):
                out.append(_Decision(
                    "drain_replace",
                    {"target": url, "unhealthy_ticks": streak},
                    lambda u=url: self._apply_drain_replace(u),
                    holds_fn=lambda o, u=url: u not in o["replicas"]))
                break  # one replacement per tick; the loop is patient

        # -- autoscale under the cost floor ---------------------------
        ready_n = sum(1 for s in statuses if s.get("ready"))
        load = obs.get("offered_load")
        per_replica = (load / max(ready_n, 1)
                       if load is not None else None)
        if n < pol.min_replicas:
            # below the floor — the operator raised it, or a replica
            # died outside a drain: restore it regardless of load
            self._calm_ticks = 0
            if self._cooled("scale_up") \
                    and not any(d.action == "drain_replace"
                                for d in out):
                want = n + 1
                out.append(_Decision(
                    "scale_up",
                    {"want": want, "reason": "below_min_replicas"},
                    self._apply_scale_up,
                    holds_fn=lambda o, w=want: len(o["replicas"]) >= w))
        elif per_replica is None:
            # no genuine load signal this tick (actuator without a
            # load source, or its load command failed): hold the
            # replica count — scaling on a proxy would retire healthy
            # replicas.  The floor restore above, drain-and-replace,
            # mesh re-resolve and hedge tuning all still run.
            self._calm_ticks = 0
        elif per_replica > pol.scale_up_load:
            self._calm_ticks = 0
            if n < pol.max_replicas and self._cooled("scale_up") \
                    and not any(d.action == "drain_replace"
                                for d in out):
                want = n + 1
                out.append(_Decision(
                    "scale_up",
                    {"want": want,
                     "load_per_replica": round(per_replica, 2)},
                    self._apply_scale_up,
                    holds_fn=lambda o, w=want: len(o["replicas"]) >= w))
        elif per_replica < pol.scale_down_load:
            self._calm_ticks += 1
            if self._calm_ticks >= pol.scale_down_holds \
                    and n > pol.min_replicas \
                    and self._cooled("scale_down") \
                    and not any(d.action == "drain_replace"
                                for d in out):
                want = n - 1
                target = self._pick_scale_down(obs)
                out.append(_Decision(
                    "scale_down",
                    {"want": want, "target": target,
                     "calm_ticks": self._calm_ticks,
                     "load_per_replica": round(per_replica, 2)},
                    lambda t=target: self._apply_scale_down(t),
                    holds_fn=lambda o, w=want: len(o["replicas"]) <= w))
                self._calm_ticks = 0
        else:
            self._calm_ticks = 0

        # -- sustained host degradation: mesh re-resolve --------------
        for s in statuses:
            url = s["endpoint"]
            dhosts = list((s.get("mesh") or {}).get("degraded_hosts")
                          or ())
            if dhosts:
                self._degraded[url] = self._degraded.get(url, 0) + 1
            else:
                self._degraded.pop(url, None)
            if self._degraded.get(url, 0) >= pol.degraded_ticks \
                    and self._cooled("mesh_reresolve"):
                out.append(_Decision(
                    "mesh_reresolve",
                    {"target": url, "hosts": dhosts,
                     "degraded_ticks": self._degraded[url]},
                    lambda u=url: self.actuator.reresolve_mesh(u),
                    holds_fn=lambda o, u=url:
                        not self._degraded_hosts_of(o, u)))
                self._degraded[url] = 0

        # -- hedge budget from p99/p50 probe skew ---------------------
        q = telemetry.probe_quantiles(
            [s.get("probe_s") for s in statuses])
        if q:
            p50, p99, skew = q["p50_s"], q["p99_s"], q["skew"]
            want = None
            if skew >= pol.hedge_skew \
                    and self._hedge_budget != pol.hedge_budget_hi:
                want = pol.hedge_budget_hi
            elif skew < pol.hedge_skew / 2.0 \
                    and self._hedge_budget != self._hedge_baseline:
                want = self._hedge_baseline
            if want is not None and self._cooled("hedge_tune"):
                out.append(_Decision(
                    "hedge_tune",
                    {"budget": want, "skew": round(skew, 2),
                     "p50_s": round(p50, 4), "p99_s": round(p99, 4)},
                    lambda b=want: self._apply_hedge(b),
                    holds_fn=lambda o, b=want:
                        self._hedge_budget == b))
        return out

    # ------------------------------------------------------------ tick
    def tick(self) -> dict:
        """One control pass.  Returns the tick report: observations,
        reconciled leftovers, and the actions taken (or rehearsed
        under ``dry_run``)."""
        self.ticks += 1
        obs_metrics.CONTROLLER_TICKS.inc()
        if not controller_enabled():
            return {"enabled": False, "actions": [],
                    "reconciled": []}
        with tracing.span("fleet.control"):
            obs = self.actuator.observe()
            obs_metrics.CONTROLLER_REPLICAS.set(
                float(len(obs["replicas"])))
            reconciled = self._reconcile(obs)
            actions = []
            # a tick that reconciled crash-pending intents makes no
            # fresh decisions: the observation predates the re-fires,
            # and deciding on it could double an action the replay
            # just performed — wait one tick for a fresh observation
            for d in (self._decide(obs) if not reconciled else []):
                try:
                    actions.append(self._execute(d))
                except ActuatorError as exc:
                    _log.warn("controller action failed; will "
                              "reconcile next tick",
                              action=d.action, err=str(exc))
                    actions.append({"action": d.action,
                                    "outcome": "failed",
                                    "error": str(exc), **d.fields})
        return {"enabled": True, "replicas": obs["replicas"],
                "offered_load": obs["offered_load"],
                "reconciled": reconciled, "actions": actions}

    def run(self, interval_s: float = 5.0, max_ticks: int | None = None,
            stop=None, on_tick=None) -> int:
        """The blocking loop behind ``trivy-tpu fleet control``."""
        import threading

        stop = stop or threading.Event()
        done = 0
        while not stop.is_set():
            report = self.tick()
            done += 1
            if on_tick is not None:
                on_tick(report)
            if max_ticks is not None and done >= max_ticks:
                break
            if stop.wait(interval_s):
                break
        return done

    def close(self) -> None:
        if self.journal is not None:
            self.journal.close()


def render_report(report: dict) -> str:
    """One tick report as a JSON line (the CLI's stdout stream)."""
    return json.dumps(report, sort_keys=True)
