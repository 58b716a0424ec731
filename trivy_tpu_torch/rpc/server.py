"""Scan + cache server (reference pkg/rpc/server + rpc/server/listen.go).

Endpoints:
  POST /twirp/trivy.scanner.v1.Scanner/Scan    scan cached blobs
  POST /twirp/trivy.cache.v1.Cache/PutArtifact
  POST /twirp/trivy.cache.v1.Cache/PutBlob
  POST /twirp/trivy.cache.v1.Cache/MissingBlobs
  POST /twirp/trivy.cache.v1.Cache/DeleteBlobs
  GET  /healthz, GET /readyz, GET /version, GET /metrics
  GET  /debug/profile, /debug/flight, /debug/usage
  GET  /monitor/events?since=N                 continuous-monitoring
                                               events (--monitor-index)
  POST /fleet/reload|rescore|drain|reresolve   fleet control surface

Token auth via the Trivy-Token header (reference listen.go:96-108).
A background worker watches the advisory-DB directory and hot-swaps the
match engine between requests, quiescing in-flight scans first
(reference listen.go:147-202 dbWorker; the swap happens under an RW
lock so the card holds at most the old and the new DB during it).

Copy of trivy_tpu/rpc/server.py. The hot reload builds the port's
MatchEngine on the device the served engine is on, and keeps its
serving mesh (a spec-built mesh or host topology resolves again
against the new DB, a prebuilt grid carries over) and closes the old
engine once the swap is done (a distributed MeshDB's workers exit);
/readyz reports the mesh's shard health and, on the distributed
MeshDB, its hosts.
With `monitor_index` the service records each completed scan in the
monitor index and, after every hot swap, re-scores the affected
artifacts on a background thread (trivy_tpu_torch/monitor) through the
match scheduler; the events are served at /monitor/events. `/metrics`
serves the server's own registry and the process-wide one
(obs/metrics.py); `/debug/profile`, `/debug/flight` and `/debug/usage`
serve the bottleneck attribution the server holds for its lifetime
(obs/attrib.py) and the usage registry (obs/usage.py), behind the scan
token or TRIVY_TPU_PROFILE_TOKEN. `/fleet/*` is the fleet control
surface (reload, with `rescore=false` parking the monitor's re-score,
rescore, drain, reresolve), token-gated like the scan POSTs. One
departure from the reference on purpose: a device error during
`/fleet/reresolve` (a device.DeviceError: a CUDA error, a kernel that
cannot launch, a failed upload, a DCN worker's device error) answers 500
naming it, where the reference answers 200 `{"reresolved": false,
"error": ...}`, which a fleet controller reads as "try again later";
any other failure keeps the reference's reply. A `ScanService` built on a
`RedisCache` takes the redis layer gate (fleet/dedupe.py), so servers
sharing one redis tier analyze each unique layer once; `TRIVY_TPU_FLEET=0`
keeps the in-process gate. The listen backlog is 128 connections (the
reference's is socketserver's 5).
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import trivy_tpu_torch
from trivy_tpu_torch.analysis.witness import make_lock
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import tracing
from trivy_tpu_torch.obs import usage
from trivy_tpu_torch.resilience.retry import (
    DEADLINE_HEADER,
    Deadline,
    DeadlineExceeded,
    deadline_scope,
)
from trivy_tpu_torch.rpc import columnar as colwire
from trivy_tpu_torch.rpc import wire
from trivy_tpu_torch.sched.scheduler import Overloaded  # noqa: F401 — re-export

_log = logger("server")

SCAN_PATH = "/twirp/trivy.scanner.v1.Scanner/Scan"
CACHE_PREFIX = "/twirp/trivy.cache.v1.Cache/"


class _RWLock:
    """Many readers (scans) / one writer (DB swap)."""

    def __init__(self):
        self._cond = make_lock("rpc.server._cond", threading.Condition())
        self._readers = 0
        self._writing = False
        self._writers_waiting = 0

    def acquire_read(self, timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            # writer preference: new readers queue behind a waiting
            # writer so the DB swap cannot starve under scan load
            while self._writing or self._writers_waiting:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining)
            self._readers += 1
            return True

    @property
    def write_busy(self) -> bool:
        """A writer holds or is waiting for the lock (DB swap underway)."""
        with self._cond:
            return self._writing or bool(self._writers_waiting)

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writing or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writing = True

    def release_write(self):
        with self._cond:
            self._writing = False
            self._cond.notify_all()


class Metrics:
    """Scan-server metrics exposed at /metrics in Prometheus text format
    (SURVEY §5: greenfield for the TPU sidecar).

    Backed by an obs.metrics.Registry private to this server instance
    (fresh Server => zeroed counters, as tests expect) — every
    pre-existing trivy_tpu_* series name is byte-stable, enforced by a
    golden test. render() appends the process-wide spine registry
    (scan-phase / RPC histograms, breaker state, cache corruption,
    fault fires), each rendered under one lock snapshot so concurrent
    scans cannot produce torn counter reads.

    The legacy integer attributes (scans_total, ...) remain readable as
    properties; writers go through the typed metric handles."""

    def __init__(self):
        self.registry = obs_metrics.Registry()
        reg = self.registry
        self.scans = reg.counter(
            "trivy_tpu_scans_total", "Scan RPCs handled")
        self.scan_errors = reg.counter(
            "trivy_tpu_scan_errors_total", "Scan RPCs that errored")
        self.scan_seconds = reg.counter(
            "trivy_tpu_scan_seconds_sum",
            "Total seconds spent in scan RPCs")
        self.findings = reg.counter(
            "trivy_tpu_findings_total", "Vulnerabilities reported")
        self.db_reloads = reg.counter(
            "trivy_tpu_db_reloads_total", "Advisory-DB hot swaps served")
        self.db_reload_failures = reg.counter(
            "trivy_tpu_db_reload_failures_total",
            "Advisory-DB candidates rejected (serving last-good)")
        self.scans_shed = reg.counter(
            "trivy_tpu_scans_shed_total",
            "Scans shed with 503 (drain, DB swap, deadline)")
        self.drained_scans = reg.counter(
            "trivy_tpu_drained_scans_total",
            "In-flight scans carried to completion during drain")
        self.db_reload_seconds = reg.histogram(
            "trivy_tpu_db_reload_seconds",
            "Advisory-DB reload attempt duration (load+validate+swap)")
        self.db_generation_age = reg.gauge(
            "trivy_tpu_db_generation_age_seconds",
            "Seconds since the served DB generation was loaded")

    # legacy integer views (tests and operators read these directly)

    @property
    def scans_total(self) -> int:
        return int(self.scans.value())

    @property
    def scan_errors_total(self) -> int:
        return int(self.scan_errors.value())

    @property
    def scan_seconds_sum(self) -> float:
        return self.scan_seconds.value()

    @property
    def findings_total(self) -> int:
        return int(self.findings.value())

    @property
    def db_reloads_total(self) -> int:
        return int(self.db_reloads.value())

    @property
    def db_reload_failures_total(self) -> int:
        return int(self.db_reload_failures.value())

    @property
    def scans_shed_total(self) -> int:
        return int(self.scans_shed.value())

    @property
    def drained_scans_total(self) -> int:
        return int(self.drained_scans.value())

    def record(self, seconds: float, findings: int = 0,
               error: bool = False) -> None:
        with self.registry.locked():  # one snapshot-consistent update
            self.scans.inc()
            self.scan_seconds.inc(round(seconds, 6))
            if findings:
                self.findings.inc(findings)
            if error:
                self.scan_errors.inc()

    def render(self) -> bytes:
        return self.registry.render() + obs_metrics.REGISTRY.render()

    def render_openmetrics(self) -> bytes:
        """OpenMetrics exposition (exemplars + `# EOF`), served only
        under `Accept: application/openmetrics-text` — the legacy
        0.0.4 bytes from render() stay golden."""
        return (self.registry.render_openmetrics(eof=False)
                + obs_metrics.REGISTRY.render_openmetrics())


class ScanService:
    """Holds the hot-swappable engine + the server-side cache."""

    def __init__(self, engine, cache, db_path: str | None = None,
                 sched_window_ms: float | None = None,
                 sched_max_rows: int | None = None,
                 monitor_index: str | None = None):
        self.lock = _RWLock()
        self.engine = engine
        self.cache = cache
        self.db_path = db_path
        self._db_state = self._db_identity()
        self.metrics = Metrics()
        # generation age: seconds since the served DB was (re)loaded,
        # evaluated at /metrics render time (monotonic: an NTP step
        # must not age or rejuvenate the serving generation)
        self._db_loaded_at = time.monotonic()
        self.metrics.db_generation_age.set_function(
            lambda: time.monotonic() - self._db_loaded_at)
        # durable-lifecycle state: the generation the live engine was
        # loaded from (rollback target), the identity of the last
        # candidate we rejected (avoid a reload/reject loop), and a
        # human-readable note for /readyz when serving last-good
        self._active_db_dir = self._resolved_db_dir()
        self._rejected_db_state: tuple = ()
        self.db_degraded: str = ""
        # drain state: SIGTERM flips draining; in-flight scans finish
        # under the drain budget, new scans shed with Retry-After
        self._drain_cond = make_lock("rpc.server._drain_cond",
                                     threading.Condition())
        self._inflight = 0
        self.draining = False
        # cross-CLIENT layer dedupe: analysis happens client-side, but
        # MissingBlobs/PutBlob route through this cache — the gate makes
        # a second client's MissingBlobs wait (bounded) on the first
        # client's in-flight analysis of a shared base layer instead of
        # reporting it missing, so the clients analyze each unique layer
        # once (TTL claims: a client that dies mid-analysis expires)
        from trivy_tpu_torch.fanal import pipeline as _analysis

        self.layer_gate = _analysis.LayerSingleflight(
            ttl_s=_analysis.SERVER_CLAIM_TTL_S)
        # fleet tier: when the server cache is the shared redis
        # backend, layer claims live in redis too, so clients of
        # DIFFERENT replicas dedupe against each other — each unique
        # layer is analyzed once fleet-wide.
        # TRIVY_TPU_FLEET=0 keeps the in-process gate.
        from trivy_tpu_torch import fleet as _fleet

        if _fleet.enabled():
            from trivy_tpu_torch.fleet.dedupe import maybe_distributed_gate

            gate = maybe_distributed_gate(
                cache, ttl_s=_analysis.SERVER_CLAIM_TTL_S)
            if gate is not None:
                self.layer_gate = gate
        # cross-request continuous batching: concurrent scans' detect
        # phases coalesce into shared device micro-batches
        # (trivy_tpu_torch/sched). TRIVY_TPU_SCHED=0 restores the exact
        # per-request path. The engine is read through a callable so a
        # DB hot swap's replacement engine is picked up at dispatch
        # time (in-flight scans hold the read lock, so it is always a
        # consistent read); the in-flight counter feeds the lone-scan
        # fast path (window skipped when nobody else can submit).
        from trivy_tpu_torch import sched as _sched

        self.scheduler = None
        if _sched.enabled():
            self.scheduler = _sched.MatchScheduler(
                lambda: self.engine,
                window_ms=(sched_window_ms if sched_window_ms is not None
                           else _sched.DEFAULT_WINDOW_MS),
                max_rows=(sched_max_rows if sched_max_rows is not None
                          else _sched.DEFAULT_MAX_ROWS),
                on_shed=self.metrics.scans_shed.inc,
                busy_fn=lambda: self._inflight,
                # mesh-shape-aware composition: inert until the engine
                # serves from a mesh (read at compose time so a hot swap
                # is picked up immediately)
                data_axis_fn=lambda: getattr(
                    self.engine, "mesh_data_axis", 1),
                row_floor_fn=lambda: getattr(
                    self.engine, "mesh_row_floor", 0))
        # coordinated fleet rollout: a hot swap driven with
        # rescore=False parks its delta re-score here; the rollout
        # controller consumes it via POST /fleet/rescore after the whole
        # fleet has rolled. The reload mutex serializes the
        # check-load-swap of maybe_reload_db: it is reachable from
        # /fleet/reload handler threads and the hourly poller, and two
        # racing reloads would build two engines and clobber the
        # parked re-score.
        self._pending_rescore: tuple | None = None
        self._reload_lock = make_lock("rpc.server._reload_lock")
        # continuous monitoring (--monitor-index): completed scans
        # record inventory + finding baselines into the durable
        # package→artifact index; every DB hot swap triggers an
        # advisory-delta re-score emitting introduced/resolved events at
        # /monitor/events. The served generation's digest is tracked so
        # the promote hook knows the delta's old side.
        self.monitor = None
        self._db_digest: str | None = None
        if monitor_index and db_path:
            from trivy_tpu_torch import monitor as monitor_mod

            if monitor_mod.enabled():
                from trivy_tpu_torch.monitor.watch import MonitorService
                from trivy_tpu_torch.tensorize import cache as compile_cache

                # the digest is only read by the monitor's promote hook
                # and scan stamps: a monitor-less server never hashes
                self._db_digest = compile_cache.db_digest(db_path)
                self.monitor = MonitorService(
                    monitor_index, lambda: self.engine, db_path,
                    scheduler=self.scheduler)

    def close(self) -> None:
        """Join the monitor's re-score and close its index, then stop
        the scheduler thread (after the drain budget: it finishes
        whatever queued-and-admitted work remains)."""
        if self.monitor is not None:
            self.monitor.close()
        if self.scheduler is not None:
            self.scheduler.close()

    def _resolved_db_dir(self) -> str | None:
        """Real directory the DB would load from right now (a generation
        dir when last-good is installed, else the flat root)."""
        if not self.db_path:
            return None
        from trivy_tpu_torch.db import generations

        return os.path.realpath(generations.resolve(self.db_path))

    def _is_generation(self, path: str | None) -> bool:
        if not path or not self.db_path:
            return False
        from trivy_tpu_torch.db import generations

        root = os.path.realpath(generations.generations_root(self.db_path))
        return path.startswith(root + os.sep)

    def _db_identity(self) -> tuple:
        """DB identity for hot-swap decisions: the metadata document
        (UpdatedAt/Version — reference pkg/db/db.go:97 NeedsUpdate reads
        metadata, not file timestamps) plus an mtime fallback for DBs
        written without metadata. Reads through the last-good link when
        the root is generation-managed, so promoting a new generation is
        what makes the identity change."""
        if not self.db_path:
            return ()
        from trivy_tpu_torch.db import generations

        resolved = generations.resolve(self.db_path)
        meta_path = os.path.join(resolved, "metadata.json")
        try:
            with open(meta_path, encoding="utf-8") as f:
                md = json.load(f)
            ident = (md.get("Version"), md.get("UpdatedAt"),
                     md.get("NextUpdate"), md.get("DownloadedAt"))
            # a DB written without meaningful metadata falls back to
            # timestamps below — an empty tuple must not pin the identity
            if any(ident[1:]):
                return ident
        except (OSError, ValueError):
            pass
        try:
            return (max(
                os.path.getmtime(os.path.join(resolved, f))
                for f in os.listdir(resolved)
            ),)
        except (OSError, ValueError):
            return ()

    def ready(self) -> tuple[bool, str]:
        """Readiness (distinct from liveness): not ready while draining,
        while the advisory-DB swap holds/awaits the write lock, or
        before an engine is loaded. /healthz stays a pure liveness
        probe. A rejected DB candidate does NOT unready the server — it
        keeps serving last-good and says so."""
        if self.draining:
            return False, "draining"
        if self.engine is None:
            return False, "engine not loaded"
        if self.lock.write_busy:
            return False, "advisory-DB swap in progress"
        # mesh shard health: a shard degraded to the host mask keeps the
        # server ready (zero finding diff, less throughput) but /readyz
        # says so, the way serving last-good does
        note = ""
        health_fn = getattr(self.engine, "shard_health", None)
        health = health_fn() if callable(health_fn) else None
        if health:
            note = f"; mesh {health['shape']}"
            if health.get("degraded_hosts"):
                # distributed MeshDB: a lost peer host serves its whole
                # slice from the coordinator's host mask: ready, but
                # the fleet should know
                note += (" host(s) "
                         + ",".join(str(h)
                                    for h in health["degraded_hosts"])
                         + " degraded to host-mask")
            if health["degraded"]:
                note += (" shard(s) "
                         + ",".join(str(d) for d in health["degraded"])
                         + " degraded to host")
        # hybrid secret probe verdict: once this process has measured
        # its device-vs-host split, /readyz says which path secret
        # scans take; absent until the one-shot probe runs
        from trivy_tpu_torch.secret.scanner import hybrid_probe_state

        probe = hybrid_probe_state()
        if probe is not None:
            note += ("; secret probe: "
                     + ("device" if probe["device"] else "host"))
        if self.db_degraded:
            return True, f"ok (serving last-good: {self.db_degraded})" + note
        return True, "ok" + note

    def generation_name(self) -> str | None:
        """Name of the advisory-DB generation the live engine serves
        (``sha256-<hex>``), or None on a flat/unmanaged DB root."""
        d = self._active_db_dir
        return os.path.basename(d) if self._is_generation(d) else None

    def ready_doc(self) -> dict:
        """Machine-parseable readiness (the ``Accept:
        application/json`` variant of /readyz): everything the text
        body says, as structured fields, plus the serving generation.
        The keys are the reference's."""
        ok, why = self.ready()
        doc = {
            "ready": ok,
            "status": why,
            "draining": self.draining,
            "inflight": self._inflight,
            "serving_last_good": self.db_degraded,
            "generation": self.generation_name(),
            "monitor": self.monitor is not None,
        }
        health_fn = getattr(self.engine, "shard_health", None)
        health = health_fn() if callable(health_fn) else None
        if health:
            doc["mesh"] = {"shape": health["shape"],
                           "degraded": list(health["degraded"])}
            if "hosts" in health:
                # the distributed MeshDB's host topology
                doc["mesh"]["hosts"] = health["hosts"]
                doc["mesh"]["degraded_hosts"] = list(
                    health.get("degraded_hosts") or ())
        from trivy_tpu_torch.secret.scanner import hybrid_probe_state

        probe = hybrid_probe_state()
        if probe is not None:
            doc["secret_probe"] = "device" if probe["device"] else "host"
        return doc

    def trigger_pending_rescore(self) -> dict:
        """Consume the re-score a rescore=False hot swap parked: after
        the whole fleet has rolled, the rollout controller calls this
        on each monitor-enabled replica, so every replica re-scores its
        own indexed slice exactly once, instead of N uncoordinated
        mid-rollout sweeps against mixed generations."""
        with self._reload_lock:
            pending, self._pending_rescore = self._pending_rescore, None
        if self.monitor is None:
            return {"rescored": False,
                    "reason": "monitor not enabled (--monitor-index)"}
        if pending is None:
            return {"rescored": False, "reason": "no pending swap"}
        old_digest, db, new_digest = pending
        self.monitor.on_promote(old_digest, db, new_digest)
        return {"rescored": True}

    def reresolve_mesh(self) -> dict:
        """Re-resolve the serving mesh after sustained degradation (the
        fleet controller's ``mesh_reresolve`` action through POST
        /fleet/reresolve): quiesce in-flight scans under the write lock,
        then let the engine upload degraded shards to their devices
        again or re-partition over the surviving DCN hosts
        (MatchEngine.reresolve_mesh). Serialized against hot swaps by
        the reload lock. A failed re-resolve keeps the degraded but
        exact topology serving and reports the error, as the
        reference's does; a device error (device.DeviceError) raises
        instead."""
        from trivy_tpu_torch.device import DeviceError

        with self._reload_lock:
            engine = self.engine
            fn = getattr(engine, "reresolve_mesh", None)
            if not callable(fn):
                return {"reresolved": False,
                        "reason": "engine has no serving mesh"}
            self.lock.acquire_write()  # quiesce in-flight scans
            try:
                changed = bool(fn())
            except DeviceError:
                raise
            except Exception as exc:
                _log.warn("mesh re-resolve failed; serving topology "
                          "unchanged", err=str(exc))
                return {"reresolved": False, "error": str(exc),
                        "mesh": engine.shard_health()}
            finally:
                self.lock.release_write()
            return {"reresolved": changed, "mesh": engine.shard_health()}

    def begin_scan(self) -> None:
        """Admission control: refused while draining (503 + Retry-After
        so a rolling restart's clients go elsewhere); otherwise counts
        the scan as in-flight until end_scan."""
        with self._drain_cond:
            if self.draining:
                self.metrics.scans_shed.inc()
                raise Overloaded("server draining (shutting down)",
                                 retry_after=2.0)
            self._inflight += 1

    def end_scan(self) -> None:
        with self._drain_cond:
            self._inflight -= 1
            if self.draining:
                # an in-flight scan carried to completion during drain
                self.metrics.drained_scans.inc()
            self._drain_cond.notify_all()

    def start_drain(self) -> None:
        with self._drain_cond:
            self.draining = True

    def await_drained(self, timeout: float) -> int:
        """Block until in-flight scans complete or `timeout` elapses;
        returns how many were still running (shed by process exit)."""
        deadline = time.monotonic() + max(timeout, 0.0)
        with self._drain_cond:
            while self._inflight and time.monotonic() < deadline:
                self._drain_cond.wait(deadline - time.monotonic())
            return self._inflight

    def filter_inflight_blobs(self, missing: list[str],
                              budget_s: float | None = None,
                              holder: str | None = None) -> list[str]:
        """Cross-client layer dedupe on the MissingBlobs path: blobs
        another client is analyzing right now (a fresh gate claim with
        no PutBlob yet) are waited on — bounded by one shared budget —
        and re-probed; a blob that landed meanwhile is dropped from the
        missing set, so this caller never analyzes it. Everything else
        (including wait timeouts and dead leaders) is claimed for this
        caller and returned, preserving order — correctness never
        depends on the gate, it only removes duplicate work."""
        from trivy_tpu_torch.fanal import pipeline as _analysis

        waits: list[tuple[str, object]] = []
        out: set[str] = set()
        for b in dict.fromkeys(missing):  # unique, order kept — a dup
            # diffID must not wait on this very request's own claim,
            # and neither must a RETRY of this request (lost response,
            # resent body): the holder identity re-leads idempotently
            slot, leader = self.layer_gate.claim(b, holder=holder)
            if leader:
                out.add(b)
            else:
                waits.append((b, slot))
        budget = _analysis.SERVER_WAIT_BUDGET_S
        if budget_s is not None:
            budget = min(budget, budget_s)
        resolved: list[str] = []
        for b, slot in waits:
            t0 = time.monotonic()
            if budget > 0:
                obs_metrics.LAYER_DEDUPE_INFLIGHT_WAITS.inc()
                # queue_wait attribution lane: this request parked on
                # another client's in-flight analysis of a shared layer
                with tracing.span("analysis.dedupe.wait"):
                    done = slot.event.wait(budget)
            else:
                done = slot.done
            budget = max(0.0, budget - (time.monotonic() - t0))
            if done and slot.ok:
                resolved.append(b)
            else:
                # stale/failed claim: this caller takes it over (the
                # ghost slot is resolved, so later requests park on
                # THIS caller's fresh claim instead of re-paying the
                # wait budget until the TTL expires)
                self.layer_gate.reclaim(b, holder=holder)
                out.add(b)
        if resolved:
            # the leaders' PutBlobs hit this service's cache; ONE
            # batched probe verifies before trusting (a leader may have
            # died after its claim expired elsewhere)
            _ma, still = self.cache.missing_blobs("", resolved)
            still_set = set(still)
            for b in resolved:
                if b in still_set:
                    self.layer_gate.reclaim(b, holder=holder)
                    out.add(b)
                else:
                    obs_metrics.LAYER_DEDUPE_HITS.inc()
                    usage.add("layers_deduped")
        return [b for b in missing if b in out]

    def scan(self, target, artifact_key, blob_keys, options,
             deadline: Deadline | None = None):
        self.begin_scan()
        try:
            if self.monitor is None:
                return self._scan_admitted(target, artifact_key,
                                           blob_keys, options, deadline)
            from trivy_tpu_torch.monitor.capture import capture_scan

            # the generation stamp is read BEFORE the scan runs: a hot
            # swap completing mid-scan must not stamp the NEW digest
            # onto findings the OLD engine matched (a stale-looking
            # stamp only re-baselines conservatively; a too-new stamp
            # would make an incremental re-score trust stale findings)
            db_digest = self._db_digest
            with capture_scan() as cap:
                out = self._scan_admitted(target, artifact_key,
                                          blob_keys, options, deadline)
            # only a COMPLETED scan updates the artifact's index record
            # (a shed/failed scan must not regress the stored baseline)
            self.monitor.record_scan(target, cap, db_digest=db_digest)
            return out
        finally:
            self.end_scan()

    def _scan_admitted(self, target, artifact_key, blob_keys, options,
                       deadline: Deadline | None = None):
        from trivy_tpu_torch.scanner.local import LocalDriver

        timeout = None
        if deadline is not None:
            timeout = deadline.remaining()
            if timeout <= 0:
                self.metrics.scans_shed.inc()
                raise Overloaded("deadline budget exhausted before scan "
                                 "start", retry_after=1.0)
        if not self.lock.acquire_read(timeout=timeout):
            # a DB swap holds the write lock and the caller's budget ran
            # out waiting: shed instead of blocking behind the swap
            self.metrics.scans_shed.inc()
            raise Overloaded(
                "server busy (advisory-DB swap in progress); deadline "
                f"budget of {deadline.budget_s:.3f}s exhausted waiting",
                retry_after=1.0)
        start = time.perf_counter()
        try:
            driver = LocalDriver(self.engine, self.cache,
                                 scheduler=self.scheduler)
            with deadline_scope(deadline):
                results, os_found = driver.scan(
                    target, artifact_key, blob_keys, options)
            self.metrics.record(
                time.perf_counter() - start,
                findings=sum(len(r.vulnerabilities) for r in results))
            return results, os_found
        except Overloaded:
            # the match scheduler shed this scan (queue overload or
            # deadline expiry while queued) and already counted it in
            # scans_shed through its on_shed hook — not a scan error
            raise
        except DeadlineExceeded:
            # mid-scan deadline checkpoints fired. Sheds count ONLY in
            # scans_shed (consistent with the pre-lock shed path): a
            # caller-imposed budget running out is not a scan error
            self.metrics.scans_shed.inc()
            raise
        except Exception:
            self.metrics.record(time.perf_counter() - start, error=True)
            raise
        finally:
            self.lock.release_read()

    def maybe_reload_db(self, rescore: bool = True) -> bool:
        """Hot-swap the engine when the DB *metadata* changed (a new
        UpdatedAt/Version), not merely a file timestamp.

        The swap is guarded: the candidate is loaded and validated
        BEFORE the write lock is taken. A candidate that fails to load
        or validate is never served — the server keeps the engine it
        has (last-good), quarantines the corrupt generation when the
        root is generation-managed, and remembers the rejected identity
        so the reload worker doesn't retry the same bad bytes forever.

        The new engine is the port's MatchEngine with the served
        engine's `use_device` and `device`: a server on ``cuda:1``
        reloads onto ``cuda:1``. With a monitor, the swap triggers its
        delta re-score in the background; ``rescore=False`` (the fleet
        rollout's reload) parks it instead, for /fleet/rescore to
        trigger after the roll."""
        with self._reload_lock:
            return self._maybe_reload_db_locked(rescore)

    def _maybe_reload_db_locked(self, rescore: bool) -> bool:
        state = self._db_identity()
        if not self.db_path or not state or state == self._db_state \
                or state == self._rejected_db_state:
            return False
        from trivy_tpu_torch.db import generations
        from trivy_tpu_torch.db.store import AdvisoryDB, validate_db
        from trivy_tpu_torch.detector.engine import MatchEngine

        resolved = self._resolved_db_dir()
        _log.info("advisory DB changed; reloading", path=resolved)
        reload_start = time.perf_counter()
        problem = None
        db = new_engine = None
        try:
            db = AdvisoryDB.load(self.db_path)
            problem = validate_db(db)
            if problem is None:
                # db_path routes the reload through the persistent
                # compiled-DB cache: a generation already compiled by a
                # sibling process (or a rollback to last-good) swaps in
                # without paying the full tensorize cost again
                # the swap keeps the serving mesh: a spec-built mesh or
                # host topology resolves again against the new DB's row
                # count, a prebuilt grid carries over as it is (on the
                # distributed MeshDB it places the coordinator's cells)
                mesh_spec = getattr(self.engine, "mesh_spec", None)
                keep_grid = not mesh_spec or getattr(
                    self.engine, "dcn_plan", None) is not None
                new_engine = MatchEngine(
                    db, use_device=self.engine.use_device,
                    device=self.engine.device, db_path=self.db_path,
                    mesh=getattr(self.engine, "mesh", None)
                    if keep_grid else None,
                    mesh_spec=mesh_spec)
        except Exception as exc:
            problem = f"unloadable: {exc}"
        if problem is not None:
            self._rejected_db_state = state
            self.db_degraded = f"DB candidate rejected ({problem})"
            self.metrics.db_reload_failures.inc()
            self.metrics.db_reload_seconds.observe(
                time.perf_counter() - reload_start)
            _log.warn("advisory DB candidate rejected; serving last-good",
                      path=resolved, reason=problem)
            if self._is_generation(resolved) \
                    and resolved != self._active_db_dir:
                # generation layout: put the bad generation out of
                # reach and repoint last-good at the one we serve
                generations.quarantine(self.db_path, resolved)
                if self._is_generation(self._active_db_dir) \
                        and os.path.isdir(self._active_db_dir):
                    generations.promote(self.db_path, self._active_db_dir)
                # the rollback restored the old identity; clear the
                # rejection latch so a FUTURE good candidate (new
                # generation, new identity) still triggers a reload
                self._rejected_db_state = ()
                self._db_state = self._db_identity()
            return False
        old_digest = new_digest = None
        if self.monitor is not None:
            from trivy_tpu_torch.tensorize import cache as compile_cache

            old_digest = self._db_digest
            new_digest = compile_cache.db_digest(self.db_path)
        old_engine = self.engine
        self.lock.acquire_write()  # quiesce in-flight scans
        try:
            self.engine = new_engine
            self._db_state = state
            self._active_db_dir = resolved
            self._rejected_db_state = ()
            self.db_degraded = ""
            self._db_digest = new_digest
            self._db_loaded_at = time.monotonic()
        finally:
            self.lock.release_write()
        # the write lock quiesced every scan on the old engine: release
        # what it owns (a distributed MeshDB's workers and connections),
        # so a hot swap leaks no worker fleet
        close = getattr(old_engine, "close", None)
        if close is not None and old_engine is not new_engine:
            try:
                close()
            except Exception as exc:
                _log.warn("old engine close failed after hot swap",
                          err=str(exc))
        self.metrics.db_reloads.inc()
        self.metrics.db_reload_seconds.observe(
            time.perf_counter() - reload_start)
        _log.info("advisory DB hot-swapped", **db.stats())
        if self.monitor is not None:
            if rescore:
                # continuous monitoring: the promote triggers an
                # advisory-delta re-score in the background — affected
                # indexed artifacts re-match and the introduced/resolved
                # finding events land on /monitor/events
                self.monitor.on_promote(old_digest, db, new_digest)
            else:
                # fleet rollout: the controller decides which replica
                # re-scores, once, after the whole fleet has rolled
                self._pending_rescore = (old_digest, db, new_digest)
        return True


class _HTTPServer(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 resets the
    # connections of a burst of concurrent clients before the accept
    # loop reaches them
    request_queue_size = 128


def _make_handler(service: ScanService, token: str | None,
                  path_prefix: str = ""):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route into our logger
            _log.debug("http " + (fmt % args))

        def parse_request(self) -> bool:
            # mount the whole service under a URL path prefix (reference
            # client_server_test.go "with path prefix"): requests outside
            # it 404 via the normal routing (stripped path won't match)
            ok = super().parse_request()
            if ok and path_prefix:
                if self.path.startswith(path_prefix):
                    self.path = self.path[len(path_prefix):] or "/"
                else:
                    self.path = "\x00" + self.path  # never matches a route
            return ok

        def _reply(self, code: int, body: bytes,
                   ctype: str = "application/json",
                   extra_headers: dict | None = None):
            # large responses gzip when the client offered it; every
            # response advertises the server's own gzip capability so
            # the client may start gzipping large REQUEST bodies
            # (wire.py negotiation — header-less old clients keep the
            # plain byte-identical wire)
            accept = (self.headers.get("Accept-Encoding") or "").lower()
            encoding = None
            usage.add("bytes_out", float(len(body)))
            if "gzip" in accept and len(body) >= wire.GZIP_MIN_BYTES \
                    and ctype != colwire.CONTENT_TYPE:
                # columnar bodies skip whole-body gzip: frames carry
                # their own per-frame deflate
                body = wire.gzip_bytes(body)
                encoding = "gzip"
            usage.add("wire_bytes_out", float(len(body)))
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header(wire.GZIP_CAPABLE_HEADER, "1")
            if colwire.enabled():
                # columnar capability advertisement (absent when the
                # kill switch is off, which is what drives a columnar
                # client's unlearn after a rollback)
                self.send_header(colwire.CAPABLE_HEADER, "1")
            if encoding:
                self.send_header("Content-Encoding", encoding)
            for name, value in (extra_headers or {}).items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def _reply_stream(self, frames):
            """Chunked streaming columnar reply: each frame is written
            and flushed as its own HTTP/1.1 chunk the moment it is
            encoded, so the client can start demuxing the first result
            table while the server is still encoding the rest."""
            self.send_response(200)
            self.send_header("Content-Type", colwire.CONTENT_TYPE)
            self.send_header(wire.GZIP_CAPABLE_HEADER, "1")
            self.send_header(colwire.CAPABLE_HEADER, "1")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            total = 0
            for frame in frames:
                total += len(frame)
                self.wfile.write(b"%x\r\n" % len(frame))
                self.wfile.write(frame)
                self.wfile.write(b"\r\n")
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
            # columnar bodies have no whole-body compression layer, so
            # payload bytes == wire bytes (conservation invariant)
            usage.add("bytes_out", float(total))
            usage.add("wire_bytes_out", float(total))

        def _accepts_columnar(self) -> bool:
            return (colwire.enabled() and colwire.CONTENT_TYPE in
                    (self.headers.get("Accept") or ""))

        def _columnar_body(self, body: bytes) -> bool:
            # route by the DECLARED content type too: a columnar body
            # whose magic got mangled in transit must land in the
            # columnar decoder's deterministic WireFormatError (-> 400
            # frame reject), not fall through to the JSON parser
            return ((self.headers.get("Content-Type") or "")
                    .startswith(colwire.CONTENT_TYPE)
                    or colwire.is_columnar(body))

        def _shed(self, msg: str, retry_after: float):
            """503 + Retry-After: the reply a well-behaved client backs
            off on instead of hammering a busy server."""
            # every shed REPLY meters the tenant exactly once — shed
            # demand must stay visible per tenant even under overload
            usage.add("sheds")
            self._reply(
                503, json.dumps({"error": msg}).encode(),
                extra_headers={"Retry-After": f"{max(retry_after, 0.0):g}"})

        def _error(self, code: int, msg: str):
            self._reply(code, json.dumps({"error": msg}).encode())

        def _authed(self) -> bool:
            if not token:
                return True
            return self.headers.get("Trivy-Token") == token

        def _debug_authed(self) -> bool:
            """/debug/* gate: the scan token works, and the dedicated
            TRIVY_TPU_PROFILE_TOKEN (when set) grants profile access
            without handing out the scan/cache surface."""
            profile_token = os.environ.get("TRIVY_TPU_PROFILE_TOKEN", "")
            if profile_token and \
                    self.headers.get("Trivy-Token") == profile_token:
                return True
            return self._authed()

        def do_GET(self):
            if self.path.startswith("/debug/"):
                # live bottleneck attribution + slow-scan flight
                # recorder + usage; token-gated like /monitor/events
                # (profiles name scan targets and trace ids)
                if not self._debug_authed():
                    self._error(401, "invalid token")
                    return
                from trivy_tpu_torch.obs import attrib

                if self.path.startswith("/debug/profile"):
                    self._reply(200, json.dumps(
                        attrib.AGG.snapshot()).encode())
                elif self.path.startswith("/debug/flight"):
                    self._reply(200, json.dumps(
                        attrib.AGG.flight.chrome_doc()).encode())
                elif self.path.startswith("/debug/usage"):
                    # per-tenant cost vectors + the machine-checked
                    # conservation totals (docs/observability.md
                    # "Usage metering"); tenants are token hashes,
                    # never raw tokens
                    self._reply(200, json.dumps(
                        usage.USAGE.snapshot()).encode())
                else:
                    self._error(404, "not found")
                return
            if self.path.startswith("/monitor/events"):
                if not self._authed():
                    # events name scan targets + CVEs: token-gated like
                    # the scan/cache POST surface
                    self._error(401, "invalid token")
                    return
                if service.monitor is None:
                    self._error(404, "monitor not enabled "
                                     "(--monitor-index)")
                    return
                from urllib.parse import parse_qs, urlsplit

                q = parse_qs(urlsplit(self.path).query)
                try:
                    since = int((q.get("since") or ["0"])[0])
                except ValueError:
                    self._error(400, "bad since cursor")
                    return
                nxt, events = service.monitor.events_since(since)
                self._reply(200, json.dumps(
                    {"next": nxt, "events": events}).encode())
                return
            if self.path == "/healthz":
                self._reply(200, b"ok", "text/plain")
            elif self.path == "/readyz":
                accept = self.headers.get("Accept") or ""
                if "application/json" in accept:
                    # machine-parseable variant: same verdict as the
                    # text body, structured, plus the serving
                    # generation; 503-when-not-ready semantics are
                    # identical
                    doc = service.ready_doc()
                    body = json.dumps(doc).encode()
                    if doc["ready"]:
                        self._reply(200, body)
                    else:
                        self._reply(503, body, extra_headers={
                            "Retry-After": "1"})
                    return
                ok, why = service.ready()
                if ok:
                    self._reply(200, why.encode(), "text/plain")
                else:
                    self._shed(f"not ready: {why}", retry_after=1.0)
            elif self.path == "/version":
                self._reply(200, json.dumps(
                    {"Version": trivy_tpu_torch.__version__}).encode())
            elif self.path == "/metrics":
                # content negotiation: the OpenMetrics exposition (with
                # trace-id exemplars) only on explicit Accept — every
                # header-less legacy scraper keeps the byte-stable
                # 0.0.4 text
                accept = self.headers.get("Accept") or ""
                if "application/openmetrics-text" in accept:
                    self._reply(
                        200, service.metrics.render_openmetrics(),
                        "application/openmetrics-text; version=1.0.0; "
                        "charset=utf-8")
                else:
                    self._reply(200, service.metrics.render(),
                                "text/plain; version=0.0.4")
            else:
                self._error(404, "not found")

        def do_POST(self):
            if not self._authed():
                self._error(401, "invalid token")
                return
            # usage metering scope: the whole admitted request — scan
            # and cache POSTs alike — accrues its cost vector to the
            # tenant hashed from the auth token (never the raw token;
            # no token = the anonymous bucket), which the scheduler's
            # QoS reads too. The scope is ambient on this handler
            # thread, follows worker threads via capture/adopt, and
            # folds into the per-tenant registry on exit.
            # TRIVY_TPU_USAGE=0 makes this a no-op.
            with usage.scope(usage.tenant_id(
                    self.headers.get("Trivy-Token"))):
                self._post_metered()

        def _post_metered(self):
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length)
            usage.add("wire_bytes_in", float(len(body)))
            if "gzip" in (self.headers.get("Content-Encoding")
                          or "").lower():
                try:
                    body = wire.gunzip_bytes(body)
                except OSError as exc:
                    # deterministic decode failure: never retried
                    self._error(400, f"bad request body: {exc}")
                    return
            usage.add("bytes_in", float(len(body)))
            is_columnar_req = (
                (self.headers.get("Content-Type") or "")
                .startswith(colwire.CONTENT_TYPE)
                or colwire.is_columnar(body))
            if is_columnar_req and not colwire.enabled():
                # rolled back / kill-switched: the 400 goes out WITHOUT
                # the X-Trivy-Columnar header (see _reply), which is
                # exactly what makes the client unlearn the sticky
                # capability and resend JSON
                self._error(400, "columnar wire not supported")
                return
            if self.path.startswith("/twirp/") and \
                    self.headers.get("X-Trivy-Tpu-Wire") != "internal":
                # reference wire protocol (Twirp protobuf / proto3-JSON).
                # This framework's own client marks its extended-fidelity
                # JSON encoding with the header above; anything else on
                # the twirp paths is treated as a reference client.
                from trivy_tpu_torch.rpc import twirp

                try:
                    res = twirp.handle(
                        service, self.path,
                        self.headers.get("Content-Type", ""), body)
                except Overloaded as exc:
                    _log.warn("twirp scan shed", err=str(exc))
                    self._shed(str(exc), exc.retry_after)
                    return
                except DeadlineExceeded as exc:
                    _log.warn("twirp scan shed mid-flight", err=str(exc))
                    self._shed(str(exc), 1.0)
                    return
                if res is not None:
                    status, ct, out = res
                    self._reply(status, out, ct)
                    return
            try:
                if self.path == SCAN_PATH:
                    self._handle_scan(body)
                elif self.path.startswith(CACHE_PREFIX):
                    self._handle_cache(self.path[len(CACHE_PREFIX):], body)
                elif self.path.startswith("/fleet/"):
                    self._handle_fleet(self.path[len("/fleet/"):], body)
                else:
                    self._error(404, "not found")
            except (json.JSONDecodeError, KeyError, TypeError,
                    colwire.WireFormatError) as exc:
                # malformed request: deterministic, must not be retried
                # (a columnar frame-checksum reject lands here — the
                # client sees 400 + the capability header and resends
                # the same call as JSON)
                _log.warn("bad rpc request", path=self.path, err=str(exc))
                self._error(400, f"bad request: {exc}")
            except Exception as exc:  # twirp-style error envelope
                _log.warn("rpc error", path=self.path, err=str(exc))
                self._error(500, str(exc))

        def _handle_scan(self, body: bytes):
            if self._columnar_body(body):
                target, akey, blobs, options = \
                    colwire.decode_scan_request(body)
                obs_metrics.WIRE_REQUESTS.inc(format="columnar",
                                              direction="in")
            else:
                target, akey, blobs, options = \
                    wire.decode_scan_request(body)
                obs_metrics.WIRE_REQUESTS.inc(format="json",
                                              direction="in")
            deadline = Deadline.from_header(
                self.headers.get(DEADLINE_HEADER))
            # adopt the caller's trace identity (X-Trivy-Trace) so the
            # server-side phases nest under the client's RPC span — a
            # remote scan renders as one stitched tree. A reference
            # client's hedged or failed-over dispatch carries its
            # attempt identity too, kept as the span's meta (the
            # attribution counts a hedge's tree as a fragment)
            trace_header = self.headers.get(tracing.TRACE_HEADER)
            extra = {}
            tag = tracing.parse_attempt_tag(trace_header)
            if tag is not None:
                key = ("failover_attempt" if tag[2] == "failover"
                       else "attempt")
                extra = {key: str(tag[0]), "endpoint": str(tag[1])}
            with tracing.server_span(
                    "server.scan", trace_header,
                    target=target, **extra):
                try:
                    results, os_found = service.scan(
                        target, akey, blobs, options, deadline=deadline)
                except Overloaded as exc:
                    _log.warn("scan shed", err=str(exc))
                    self._shed(str(exc), exc.retry_after)
                    return
                except DeadlineExceeded as exc:
                    _log.warn("scan shed mid-flight", err=str(exc))
                    self._shed(str(exc), 1.0)
                    return
            usage.add("scans")
            if self._accepts_columnar():
                self._reply_stream(
                    colwire.scan_response_frames(results, os_found))
            else:
                self._reply(200, wire.scan_response(results, os_found))

        def _handle_fleet(self, method: str, body: bytes):
            """Fleet-rollout control surface, token-gated like the
            scan/cache POSTs:

            - ``reload``: run one maybe_reload_db pass now (the
              controller's staged hot swap; the hourly poller stays as
              the standalone path). Body: {"rescore": bool}; False
              parks the monitor's delta re-score for /fleet/rescore.
            - ``rescore``: trigger the parked delta re-score (the
              controller calls this per monitor-enabled replica, once
              the whole fleet serves the new generation).
            - ``drain``: stop admitting scans and wait for in-flight
              ones (the controller's drain-and-replace and scale-down
              path; the SIGTERM drain's semantics). Body:
              {"timeout_s": float}; replies with how many scans were
              still running at the deadline.
            - ``reresolve``: re-resolve the serving mesh over surviving
              shards or hosts after sustained degradation
              (ScanService.reresolve_mesh). A device error answers 500
              naming it, never the reference's "try again" 200.
            """
            from trivy_tpu_torch.device import DeviceError

            if method == "reload":
                doc = json.loads(body) if body else {}
                changed = service.maybe_reload_db(
                    rescore=bool(doc.get("rescore", True)))
                self._reply(200, json.dumps({
                    "reloaded": changed,
                    "serving": service.generation_name(),
                    "degraded": service.db_degraded,
                }).encode())
            elif method == "rescore":
                self._reply(200,
                            json.dumps(
                                service.trigger_pending_rescore()
                            ).encode())
            elif method == "drain":
                doc = json.loads(body) if body else {}
                timeout_s = float(doc.get("timeout_s", 30.0))
                service.start_drain()
                left = service.await_drained(timeout_s)
                self._reply(200, json.dumps({
                    "draining": True, "inflight": left,
                }).encode())
            elif method == "reresolve":
                try:
                    doc = service.reresolve_mesh()
                except DeviceError as exc:
                    _log.error("mesh re-resolve hit a device error",
                               err=str(exc))
                    self._error(500, "device error during mesh "
                                f"re-resolve: {exc}")
                    return
                self._reply(200, json.dumps(doc).encode())
            else:
                self._error(404, f"unknown fleet method {method}")

        def _handle_cache(self, method: str, body: bytes):
            if self._columnar_body(body):
                obs_metrics.WIRE_REQUESTS.inc(format="columnar",
                                              direction="in")
                if method == "PutBlob":
                    diff_id, blob_info = colwire.decode_put_blob(body)
                    doc = {"diff_id": diff_id, "blob_info": blob_info}
                elif method == "MissingBlobs":
                    artifact_id, blob_ids = \
                        colwire.decode_missing_blobs(body)
                    doc = {"artifact_id": artifact_id,
                           "blob_ids": blob_ids}
                else:
                    self._error(400, "columnar body not supported for "
                                     f"cache method {method}")
                    return
            else:
                doc = json.loads(body) if body else {}
            cache = service.cache
            if method == "PutArtifact":
                cache.put_artifact(doc["artifact_id"], doc["artifact_info"])
                self._reply(200, b"{}")
            elif method == "PutBlob":
                cache.put_blob(doc["diff_id"], doc["blob_info"])
                # a durable layer analysis arrived: release any clients
                # the MissingBlobs gate parked on this blob
                service.layer_gate.complete(doc["diff_id"])
                self._reply(200, b"{}")
            elif method == "MissingBlobs":
                blob_ids = doc.get("blob_ids") or []
                missing_artifact, missing_blobs = cache.missing_blobs(
                    doc["artifact_id"], blob_ids
                )
                usage.add("cache_hits",
                          float(len(blob_ids) - len(missing_blobs)))
                usage.add("cache_misses", float(len(missing_blobs)))
                if missing_blobs:
                    from trivy_tpu_torch.fanal import pipeline as _analysis

                    if _analysis.enabled():
                        # a deadline-scoped client must not burn its
                        # whole budget parked on another client's layer
                        dl = Deadline.from_header(
                            self.headers.get(DEADLINE_HEADER))
                        # the trace id (stable across retry attempts of
                        # one scan) identifies the claimant, so a
                        # resent MissingBlobs re-leads its own claims
                        trace = self.headers.get(tracing.TRACE_HEADER)
                        holder = trace.split("-", 1)[0] if trace else None
                        missing_blobs = service.filter_inflight_blobs(
                            missing_blobs,
                            budget_s=(max(dl.remaining() / 2, 0.0)
                                      if dl else None),
                            holder=holder)
                if self._accepts_columnar():
                    self._reply(200, colwire.encode_missing_response(
                        missing_artifact, missing_blobs),
                        ctype=colwire.CONTENT_TYPE)
                else:
                    self._reply(200, json.dumps({
                        "missing_artifact": missing_artifact,
                        "missing_blob_ids": missing_blobs,
                    }).encode())
            elif method == "DeleteBlobs":
                cache.delete_blobs(doc.get("blob_ids") or [])
                self._reply(200, b"{}")
            else:
                self._error(404, f"unknown cache method {method}")

    return Handler


class Server:
    """reference pkg/rpc/server/listen.go Server."""

    def __init__(self, engine, cache, host="localhost", port=4954,
                 token: str | None = None, db_path: str | None = None,
                 db_reload_interval: float = 3600.0,
                 path_prefix: str = "",
                 sched_window_ms: float | None = None,
                 sched_max_rows: int | None = None,
                 monitor_index: str | None = None):
        if path_prefix and not path_prefix.startswith("/"):
            path_prefix = "/" + path_prefix
        self.service = ScanService(engine, cache, db_path=db_path,
                                   sched_window_ms=sched_window_ms,
                                   sched_max_rows=sched_max_rows,
                                   monitor_index=monitor_index)
        try:
            self.httpd = _HTTPServer(
                (host, port),
                _make_handler(self.service, token, path_prefix.rstrip("/"))
            )
        except BaseException:
            self.service.close()
            raise
        # live bottleneck attribution (obs/attrib.py): on by default
        # for the server's lifetime — /debug/profile answers "which
        # lane bounds this server" without a restart; TRIVY_TPU_ATTRIB=0
        # is the kill switch. Refcounted so tests spinning several
        # servers per process release the span sink on shutdown.
        from trivy_tpu_torch.obs import attrib

        self._attrib_held = attrib.acquire()
        self.db_reload_interval = db_reload_interval
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self):
        # a short poll interval: shutdown() returns within 0.1 s
        # lint: allow[tracing-capture] accept loop: no ambient scan exists; per-request spans adopt X-Trivy-Trace
        t = threading.Thread(target=self.httpd.serve_forever,
                             kwargs={"poll_interval": 0.1},
                             name="ttpu-server", daemon=True)
        t.start()
        self._threads.append(t)
        if self.service.db_path:
            # lint: allow[tracing-capture] background DB-reload poller, owns its own root spans
            w = threading.Thread(target=self._db_worker,
                                 name="ttpu-db-reload", daemon=True)
            w.start()
            self._threads.append(w)
        _log.info("server listening", addr=self.address)

    def _db_worker(self):
        # reference rpc/server/listen.go:61-79 dbWorker (hourly)
        while not self._stop.wait(self.db_reload_interval):
            try:
                self.service.maybe_reload_db()
            except Exception as exc:
                _log.warn("db reload failed", err=str(exc))

    def drain(self, timeout: float) -> int:
        """Graceful drain: flip /readyz to 503 immediately so balancers
        stop routing here, let in-flight scans finish under the
        `timeout` budget, shed whatever is left. Returns the number of
        scans still running when the budget ran out (0 = fully
        drained)."""
        self.service.start_drain()
        _log.info("draining", timeout_s=timeout)
        left = self.service.await_drained(timeout)
        if left:
            _log.warn("drain budget exhausted; shedding in-flight scans",
                      remaining=left)
        else:
            _log.info("drained", completed=self.service.metrics
                      .drained_scans_total)
        return left

    def shutdown(self, drain_timeout: float | None = None):
        if drain_timeout is not None:
            self.drain(drain_timeout)  # idempotent if already draining
        self._stop.set()
        if self._attrib_held:
            from trivy_tpu_torch.obs import attrib

            self._attrib_held = False
            attrib.release()
        # flush a final usage-journal snapshot (no-op when
        # TRIVY_TPU_USAGE_JOURNAL is unset)
        usage.USAGE.journal_sync()
        # after the drain budget: the monitor's re-score is joined and
        # its index closed; the scheduler finishes whatever
        # queued-and-admitted work remains, then stops admitting
        self.service.close()
        # a distributed MeshDB's engine owns worker processes and
        # connections; every other engine has nothing to release
        close = getattr(self.service.engine, "close", None)
        try:
            if close is not None:
                close()
        except Exception as exc:
            _log.warn("engine close failed on shutdown", err=str(exc))
        self.httpd.shutdown()
        self.httpd.server_close()
        for t in self._threads:
            t.join(10.0)


def serve(engine, host="localhost", port=4954, token=None, cache=None,
          db_path=None, db_reload_interval=3600.0, drain_timeout=30.0,
          sched_window_ms=None, sched_max_rows=None, monitor_index=None):
    """Blocking entry point for `trivy-tpu-torch server`.

    SIGTERM triggers a graceful drain: /readyz goes 503 at once,
    in-flight scans get `drain_timeout` seconds to finish, then the
    process exits (remaining work is shed with Retry-After)."""
    import signal

    if cache is None:
        from trivy_tpu_torch.cache.cache import MemoryCache

        cache = MemoryCache()
    srv = Server(engine, cache, host=host, port=port, token=token,
                 db_path=db_path, db_reload_interval=db_reload_interval,
                 sched_window_ms=sched_window_ms,
                 sched_max_rows=sched_max_rows,
                 monitor_index=monitor_index)
    srv.start()
    stop = threading.Event()

    def _on_term(*_):
        # flip readiness in the handler itself so balancers see the 503
        # the instant the TERM lands, not up to a poll-tick later (the
        # handler runs on the main thread, which never holds the drain
        # lock here — no self-deadlock)
        srv.service.start_drain()
        stop.set()

    try:
        # only the main thread may install handlers; embedded callers
        # (tests) drive srv.drain()/shutdown() directly instead
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        pass
    try:
        while not stop.wait(1.0):
            pass
    except KeyboardInterrupt:
        # interactive Ctrl-C: stop now — the drain budget is for
        # orchestrated rollouts (SIGTERM), not a foreground operator
        srv.shutdown()
        return
    srv.shutdown(drain_timeout=drain_timeout)
