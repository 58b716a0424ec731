"""Watch mode: DB promote → delta re-score → introduced/resolved events.

Two consumers share the machinery:

- **Server** (`MonitorService`): attached to a `ScanService` when the
  server runs with `--monitor-index`.  Completed scans record their
  inventory/baseline; after every successful advisory-DB hot swap the
  service re-scores in a background thread (one at a time — a promote
  landing mid-re-score is queued, never stacked), publishes events to a
  bounded ring served at ``GET /monitor/events?since=N``, and logs each
  event as a JSON-able record carrying the re-score's scan id.
- **CLI** (`watch_local` / `watch_remote`): ``watch`` either polls a DB
  root + local index directly (emitting events as JSON lines on
  stdout) or tails a server's event ring.

Copy of trivy_tpu/monitor/watch.py; each re-score runs in a forced
scan scope, whose id its events and log lines carry, and its span
follows the promote onto the background thread. A re-score on the
server's background thread re-matches on the served engine's card; a failure there is
logged, kept in `MonitorService.last_error` and leaves the index's
state where it was (the next promote re-plans from it), and a device
error is also re-raised on that thread: it is never turned into a host
re-match. `watch_local` closes each engine it built once its re-score
is done (a distributed MeshDB's workers exit then, not at process
exit).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

from trivy_tpu_torch.analysis.witness import make_lock
from trivy_tpu_torch.durability.appendlog import AppendLogError
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.monitor import rematch as rematch_mod
from trivy_tpu_torch.monitor.delta import compute_delta
from trivy_tpu_torch.monitor.index import MonitorIndex, MonitorIndexError
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import tracing
from trivy_tpu_torch.sched.scheduler import Overloaded

_log = logger("monitor.watch")

EVENT_RING = 4096


def budget_s() -> float | None:
    """TRIVY_TPU_DELTA_BUDGET_S bounds one re-score's wall time (the
    deadline budget of the monitor path; unset = unbounded)."""
    raw = os.environ.get("TRIVY_TPU_DELTA_BUDGET_S", "")
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        _log.warn("malformed TRIVY_TPU_DELTA_BUDGET_S; ignoring",
                  value=raw)
        return None


def open_index(path: str, journal_path: str | None = None
               ) -> MonitorIndex:
    """Open an index; a corrupt one rebuilds from the fleet journal
    when available, else moves aside and starts fresh."""
    try:
        return MonitorIndex.open(path)
    except MonitorIndexError as e:
        if journal_path and os.path.exists(journal_path):
            _log.warn("monitor index unusable; rebuilding from journal",
                      path=path, err=str(e))
            return MonitorIndex.rebuild_from_journal(path, journal_path)
        return MonitorIndex.open_or_reset(path)


class MonitorService:
    """Server-side monitor: scan recording + promote-triggered
    re-scoring + the event ring behind ``/monitor/events``."""

    def __init__(self, index_path: str, engine_fn, db_path: str,
                 scheduler=None, journal_path: str | None = None):
        self.index = open_index(index_path, journal_path)
        self._engine_fn = engine_fn
        self._scheduler = scheduler
        self.db_path = db_path
        self._lock = make_lock("monitor.watch._lock")
        self._events: collections.deque = collections.deque(
            maxlen=EVENT_RING)
        self._seq = 0
        self._running = False
        self._pending = None  # (old_digest, db, new_digest) queued promote
        self._threads: list[threading.Thread] = []
        # the last background re-score's failure ("" after a success)
        self.last_error = ""

    # ------------------------------------------------------------ scans

    def record_scan(self, artifact_id: str, cap,
                    db_digest: str | None = None) -> None:
        """Index one completed scan's capture (inventory + engine-level
        finding baseline, stamped with the generation it was matched
        against). Never fails the scan: append errors degrade the
        index (next re-score goes full)."""
        self.index.update(artifact_id, cap.packages, cap.findings,
                          db_digest=db_digest)

    # ---------------------------------------------------------- promote

    def on_promote(self, old_digest: str | None, db,
                   new_digest: str | None,
                   params_changed: str | None = None) -> bool:
        """Hot-swap hook: schedule the delta re-score in the background.
        A promote landing while one is running replaces any queued one
        (only the LATEST generation matters — intermediate deltas are
        subsumed because the planner diffs from the index's stored
        baseline digest, not from the interrupted attempt)."""
        with self._lock:
            if self._running:
                self._pending = (old_digest, db, new_digest,
                                 params_changed)
                obs_metrics.DELTA_SHEDS.inc()
                _log.info("re-score already running; promote queued",
                          new=new_digest)
                return False
            self._running = True
        ctx = tracing.capture()

        def _bg():
            with tracing.adopt(ctx):
                self._rescore_loop(old_digest, db, new_digest,
                                   params_changed)

        t = threading.Thread(target=_bg, name="ttpu-monitor", daemon=True)
        t.start()
        with self._lock:
            self._threads = [th for th in self._threads
                             if th.is_alive()] + [t]
        return True

    def _rescore_loop(self, old_digest, db, new_digest,
                      params_changed) -> None:
        while True:
            try:
                self.rescore_now(old_digest, db, new_digest,
                                 params_changed)
                self.last_error = ""
            except (OSError, AppendLogError, MonitorIndexError,
                    Overloaded) as exc:
                # the index's own I/O, or the scheduler shedding the
                # sweep: the state stays un-advanced and the next
                # promote re-plans from it
                self.last_error = f"{type(exc).__name__}: {exc}"
                _log.warn("delta re-score failed; index state not "
                          "advanced (next promote re-plans)",
                          err=str(exc))
            except BaseException as exc:
                # anything else (a device error among them) is not the
                # monitor's to absorb: record it, release the loop and
                # raise it on this thread
                self.last_error = f"{type(exc).__name__}: {exc}"
                _log.error("delta re-score failed", err=self.last_error)
                with self._lock:
                    self._pending = None
                    self._running = False
                raise
            with self._lock:
                if self._pending is None:
                    self._running = False
                    return
                old_digest, db, new_digest, params_changed = \
                    self._pending
                self._pending = None

    def rescore_now(self, old_digest, db, new_digest,
                    params_changed=None):
        """Synchronous re-score (the background loop and tests)."""
        # scan_scope assigns the correlation id the emitted events and
        # this re-score's log lines share (works with tracing off)
        with tracing.scan_scope(force=True), \
                tracing.span("monitor.promote", db=new_digest or ""):
            plan = compute_delta(self.db_path, old_digest, db,
                                 new_digest=new_digest,
                                 params_changed=params_changed)
            engine = self._engine_fn()
            if self._scheduler is not None:
                from trivy_tpu_torch.sched.scheduler import SchedEngine

                # the re-match sweep joins the shared micro-batch
                # stream, interleaving with live scans under the
                # scheduler's fairness rules instead of monopolizing
                # the device
                engine = SchedEngine(engine, self._scheduler)
            return rematch_mod.rescore(engine, self.index, plan,
                                       budget_s=budget_s(),
                                       on_event=self._emit)

    # ----------------------------------------------------------- events

    def _emit(self, ev: dict) -> None:
        with self._lock:
            self._seq += 1
            self._events.append((self._seq, ev))
        _log.info("monitor event", **ev)

    def events_since(self, since: int) -> tuple[int, list[dict]]:
        """-> (next cursor, events with seq > since). The ring is
        bounded: a slow consumer that falls more than EVENT_RING events
        behind misses the overwritten ones (the cursor jump tells it)."""
        with self._lock:
            out = [ev for seq, ev in self._events if seq > since]
            return self._seq, out

    def close(self) -> None:
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=10.0)
        self.index.close()


# ------------------------------------------------------------- CLI loops

def emit_line(fh, doc: dict) -> None:
    fh.write(json.dumps(doc, sort_keys=True) + "\n")
    fh.flush()


def watch_local(db_path: str, index: MonitorIndex, engine_factory,
                out_fh, interval_s: float = 60.0, once: bool = False,
                verify: bool | None = None, stop_event=None) -> int:
    """Poll `db_path` for generation changes; on change, delta-re-score
    the local index and emit events as JSON lines on `out_fh`.

    `engine_factory` is a zero-arg callable returning a freshly built
    MatchEngine over the CURRENT on-disk DB (cli/run.new_engine under
    the parsed args: the match kernel on the card unless --no-tpu),
    closed after its re-score. Returns 0 (loop ended / --once
    complete)."""
    from trivy_tpu_torch.tensorize import cache as compile_cache

    while True:
        digest = compile_cache.db_digest(db_path)
        if digest is not None and digest != index.db_digest:
            with tracing.scan_scope(force=True), \
                    tracing.span("watch.rescore", db=digest):
                engine = engine_factory()
                try:
                    plan = compute_delta(db_path, index.db_digest,
                                         engine.db, new_digest=digest)
                    report = rematch_mod.rescore(
                        engine, index, plan, budget_s=budget_s(),
                        verify=verify,
                        on_event=lambda ev: emit_line(out_fh, ev))
                finally:
                    # a distributed MeshDB's workers end with the
                    # re-score
                    engine.close()
            emit_line(out_fh, {
                "event": "rescore", "db_digest": digest,
                "full": report.full, "reason": report.reason,
                "rematched": report.rematched,
                "indexed": report.total_indexed,
                "introduced": report.introduced,
                "resolved": report.resolved, "shed": report.shed,
                "duration_s": round(report.duration_s, 3),
            })
        if once:
            return 0
        if stop_event is not None and stop_event.wait(interval_s):
            return 0
        if stop_event is None:
            time.sleep(interval_s)


def watch_remote(server: str, out_fh, token: str | None = None,
                 interval_s: float = 2.0, once: bool = False,
                 stop_event=None) -> int:
    """Tail a server's /monitor/events ring, printing each event as a
    JSON line.  Survives server restarts (the cursor resets when the
    server's sequence does)."""
    import urllib.request

    cursor = 0
    base = server.rstrip("/")
    while True:
        url = f"{base}/monitor/events?since={cursor}"
        req = urllib.request.Request(url)
        if token:
            req.add_header("Trivy-Token", token)
        try:
            with urllib.request.urlopen(req, timeout=10.0) as resp:
                doc = json.loads(resp.read())
            nxt = int(doc.get("next", cursor))
            if nxt < cursor:
                cursor = 0  # server restarted; resync from its start
            else:
                cursor = nxt
            for ev in doc.get("events") or []:
                emit_line(out_fh, ev)
        except OSError as exc:
            _log.warn("watch: server unreachable; retrying",
                      server=base, err=str(exc))
        if once:
            return 0
        if stop_event is not None and stop_event.wait(interval_s):
            return 0
        if stop_event is None:
            time.sleep(interval_s)
