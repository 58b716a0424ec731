"""Fleet ops event bus, durable event journal, and SLO burn-rate
engine (docs/fleet.md "Fleet observability control plane").

Fleet-level operations — hedge races, failovers, breaker trips,
rollout stages, DB swaps, shard degradations, replica skew — used to
leave no queryable record: each was a log line at best. This module
gives them one spine:

- **EVENTS registry** — the closed vocabulary of fleet event kinds.
  The ``event-kind`` lint rule (docs/static-analysis.md) enforces, in
  both directions, that every kind emitted in code is declared here
  and documented in docs/fleet.md's event catalog.
- **event bus** — :func:`emit_event` validates the kind, stamps a
  wall-clock timestamp + monotone sequence number, counts it in
  ``trivy_tpu_fleet_events_total{kind}``, keeps it in a bounded
  in-memory ring (``events_since`` — the ``/events`` tail), and, when
  a journal is installed, appends it durably.
  ``TRIVY_TPU_FLEET_EVENTS=0`` is the kill switch: emission collapses
  to one env check (guarded <2% by bench_fleetobs).
- **OpsEventLog** — the fsynced JSONL journal over
  ``durability/appendlog.py``: durable-when-returned appends, replay
  that tolerates a torn tail (the signature crash artifact), so a
  controller restart replays the fleet's operational history intact.
- **SLOEngine** — multi-window burn-rate alerting over
  availability/latency SLIs: a request is *good* when it succeeded
  (and, when a latency SLO is set, answered under the threshold);
  burn rate = error_rate / (1 - target). An alert fires when BOTH the
  long and the short window of any configured pair exceed the pair's
  factor (the short window makes firing fast, the long window keeps
  it spike-proof), journals ``slo_burn state=firing``, and resolves —
  journaled again — once every long window is back under.
- **SkewDetector** — cross-replica consistency watch: mixed advisory
  generations among ready replicas ("Vexed by VEX"'s failure class),
  probe-latency outliers vs the fleet median, and per-replica mesh
  shard degradations, each emitted on the *transition*, not per probe.

Copy of trivy_tpu/fleet/slo.py: the same closed EVENTS vocabulary,
journal header and record shapes, so either package's `fleet events`
reads the other's journal.
"""

from __future__ import annotations

import json
import os

from trivy_tpu_torch.analysis.witness import make_lock
import time
from collections import deque

from trivy_tpu_torch.durability.appendlog import AppendLog, AppendLogError
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs import metrics as obs_metrics

_log = logger("fleet.slo")

# ------------------------------------------------------ event registry

#: The closed fleet event vocabulary: (kind, what one record means).
#: Machine-checked three ways by the ``event-kind`` lint rule — every
#: kind emitted in code is declared here, every declared kind is
#: emitted somewhere, and docs/fleet.md's event catalog lists exactly
#: this set.
EVENTS: tuple[tuple[str, str], ...] = (
    ("failover", "a request was retried on a different replica after "
     "a transport-level failure on its first choice"),
    ("hedge", "a hedged dispatch resolved (outcome=won/lost/denied)"),
    ("breaker", "a per-replica circuit breaker changed state "
     "(closed/half-open/open)"),
    ("probe_health", "a replica's /readyz health verdict flipped "
     "(healthy=true/false) as seen by the background prober"),
    ("shard_degraded", "a replica reported mesh shard(s) degraded to "
     "the host oracle (or recovered)"),
    ("replica_skew", "cross-replica inconsistency: mixed advisory-DB "
     "generations among ready replicas, or a probe-latency outlier "
     "vs the fleet median"),
    ("rollout_stage", "one stage of a coordinated advisory-DB rollout "
     "finished (ok=true/false)"),
    ("db_swap", "a replica hot-swapped its advisory DB during a "
     "coordinated rollout (serving=<generation>)"),
    ("slo_burn", "a multi-window burn-rate alert changed state "
     "(state=firing/resolved) over the fleet SLIs"),
    ("controller_action", "the fleet controller decided (and, unless "
     "dry-run/dropped, performed) one action from the "
     "fleet.controller.ACTIONS vocabulary (action=<kind>, "
     "outcome=applied/dry_run/reconciled/dropped)"),
)

KINDS = frozenset(k for k, _ in EVENTS)

_RING_N = 1024

_bus_lock = make_lock("fleet.slo._bus_lock")
_ring: deque = deque(maxlen=_RING_N)
_seq = 0
_journal: "OpsEventLog | None" = None
_env_journal_checked = False


def events_enabled() -> bool:
    """The ``TRIVY_TPU_FLEET_EVENTS`` kill switch (default on): 0
    restores the pre-feature path — no ring, no journal, no counter."""
    return os.environ.get("TRIVY_TPU_FLEET_EVENTS", "1") != "0"


def _maybe_env_journal_locked() -> None:
    """The bus is PROCESS-LOCAL: a journal installed in the controller
    (``fleet serve``/``rollout --journal``) cannot see the scan
    client's failover/hedge/breaker events. ``TRIVY_TPU_FLEET_EVENTS_
    JOURNAL`` closes that gap — any process (the smart client
    included) lazily installs a journal at that path on its first
    emit. Use one path per process: concurrent writers interleave."""
    global _env_journal_checked, _journal
    if _env_journal_checked or _journal is not None:
        return
    _env_journal_checked = True
    path = os.environ.get("TRIVY_TPU_FLEET_EVENTS_JOURNAL", "")
    if not path:
        return
    global _seq
    try:
        _journal, past = OpsEventLog.open(path)
        top = max((int(d.get("seq", 0)) for d in past), default=0)
        if top > _seq:
            _seq = top  # resume past the replay, like install_journal
    except (AppendLogError, OSError) as exc:
        _log.warn("TRIVY_TPU_FLEET_EVENTS_JOURNAL unusable; events "
                  "stay in-memory", path=path, err=str(exc))


def emit_event(kind: str, **fields) -> dict | None:
    """Publish one fleet ops event. Validates the kind against the
    EVENTS registry (an unknown kind is a programming error, caught by
    the event-kind lint rule before it ever fires here), stamps
    ``ts``/``seq``, counts it, rings it, and — when a journal is
    installed — appends it durably. Returns the event document, or
    None under the kill switch."""
    if not events_enabled():
        return None
    if kind not in KINDS:
        raise ValueError(
            f"unknown fleet event kind {kind!r} — declare it in "
            "fleet.slo.EVENTS (and docs/fleet.md's event catalog)")
    global _seq
    doc = {"kind": kind, "ts": round(time.time(), 3), **fields}
    with _bus_lock:
        _maybe_env_journal_locked()
        _seq += 1
        doc["seq"] = _seq
        _ring.append(doc)
        journal = _journal
        if journal is not None:
            try:
                journal.append(doc)
            except AppendLogError as exc:
                # a failed journal append must never break the serving
                # path that emitted the event; the ring still has it
                _log.warn("fleet event journal append failed",
                          kind=kind, err=str(exc))
    obs_metrics.FLEET_EVENTS.inc(kind=kind)
    return doc


def events_since(seq: int) -> tuple[int, list[dict]]:
    """Ring tail: events with a sequence number > ``seq`` (oldest
    first) and the cursor to pass next time — the same contract as the
    monitor's /monitor/events ring."""
    with _bus_lock:
        out = [dict(d) for d in _ring if d.get("seq", 0) > seq]
        return _seq, out


def install_journal(path: str) -> list[dict]:
    """Make the bus durable: every future emit appends (fsynced) to
    the ops journal at ``path``. An existing journal is replayed first
    — torn tail truncated, mid-file rot skipped — and its surviving
    records are returned, so a restarted controller sees the fleet's
    operational history; the bus sequence resumes past the replay."""
    global _journal, _seq
    log, past = OpsEventLog.open(path)
    with _bus_lock:
        if _journal is not None:
            _journal.close()
        _journal = log
        top = max((int(d.get("seq", 0)) for d in past), default=0)
        if top > _seq:
            _seq = top
    return past


def uninstall_journal() -> None:
    global _journal
    with _bus_lock:
        if _journal is not None:
            _journal.close()
        _journal = None


def reset_bus() -> None:
    """Test hook: drop the ring and detach any journal."""
    global _seq, _env_journal_checked
    uninstall_journal()
    with _bus_lock:
        _ring.clear()
        _seq = 0
        _env_journal_checked = False


# ----------------------------------------------------- durable journal


class OpsEventLog:
    """The fleet ops journal: an fsynced JSONL append log whose records
    are event documents. Same durability contract as the scan journal
    (docs/durability.md): ``append`` returns only after the record hit
    the disk; ``open`` replays, truncating a torn tail."""

    HEADER = {"log": "fleet-events", "v": 1}

    def __init__(self, log: AppendLog):
        self._log = log

    @classmethod
    def open(cls, path: str) -> tuple["OpsEventLog", list[dict]]:
        """-> (journal ready for appends, replayed past events)."""
        if os.path.exists(path):
            try:
                log, past = AppendLog.replay(path)
                return cls(log), past
            except AppendLogError as exc:
                # unreadable/headerless: quarantine-by-rename would hide
                # evidence; refuse and let the operator choose a path
                raise AppendLogError(
                    f"fleet event journal {path} unusable: {exc}")
        return cls(AppendLog.create(path, dict(cls.HEADER))), []

    @staticmethod
    def read(path: str) -> list[dict]:
        """Read-only replay (the ``fleet events`` CLI): surviving
        event records, torn tail tolerated, file left untouched."""
        log, past = AppendLog.replay(path)
        log.close()
        return past

    def append(self, doc: dict) -> None:
        self._log.append(doc)

    def compact(self, keep_last: int = 512) -> list[dict]:
        """Rotate the journal in place: atomically rewrite it as
        header + the newest ``keep_last`` events (a crash mid-compact
        leaves the previous journal intact). Returns the kept events.
        Followers detect the rewrite (new inode / shrunk size) and
        resume from the sealed replay point — :class:`JournalTail`."""
        past = self.read(self.path)
        keep = past[-keep_last:] if keep_last >= 0 else past
        self._log.rewrite(keep)
        return keep

    def close(self) -> None:
        self._log.close()

    @property
    def path(self) -> str:
        return self._log.path


class JournalTail:
    """Incremental, rotation-proof follower for an ops journal — what
    ``trivy-tpu fleet events --follow`` runs on.

    Each :meth:`poll` parses only the bytes appended since the last
    one (no O(file) re-replay per second) and returns the events whose
    ``seq`` is beyond the last one delivered. When the journal is
    compacted or rotated underneath the tail — the file shrinks below
    the parse offset, or the path resolves to a new inode after an
    atomic rewrite — the stale fd is dropped, the sealed journal is
    replayed from its start, and delivery resumes from the sealed
    replay point: the ``seq`` cursor, which survives rotation because
    the bus sequence is monotone across compactions. A torn tail (a
    partially-appended record) is left buffered until the writer
    completes it, never delivered as garbage."""

    def __init__(self, path: str, since: int = 0):
        self._path = path
        self._fd = None
        self._ino = -1
        self._offset = 0
        self._buf = b""
        self.last_seq = int(since)

    def _drop_fd(self) -> None:
        if self._fd is not None:
            try:
                self._fd.close()
            except OSError:
                pass
        self._fd = None
        self._ino = -1
        self._offset = 0
        self._buf = b""

    def _ensure_fd(self) -> bool:
        """(Re)open the journal when absent, rotated (new inode), or
        truncated (compaction rewrote it shorter than our offset)."""
        try:
            st = os.stat(self._path)
        except OSError:
            self._drop_fd()
            return False
        if self._fd is not None and st.st_ino == self._ino \
                and st.st_size >= self._offset:
            return True
        rotated = self._fd is not None
        self._drop_fd()
        try:
            self._fd = open(self._path, "rb")
            self._ino = os.fstat(self._fd.fileno()).st_ino
        except OSError:
            self._drop_fd()
            return False
        if rotated:
            _log.debug("ops journal rotated; resuming from the "
                       "sealed replay point", path=self._path,
                       since=self.last_seq)
        return True

    def poll(self) -> list[dict]:
        """New events (``seq`` beyond the last delivered), oldest
        first. Empty when nothing new, the journal is missing, or only
        a torn tail arrived."""
        if not self._ensure_fd():
            return []
        self._fd.seek(self._offset)
        chunk = self._fd.read()
        self._offset += len(chunk)
        self._buf += chunk
        complete, nl, rest = self._buf.rpartition(b"\n")
        if not nl:
            return []  # torn tail only; wait for the writer
        self._buf = rest
        out = []
        for line in complete.split(b"\n"):
            if not line.strip():
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                continue  # mid-file rot: replay-equivalent skip
            if not isinstance(doc, dict) or doc.get("kind") == "header":
                continue
            seq = int(doc.get("seq", 0))
            if seq > self.last_seq:
                self.last_seq = max(self.last_seq, seq)
                out.append(doc)
        return out

    def close(self) -> None:
        self._drop_fd()


# --------------------------------------------------------- SLO engine

DEFAULT_SLO_TARGET = 0.999

#: (long window s, short window s, burn-rate factor) pairs — the
#: classic multiwindow shape: the short window makes the alert fire
#: fast, the long window keeps one spike from paging.
DEFAULT_WINDOWS: tuple[tuple[float, float, float], ...] = (
    (300.0, 60.0, 14.4),
    (3600.0, 300.0, 6.0),
)


def slo_target() -> float:
    """Availability SLO target (``TRIVY_TPU_FLEET_SLO_TARGET``,
    default 0.999). Clamped to (0, 1)."""
    raw = os.environ.get("TRIVY_TPU_FLEET_SLO_TARGET", "")
    if raw:
        try:
            v = float(raw)
            if 0.0 < v < 1.0:
                return v
        except ValueError:
            pass
        _log.warn("malformed TRIVY_TPU_FLEET_SLO_TARGET; using default",
                  value=raw)
    return DEFAULT_SLO_TARGET


def slo_latency_s() -> float | None:
    """Latency SLI threshold in seconds
    (``TRIVY_TPU_FLEET_SLO_LATENCY_MS``; unset = availability-only: a
    slow-but-correct answer still counts as good)."""
    raw = os.environ.get("TRIVY_TPU_FLEET_SLO_LATENCY_MS", "")
    if not raw:
        return None
    try:
        return max(float(raw), 0.0) / 1000.0
    except ValueError:
        _log.warn("malformed TRIVY_TPU_FLEET_SLO_LATENCY_MS; ignoring",
                  value=raw)
        return None


class SLOEngine:
    """Multi-window burn-rate evaluation over a stream of good/bad
    samples, bucketed per second.

    burn = (bad / total) / (1 - target); an alert FIRES when any
    configured (long, short, factor) pair has both windows' burn at or
    above the factor, and RESOLVES once every long window is back
    under its factor. Both transitions are emitted (and journaled) as
    ``slo_burn`` events. ``clock`` is injectable for deterministic
    tests; production uses the monotonic clock so an NTP step cannot
    shift a window."""

    def __init__(self, target: float | None = None,
                 latency_s: float | None = None,
                 windows=DEFAULT_WINDOWS,
                 name: str = "fleet-availability",
                 clock=time.monotonic):
        self.target = slo_target() if target is None else float(target)
        self.latency_s = (slo_latency_s() if latency_s is None
                          else latency_s)
        self.windows = tuple(windows)
        self.name = name
        self._clock = clock
        self._lock = make_lock("fleet.slo.SLOEngine._lock")
        self._buckets: deque = deque()  # (second:int, good:int, bad:int)
        self._max_window = max(w[0] for w in self.windows)
        self.firing = False

    # ------------------------------------------------------- recording

    def record(self, ok: bool, latency_s: float | None = None,
               now: float | None = None) -> None:
        """One request outcome. With a latency SLO configured, a
        successful-but-slow answer counts as bad (it burned budget)."""
        good = bool(ok)
        if good and self.latency_s is not None \
                and latency_s is not None and latency_s > self.latency_s:
            good = False
        self.record_counts(1 if good else 0, 0 if good else 1, now=now)

    def record_counts(self, good: int, bad: int,
                      now: float | None = None) -> None:
        """Fold pre-aggregated counts in (the fleet monitor records
        federated counter deltas this way)."""
        if good <= 0 and bad <= 0:
            return
        sec = int(self._clock() if now is None else now)
        with self._lock:
            if self._buckets and self._buckets[-1][0] == sec:
                s, g, b = self._buckets[-1]
                self._buckets[-1] = (s, g + good, b + bad)
            else:
                self._buckets.append((sec, good, bad))
            horizon = sec - self._max_window - 1
            while self._buckets and self._buckets[0][0] < horizon:
                self._buckets.popleft()

    # ------------------------------------------------------ evaluation

    def _window_burn(self, window_s: float, now: float) -> float:
        lo = now - window_s
        good = bad = 0
        for sec, g, b in self._buckets:
            if sec >= lo:
                good += g
                bad += b
        total = good + bad
        if total == 0:
            return 0.0
        budget = max(1.0 - self.target, 1e-9)
        return (bad / total) / budget

    def evaluate(self, now: float | None = None) -> dict:
        """Evaluate every window pair; emit ``slo_burn`` on a firing or
        resolving transition. Returns the current state document (also
        what the federation /profile endpoint embeds)."""
        now = self._clock() if now is None else now
        burns = []
        fired_by = None
        with self._lock:
            for long_s, short_s, factor in self.windows:
                lb = self._window_burn(long_s, now)
                sb = self._window_burn(short_s, now)
                burns.append({"long_s": long_s, "short_s": short_s,
                              "factor": factor,
                              "long_burn": round(lb, 2),
                              "short_burn": round(sb, 2)})
                if lb >= factor and sb >= factor and fired_by is None:
                    fired_by = burns[-1]
            calm = all(b["long_burn"] < b["factor"] for b in burns)
            was_firing = self.firing
            if fired_by is not None and not was_firing:
                self.firing = True
            elif was_firing and calm:
                self.firing = False
            transition = self.firing != was_firing
        if transition:
            if self.firing:
                emit_event("slo_burn", state="firing", slo=self.name,
                           target=self.target, window=fired_by)
            else:
                emit_event("slo_burn", state="resolved", slo=self.name,
                           target=self.target)
        return {"slo": self.name, "target": self.target,
                "firing": self.firing, "windows": burns}


# ------------------------------------------------------- skew detector


class SkewDetector:
    """Cross-replica consistency watch over health-probe results.
    Stateful on purpose: every condition is emitted when it appears
    and when it clears, never once per probe pass."""

    #: probe latency is an outlier when it exceeds the fleet median by
    #: this factor AND the absolute floor (tiny medians would otherwise
    #: flag scheduler noise)
    OUTLIER_FACTOR = 4.0
    OUTLIER_FLOOR_S = 0.05

    def __init__(self):
        self._mixed: str = ""            # last mixed-generation signature
        self._outliers: set = set()      # endpoints currently flagged
        self._degraded: dict = {}        # endpoint -> degraded shard sig

    def observe(self, statuses: list[dict]) -> None:
        """One probe pass over the fleet. Each status document:
        ``{"endpoint", "ready", "generation", "mesh", "probe_s"}`` —
        what ``EndpointSet.probe_health`` / ``fleet_status`` collect."""
        self._check_generations(statuses)
        self._check_latency(statuses)
        self._check_shards(statuses)

    def _check_generations(self, statuses: list[dict]) -> None:
        by_gen: dict[str, list[str]] = {}
        for s in statuses:
            if s.get("ready") and s.get("generation"):
                by_gen.setdefault(s["generation"], []).append(
                    s.get("endpoint", "?"))
        sig = ""
        if len(by_gen) > 1:
            sig = ";".join(f"{g}={','.join(sorted(eps))}"
                           for g, eps in sorted(by_gen.items()))
        if sig and sig != self._mixed:
            emit_event("replica_skew", reason="generation_mismatch",
                       generations={g: sorted(eps)
                                    for g, eps in by_gen.items()})
        elif not sig and self._mixed:
            emit_event("replica_skew", reason="generation_converged")
        self._mixed = sig

    def _check_latency(self, statuses: list[dict]) -> None:
        lats = sorted(s["probe_s"] for s in statuses
                      if s.get("probe_s") is not None)
        if len(lats) < 3:
            return  # a median of two is just the other replica
        median = lats[len(lats) // 2]
        threshold = max(median * self.OUTLIER_FACTOR,
                        self.OUTLIER_FLOOR_S)
        for s in statuses:
            ep = s.get("endpoint", "?")
            lat = s.get("probe_s")
            if lat is None:
                continue
            if lat > threshold and ep not in self._outliers:
                self._outliers.add(ep)
                emit_event("replica_skew", reason="latency_outlier",
                           endpoint=ep, probe_s=round(lat, 4),
                           fleet_median_s=round(median, 4))
            elif lat <= threshold and ep in self._outliers:
                self._outliers.discard(ep)
                emit_event("replica_skew", reason="latency_recovered",
                           endpoint=ep, probe_s=round(lat, 4))

    def _check_shards(self, statuses: list[dict]) -> None:
        for s in statuses:
            ep = s.get("endpoint", "?")
            mesh = s.get("mesh") or {}
            degraded = sorted(mesh.get("degraded") or ())
            # distributed MeshDB: a degraded peer HOST (its whole
            # advisory slice on the coordinator's host mask) is the
            # same ladder one level up — fold it into the transition
            # signature so host losses fire exactly once, like shards
            dhosts = sorted(mesh.get("degraded_hosts") or ())
            sig = ",".join(str(d) for d in degraded)
            if dhosts:
                sig += "|hosts:" + ",".join(str(h) for h in dhosts)
            prev = self._degraded.get(ep, "")
            if sig != prev:
                emit_event("shard_degraded", endpoint=ep,
                           shards=degraded, hosts=dhosts,
                           recovered=not sig)
                if sig:
                    self._degraded[ep] = sig
                else:
                    self._degraded.pop(ep, None)
