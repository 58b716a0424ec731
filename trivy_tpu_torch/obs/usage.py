"""Per-tenant usage metering: who is spending the fleet's seconds,
bytes, and device rows (docs/observability.md "Usage metering").

Every scan accrues a per-request **cost vector** — attribution-lane
busy seconds (the obs.attrib taxonomy), device rows matched, queries
submitted, layers fetched/analyzed/deduped, bytes over the RPC wire
(pre/post gzip, both directions), cache hits/misses, secret MB
screened, queue-wait seconds, and shed outcomes — keyed by a tenant id
derived from the auth token (hashed, never logged raw; requests with
no token land in the ``anonymous`` bucket).

The accrual scope is a contextvar that follows the scan across the
scheduler, fanal pipeline, secret lane, and mesh dispatch exactly the
way tracing capture/adopt does: the RPC server opens a scope per
request, the scheduler captures it per pending request and re-adopts
it around batch dispatch, and the fanal fetch lane adopts it on its
worker thread.  ``add()`` with no ambient scope is a no-op costing one
contextvar read, which is also the whole disabled (TRIVY_TPU_USAGE=0)
fast path — guarded <2% of scan wall by bench.py --usage.

Load-bearing invariant — **conservation**: the per-tenant lane-second
sums equal the fleet attribution totals
(trivy_tpu_attrib_lane_seconds_total{kind="busy"}), because
obs.attrib's aggregator hands every observed root's busy vector to
``add_lanes`` on the same thread that closed the root span; spans that
close outside any request scope (client-side RPCs, background work)
accrue to ``anonymous``, so overload and unattributed work cannot hide
a tenant's demand.  ``snapshot()`` machine-checks the invariant and
/debug/usage serves it.

Aggregates live in a bounded top-N registry (tenants beyond
TRIVY_TPU_USAGE_TOP_N collapse into ``other`` — the same cardinality
policy the tenant spine metrics enforce via ``collapse_label``), are
optionally journaled per interval over durability/appendlog
(torn-tail-tolerant replay, compaction), and are federated across
replicas by fleet.telemetry / the ``trivy-tpu usage`` CLI.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import os
import time

from trivy_tpu_torch.analysis.witness import make_lock
from trivy_tpu_torch.obs import metrics as obs_metrics

# The cost-vector field catalog.  Pure literal: the usage-field lint
# rule parses this registry and cross-checks it against every
# usage.add()/add_to() call site and the docs/observability.md
# "Cost-vector fields" table, so a field cannot be emitted, dropped,
# or documented on its own.
FIELDS = (
    ("scans", "scan RPCs served to completion"),
    ("sheds", "requests shed with 503 (overload, deadline, draining)"),
    ("queries", "rows submitted to the scheduler (match + screen)"),
    ("rows_matched", "device advisory rows matched"),
    ("layers_fetched", "layer blobs fetched by the fanal pipeline"),
    ("layers_analyzed", "layer blobs walked by analyzers"),
    ("layers_deduped", "layer fetches avoided by the dedupe gate"),
    ("bytes_in", "request payload bytes after transport decoding"),
    ("bytes_out", "response payload bytes before transport encoding"),
    ("wire_bytes_in", "request bytes on the wire (post-gzip)"),
    ("wire_bytes_out", "response bytes on the wire (post-gzip)"),
    ("cache_hits", "cache blobs already present at MissingBlobs"),
    ("cache_misses", "cache blobs absent at MissingBlobs (pre-dedupe)"),
    ("secret_mb", "megabytes screened by the secret scanner"),
    ("queue_wait_s", "seconds queued in the scheduler before dispatch"),
    ("lane_s", "attribution-lane busy seconds (conservation field)"),
)

_FIELD_NAMES = frozenset(name for name, _doc in FIELDS)

ANONYMOUS = "anonymous"
OTHER = "other"

_DEF_TOP_N = 64
_DEF_INTERVAL_S = 60.0
_JOURNAL_COMPACT_EVERY = 256

_scope: contextvars.ContextVar["UsageScope | None"] = contextvars.ContextVar(
    "trivy_tpu_usage_scope", default=None)


def enabled() -> bool:
    """TRIVY_TPU_USAGE=0 is the kill switch: no scopes are created, so
    every accrual call short-circuits on the ambient-scope read."""
    return os.environ.get("TRIVY_TPU_USAGE", "") not in ("0", "false")


def top_n() -> int:
    try:
        return max(1, int(os.environ.get("TRIVY_TPU_USAGE_TOP_N", "")
                          or _DEF_TOP_N))
    except ValueError:
        return _DEF_TOP_N


def tenant_id(token: str | None) -> str:
    """Stable tenant key for an auth token: 16 hex chars of SHA-256.
    The raw token is never logged, journaled, or exported — only this
    hash appears in metrics, /debug/usage, and the journal."""
    if not token:
        return ANONYMOUS
    return "t-" + hashlib.sha256(token.encode()).hexdigest()[:16]


class UsageScope:
    """One request's accumulating cost vector.  Thread-safe: the fanal
    fetch lane and scheduler accrue from worker threads while the
    handler thread owns the scope."""

    __slots__ = ("tenant", "fields", "lanes", "_lock")

    def __init__(self, tenant: str):
        self.tenant = tenant
        self.fields: dict[str, float] = {}
        self.lanes: dict[str, float] = {}
        self._lock = make_lock("obs.usage.scope._lock")

    def _add(self, field: str, amount: float) -> None:
        with self._lock:
            self.fields[field] = self.fields.get(field, 0.0) + amount

    def _add_lanes(self, busy: dict) -> None:
        with self._lock:
            for lane, v in busy.items():
                if v > 0:
                    self.lanes[lane] = self.lanes.get(lane, 0.0) + v


# ------------------------------------------------------------ accrual


def ambient() -> UsageScope | None:
    """The scope the current context accrues to (None = unmetered)."""
    return _scope.get()


def add(field: str, amount: float = 1.0) -> None:
    """Accrue `amount` to the ambient scope; no-op (one contextvar
    read) when the context is unmetered or metering is disabled."""
    s = _scope.get()
    if s is None:
        return
    s._add(field, amount)


def add_to(scope: UsageScope | None, field: str, amount: float = 1.0) -> None:
    """Accrue to a captured scope from another thread (the scheduler's
    per-pending queue-wait accounting)."""
    if scope is None:
        return
    scope._add(field, amount)


def add_lanes(busy: dict) -> None:
    """Fold one observed root span's per-lane busy seconds — called by
    obs.attrib on the thread that closed the root, where the request's
    scope is still ambient.  Rootless-context spans accrue straight to
    the ``anonymous`` bucket so conservation holds by construction."""
    if not busy or not enabled():
        return
    s = _scope.get()
    if s is not None:
        s._add_lanes(busy)
        return
    USAGE.fold_lanes(ANONYMOUS, busy)


def capture() -> UsageScope | None:
    """Snapshot the ambient scope for adoption on another thread —
    the usage twin of tracing.capture()."""
    return _scope.get()


@contextlib.contextmanager
def adopt(scope: UsageScope | None):
    """Re-establish a captured scope on the current thread."""
    if scope is None:
        yield
        return
    token = _scope.set(scope)
    try:
        yield
    finally:
        _scope.reset(token)


@contextlib.contextmanager
def scope(tenant: str):
    """Open a request scope for `tenant` (a tenant_id() hash).  On
    exit the accumulated cost vector folds into the process registry
    and the trivy_tpu_tenant_* spine metrics.  A no-op yielding None
    when TRIVY_TPU_USAGE=0."""
    if not enabled():
        yield None
        return
    s = UsageScope(tenant)
    token = _scope.set(s)
    try:
        yield s
    finally:
        _scope.reset(token)
        USAGE.fold(s)


# ----------------------------------------------------------- registry


def _merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        dst[k] = dst.get(k, 0.0) + v


class UsageRegistry:
    """Bounded per-tenant aggregate store.  Beyond top_n() distinct
    tenants new arrivals collapse into ``other`` instead of tripping
    the CardinalityError a public server cannot afford; the tenant
    spine metrics apply the same policy via collapse_label."""

    def __init__(self):
        self._lock = make_lock("obs.usage._lock")
        self._tenants: dict[str, dict] = {}
        self._journal = None
        self._journal_path = None
        self._journal_next_t = 0.0

    # -- folding ----------------------------------------------------

    def _collapse(self, tenant: str) -> str:
        if tenant in self._tenants or tenant == OTHER:
            return tenant
        if len(self._tenants) >= top_n():
            return OTHER
        return tenant

    def fold(self, s: UsageScope) -> None:
        with s._lock:
            fields = dict(s.fields)
            lanes = dict(s.lanes)
        with self._lock:
            tenant = self._collapse(s.tenant)
            rec = self._tenants.setdefault(tenant,
                                           {"fields": {}, "lanes": {}})
            _merge(rec["fields"], fields)
            _merge(rec["lanes"], lanes)
        self._export(tenant, fields, lanes)
        self._journal_tick()

    def fold_lanes(self, tenant: str, busy: dict) -> None:
        lanes = {k: v for k, v in busy.items() if v > 0}
        if not lanes:
            return
        with self._lock:
            tenant = self._collapse(tenant)
            rec = self._tenants.setdefault(tenant,
                                           {"fields": {}, "lanes": {}})
            _merge(rec["lanes"], lanes)
        self._export(tenant, {}, lanes)
        self._journal_tick()

    def _export(self, tenant: str, fields: dict, lanes: dict) -> None:
        """Mirror a fold into the trivy_tpu_tenant_* spine metrics
        (outside self._lock: the metrics registry has its own)."""
        m = obs_metrics
        if fields.get("scans"):
            m.TENANT_SCANS.inc(fields["scans"], tenant=tenant)
        if fields.get("sheds"):
            m.TENANT_SHEDS.inc(fields["sheds"], tenant=tenant)
        if fields.get("queries"):
            m.TENANT_QUERIES.inc(fields["queries"], tenant=tenant)
        if fields.get("rows_matched"):
            m.TENANT_ROWS_MATCHED.inc(fields["rows_matched"],
                                      tenant=tenant)
        if fields.get("wire_bytes_in"):
            m.TENANT_WIRE_BYTES.inc(fields["wire_bytes_in"],
                                    tenant=tenant, direction="in")
        if fields.get("wire_bytes_out"):
            m.TENANT_WIRE_BYTES.inc(fields["wire_bytes_out"],
                                    tenant=tenant, direction="out")
        for lane, v in lanes.items():
            m.TENANT_LANE_SECONDS.inc(v, tenant=tenant, lane=lane)

    # -- snapshot / conservation ------------------------------------

    def snapshot(self) -> dict:
        """Per-tenant table + fleet totals + the machine-checked
        conservation comparison against the attribution spine."""
        with self._lock:
            tenants = {t: {"fields": dict(r["fields"]),
                           "lanes": dict(r["lanes"])}
                       for t, r in self._tenants.items()}
        totals = {"fields": {}, "lanes": {}}
        for rec in tenants.values():
            _merge(totals["fields"], rec["fields"])
            _merge(totals["lanes"], rec["lanes"])
        from trivy_tpu_torch.obs import attrib  # import cycle: attrib -> usage
        lane_busy = {}
        for lane in attrib.LANES:
            v = obs_metrics.ATTRIB_LANE_SECONDS.value(lane=lane,
                                                      kind="busy")
            if v:
                lane_busy[lane] = v
        tenant_lane_s = sum(totals["lanes"].values())
        attrib_lane_s = sum(lane_busy.values())
        diff = abs(tenant_lane_s - attrib_lane_s)
        tol = 1e-6 + 1e-9 * max(tenant_lane_s, attrib_lane_s)
        return {
            "enabled": enabled(),
            "top_n": top_n(),
            "tenants": tenants,
            "totals": totals,
            "conservation": {
                "tenant_lane_s": tenant_lane_s,
                "attrib_lane_s": attrib_lane_s,
                "attrib_lanes": lane_busy,
                "diff_s": diff,
                "ok": diff <= tol,
            },
        }

    def reset(self) -> None:
        with self._lock:
            self._tenants.clear()

    # -- journal ----------------------------------------------------

    def _journal_interval(self) -> float:
        try:
            return float(os.environ.get("TRIVY_TPU_USAGE_INTERVAL_S", "")
                         or _DEF_INTERVAL_S)
        except ValueError:
            return _DEF_INTERVAL_S

    def _journal_open(self, path: str):
        from trivy_tpu_torch.durability.appendlog import AppendLog, AppendLogError
        header = {"log": "usage-journal", "version": 1}
        try:
            if os.path.exists(path):
                log, records = AppendLog.replay(path)
                self._adopt_journal_records(records)
                return log
            return AppendLog.create(path, header)
        except AppendLogError:
            try:
                log, records = AppendLog.salvage(path, header)
                self._adopt_journal_records(records)
                return log
            except AppendLogError:
                return None

    def _adopt_journal_records(self, records: list[dict]) -> None:
        """Journal records are cumulative snapshots: the last durable
        one wins (torn tails were already truncated by replay).
        Caller holds self._lock (_journal_open runs under the
        _journal_tick lock; the lock is not re-entrant)."""
        last = None
        for rec in records:
            if rec.get("kind") == "usage":
                last = rec
        if last is None:
            return
        for t, r in (last.get("tenants") or {}).items():
            slot = self._tenants.setdefault(
                t, {"fields": {}, "lanes": {}})
            _merge(slot["fields"], r.get("fields") or {})
            _merge(slot["lanes"], r.get("lanes") or {})

    def _journal_tick(self) -> None:
        path = os.environ.get("TRIVY_TPU_USAGE_JOURNAL", "")
        if not path:
            return
        now = time.monotonic()
        with self._lock:
            if path != self._journal_path:
                self._journal_path = path
                self._journal = self._journal_open(path)
                self._journal_next_t = 0.0
            if self._journal is None or now < self._journal_next_t:
                return
            self._journal_next_t = now + self._journal_interval()
            rec = {"kind": "usage",
                   "tenants": {t: {"fields": dict(r["fields"]),
                                   "lanes": dict(r["lanes"])}
                               for t, r in self._tenants.items()}}
            journal = self._journal
        from trivy_tpu_torch.durability.appendlog import AppendLogError
        try:
            journal.append(rec)
            if journal.records_written > _JOURNAL_COMPACT_EVERY:
                journal.rewrite([rec])
        except AppendLogError:
            pass  # journaling is best-effort; metering must not fail scans

    def journal_sync(self) -> None:
        """Force a journal snapshot now (shutdown hook / tests)."""
        with self._lock:
            self._journal_next_t = 0.0
        self._journal_tick()

    def journal_close(self) -> None:
        with self._lock:
            if self._journal is not None:
                self._journal.close()
            self._journal = None
            self._journal_path = None


def replay_journal(path: str) -> dict:
    """Load the last durable usage snapshot from a journal file —
    the `trivy-tpu usage --journal PATH` data source."""
    from trivy_tpu_torch.durability.appendlog import AppendLog
    log, records = AppendLog.replay(path)
    log.close()
    last: dict = {"kind": "usage", "tenants": {}}
    for rec in records:
        if rec.get("kind") == "usage":
            last = rec
    return {"tenants": last.get("tenants") or {}}


USAGE = UsageRegistry()
