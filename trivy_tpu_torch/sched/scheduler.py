"""Cross-request continuous batching for the scan server
(docs/performance.md "Serving: continuous batching").

Before this module, N concurrent scan RPCs ran N private
``engine.detect`` calls: N small, contending device dispatches instead
of one saturated batch — the exact problem continuous/dynamic batching
solves in inference serving. The ``MatchScheduler`` closes that gap:
the detect phase of every in-flight request submits its ``PkgQuery``
list here; submissions are coalesced under a size/latency window
(target rows + max coalesce wait), dispatched through the engine's
pipelined executor as ONE shared micro-batch, and the per-query
results are demultiplexed back to each waiting request.

Guarantees:

- **Zero diff.** Results for any interleaving are byte-identical to
  sequential per-request scans: the engine's detect path is exact and
  deterministic per query (memo-generation handling makes the shared
  engine safe under concurrency), and the scheduler only regroups
  queries — it never reorders results within a request.
- **Fairness.** Each request's rows are dispatched in
  ``chunk_rows``-sized chunks, interleaved round-robin across waiting
  requests in oldest-deadline-first order, so one 200k-package image
  cannot starve ten 50-package images queued behind it.
- **Per-tenant QoS.** The interleave is additionally weighted
  fair-share across TENANTS (the usage tenant id, obs/usage.py): a deficit
  round-robin banks ``TRIVY_TPU_QOS_WEIGHTS`` quanta per tenant per
  round and emits one chunk per whole quantum, so a greedy tenant's
  crawler shares every micro-batch with interactive tenants at its
  weight's share, not its request count's. Per-tenant queue-depth
  caps (``TRIVY_TPU_QOS_TENANT_QUEUE``) shed a tenant that tries to
  buy the whole queue, folded into the usual shed accounting (the
  server replies 503 under the tenant's usage scope, so the
  ``trivy_tpu_tenant_*`` sheds field picks it up). With a single
  tenant (or ``TRIVY_TPU_QOS=0``) the emitted chunk sequence is
  EXACTLY the historical request-level round-robin, and any
  interleaving is zero-diff by the compose-determinism argument
  above.
- **Deadlines.** A request whose ambient ``X-Trivy-Deadline`` budget
  expires while (partly) queued is shed with ``Overloaded`` (503 +
  Retry-After upstream) and counted via ``on_shed`` — never silently
  dropped. Rows already in flight are awaited (the batch is running).
- **Admission control.** A bounded submission queue: past
  ``max_queue`` waiting requests new submissions shed immediately.
- **Observability.** ``trivy_tpu_sched_batch_rows`` /
  ``_coalesced_requests`` / ``_queue_depth`` / ``_wait_seconds``
  metrics, plus ``sched.enqueue`` (in the request's own trace) and
  ``sched.batch`` spans (attached to the oldest coalesced request's
  trace, so batch timing keeps request parentage across the scheduler
  thread); ``stats``: batches, rows, the largest number of requests
  one batch coalesced, and sheds, since start.
- **Fault site.** ``sched.submit``: ``delay`` stalls the submission,
  ``drop`` bypasses the scheduler for that submission (direct
  per-request detect — degraded coalescing, identical bytes),
  ``error`` sheds it with ``Overloaded``.

``TRIVY_TPU_SCHED=0`` kills the scheduler process-wide: the server
runs the exact pre-scheduler per-request path.

The machinery is lane-generic: queries are opaque to the scheduler, so
the secret engine reuses it verbatim (``lane="secret"``) with 16 KiB
anchor-screen chunks as rows and a ``_ScreenEngine`` facade as the
engine — concurrent scans' secret screens coalesce into shared packed
super-buffer dispatches. ``submit_async``/``collect`` split the
blocking ``submit`` so dispatch-first callers (the hybrid secret split,
streaming steps) can enqueue, do host work, then block.

The secret lane reports under ``trivy_tpu_secret_sched_*`` instead of
the match-lane histograms.

Copy of trivy_tpu/sched/scheduler.py; the port keeps a ``stats`` dict
beside the metric handles. ``_mesh_fill`` reads the port's
``ops.match._bucket`` and tops batches up at a data axis above 1
(ops/mesh.py). The bulk entry point
(``submit_lists``, ``SchedEngine.submit``) carries the monitor's delta
re-scoring on a server (trivy_tpu_torch/monitor).
"""

from __future__ import annotations

import os
import threading
import time

from trivy_tpu_torch.analysis.witness import make_lock
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import tracing
from trivy_tpu_torch.obs import usage
from trivy_tpu_torch.resilience import faults
from trivy_tpu_torch.resilience.retry import current_deadline

_log = logger("sched")

ENV_KILL = "TRIVY_TPU_SCHED"
ENV_QOS = "TRIVY_TPU_QOS"
ENV_QOS_TENANT_QUEUE = "TRIVY_TPU_QOS_TENANT_QUEUE"
ENV_QOS_WEIGHTS = "TRIVY_TPU_QOS_WEIGHTS"

DEFAULT_WINDOW_MS = 3.0
DEFAULT_MAX_ROWS = 65536
DEFAULT_MAX_QUEUE = 256
# micro-batches concurrently in flight: >1 lets the next batch encode
# and dispatch while the previous one's device round-trip (or
# GIL-dropping crunch) is still running — the continuous-batching
# analogue of pipeline depth
DEFAULT_DEPTH = 2


def enabled() -> bool:
    """TRIVY_TPU_SCHED=0 is the kill switch: scans run the exact
    per-request ``engine.detect`` path with no scheduler thread."""
    return os.environ.get(ENV_KILL, "1") != "0"


def qos_enabled() -> bool:
    """TRIVY_TPU_QOS=0 restores the pure request-level round-robin
    compose (no tenant grouping, no per-tenant queue caps)."""
    return os.environ.get(ENV_QOS, "1") != "0"


def _qos_weights() -> dict[str, float]:
    """TRIVY_TPU_QOS_WEIGHTS="<tenant>=<w>,..." — fair-share weights
    keyed by the usage tenant id (``*`` sets the default, 1.0
    otherwise). Malformed entries are ignored (an operator typo must
    not take the scheduler down)."""
    out: dict[str, float] = {}
    for part in os.environ.get(ENV_QOS_WEIGHTS, "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        tenant, _eq, w = part.partition("=")
        try:
            val = float(w)
        except ValueError:
            continue
        if val > 0:
            out[tenant.strip()] = val
    return out


def _qos_tenant_queue(max_queue: int) -> int:
    """Per-tenant waiting-request cap; 0/unset = the global
    ``max_queue`` (no separate per-tenant bound)."""
    try:
        n = int(os.environ.get(ENV_QOS_TENANT_QUEUE, "") or 0)
    except ValueError:
        n = 0
    return n if n > 0 else max_queue


class Overloaded(Exception):
    """The server sheds this request instead of blocking (503).

    Defined here (not in rpc/server) so the scheduler can shed without
    importing the HTTP layer; ``trivy_tpu_torch.rpc.server`` re-exports
    it."""

    def __init__(self, msg: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = retry_after


class _Pending:
    """One submitted request: queries, chunk cursor, result slots."""

    __slots__ = ("queries", "results", "next_row", "inflight", "deadline",
                 "arrival", "seq", "trace_ctx", "usage_ctx", "error",
                 "done", "dispatched_at", "tenant")

    def __init__(self, queries: list, deadline, seq: int):
        self.queries = queries
        self.results: list = [None] * len(queries)
        self.next_row = 0       # first row not yet dispatched
        self.inflight = 0       # chunks dispatched, results pending
        self.deadline = deadline
        self.arrival = time.monotonic()
        self.seq = seq
        # captured so the batch span in the scheduler thread can attach
        # to this request's trace instead of becoming an orphaned root
        self.trace_ctx = tracing.capture()
        # usage twin: queue-wait seconds accrue per pending request
        # from the scheduler thread, and the batch dispatch re-adopts
        # the lead request's tenant scope (obs/usage.py)
        self.usage_ctx = usage.capture()
        # QoS key: the submitting request's usage tenant (the hashed
        # token the server's handler scope carries); scope-less
        # submissions share the anonymous bucket
        self.tenant = (self.usage_ctx.tenant
                       if self.usage_ctx is not None else usage.ANONYMOUS)
        self.error: Exception | None = None
        self.done = threading.Event()
        self.dispatched_at: float | None = None

    @property
    def queued_rows(self) -> int:
        return len(self.queries) - self.next_row

    def sort_key(self) -> tuple:
        """Oldest-deadline-first, then submission order."""
        d = self.deadline
        rem = d.remaining() if d is not None else float("inf")
        return (rem, self.seq)


class MatchScheduler:
    """Coalesces concurrent detect-phase submissions into shared device
    micro-batches (class docstring above; knobs: ``--sched-window-ms``,
    ``--sched-max-rows``).

    `engine_fn` is a zero-arg callable returning the CURRENT engine —
    the server's advisory-DB hot swap replaces the engine object, and
    in-flight requests hold the service read lock, so reading it at
    dispatch time is always consistent."""

    def __init__(self, engine_fn, window_ms: float = DEFAULT_WINDOW_MS,
                 max_rows: int = DEFAULT_MAX_ROWS,
                 max_queue: int = DEFAULT_MAX_QUEUE,
                 chunk_rows: int | None = None,
                 depth: int = DEFAULT_DEPTH, on_shed=None,
                 busy_fn=None, data_axis_fn=None, row_floor_fn=None,
                 lane: str = "match"):
        self._engine_fn = engine_fn
        # "match" (rows: package queries) or "secret" (rows: 16 KiB
        # anchor-screen chunks); names the thread
        self.lane = lane
        # metric handles per lane: the vuln-match lane keeps the
        # historical trivy_tpu_sched_* series byte-stable; the secret
        # anchor-screen lane (rows = 16 KiB device chunks, a different
        # unit entirely) reports under trivy_tpu_secret_sched_* instead
        # of skewing the match-lane row histograms
        if lane == "secret":
            self._m_rows = obs_metrics.SECRET_SCHED_BATCH_CHUNKS
            self._m_coalesced = obs_metrics.SECRET_SCHED_COALESCED
            self._m_depth = None
            self._m_wait = None
        else:
            self._m_rows = obs_metrics.SCHED_BATCH_ROWS
            self._m_coalesced = obs_metrics.SCHED_COALESCED
            self._m_depth = obs_metrics.SCHED_QUEUE_DEPTH
            self._m_wait = obs_metrics.SCHED_WAIT_SECONDS
        # optional zero-arg callable -> the engine's mesh data-parallel
        # width (1 = single-chip). When > 1, composed batches top up to
        # a multiple of the data axis' padded row granularity so every
        # data-parallel group carries real queries, not padding
        # (mesh-shape-aware composition; see _compose).
        self._data_axis_fn = data_axis_fn
        # optional zero-arg callable -> the mesh grid's ratcheted
        # per-group bucket (engine.mesh_row_floor): dispatch pads
        # every group up to it regardless, so the top-up targets it
        self._row_floor_fn = row_floor_fn
        # optional zero-arg callable -> number of in-flight scans (the
        # server wires its admission counter). When it reports <= 1,
        # nobody else can submit concurrently, so the coalesce window
        # is skipped — a lone scan on an idle server pays no added
        # latency per detect submission. None = always hold the window.
        self._busy_fn = busy_fn
        self.window_s = max(float(window_ms), 0.0) / 1000.0
        self.max_rows = max(int(max_rows), 1)
        self.chunk_rows = (max(int(chunk_rows), 1) if chunk_rows
                           else max(self.max_rows // 8, 256))
        self.max_queue = max(int(max_queue), 1)
        self.depth = max(int(depth), 1)
        self.on_shed = on_shed
        # per-tenant QoS (read once at construction, like the CLI's
        # sched knobs): weighted deficit round-robin across tenants in
        # _compose, per-tenant queue-depth caps in _enqueue
        self.qos = qos_enabled()
        self.tenant_queue = _qos_tenant_queue(self.max_queue)
        self.weights = _qos_weights()
        self._deficit: dict[str, float] = {}
        self._cond = make_lock("sched.scheduler._cond",
                               threading.Condition())
        self._waiting: list[_Pending] = []
        self._seq = 0
        self._stopping = False
        # bounds concurrently-in-flight micro-batches to `depth`
        self._inflight_slots = threading.Semaphore(self.depth)
        # batches/rows/sheds since start (diagnostics + bench)
        self.stats = {"batches": 0, "rows": 0, "coalesced": 0, "sheds": 0}
        self._thread = threading.Thread(
            target=self._run, name=f"ttpu-sched-{lane}", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ submit

    def submit(self, queries: list) -> list:
        """Coalesced replacement for ``engine.detect``: blocks until the
        shared micro-batches carrying this request's rows complete.
        Byte-identical to a private ``engine.detect(queries)`` call."""
        if not queries:
            return []
        direct = False
        for rule in faults.fire("sched.submit"):
            if rule.action == "delay":
                time.sleep(rule.param if rule.param is not None else 0.002)
            elif rule.action == "drop":
                direct = True
            elif rule.action == "error":
                self._count_shed()
                raise Overloaded("injected sched.submit overload",
                                 retry_after=1.0)
        if direct:
            # the scheduler lane is "dropped" for this submission: fall
            # back to the private per-request dispatch — no coalescing,
            # identical bytes
            return self._engine_fn().detect(list(queries))
        with tracing.span("sched.enqueue", rows=len(queries)):
            p = self._enqueue(queries)
            self._await(p)
        if p.error is not None:
            raise p.error
        return p.results

    def submit_async(self, queries: list) -> _Pending:
        """Dispatch-first entry point: enqueue `queries` into the shared
        micro-batch stream and return immediately with an opaque handle
        for :meth:`collect`.  The scheduler thread encodes and
        dispatches while the caller does other work — the secret
        engine's hybrid split enqueues its device share here, scans its
        host share, then collects (docs/secrets.md).  No fault probe
        fires here: callers with their own site (``secret.device``)
        probe before enqueueing."""
        if not queries:
            p = _Pending([], None, 0)
            p.done.set()
            return p
        with tracing.span("sched.enqueue", rows=len(queries)):
            return self._enqueue(queries)

    def collect(self, p: _Pending) -> list:
        """Block until a :meth:`submit_async` handle's micro-batches
        complete; returns its per-query results (or raises the shed /
        batch error, exactly like :meth:`submit`)."""
        if not p.queries:
            return []
        with tracing.span("sched.collect", rows=len(p.queries)):
            self._await(p)
        if p.error is not None:
            raise p.error
        return p.results

    def submit_lists(self, query_lists: list[list]) -> list[list]:
        """Batched ``engine.submit`` equivalent THROUGH the scheduler:
        the flattened union joins the shared micro-batch stream, so a
        bulk submitter (the monitor's delta re-scoring after a DB
        promote) interleaves chunk-wise with live scan requests under
        the same fairness/deadline rules instead of monopolizing the
        device, then results demux back per input list."""
        flat: list = []
        for qs in query_lists:
            flat.extend(qs)
        res = self.submit(flat)
        out: list[list] = []
        i = 0
        for qs in query_lists:
            out.append(res[i: i + len(qs)])
            i += len(qs)
        return out

    def _set_depth(self, n: int) -> None:
        if self._m_depth is not None:
            self._m_depth.set(n)

    def _observe_wait(self, p: _Pending, seconds: float) -> None:
        if self._m_wait is not None:
            self._m_wait.observe(seconds)
        # per-tenant queue-wait: accrued to the submitting request's
        # captured scope (this runs on the scheduler thread)
        usage.add_to(p.usage_ctx, "queue_wait_s", seconds)

    def _count_shed(self) -> None:
        self.stats["sheds"] += 1
        if self.on_shed is not None:
            self.on_shed()

    def _enqueue(self, queries: list) -> _Pending:
        deadline = current_deadline()
        with self._cond:
            if self._stopping or not self._thread.is_alive():
                self._count_shed()
                raise Overloaded(
                    "match scheduler stopped (server shutting down)",
                    retry_after=2.0)
            if len(self._waiting) >= self.max_queue:
                self._count_shed()
                raise Overloaded(
                    f"match scheduler overloaded "
                    f"({len(self._waiting)} requests queued)",
                    retry_after=1.0)
            if self.qos and self.tenant_queue < self.max_queue:
                scope = usage.ambient()
                tenant = (scope.tenant if scope is not None
                          else usage.ANONYMOUS)
                depth = sum(1 for w in self._waiting
                            if w.tenant == tenant)
                if depth >= self.tenant_queue:
                    self._count_shed()
                    obs_metrics.QOS_QUEUE_SHEDS.inc(tenant=tenant)
                    raise Overloaded(
                        f"tenant {tenant} over its queue-depth cap "
                        f"({depth} requests queued, cap "
                        f"{self.tenant_queue})",
                        retry_after=1.0)
            self._seq += 1
            p = _Pending(list(queries), deadline, self._seq)
            self._waiting.append(p)
            self._set_depth(len(self._waiting))
            self._cond.notify_all()
        # admitted rows count toward the submitting tenant (shed
        # submissions surface in the sheds field instead)
        usage.add("queries", float(len(p.queries)))
        return p

    def _await(self, p: _Pending) -> None:
        while not p.done.is_set():
            if not self._thread.is_alive():
                # the scheduler thread died (should not happen; a batch
                # failure is isolated per slice) — do not hang the
                # request, and free its bounded-queue slot so queue
                # depth cannot climb with unreachable entries
                with self._cond:
                    if p in self._waiting:
                        self._waiting.remove(p)
                        self._set_depth(len(self._waiting))
                if p.error is None:
                    p.error = RuntimeError("match scheduler thread died")
                return
            d = p.deadline
            if d is None:
                p.done.wait(0.5)
                continue
            rem = d.remaining()
            if rem > 0:
                p.done.wait(min(rem + 0.001, 0.5))
                continue
            # budget expired: shed the rows still queued. Rows already
            # in flight are awaited below — their batch is running and
            # cannot be recalled, and the driver's next deadline
            # checkpoint sheds the scan right after.
            with self._cond:
                if not p.done.is_set() and p.queued_rows:
                    self._waiting.remove(p)
                    self._set_depth(len(self._waiting))
                    p.error = Overloaded(
                        f"deadline budget of {d.budget_s:.3f}s expired "
                        "while queued in the match scheduler",
                        retry_after=1.0)
                    self._count_shed()
                    p.done.set()
                    return
            p.done.wait(0.5)

    # --------------------------------------------------------- scheduler

    def _run(self) -> None:
        from concurrent.futures import ThreadPoolExecutor

        if self.depth <= 1:
            while True:
                batch = self._compose()
                if batch is None:
                    return
                self._dispatch(*batch)
        # depth > 1: the compose loop keeps cutting batches while up to
        # `depth` dispatches run — batch N+1 encodes and dispatches
        # while batch N's device round-trip / GIL-dropping crunch is
        # still in flight
        pool = ThreadPoolExecutor(self.depth,
                                  thread_name_prefix="ttpu-sched-d")
        try:
            while True:
                batch = self._compose()
                if batch is None:
                    return
                if not batch[0]:
                    continue
                self._inflight_slots.acquire()
                pool.submit(self._dispatch_slot, *batch)
        finally:
            pool.shutdown(wait=True)

    def _dispatch_slot(self, parts, rows: int) -> None:
        try:
            self._dispatch(parts, rows)
        finally:
            self._inflight_slots.release()

    def _compose(self):
        """Block until work is queued, hold the coalesce window open,
        then cut a fairness-interleaved batch. -> (parts, rows) with
        parts = [(pending, lo, hi)], or None when stopped and drained."""
        with self._cond:
            while not self._waiting:
                if self._stopping:
                    return None
                self._cond.wait(0.5)
            # coalesce window: measured from the oldest queued
            # submission so a request never waits more than window_s
            # before its first chunk is eligible
            end = min(p.arrival for p in self._waiting) + self.window_s
            while (not self._stopping
                   and sum(p.queued_rows for p in self._waiting)
                   < self.max_rows):
                if self._busy_fn is not None and self._busy_fn() <= 1:
                    # a lone in-flight scan: nothing else can submit,
                    # holding the window would only add latency
                    break
                left = end - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(left)
                if not self._waiting:
                    # everything shed while we coalesced
                    return ([], 0)
            # fairness: oldest-deadline-first order, one chunk per
            # request per round, so a huge image shares every batch
            # with the small ones queued beside it; with QoS on, the
            # rounds are tenant-level weighted deficit round-robin
            # instead (one chunk per banked quantum, rotating across
            # the tenant's requests) — for a single tenant at weight 1
            # the emitted chunk sequence is identical to the
            # request-level interleave, so the historical compose is a
            # special case, not a second code path to diverge
            order = sorted(self._waiting, key=_Pending.sort_key)
            if self.qos:
                parts, rows = self._compose_qos(order)
            else:
                parts = []
                rows = 0
                progressed = True
                while rows < self.max_rows and progressed:
                    progressed = False
                    for p in order:
                        if rows >= self.max_rows:
                            break
                        if not p.queued_rows:
                            continue
                        rows += self._cut_chunk(p, parts, rows)
                        progressed = True
            self._mesh_fill(order, parts, rows)
            rows = sum(hi - lo for _p, lo, hi in parts)
            # fully-dispatched requests leave the queue; they complete
            # from the dispatch path when their in-flight chunks land
            self._waiting = [p for p in self._waiting if p.queued_rows]
            self._set_depth(len(self._waiting))
            return (parts, rows)

    def _cut_chunk(self, p: _Pending, parts: list, rows: int) -> int:
        """Cut one ``chunk_rows`` chunk from `p` into `parts` (caller
        holds _cond); -> rows taken."""
        lo = p.next_row
        hi = min(lo + self.chunk_rows, len(p.queries),
                 lo + (self.max_rows - rows))
        p.next_row = hi
        p.inflight += 1
        if p.dispatched_at is None:
            p.dispatched_at = time.monotonic()
            self._observe_wait(p, p.dispatched_at - p.arrival)
        parts.append((p, lo, hi))
        return hi - lo

    def _compose_qos(self, order: list[_Pending]):
        """Weighted deficit round-robin across tenants (caller holds
        _cond): each round banks every queued tenant's weight as
        credit and emits one chunk per whole credit, rotating across
        that tenant's requests in deadline order.  Deficits persist
        across batches so fractional weights average out; an idle
        tenant's deficit resets (no banking while unqueued) so a
        returning tenant cannot burst past its share."""
        groups: dict[str, list[_Pending]] = {}
        torder: list[str] = []
        for p in order:
            g = groups.get(p.tenant)
            if g is None:
                groups[p.tenant] = g = []
                torder.append(p.tenant)
            g.append(p)
        # drop stale deficits: tenants with nothing queued stop banking
        self._deficit = {t: d for t, d in self._deficit.items()
                         if t in groups}
        obs_metrics.QOS_ACTIVE_TENANTS.set(len(groups))
        default_w = self.weights.get("*", 1.0)
        cursor = {t: 0 for t in torder}
        parts: list[tuple[_Pending, int, int]] = []
        rows = 0
        progressed = True
        while rows < self.max_rows and progressed:
            progressed = False
            for t in torder:
                if rows >= self.max_rows:
                    break
                g = groups[t]
                if not any(p.queued_rows for p in g):
                    self._deficit.pop(t, None)
                    continue
                w = self.weights.get(t, default_w)
                # bank one round's quantum, capped so an idle-within-
                # batch tenant cannot accumulate unbounded credit
                credit = min(self._deficit.get(t, 0.0) + w,
                             max(w, 1.0))
                while credit >= 1.0 and rows < self.max_rows:
                    k = cursor[t]
                    n = len(g)
                    p = None
                    for j in range(n):
                        cand = g[(k + j) % n]
                        if cand.queued_rows:
                            p = cand
                            cursor[t] = (k + j + 1) % n
                            break
                    if p is None:
                        break
                    credit -= 1.0
                    rows += self._cut_chunk(p, parts, rows)
                    progressed = True
                self._deficit[t] = (credit
                                    if any(p.queued_rows for p in g)
                                    else 0.0)
        return parts, rows

    def _mesh_fill(self, order, parts, rows: int) -> None:
        """Mesh-shape-aware composition (caller holds _cond): when the
        engine serves from a dp>1 data-parallel mesh, the dispatch path
        splits each batch across dp device groups and pads every group
        up to its 128*2^k bucket (ops/match._bucket) — a batch
        whose per-group size is off-bucket ships padding rows on every
        group. Top the batch up from the waiting requests' queued rows
        (deadline order, same as the interleave) to dp * the bucket the
        groups will compile to anyway, so the shipped buckets carry
        real queries instead of padding."""
        if not parts:
            return
        dp = 1
        if self._data_axis_fn is not None:
            try:
                dp = max(int(self._data_axis_fn()), 1)
            except Exception:
                # advisory sizing hint only; a broken probe must not
                # kill batch composition
                dp = 1
        if dp <= 1:
            return
        from trivy_tpu_torch.ops.match import _bucket

        floor = 0
        if self._row_floor_fn is not None:
            try:
                floor = max(int(self._row_floor_fn()), 0)
            except Exception:
                floor = 0
        # each data group pads to max(its 128*2^k bucket, the grid's
        # ratcheted floor) on dispatch — top up to whichever the groups
        # will actually compile to
        rem = dp * max(_bucket(-(-rows // dp)), floor) - rows
        for p in order:
            if not rem:
                return
            take = min(rem, p.queued_rows)
            if not take:
                continue
            lo = p.next_row
            hi = lo + take
            p.next_row = hi
            rem -= take
            for i in range(len(parts) - 1, -1, -1):
                if parts[i][0] is p and parts[i][2] == lo:
                    # extend this request's last chunk in place — no
                    # extra in-flight accounting needed
                    parts[i] = (p, parts[i][1], hi)
                    break
            else:
                p.inflight += 1
                if p.dispatched_at is None:
                    p.dispatched_at = time.monotonic()
                    self._observe_wait(p, p.dispatched_at - p.arrival)
                parts.append((p, lo, hi))

    def _dispatch(self, parts, rows: int) -> None:
        if not parts:
            return
        lists = [p.queries[lo:hi] for p, lo, hi in parts]
        n_req = len({id(p) for p, _lo, _hi in parts})
        lead = parts[0][0]
        part_errors: list[Exception | None] = [None] * len(parts)
        res_lists: list = [None] * len(parts)
        fatal = None
        try:
            # the batch span adopts the oldest coalesced request's
            # captured context: batch timing stays visible inside that
            # request's trace instead of orphaning on this thread. The
            # usage scope rides along, so batch-level costs (rows
            # matched) attribute to the lead request's tenant — the
            # same approximation the lane attribution already makes
            with tracing.adopt(lead.trace_ctx), \
                    usage.adopt(lead.usage_ctx):
                with tracing.span("sched.batch", rows=rows,
                                  requests=n_req):
                    res_lists = self._engine_fn().submit(lists)
        except Exception as exc:
            # fault isolation: re-dispatch each coalesced slice
            # PRIVATELY so one request's poison queries fail only that
            # request — per-request-path parity, not collateral 500s
            _log.warn("sched batch failed; re-dispatching slices "
                      "per-request", err=str(exc))
            for i, qs in enumerate(lists):
                try:
                    res_lists[i] = self._engine_fn().detect(list(qs))
                except Exception as solo_exc:
                    part_errors[i] = solo_exc
        except BaseException as exc:  # lint: allow[bare-except] injected kill / interpreter exit: delivered to every coalesced waiter
            err = RuntimeError(f"scheduler batch aborted: {exc!r}")
            part_errors = [err] * len(parts)
            fatal = exc
        self._m_rows.observe(rows)
        self._m_coalesced.observe(n_req)
        done_now: list[_Pending] = []
        with self._cond:
            self.stats["batches"] += 1
            self.stats["rows"] += rows
            self.stats["coalesced"] = max(self.stats["coalesced"], n_req)
            for i, (p, lo, hi) in enumerate(parts):
                p.inflight -= 1
                if part_errors[i] is not None:
                    if p.error is None:
                        p.error = part_errors[i]
                    # nothing more to schedule for a failed request;
                    # queued_rows drops to 0 so done fires when its
                    # other in-flight chunks land
                    p.next_row = len(p.queries)
                else:
                    p.results[lo:hi] = res_lists[i]
                if p.inflight == 0 and not p.queued_rows \
                        and not p.done.is_set():
                    done_now.append(p)
            if any(e is not None for e in part_errors):
                self._waiting = [p for p in self._waiting
                                 if p.queued_rows]
                self._set_depth(len(self._waiting))
        for p in done_now:
            p.done.set()
        if fatal is not None:
            raise fatal

    # ---------------------------------------------------------- lifecycle

    def close(self, timeout: float = 10.0) -> None:
        """Stop admitting new submissions, finish the queued-and-
        admitted work (drain semantics), stop the scheduler thread."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        self._thread.join(timeout)


class SchedEngine:
    """Detect-phase engine facade for ``LocalDriver``: ``detect()``
    routes through the shared scheduler's coalesced micro-batches;
    every other attribute (``db``, ``cdb``, ...) reads through to the
    real engine."""

    __slots__ = ("_engine", "_scheduler")

    def __init__(self, engine, scheduler: MatchScheduler):
        self._engine = engine
        self._scheduler = scheduler

    def detect(self, queries: list) -> list:
        return self._scheduler.submit(queries)

    def submit(self, query_lists: list[list]) -> list[list]:
        """Batched entry point, routed through the scheduler so bulk
        submissions (monitor re-scoring) share micro-batches with live
        scans — byte-identical to ``MatchEngine.submit``."""
        return self._scheduler.submit_lists(query_lists)

    def __getattr__(self, name: str):
        return getattr(self._engine, name)
