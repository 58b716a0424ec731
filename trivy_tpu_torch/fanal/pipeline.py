"""Pipelined, dedupe-aware layer-analysis executor (reference
pkg/parallel/pipeline.go).

Two mechanisms attack the artifact-analysis share of an image scan:

1. **Prefetch pipeline** — ``run_layer_pipeline`` overlaps the I/O-bound
   fetch+decode of layer N+1 with the CPU-bound walk/analyze of layer N
   (a double-buffered coordinator and lane). One fetch lane reads layer streams out of the image
   source sequentially — tar/daemon/registry handles are not required to
   be thread-safe, so exactly one thread ever touches them — while the
   coordinator (the scanning thread) analyzes in layer order, so results
   are byte-identical to the serial path by construction. Depth-bounded:
   at most ``prefetch_depth`` layers are materialized ahead.

2. **Content-addressed cross-image dedupe** — layer cache keys are
   already content addressed (diffID x analyzer versions, cache_key),
   so a base layer shared by every debian/alpine image hits the blob
   cache after its first analysis. ``LayerSingleflight`` closes the
   remaining window: two *concurrent* in-process scans that both miss
   the cache on the same blob_id coordinate so exactly one analyzes it;
   the rest wait on the completed BlobInfo document and replay it into
   their own cache handle when it differs from the leader's. The same
   registry, in TTL mode, gates the RPC server's MissingBlobs endpoint
   so concurrent *remote* clients sharing the server cache dedupe too
   (rpc/server.py).

``TRIVY_TPU_ANALYSIS_PIPELINE=0`` disables both and restores the serial
per-layer path byte-identically (artifact/image.py keeps the legacy loop
verbatim behind the switch).

3. **Multi-lane walk** — ``run_layer_lanes`` generalizes the pair into
   one in-order fetch lane feeding N walk lanes (``--parallel N`` /
   ``TRIVY_TPU_ANALYSIS_WORKERS``, reference-parity default 5 matching
   pkg/parallel/pipeline.go). Per-layer analysis is independent, so
   lanes split+analyze distinct layers concurrently — mostly inside
   GIL-dropping native/numpy code (ops/splitter.py, the vectorized
   analyzers) — while the coordinator applies every BlobInfo document
   strictly in layer order: cache writes, singleflight publishes and
   journal records happen exactly as the serial path would emit them,
   so the output is byte-identical by construction at any lane count.
   ``workers<=1`` IS the two-stage pipeline, code path and all.

4. **Fleet journal hook** — ``journal_scope`` installs one
   ``JournalHook`` for a fleet scan (cli/fleet.py): every analyzed layer
   is recorded in the fleet journal, and a resumed fleet's journaled
   layers are counted as replayed instead of re-analyzed.

Copy of trivy_tpu/fanal/pipeline.py.

Fault site ``analysis.fetch`` (resilience/faults.py grammar): ``delay``
sleeps in the fetch lane, ``drop`` discards the fetched stream and
refetches (a lost prefetch is recomputed — results unchanged), ``error``
fails the fetch once and the layer is refetched from scratch (two
consecutive injected errors fail the scan), ``kill`` crashes for the
SIGKILL-and-resume matrix.

Fault site ``analysis.lane`` mirrors the ladder at the walk stage:
``delay`` sleeps in the lane, ``drop`` discards the analyzed document
and recomputes it from the already-split members (results unchanged),
``error`` fails the lane analysis once and it is recomputed (two
consecutive injected errors fail the scan), ``kill`` crashes mid-walk
for the SIGKILL-and-resume matrix.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time

from trivy_tpu_torch.analysis.witness import make_lock

from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import tracing
from trivy_tpu_torch.obs import usage
from trivy_tpu_torch.resilience import faults

_log = logger("fanal.pipeline")

FETCH_SITE = "analysis.fetch"
LANE_SITE = "analysis.lane"

#: reference parity: pkg/parallel/pipeline.go runs 5 workers by default
DEFAULT_WORKERS = 5
#: per-lane occupancy gauge cardinality bound (and the hard lane cap)
MAX_WORKERS = 32

# a server-side MissingBlobs claim with no PutBlob after this long is
# presumed dead (client crashed mid-analysis) and may be re-claimed
SERVER_CLAIM_TTL_S = 300.0
# total seconds one MissingBlobs request spends waiting on other
# clients' in-flight layers before telling the caller to analyze them
SERVER_WAIT_BUDGET_S = 10.0
# in-process leaders always finish (try/finally), so this is a hang
# guard, not a tuning knob
_INPROC_WAIT_S = 600.0


class AnalysisFetchError(Exception):
    """A layer fetch failed (injected or real); the layer is refetched
    once before the scan fails."""


class AnalysisLaneError(Exception):
    """A lane analysis failed (injected or real); the document is
    recomputed once from the split members before the scan fails."""


def enabled() -> bool:
    """The ``TRIVY_TPU_ANALYSIS_PIPELINE`` kill switch (default on)."""
    return os.environ.get("TRIVY_TPU_ANALYSIS_PIPELINE", "1") != "0"


def prefetch_depth() -> int:
    raw = os.environ.get("TRIVY_TPU_ANALYSIS_PREFETCH")
    if raw:
        try:
            return max(int(raw), 1)
        except ValueError:
            _log.warn("bad TRIVY_TPU_ANALYSIS_PREFETCH; using default",
                      value=raw)
    return 2


def analysis_workers(requested: int | None = None) -> int:
    """Walk-lane count: ``TRIVY_TPU_ANALYSIS_WORKERS`` overrides the
    caller's ``--parallel`` value; malformed values warn-and-default
    like ``TRIVY_TPU_ANALYSIS_PREFETCH``. Clamped to [1, MAX_WORKERS]
    (the per-lane gauge's cardinality bound)."""
    n = requested if requested is not None else DEFAULT_WORKERS
    raw = os.environ.get("TRIVY_TPU_ANALYSIS_WORKERS")
    if raw:
        try:
            n = int(raw)
        except ValueError:
            _log.warn("bad TRIVY_TPU_ANALYSIS_WORKERS; using default",
                      value=raw)
    return max(1, min(n, MAX_WORKERS))


# ------------------------------------------------------------ singleflight


class _Slot:
    """One in-flight layer analysis other scans can wait on."""

    __slots__ = ("event", "doc", "ok", "src_cache", "created", "done",
                 "holder")

    def __init__(self, src_cache, holder=None):
        self.event = threading.Event()
        self.doc: dict | None = None
        self.ok = False
        self.src_cache = src_cache  # leader's cache handle (may be None)
        self.created = time.monotonic()
        self.done = False
        self.holder = holder        # opaque claimant identity (server
        #                             gate: the scan's trace id)


class LayerSingleflight:
    """blob_id-keyed in-flight registry: first claimer leads, the rest
    wait on the leader's completed blob document.

    Two modes share the implementation:

    - in-process (``ttl_s=None``): leaders are code paths with a
      try/finally around :meth:`finish`, so slots always resolve;
    - server gate (``ttl_s`` set): leaders are remote clients that may
      die between MissingBlobs and PutBlob, so a stale claim expires
      and the next claimer takes over.
    """

    def __init__(self, ttl_s: float | None = None):
        self._lock = make_lock("fanal.pipeline._lock")
        self._inflight: dict[str, _Slot] = {}
        self.ttl_s = ttl_s

    def claim(self, blob_id: str, src_cache=None,
              holder=None) -> tuple[_Slot, bool]:
        """-> (slot, is_leader). Leaders MUST eventually call
        :meth:`finish` on their slot (TTL mode excepted). A non-None
        ``holder`` matching the live claim's holder re-leads instead of
        waiting — a retried RPC (lost response, resent request) must
        not park on its own first attempt's claim, which nobody else
        will ever complete."""
        now = time.monotonic()
        with self._lock:
            slot = self._inflight.get(blob_id)
            if slot is not None and self.ttl_s is not None \
                    and now - slot.created > self.ttl_s:
                # presumed-dead leader: release its waiters (they
                # re-probe and analyze) and take the claim over
                slot.done = True
                slot.event.set()
                slot = None
            if slot is not None and holder is not None \
                    and slot.holder == holder:
                slot.created = now  # idempotent re-claim extends TTL
                return slot, True
            if slot is None:
                if self.ttl_s is not None and len(self._inflight) > 1024:
                    self._sweep_expired(now)
                slot = _Slot(src_cache, holder=holder)
                self._inflight[blob_id] = slot
                return slot, True
            return slot, False

    def _sweep_expired(self, now: float) -> None:
        # caller holds the lock; TTL mode only
        for bid in [b for b, s in self._inflight.items()
                    if now - s.created > self.ttl_s]:
            s = self._inflight.pop(bid)
            s.event.set()

    def finish(self, blob_id: str, slot: _Slot, doc: dict | None = None,
               ok: bool = False) -> None:
        """Resolve a claim (idempotent). ``ok=True`` publishes ``doc``
        to waiters; ``ok=False`` sends them back to claim()."""
        with self._lock:
            if slot.done:
                return
            slot.done = True
            if self._inflight.get(blob_id) is slot:
                del self._inflight[blob_id]
        slot.doc = doc
        slot.ok = ok
        slot.event.set()

    def reclaim(self, blob_id: str, holder=None) -> None:
        """Forcibly take over a claim whose holder is presumed dead
        (a waiter timed out on it). The stale slot's waiters are
        released (they re-probe and analyze); the fresh claim carries a
        fresh TTL and resolves at the new holder's completion, so later
        callers park on a live analysis instead of the ghost."""
        with self._lock:
            old = self._inflight.get(blob_id)
            if old is not None:
                old.done = True
                old.event.set()
            self._inflight[blob_id] = _Slot(None, holder=holder)

    def complete(self, blob_id: str) -> None:
        """Server-gate completion: a PutBlob for ``blob_id`` landed in
        the shared cache, so any slot resolves successfully (no doc —
        waiters re-probe the now-populated cache)."""
        with self._lock:
            slot = self._inflight.pop(blob_id, None)
        if slot is not None:
            slot.done = True
            slot.ok = True
            slot.event.set()

    def inflight(self) -> int:
        with self._lock:
            return len(self._inflight)


#: process-wide registry for in-process scans (fleet lanes, concurrent
#: library/server-embedded scans) — content-addressed blob_ids make
#: cross-scan sharing safe by construction
SINGLEFLIGHT = LayerSingleflight()


# ------------------------------------------------------- journal hook


class JournalHook:
    """Per-layer journal wiring a fleet lane installs around its scan:
    ``on_layer(blob_id)`` records a completed layer analysis in the
    fleet journal; ``precompleted`` is the blob_id set replayed from a
    resumed journal (those layers sit in the cache already and are
    skipped — and counted — instead of re-analyzed)."""

    def __init__(self, on_layer=None, precompleted: set[str] | None = None):
        self.on_layer = on_layer
        self.precompleted = precompleted or set()

    def layer_done(self, blob_id: str) -> None:
        if self.on_layer is not None:
            self.on_layer(blob_id)


# module-global, not a contextvar: the hook must reach the scan worker
# threads _scan_with_timeout spawns (fresh contexts), and a fleet has
# exactly one journal shared by every lane anyway
_JOURNAL_HOOK: JournalHook | None = None


@contextlib.contextmanager
def journal_scope(on_layer=None, precompleted: set[str] | None = None):
    """Install the fleet-wide layer journal for the duration of a fleet
    run (cli/fleet.py wraps run_pipeline in this)."""
    global _JOURNAL_HOOK
    prev = _JOURNAL_HOOK
    _JOURNAL_HOOK = JournalHook(on_layer, precompleted)
    try:
        yield
    finally:
        _JOURNAL_HOOK = prev


def journal_hook() -> JournalHook | None:
    return _JOURNAL_HOOK


# --------------------------------------------------------- fetch stage


def _close_quietly(obj) -> None:
    """Discarded layer streams may be real OS files (containerd content
    store); a discard must not leak the descriptor."""
    close = getattr(obj, "close", None)
    if close is not None:
        with contextlib.suppress(Exception):
            close()


def fetch_guarded(fetch):
    """Run ``fetch()`` under the ``analysis.fetch`` fault site. ``drop``
    discards the fetched stream and refetches; ``error`` raises
    AnalysisFetchError (the pipeline retries the whole fetch once);
    ``delay`` sleeps; ``kill`` dies (SIGKILL / raise-mode)."""
    rules = faults.fire(FETCH_SITE)
    faults.check_kill(FETCH_SITE, rules=rules)
    drop = err = False
    for r in rules:
        if r.action == "delay":
            time.sleep(r.param if r.param is not None else 0.05)
        elif r.action == "drop":
            drop = True
        elif r.action == "error":
            err = True
    data = fetch()
    if err:
        _close_quietly(data)
        raise AnalysisFetchError("injected analysis.fetch error")
    if drop:
        _close_quietly(data)
        data = fetch()  # the prefetched stream was lost; fetch again
    return data


def fetch_with_retry(fetch):
    try:
        return fetch_guarded(fetch)
    except AnalysisFetchError as e:
        _log.warn("layer fetch failed; refetching once", err=str(e))
        return fetch_guarded(fetch)


# ---------------------------------------------------------- lane stage


def lane_guarded(work):
    """Run ``work()`` (the analyzer pass over already-split members)
    under the ``analysis.lane`` fault site. ``work`` must be a pure
    recomputation — it consumes no stream — so ``drop`` discards the
    document and recomputes it, ``error`` raises AnalysisLaneError
    (the lane retries the analysis once), ``delay`` sleeps in the
    lane, ``kill`` dies (SIGKILL / raise-mode)."""
    rules = faults.fire(LANE_SITE)
    faults.check_kill(LANE_SITE, rules=rules)
    drop = err = False
    for r in rules:
        if r.action == "delay":
            time.sleep(r.param if r.param is not None else 0.05)
        elif r.action == "drop":
            drop = True
        elif r.action == "error":
            err = True
    if err:
        raise AnalysisLaneError("injected analysis.lane error")
    doc = work()
    if drop:
        doc = work()  # the analyzed document was lost; recompute
    return doc


def lane_with_retry(work):
    try:
        return lane_guarded(work)
    except AnalysisLaneError as e:
        _log.warn("lane analysis failed; recomputing once", err=str(e))
        return lane_guarded(work)


# ------------------------------------------------------------ pipeline


class _Stop(Exception):
    pass


def run_layer_pipeline(items: list, fetch, process,
                       depth: int | None = None) -> dict:
    """Overlap ``fetch(item)`` (fetch lane) with ``process(item,
    payload)`` (calling thread, strict item order).

    ``fetch`` must be the only code touching the image source while the
    pipeline runs (the lane serializes all fetches on one thread).
    Returns stage-busy stats and publishes the
    ``trivy_tpu_analysis_pipeline_occupancy`` gauge.
    """
    depth = depth or prefetch_depth()
    stats = {"layers": len(items), "fetch_busy_s": 0.0,
             "walk_busy_s": 0.0, "wall_s": 0.0, "occupancy": 0.0}
    if not items:
        return stats
    wall0 = time.perf_counter()

    if len(items) == 1:
        # nothing to overlap: fetch inline (same fault probes, no lane)
        t0 = time.perf_counter()
        with tracing.span(FETCH_SITE, layers=1):
            payload = fetch_with_retry(lambda: fetch(items[0]))
        usage.add("layers_fetched")
        stats["fetch_busy_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with tracing.span("analysis.walk", layers=1):
            process(items[0], payload)
        usage.add("layers_analyzed")
        stats["walk_busy_s"] = time.perf_counter() - t0
    else:
        out: queue.Queue = queue.Queue(maxsize=max(depth - 1, 1))
        stop = threading.Event()
        trace_ctx = tracing.capture()
        usage_ctx = usage.capture()

        def fetch_lane():
            with tracing.adopt(trace_ctx), usage.adopt(usage_ctx):
                for item in items:
                    if stop.is_set():
                        return
                    t0 = time.perf_counter()
                    try:
                        with tracing.span(FETCH_SITE):
                            payload = fetch_with_retry(lambda: fetch(item))
                    except BaseException as exc:  # lint: allow[bare-except] delivered to the analyzing thread in layer order
                        stats["fetch_busy_s"] += time.perf_counter() - t0
                        _put_interruptible(out, (item, exc, True), stop)
                        return
                    usage.add("layers_fetched")
                    stats["fetch_busy_s"] += time.perf_counter() - t0
                    if not _put_interruptible(out, (item, payload, False),
                                              stop):
                        _close_quietly(payload)  # coordinator aborted
                        return

        lane = threading.Thread(target=fetch_lane, daemon=True,
                                name="ttpu-layer-fetch")
        lane.start()

        def next_payload():
            # never a bare blocking get: a lane that died without
            # enqueuing (failure outside its guarded fetch) must not
            # wedge the scan — and the singleflight claims it holds —
            # forever
            while True:
                try:
                    return out.get(timeout=1.0)
                except queue.Empty:
                    if not lane.is_alive():
                        raise RuntimeError(
                            "layer fetch lane died without a result")

        try:
            for _ in items:
                # queue_wait attribution lane: the analyzing thread
                # starving on the fetch lane (fetch-bound crawls show
                # up here, not in analysis.walk)
                with tracing.span("analysis.await_fetch"):
                    item, payload, is_err = next_payload()
                if is_err:
                    raise payload
                t0 = time.perf_counter()
                with tracing.span("analysis.walk"):
                    process(item, payload)
                usage.add("layers_analyzed")
                stats["walk_busy_s"] += time.perf_counter() - t0
        finally:
            stop.set()

            def drain():
                with contextlib.suppress(queue.Empty):
                    while True:  # unblock a lane stuck on put(); close
                        _it, payload, is_err = out.get_nowait()  # orphans
                        if not is_err:
                            _close_quietly(payload)

            drain()
            lane.join(timeout=30.0)
            if lane.is_alive():
                # a wedged fetch (stalled registry/daemon read): the
                # caller will close the image source under it — the
                # lane's fault handler swallows the resulting error,
                # but say why the source teardown may log noise
                _log.warn("layer fetch lane still running at abort; "
                          "a stalled fetch will be abandoned")
            # a put that was already past its stop check can land
            # between the first drain and the lane exiting
            drain()

    wall = max(time.perf_counter() - wall0, 1e-9)
    stats["wall_s"] = wall
    stats["occupancy"] = min(
        (stats["fetch_busy_s"] + stats["walk_busy_s"]) / (2 * wall), 1.0)
    obs_metrics.ANALYSIS_PIPELINE_OCCUPANCY.set(stats["occupancy"])
    return stats


def run_layer_lanes(items: list, fetch, walk, apply,
                    depth: int | None = None, workers: int = 1) -> dict:
    """Multi-lane layer executor: one in-order fetch lane feeds
    ``workers`` walk lanes running ``walk(item, payload) -> doc``
    concurrently; the calling thread applies every document strictly in
    item order via ``apply(item, doc)``.

    Ordering invariant: ``apply`` — cache writes, singleflight
    publishes, journal records, counters — runs only on the calling
    thread and only for item k after items 0..k-1 were applied, so the
    externally visible effects are exactly the serial sequence and the
    output is byte-identical by construction at any lane count. Errors
    (fetch or walk) surface at their item's position in that order.

    ``workers<=1`` (or a single item) delegates to
    :func:`run_layer_pipeline` with ``walk``+``apply`` composed — the
    two-stage pipeline, same code path, same spans.
    """
    workers = max(1, min(int(workers), MAX_WORKERS))
    if workers <= 1 or len(items) <= 1:
        return run_layer_pipeline(
            items, fetch,
            lambda item, payload: apply(item, walk(item, payload)),
            depth=depth)

    # each lane needs a layer in hand plus one in the queue to stay
    # busy; a caller-set prefetch depth still wins when larger
    depth = depth or max(prefetch_depth(), workers + 1)
    n_lanes = min(workers, len(items))
    stats = {"layers": len(items), "fetch_busy_s": 0.0,
             "walk_busy_s": 0.0, "apply_busy_s": 0.0, "wall_s": 0.0,
             "occupancy": 0.0, "workers": n_lanes,
             "lane_busy_s": [0.0] * n_lanes}
    wall0 = time.perf_counter()

    dispatch: queue.Queue = queue.Queue(maxsize=max(depth - 1, n_lanes))
    stop = threading.Event()
    trace_ctx = tracing.capture()
    usage_ctx = usage.capture()

    cond = threading.Condition()
    results: dict[int, tuple[object, bool]] = {}
    active = [0]  # walks in flight, guarded by cond

    def deliver(seq: int, value, is_err: bool) -> None:
        with cond:
            results[seq] = (value, is_err)
            cond.notify_all()

    def fetch_lane():
        with tracing.adopt(trace_ctx), usage.adopt(usage_ctx):
            for seq, item in enumerate(items):
                if stop.is_set():
                    return
                t0 = time.perf_counter()
                try:
                    with tracing.span(FETCH_SITE):
                        payload = fetch_with_retry(lambda: fetch(item))
                except BaseException as exc:  # lint: allow[bare-except] delivered to the coordinator at this layer's position
                    stats["fetch_busy_s"] += time.perf_counter() - t0
                    deliver(seq, exc, True)
                    return
                usage.add("layers_fetched")
                stats["fetch_busy_s"] += time.perf_counter() - t0
                if not _put_interruptible(dispatch, (seq, item, payload),
                                          stop):
                    _close_quietly(payload)  # coordinator aborted
                    return

    def walk_lane(lane_id: int):
        with tracing.adopt(trace_ctx), usage.adopt(usage_ctx):
            while not stop.is_set():
                try:
                    task = dispatch.get(timeout=1.0)
                except queue.Empty:
                    continue
                if task is None:
                    return
                seq, item, payload = task
                with cond:
                    active[0] += 1
                t0 = time.perf_counter()
                try:
                    with tracing.span(LANE_SITE, lane=lane_id):
                        doc = walk(item, payload)
                except BaseException as exc:  # lint: allow[bare-except] surfaces at this layer's position in apply order
                    deliver(seq, exc, True)
                else:
                    usage.add("layers_analyzed")
                    deliver(seq, doc, False)
                finally:
                    stats["lane_busy_s"][lane_id] += \
                        time.perf_counter() - t0
                    with cond:
                        active[0] -= 1
                        cond.notify_all()

    fetcher = threading.Thread(target=fetch_lane, daemon=True,
                               name="ttpu-layer-fetch")
    lanes = [threading.Thread(target=walk_lane, args=(k,), daemon=True,
                              name=f"ttpu-analysis-lane-{k}")
             for k in range(n_lanes)]
    fetcher.start()
    for t in lanes:
        t.start()

    def wait_result(seq: int):
        # never a bare blocking wait: lanes that died without
        # delivering (failure outside their guarded stages) must not
        # wedge the scan — and the singleflight claims it holds
        with cond:
            while seq not in results:
                cond.wait(timeout=1.0)
                if seq in results:
                    break
                if (not fetcher.is_alive() and dispatch.empty()
                        and active[0] == 0):
                    raise RuntimeError(
                        "analysis lanes died without a result")
            return results.pop(seq)

    def drain():
        with contextlib.suppress(queue.Empty):
            while True:  # unblock a fetch stuck on put(); close orphans
                task = dispatch.get_nowait()
                if task is not None:
                    _close_quietly(task[2])

    try:
        for seq, item in enumerate(items):
            # queue_wait attribution lane: the coordinator starving on
            # the walk lanes (fetch- or walk-bound crawls show up here)
            with tracing.span("analysis.await_lane"):
                value, is_err = wait_result(seq)
            if is_err:
                raise value
            t0 = time.perf_counter()
            with tracing.span("analysis.apply"):
                apply(item, value)
            stats["apply_busy_s"] += time.perf_counter() - t0
    finally:
        stop.set()
        drain()
        for _ in lanes:  # wake lanes parked on get() immediately
            with contextlib.suppress(queue.Full):
                dispatch.put_nowait(None)
        fetcher.join(timeout=30.0)
        for t in lanes:
            t.join(timeout=30.0)
        if fetcher.is_alive() or any(t.is_alive() for t in lanes):
            _log.warn("analysis lanes still running at abort; a "
                      "stalled fetch/walk will be abandoned")
        drain()

    wall = max(time.perf_counter() - wall0, 1e-9)
    stats["wall_s"] = wall
    stats["walk_busy_s"] = sum(stats["lane_busy_s"])
    busy = (stats["fetch_busy_s"] + stats["walk_busy_s"]
            + stats["apply_busy_s"])
    stats["occupancy"] = min(busy / ((2 + n_lanes) * wall), 1.0)
    obs_metrics.ANALYSIS_PIPELINE_OCCUPANCY.set(stats["occupancy"])
    for k in range(n_lanes):
        obs_metrics.ANALYSIS_LANE_BUSY.set(
            min(stats["lane_busy_s"][k] / wall, 1.0), lane=str(k))
    return stats


def _put_interruptible(q: queue.Queue, obj, stop: threading.Event) -> bool:
    """Bounded put that gives up when the coordinator aborted (its
    finally-drain empties the queue, so one-second polls suffice)."""
    while not stop.is_set():
        try:
            q.put(obj, timeout=1.0)
            return True
        except queue.Full:
            continue
    return False
