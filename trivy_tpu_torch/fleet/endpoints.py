"""EndpointSet: client-side load balancing, failover, and hedging over
a replica set (docs/fleet.md).

One abstraction composes everything the single-server client already
had (keep-alive pooling, retry with decorrelated jitter, deadline
budgets, gzip negotiation — all unchanged inside ``rpc.client._Conn``)
with the fleet-level policies:

- **Load balancing** — round-robin over the healthy endpoints; health
  comes from each replica's ``/readyz`` (the machine-parseable JSON
  variant), probed by a background thread while the set is in use.
- **Per-replica circuit breakers** — a replica that keeps failing is
  skipped without burning an attempt on it; half-open probes re-admit
  it (``resilience.breaker``).
- **Failover** — a transport-level failure on one replica retries the
  request on the next one (scans and cache writes are idempotent:
  scans are read-only, ``PutBlob``/``PutArtifact`` are last-write-wins
  of identical content).
- **Hedged requests** — a scan left unanswered for ``hedge_s`` is
  dispatched a second time to another replica; the first response wins
  and the loser is discarded. Zero-diff by construction (scans are
  read-only against the same advisory generation), budget-capped so a
  uniformly slow fleet cannot double its own load.

A set of one endpoint (or ``TRIVY_TPU_FLEET=0``) routes through the
exact single-server code path, byte-for-byte.

Fault site ``fleet.endpoint.<index>`` (dynamic family, like ``rpc.*``):
``drop``/``error``/``timeout`` fail that endpoint's dispatch (failover
takes over), ``delay`` slows it (the hedging test bed).

Copy of trivy_tpu/fleet/endpoints.py, over the port's rpc/client.py
``_Conn``: each replica's keep-alive transport, retry policy and
columnar capability are the port's single-server client's.
"""

from __future__ import annotations

import concurrent.futures as futures
import json
import random
import threading
import urllib.error
import urllib.request

from trivy_tpu_torch.analysis.witness import make_lock
import time

from trivy_tpu_torch import fleet as fleet_mod
from trivy_tpu_torch.fleet import slo as slo_mod
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import tracing
from trivy_tpu_torch.resilience import faults
from trivy_tpu_torch.resilience.breaker import CircuitBreaker
from trivy_tpu_torch.resilience.retry import (
    DeadlineExceeded,
    RetryPolicy,
    current_deadline,
)
from trivy_tpu_torch.rpc.client import (
    DEFAULT_RETRY,
    RPCBackpressure,
    RPCError,
    RPCUnavailable,
    _Conn,
)
from trivy_tpu_torch.rpc.server import SCAN_PATH

_log = logger("fleet.endpoints")

#: paths safe to hedge: read-only, so a duplicate dispatch cannot
#: change any state (cache writes are NOT hedged — they are idempotent
#: enough for failover, but duplicating them buys nothing)
HEDGE_PATHS = frozenset({SCAN_PATH})


class Endpoint:
    """One replica: its keep-alive transport, breaker, and health."""

    __slots__ = ("url", "conn", "breaker", "index", "healthy", "note",
                 "removed")

    def __init__(self, url: str, conn: _Conn, index: int):
        self.url = url.rstrip("/")
        self.conn = conn
        self.index = index
        self.breaker = CircuitBreaker(
            failure_threshold=3, recovery_s=10.0,
            name=f"fleet.endpoint.{index}")
        self.healthy = True   # assumed until a probe says otherwise
        self.note = ""
        self.removed = False


def readyz_doc(url: str, token: str | None = None,
               timeout: float = 2.0) -> dict | None:
    """One ``/readyz`` probe using the JSON variant (``Accept:
    application/json``). Returns the parsed document (which carries
    ``ready``/``status``/``generation``/...) for both ready (200) and
    not-ready (503) replies, or None when the endpoint is unreachable
    or speaks no JSON."""
    headers = {"Accept": "application/json"}
    if token:
        headers["Trivy-Token"] = token
    req = urllib.request.Request(url.rstrip("/") + "/readyz",
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as exc:
        with exc:
            raw = exc.read()
        try:
            return json.loads(raw)
        except ValueError:
            return None
    except (OSError, ValueError):
        return None


class EndpointSet:
    """N replicas behind one ``post()`` — the smart client.

    For compatibility with code that treats the transport as a single
    connection (tests, the gzip-capability probes), attribute access
    falls through to the FIRST endpoint's ``_Conn``."""

    def __init__(self, urls: list[str] | tuple[str, ...] | str,
                 token: str | None = None,
                 custom_headers: dict | None = None,
                 retry: RetryPolicy | None = None,
                 hedge_s: float | None = None,
                 hedge_budget: float | None = None,
                 health_interval_s: float | None = None):
        if isinstance(urls, str):
            urls = split_urls(urls)
        if not urls:
            raise ValueError("EndpointSet needs at least one URL")
        self._token = token
        self._custom_headers = custom_headers
        self.retry = retry or DEFAULT_RETRY
        self._rng = random.Random(self.retry.seed)
        self._lock = make_lock("fleet.endpoints._lock")
        self._next_index = 0
        self._eps: list[Endpoint] = []
        for u in urls:
            self._eps.append(self._new_endpoint(u))
        self._fleet_on = fleet_mod.enabled()
        self._hedge_s = (fleet_mod.hedge_s() if hedge_s is None
                         else max(hedge_s, 0.0))
        self._hedge_budget = (fleet_mod.hedge_budget()
                              if hedge_budget is None else hedge_budget)
        self._health_interval_s = (fleet_mod.health_interval_s()
                                   if health_interval_s is None
                                   else health_interval_s)
        self._rr = 0
        self._req_n = 0
        self._hedge_n = 0
        self._pool: futures.ThreadPoolExecutor | None = None
        self._prober: threading.Thread | None = None
        self._prober_stop = threading.Event()
        # deliberately unseeded (unlike the retry RNG): probe jitter
        # exists to DEcorrelate replicas, so every instance must differ
        self._probe_rng = random.Random()
        self._skew = slo_mod.SkewDetector()

    # compatibility fall-through: single-connection callers keep
    # reading transport internals (keep-alive socket, gzip capability)
    # off the primary endpoint
    def __getattr__(self, name: str):
        eps = self.__dict__.get("_eps")
        if not eps:
            raise AttributeError(name)
        return getattr(eps[0].conn, name)

    def _new_endpoint(self, url: str) -> Endpoint:
        conn = _Conn(url, self._token, self._custom_headers,
                     retry=self.retry)
        ep = Endpoint(url, conn, self._next_index)
        self._next_index += 1
        return ep

    # ------------------------------------------------------- membership

    @property
    def urls(self) -> list[str]:
        with self._lock:
            return [ep.url for ep in self._eps]

    def set_endpoints(self, urls: list[str] | str) -> None:
        """Reconfigure the replica set. Removed endpoints are RETIRED:
        every keep-alive socket is torn down (busy ones after their
        in-flight round trip) and the retired ``_Conn`` refuses new
        requests, so a stale thread-local cannot resurrect a replica
        that left the set."""
        if isinstance(urls, str):
            urls = split_urls(urls)
        removed: list[Endpoint] = []
        with self._lock:
            keep = {ep.url: ep for ep in self._eps}
            new_eps: list[Endpoint] = []
            for u in urls:
                u = u.rstrip("/")
                ep = keep.pop(u, None)
                new_eps.append(ep if ep is not None
                               else self._new_endpoint(u))
            removed = list(keep.values())
            self._eps = new_eps
        for ep in removed:
            ep.removed = True
            ep.conn.retire()
            obs_metrics.FLEET_ENDPOINT_HEALTH.set(
                0.0, endpoint=str(ep.index))
            _log.info("endpoint retired", url=ep.url)

    def _live(self) -> list[Endpoint]:
        with self._lock:
            return list(self._eps)

    # ----------------------------------------------------------- health

    def probe_health(self) -> None:
        """One synchronous health pass over the set (the background
        prober calls this; tests may too). Each probe is timed into
        ``trivy_tpu_fleet_probe_seconds{endpoint}``; the routable
        verdict (ready AND breaker admits) lands in
        ``trivy_tpu_fleet_replica_healthy{endpoint}``; health flips,
        shard degradations, and cross-replica skew (mixed advisory
        generations, probe-latency outliers) are emitted into the
        fleet event bus on the transition."""
        statuses = []
        for ep in self._live():
            was_healthy = ep.healthy
            t0 = time.monotonic()
            doc = readyz_doc(ep.url, token=self._token)
            probe_s = time.monotonic() - t0
            ep.healthy = bool(doc.get("ready")) if doc else False
            ep.note = (str(doc.get("status", "")) if doc
                       else "unreachable")
            obs_metrics.FLEET_PROBE_SECONDS.observe(
                probe_s, endpoint=str(ep.index))
            obs_metrics.FLEET_ENDPOINT_HEALTH.set(
                1.0 if ep.healthy else 0.0, endpoint=str(ep.index))
            routable = ep.healthy and ep.breaker.state != "open"
            obs_metrics.FLEET_REPLICA_HEALTHY.set(
                1.0 if routable else 0.0, endpoint=str(ep.index))
            if ep.healthy != was_healthy:
                slo_mod.emit_event("probe_health", endpoint=ep.url,
                                   healthy=ep.healthy, status=ep.note)
            statuses.append({
                "endpoint": ep.url,
                "ready": ep.healthy,
                "generation": doc.get("generation") if doc else None,
                "mesh": doc.get("mesh") if doc else None,
                "probe_s": probe_s,
            })
        if slo_mod.events_enabled():
            self._skew.observe(statuses)

    def _ensure_prober(self) -> None:
        if self._health_interval_s <= 0:
            return
        with self._lock:
            if self._prober is not None and self._prober.is_alive():
                return
            self._prober_stop = threading.Event()
            t = threading.Thread(target=self._probe_loop, daemon=True,
                                 name="ttpu-fleet-health")
            self._prober = t
            # started INSIDE the lock: a concurrent first post must see
            # an alive prober, not replace a stored-but-unstarted one
            t.start()

    def _next_probe_delay(self, prev: float) -> float:
        """Decorrelated jitter over the configured probe interval
        (AWS's classic backoff shape, applied to a steady cadence):
        the next delay is uniform in [interval/2, min(prev*3,
        interval*1.5)], each replica's prober seeded independently.
        The window is centered on the configured interval so the MEAN
        cadence is exactly `_health_interval_s` — jitter spreads the
        probes, it must not silently slow probe cadence (and with it
        unhealthy-streak detection) below what was configured.
        Without it, a controller-driven fleet restart starts every
        replica's prober in the same instant and each pass probes the
        whole fleet simultaneously forever — a synchronized probe
        storm every interval. Jitter decorrelates the passes within a
        few cycles no matter how aligned they start."""
        base = self._health_interval_s
        lo = base / 2.0
        hi = min(max(prev, lo) * 3.0, base * 1.5)
        return lo + self._probe_rng.random() * max(hi - lo, 0.0)

    def _probe_loop(self) -> None:
        stop = self._prober_stop
        delay = self._next_probe_delay(self._health_interval_s)
        while not stop.wait(delay):
            try:
                self.probe_health()
            except Exception as exc:
                _log.warn("health probe pass failed", err=str(exc))
            delay = self._next_probe_delay(delay)

    def set_hedge_budget(self, budget: float) -> None:
        """Retune the hedge budget at runtime (the fleet controller's
        ``hedge_tune`` action). Clamped to [0, 1]; the spent-budget
        accounting carries over so a raise takes effect immediately
        and a cut throttles new hedges without cancelling in-flight
        ones."""
        with self._lock:
            self._hedge_budget = min(max(float(budget), 0.0), 1.0)

    # ---------------------------------------------------------- routing

    def _pick(self, exclude: Endpoint | None = None) -> Endpoint | None:
        """Next endpoint to try: round-robin over healthy replicas
        whose breaker admits a call; unhealthy-but-admitted replicas
        are the fallback (health probes can be stale — correctness
        never depends on them)."""
        eps = self._live()
        if exclude is not None:
            eps = [ep for ep in eps if ep is not exclude]
        if not eps:
            return None
        with self._lock:
            start = self._rr
            self._rr += 1
        ordered = [eps[(start + i) % len(eps)] for i in range(len(eps))]
        for ep in ordered:
            if ep.healthy and ep.breaker.allow():
                return ep
        for ep in ordered:
            if not ep.healthy and ep.breaker.allow():
                return ep
        return None

    # ------------------------------------------------------------- post

    def post(self, path: str, body: bytes, columnar=None,
             json_only: bool = False) -> bytes:
        # ``columnar``/``json_only`` pass through opaquely to each
        # replica's _Conn: capability is learned PER REPLICA, so a
        # mixed-capability fleet (mid-rollout) sends columnar only to
        # the replicas that advertised it (docs/performance.md)
        eps = self._live()
        if len(eps) == 1 or not self._fleet_on:
            # single replica (or the fleet kill switch): the exact
            # single-server client path, including its own retry loop
            return eps[0].conn.post(path, body, columnar=columnar,
                                    json_only=json_only)
        self._ensure_prober()
        with self._lock:
            self._req_n += 1
        deadline = current_deadline()
        delays = self.retry.delays(self._rng)
        last: Exception | None = None
        # at least one full cycle over the set: retry.attempts (3) must
        # not cap a 5-replica request below trying every replica once
        attempts = max(self.retry.attempts, len(eps))
        for attempt in range(attempts):
            if deadline is not None and deadline.expired:
                raise DeadlineExceeded(
                    f"fleet rpc {path}: deadline of "
                    f"{deadline.budget_s:.3f}s exhausted"
                    + (f" (last error: {last})" if last else ""),
                    budget_s=deadline.budget_s)
            ep = self._pick()
            if ep is None:
                raise RPCUnavailable(
                    f"fleet rpc {path}: no endpoint admits a call "
                    f"({self._state_note()}); last error: {last}")
            try:
                if path in HEDGE_PATHS and self._hedge_s > 0:
                    return self._hedged(ep, path, body, deadline,
                                        columnar=columnar,
                                        json_only=json_only)
                # failover retries (attempt >= 1) carry their attempt
                # identity in X-Trivy-Trace (kind "failover": the tree
                # still counts as a scan server-side — it is the
                # scan's only record — but the stitched trace shows
                # which retry produced it)
                return self._dispatch(
                    ep, path, body,
                    attempt=attempt if attempt else None,
                    attempt_kind="failover", columnar=columnar,
                    json_only=json_only)
            except RPCUnavailable as exc:
                last = exc
                obs_metrics.FLEET_FAILOVERS.inc()
                slo_mod.emit_event("failover", endpoint=ep.url,
                                   attempt=attempt, path=path,
                                   error=str(exc)[:200])
                _log.warn("endpoint failed; failing over",
                          url=ep.url, err=str(exc))
            if (attempt + 1) % max(len(eps), 1) == 0 \
                    and attempt < attempts - 1:
                # a full cycle failed: back off before going around
                # again (failing over to a DIFFERENT replica is free)
                delay = next(delays)
                if deadline is not None \
                        and deadline.remaining() <= delay:
                    raise DeadlineExceeded(
                        f"fleet rpc {path}: deadline leaves no room to "
                        f"retry (last error: {last})",
                        budget_s=deadline.budget_s)
                self.retry.sleep(delay)
        raise RPCUnavailable(
            f"fleet rpc {path} failed after {attempts} "
            f"endpoint attempts: {last}")

    def _state_note(self) -> str:
        return ", ".join(
            f"{ep.url}: {'removed' if ep.removed else ep.breaker.state}"
            f"{'' if ep.healthy else ' unhealthy'}"
            for ep in self._live())

    def _dispatch(self, ep: Endpoint, path: str, body: bytes,
                  attempt: int | None = None,
                  attempt_kind: str = "hedge", columnar=None,
                  json_only: bool = False) -> bytes:
        """One attempt on one endpoint, with breaker accounting. Only
        RPCUnavailable counts against the breaker — a deterministic
        4xx reply proves the replica is alive and answering, and so
        does a deliberate shed (RPCBackpressure: 503 + Retry-After).

        ``attempt`` (hedged or failover dispatches) tags the outgoing
        trace header with the dispatch identity so the server-side
        trace tree is attributable to THIS attempt; the plain
        single-dispatch path stays untagged, byte-identical."""
        obs_metrics.FLEET_REQUESTS.inc(endpoint=str(ep.index))
        state_before = ep.breaker.state
        try:
            for rule in faults.fire(f"fleet.endpoint.{ep.index}"):
                if rule.action == "delay":
                    time.sleep(rule.param if rule.param is not None
                               else 0.05)
                elif rule.action == "drop":
                    raise RPCUnavailable(
                        f"injected drop at endpoint {ep.index}")
                elif rule.action == "timeout":
                    raise RPCUnavailable(
                        f"injected timeout at endpoint {ep.index}")
                elif rule.action == "error":
                    raise RPCUnavailable(
                        f"injected HTTP {int(rule.param or 503)} at "
                        f"endpoint {ep.index}")
            if attempt is not None:
                with tracing.attempt_scope(attempt, ep.index,
                                           kind=attempt_kind):
                    out = ep.conn.post_once(path, body,
                                            columnar=columnar,
                                            json_only=json_only)
            else:
                out = ep.conn.post_once(path, body, columnar=columnar,
                                        json_only=json_only)
        except RPCBackpressure:
            # deliberate shed (503 + Retry-After from drain/overload):
            # the replica answered coherently, so this is backpressure,
            # not replica death — fail over without charging the
            # breaker, or an overloaded-but-healthy fleet cascades
            # into open breakers
            ep.breaker.record_success()
            self._breaker_event(ep, state_before)
            raise
        except RPCUnavailable:
            ep.breaker.record_failure()
            self._breaker_event(ep, state_before)
            raise
        except DeadlineExceeded:
            raise  # the caller's budget, not this endpoint's health
        except RPCError:
            ep.breaker.record_success()
            self._breaker_event(ep, state_before)
            raise
        ep.breaker.record_success()
        self._breaker_event(ep, state_before)
        return out

    @staticmethod
    def _breaker_event(ep: Endpoint, state_before: str) -> None:
        state = ep.breaker.state
        if state != state_before:
            slo_mod.emit_event("breaker", endpoint=ep.url,
                               breaker=f"fleet.endpoint.{ep.index}",
                               state=state, previous=state_before)

    # ---------------------------------------------------------- hedging

    def _ensure_pool(self) -> futures.ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = futures.ThreadPoolExecutor(
                    max_workers=max(4, 2 * len(self._eps)),
                    thread_name_prefix="ttpu-fleet")
            return self._pool

    def _hedge_allowed(self) -> bool:
        with self._lock:
            if self._hedge_n + 1 > self._hedge_budget * self._req_n:
                obs_metrics.FLEET_HEDGES.inc(outcome="denied")
                slo_mod.emit_event("hedge", outcome="denied")
                return False
            self._hedge_n += 1
            return True

    def _hedged(self, ep: Endpoint, path: str, body: bytes,
                deadline, columnar=None,
                json_only: bool = False) -> bytes:
        """Dispatch on ``ep``; if no response lands within the hedge
        delay, dispatch the same request to a second replica and take
        whichever answers first. The loser is not awaited — its worker
        finishes in the background and the response is discarded (its
        breaker bookkeeping still happens).

        Trace hygiene: each raced dispatch runs under its own
        ``fleet.attempt`` span (attempt index + endpoint) and tags its
        outgoing X-Trivy-Trace accordingly, so the server-side trees
        become attributable FRAGMENTS of this one scan instead of
        orphan roots; the instant the race resolves, the losing
        attempt's span is stamped ``cancelled`` (it is still open —
        that is WHY it lost), which is what marks the loser in the
        stitched cross-replica trace (fleet/telemetry.py)."""
        pool = self._ensure_pool()
        ctx = tracing.capture()
        lost: set[int] = set()  # endpoint indexes whose attempt lost

        def submit(target: Endpoint, attempt: int):
            def _go():
                with tracing.adopt(ctx):
                    with tracing.span("fleet.attempt",
                                      attempt=str(attempt),
                                      endpoint=str(target.index)) as s:
                        out = self._dispatch(target, path, body,
                                             attempt=attempt,
                                             columnar=columnar,
                                             json_only=json_only)
                        if s is not None and target.index in lost:
                            s.meta["cancelled"] = "1"
                        return out
            return pool.submit(_go)

        f1 = submit(ep, 0)
        wait_s = self._hedge_s
        if deadline is not None:
            wait_s = min(wait_s, max(deadline.remaining(), 0.001))
        done, _pending = futures.wait({f1}, timeout=wait_s)
        if f1 in done:
            exc = f1.exception()
            if exc is None:
                return f1.result()
            raise exc  # RPCUnavailable -> failover loop; rest propagate
        alt = self._pick(exclude=ep)
        if alt is None or not self._hedge_allowed():
            exc = f1.exception()  # blocks; bounded by the socket timeout
            if exc is None:
                return f1.result()
            raise exc
        # fetch_io attribution lane: waiting on the raced responses
        with tracing.span("fleet.hedge", endpoint=str(alt.index)) as hs:
            f2 = submit(alt, 1)
            by_future = {f1: ep, f2: alt}
            pending = {f1, f2}
            first_err: Exception | None = None
            while pending:
                done, pending = futures.wait(
                    pending, return_when=futures.FIRST_COMPLETED)
                # deterministic preference when both landed in one
                # wake-up: the primary answered, so the hedge "lost"
                for f in (x for x in (f1, f2) if x in done):
                    exc = f.exception()
                    if exc is None:
                        winner = by_future[f]
                        # every non-winning attempt is the loser —
                        # recorded FIRST (best-effort: the loser's
                        # attempt span reads this set when its own
                        # dispatch returns; the stitcher additionally
                        # derives the loser from the winner meta on
                        # this still-open hedge span, which is not
                        # subject to that race)
                        for other in by_future.values():
                            if other is not winner:
                                lost.add(other.index)
                        if hs is not None:
                            hs.meta["winner"] = str(winner.index)
                        outcome = "won" if f is f2 else "lost"
                        obs_metrics.FLEET_HEDGES.inc(outcome=outcome)
                        slo_mod.emit_event(
                            "hedge", outcome=outcome,
                            winner=winner.url,
                            loser=next((o.url for o in by_future.values()
                                        if o is not winner), None))
                        return f.result()
                    if first_err is None:
                        first_err = exc
            raise first_err

    # ---------------------------------------------------------- closing

    def close(self) -> None:
        """Close every idle keep-alive socket (same semantics as the
        single-connection client: the set stays usable, pooled callers
        share it). Stops the health prober and the hedge pool; both
        restart lazily on next use."""
        self._prober_stop.set()
        with self._lock:
            self._prober = None
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        for ep in self._live():
            ep.conn.close()


def split_urls(url: str) -> list[str]:
    """``http://a:1,http://b:2`` -> endpoint list (whitespace ok)."""
    return [u.strip() for u in url.split(",") if u.strip()]
