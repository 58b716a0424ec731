"""RPC client: remote scan driver + remote cache
(reference pkg/rpc/client/client.go + pkg/cache/remote.go).

RemoteDriver implements the scanner Driver seam over HTTP; RemoteCache
implements the ArtifactCache write interface so analysis results land in
the server's cache. Transport is a persistent keep-alive
http.client.HTTPConnection per thread (fleet lanes each hold their own
socket), so a fleet run pays TCP connect + handshake once per lane
instead of once per scan; a stale keep-alive socket (server closed it
idle) is rebuilt transparently. Both clients accept a comma-separated
URL naming a replica SET: routing then goes through
trivy_tpu_torch/fleet/endpoints.py EndpointSet (client-side load
balancing, per-replica circuit breakers, failover, hedged requests);
a single URL keeps the exact single-server path. Transient failures
retry under a RetryPolicy with decorrelated jitter; 503 responses honor
Retry-After; the ambient per-scan deadline budget
(resilience.retry.deadline_scope) rides the X-Trivy-Deadline header and
bounds both the per-request socket timeout and the total retry loop.
Large bodies gzip under the wire.py negotiation. Fault-injection rules
(resilience.faults) are consulted before every request so
degraded-network behavior is testable deterministically.

Copy of trivy_tpu/rpc/client.py. Default-configured clients share one
pooled EndpointSet per (urls, token); `close_pool` closes their idle
sockets. Each call is one `rpc.<method>` span whose identity rides the
X-Trivy-Trace header, its round trips are timed in
trivy_tpu_rpc_client_seconds, and its bytes meter the ambient usage
scope.
"""

from __future__ import annotations

import http.client
import json
import random
import threading

from trivy_tpu_torch.analysis.witness import make_lock
import time
import urllib.error
import urllib.request
from urllib.parse import urlsplit

from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import tracing
from trivy_tpu_torch.obs import usage
from trivy_tpu_torch.resilience import faults
from trivy_tpu_torch.resilience.retry import (
    DEADLINE_HEADER,
    DeadlineExceeded,
    RetryPolicy,
    current_deadline,
    parse_retry_after,
)
from trivy_tpu_torch.rpc import columnar as colwire
from trivy_tpu_torch.rpc import wire
from trivy_tpu_torch.rpc.server import CACHE_PREFIX, SCAN_PATH

_log = logger("rpc.client")

DEFAULT_RETRY = RetryPolicy(attempts=3, base_s=0.5, cap_s=10.0)

# fault-injection site for the columnar wire negotiation itself
# (docs/resilience.md): drop renegotiates to JSON, error costs the
# columnar attempt (one retry, then JSON), corrupt flips bytes in the
# outgoing frame so the server's checksum reject drives the resend
WIRE_SITE = "rpc.wire"


class RPCError(Exception):
    pass


class _WireError(RPCError):
    """Internal: an injected columnar wire error; retryable within
    _post_attempts (never escapes it)."""


class RPCUnavailable(RPCError):
    """Transport-level / retries-exhausted failure: the endpoint did
    not produce a definite answer. Distinct from a deterministic 4xx
    RPCError so the fleet EndpointSet knows a failover to another
    replica may still succeed (docs/fleet.md)."""


class RPCBackpressure(RPCUnavailable):
    """Retries exhausted against a replica that was deliberately
    shedding (503 + Retry-After from drain or overload). Still an
    RPCUnavailable — failover to another replica is the right move —
    but the EndpointSet must NOT count it against the breaker: the
    replica answered coherently, so an overloaded-but-healthy fleet
    never cascades into open breakers (docs/fleet.md)."""


class _Conn:
    def __init__(self, url: str, token: str | None = None,
                 custom_headers: dict | None = None, timeout: float = 300.0,
                 retry: RetryPolicy | None = None):
        self.base = url.rstrip("/")
        parts = urlsplit(self.base if "//" in self.base
                         else "http://" + self.base)
        self._https = parts.scheme == "https"
        self._netloc = parts.netloc
        self._path_prefix = parts.path.rstrip("/")
        self.token = token
        self.custom_headers = custom_headers or {}
        self.timeout = timeout
        self.retry = retry or DEFAULT_RETRY
        self._rng = random.Random(self.retry.seed)
        # one persistent keep-alive connection PER THREAD: fleet lanes
        # never share a socket (http.client is not thread-safe), and
        # each lane amortizes its TCP connect across its whole run
        self._tls = threading.local()
        self._all_conns: set = set()
        self._conns_lock = make_lock("rpc.client._conns_lock")
        # sticky capability learned from the first response's
        # X-Trivy-Gzip header: only then are REQUEST bodies gzipped
        # (an old server must never see a gzip request body)
        self._server_gzip = False
        # same ladder for the columnar wire: only after a response
        # carries X-Trivy-Columnar are REQUEST bodies sent columnar
        # (an old server must never see a columnar request body)
        self._server_columnar = False
        # http_proxy/https_proxy/no_proxy targets go through urllib
        # (which implements proxy routing); keep-alive sockets are for
        # direct connections only
        self._via_proxy = self._proxy_configured()
        # a retired conn belongs to an endpoint REMOVED from its fleet
        # set: it refuses new requests so a stale thread-local cannot
        # resurrect the replica (docs/fleet.md)
        self._retired = False

    def _proxy_configured(self) -> bool:
        proxies = urllib.request.getproxies()
        scheme = "https" if self._https else "http"
        if scheme not in proxies:
            return False
        host = self._netloc.rsplit("@", 1)[-1]
        try:
            return not urllib.request.proxy_bypass(host)
        except OSError:
            return True

    # ------------------------------------------------------- transport

    def _connection(self, timeout: float) -> http.client.HTTPConnection:
        c = getattr(self._tls, "conn", None)
        if c is not None and getattr(c, "_ttpu_close_deferred", False):
            # a concurrent close() asked for teardown while this thread
            # was mid-request: honor it now, then hand out a fresh conn
            self._drop_connection()
            c = None
        if c is None:
            cls = (http.client.HTTPSConnection if self._https
                   else http.client.HTTPConnection)
            c = cls(self._netloc, timeout=timeout)
            self._tls.conn = c
        # (re-)register every handout: a thread whose socket close()
        # severed may auto-reopen this conn object, and a later close()
        # must still find it
        with self._conns_lock:
            self._all_conns.add(c)
        c.timeout = timeout
        if c.sock is not None:
            try:
                c.sock.settimeout(timeout)
            except OSError:
                # the socket died under us (closed fd): rebuild fresh
                self._drop_connection()
                return self._connection(timeout)
        return c

    def _drop_connection(self) -> None:
        c = getattr(self._tls, "conn", None)
        if c is not None:
            self._tls.conn = None
            with self._conns_lock:
                self._all_conns.discard(c)
            try:
                c.close()
            except OSError:
                pass

    def close(self) -> None:
        """Close every IDLE thread's keep-alive socket (best effort).
        A pooled connection stays usable: the next request auto-reopens
        and re-registers its socket.

        Pooled _Conns are shared across threads (one socket per
        thread), so a conn currently INSIDE a request on another
        thread must not be torn down under it — closing it there races
        http.client's response read (fp=None mid-read, observed as an
        AttributeError under the capstone bench's fleet). Busy conns
        are marked close-deferred instead; the owning thread finishes
        its round trip and closes on its next handout."""
        with self._conns_lock:
            conns, self._all_conns = list(self._all_conns), set()
        for c in conns:
            if getattr(c, "_ttpu_busy", False):
                c._ttpu_close_deferred = True
                continue
            try:
                c.close()
            except OSError:
                pass
        self._tls.conn = None

    def retire(self) -> None:
        """Endpoint-aware teardown: this conn's endpoint left the
        fleet set. Every thread's keep-alive socket is closed (busy
        ones right after their in-flight round trip via the deferred
        path), and any LATER request on this conn — e.g. from a thread
        still holding it in a thread-local — fails instead of quietly
        reopening a socket to the removed replica."""
        self._retired = True
        self.close()

    def _request_once(self, path: str, body: bytes, headers: dict,
                      timeout: float):
        """One HTTP round trip on this thread's keep-alive connection.
        -> (status, response headers, body bytes). A stale keep-alive
        (the server closed the idle socket between requests) is rebuilt
        and resent ONCE transparently, so the retry policy only ever
        sees real failures; timeouts are never transparently resent
        (the deadline budget owns those)."""
        if self._retired:
            raise RPCUnavailable(
                f"endpoint {self.base} retired (removed from its "
                "endpoint set)")
        if self._via_proxy:
            return self._request_via_urllib(path, body, headers, timeout)
        reused = getattr(self._tls, "conn", None) is not None \
            and getattr(self._tls.conn, "sock", None) is not None
        conn = self._connection(timeout)
        url_path = self._path_prefix + path
        try:
            resp, data = self._roundtrip(conn, url_path, body, headers)
        except TimeoutError:
            self._drop_connection()
            raise
        except (http.client.HTTPException, ConnectionError, OSError):
            self._drop_connection()
            if not reused:
                raise
            conn = self._connection(timeout)
            try:
                resp, data = self._roundtrip(conn, url_path, body,
                                             headers)
            except (http.client.HTTPException, ConnectionError, OSError):
                self._drop_connection()
                raise
        if resp.will_close:
            # the server asked for Connection: close; the next request
            # auto-reopens (http.client auto_open), nothing to do
            pass
        return resp.status, resp.headers, data

    def _roundtrip(self, conn, url_path: str, body: bytes,
                   headers: dict):
        """One request/response on `conn`, marked busy for the
        duration so a concurrent close() of this (pooled, shared)
        _Conn defers teardown instead of yanking the socket out from
        under the in-flight response read."""
        conn._ttpu_busy = True
        try:
            conn.request("POST", url_path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            return resp, data
        finally:
            conn._ttpu_busy = False
            if getattr(conn, "_ttpu_close_deferred", False):
                # the close that was deferred to us: the response is
                # consumed, teardown is safe now
                self._drop_connection()

    def _request_via_urllib(self, path: str, body: bytes, headers: dict,
                            timeout: float):
        """Proxy-routed fallback (no keep-alive): urllib implements the
        http_proxy/https_proxy/no_proxy handling this client must keep
        honoring. Same (status, headers, body) contract."""
        req = urllib.request.Request(
            self.base + path, data=body, headers=headers, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, r.headers, r.read()
        except urllib.error.HTTPError as exc:
            with exc:
                return exc.code, exc.headers, exc.read()

    # ------------------------------------------------------------ post

    @staticmethod
    def _span_meta(base: str) -> dict:
        # a fleet dispatch (hedged / failover retry) carries its
        # attempt identity on the client span too, so the stitched
        # cross-replica trace shows which attempt each round trip
        # belonged to (fleet/telemetry.py)
        meta = {"url": base}
        tag = tracing.current_attempt_tag()
        if tag is not None:
            meta["attempt"] = str(tag[0])
            meta["endpoint"] = str(tag[1])
        return meta

    def post(self, path: str, body: bytes, columnar=None,
             json_only: bool = False) -> bytes:
        # one client span covers the whole retried call; the trace
        # identity rides X-Trivy-Trace so the server's handler span
        # becomes this span's child (docs/observability.md)
        method = path.rsplit("/", 1)[-1]
        with tracing.span(f"rpc.{method}", **self._span_meta(self.base)):
            return self._post_attempts(path, method, body,
                                       columnar=columnar,
                                       json_only=json_only)

    def post_once(self, path: str, body: bytes, columnar=None,
                  json_only: bool = False) -> bytes:
        """Single-attempt post: the fleet EndpointSet drives its own
        failover loop ACROSS endpoints, so the per-endpoint retry loop
        collapses to one attempt (the stale-keep-alive rebuild inside
        _request_once still applies — it is transport plumbing, not a
        retry)."""
        method = path.rsplit("/", 1)[-1]
        with tracing.span(f"rpc.{method}", **self._span_meta(self.base)):
            return self._post_attempts(path, method, body, attempts=1,
                                       columnar=columnar,
                                       json_only=json_only)

    def _post_attempts(self, path: str, method: str, body: bytes,
                       attempts: int | None = None, columnar=None,
                       json_only: bool = False) -> bytes:
        # the extended-fidelity internal encoding is marked so the server
        # can tell it apart from reference Twirp clients on the same paths
        headers = {"Content-Type": "application/json",
                   "X-Trivy-Tpu-Wire": "internal",
                   "Accept-Encoding": "gzip",
                   **self.custom_headers}
        if self.token:
            headers["Trivy-Token"] = self.token
        tracing.inject_headers(headers)
        policy = self.retry
        attempts = policy.attempts if attempts is None else attempts
        deadline = current_deadline()
        delays = policy.delays(self._rng)
        site = faults.rpc_site(path)
        # columnar offer: ``columnar`` is a zero-arg thunk producing the
        # columnar request bytes, evaluated lazily at most once — and
        # only after this conn has learned the server speaks columnar
        # (the X-Trivy-Columnar capability ladder, docs/performance.md)
        offer_columnar = (columnar is not None and colwire.enabled()
                          and not json_only)
        col_bytes: bytes | None = None
        col_fails = 0    # columnar attempts lost to the wire ladder
        wire_extra = 0   # extra attempts granted for columnar->JSON
        last_err: Exception | None = None
        shed = False  # last failure was a deliberate 503 + Retry-After
        attempt = 0
        while attempt < attempts + wire_extra:
            if deadline is not None and deadline.expired:
                raise DeadlineExceeded(
                    f"rpc to {self.base}{path}: deadline of "
                    f"{deadline.budget_s:.3f}s exhausted"
                    + (f" (last error: {last_err})" if last_err else ""),
                    budget_s=deadline.budget_s)
            hdrs = dict(headers)
            if deadline is not None:
                hdrs[DEADLINE_HEADER] = deadline.header_value()
            use_columnar = (offer_columnar and self._server_columnar
                            and col_fails < 2)
            if offer_columnar:
                hdrs["Accept"] = (colwire.CONTENT_TYPE
                                  + ", application/json")
            if use_columnar:
                if col_bytes is None:
                    col_bytes = columnar()
                # frames carry their own per-frame deflate; whole-body
                # gzip would defeat frame-at-a-time decode
                payload = send_body = col_bytes
                hdrs["Content-Type"] = colwire.CONTENT_TYPE
            else:
                payload = send_body = body
                if self._server_gzip and len(body) >= wire.GZIP_MIN_BYTES:
                    send_body = wire.gzip_bytes(body)
                    hdrs["Content-Encoding"] = "gzip"
            # client-side cost vector (no-ops without an ambient usage
            # scope): payload bytes pre-compression, wire bytes as
            # actually sent, accrued per attempt — retries really do
            # re-ship bytes
            usage.add("bytes_out", float(len(payload)))
            usage.add("wire_bytes_out", float(len(send_body)))
            obs_metrics.WIRE_REQUESTS.inc(
                format="columnar" if use_columnar else "json",
                direction="out")
            retry_after: float | None = None
            corrupt = False
            try:
                for rule in faults.fire(site):
                    if rule.action == "delay":
                        policy.sleep(rule.param or 0.0)
                    elif rule.action == "drop":
                        raise urllib.error.URLError(
                            ConnectionRefusedError("injected drop"))
                    elif rule.action == "timeout":
                        raise TimeoutError("injected timeout")
                    elif rule.action == "error":
                        raise faults.InjectedHTTPError(
                            int(rule.param or 503))
                    elif rule.action == "corrupt":
                        corrupt = True
                if offer_columnar:
                    for rule in faults.fire(WIRE_SITE):
                        if rule.action == "delay":
                            policy.sleep(rule.param or 0.0)
                        elif rule.action == "drop" and use_columnar:
                            # the columnar channel dropped mid-flight:
                            # forget the capability and renegotiate —
                            # the retry goes JSON, and the next 2xx
                            # response re-advertises columnar
                            self._server_columnar = False
                            wire_extra = min(wire_extra + 1, 2)
                            obs_metrics.WIRE_FALLBACKS.inc(reason="drop")
                            raise urllib.error.URLError(
                                ConnectionResetError(
                                    "injected columnar drop"))
                        elif rule.action == "error" and use_columnar:
                            # one columnar retry; a second error falls
                            # this call back to JSON for good
                            col_fails += 1
                            wire_extra = min(wire_extra + 1, 2)
                            if col_fails >= 2:
                                obs_metrics.WIRE_FALLBACKS.inc(
                                    reason="error")
                            raise _WireError(
                                "injected columnar wire error")
                        elif rule.action == "corrupt" and use_columnar:
                            # flip bytes in the outgoing frames: the
                            # server's checksum reject (400) drives the
                            # JSON resend below
                            send_body = faults.corrupt_bytes(send_body)
                timeout = self.timeout
                if deadline is not None:
                    # small grace past the budget: a deadline-aware
                    # server sheds AT the deadline and replies 503 +
                    # Retry-After — waiting a moment longer turns a
                    # blind socket timeout into that definite answer
                    timeout = max(0.001, min(
                        timeout, deadline.remaining() + 0.5))
                rt_start = time.perf_counter()
                try:
                    status, rhdrs, raw = self._request_once(
                        path, send_body, hdrs, timeout)
                finally:
                    # per-attempt round-trip latency, errors included;
                    # the ambient rpc.<method> span's trace id rides
                    # along as an OpenMetrics exemplar so a tail bucket
                    # names the exact trace that landed there
                    cur = tracing.current()
                    obs_metrics.RPC_CLIENT_SECONDS.observe(
                        time.perf_counter() - rt_start, method=method,
                        exemplar=cur.trace_id if cur is not None
                        else None)
                if rhdrs.get(wire.GZIP_CAPABLE_HEADER):
                    self._server_gzip = True
                if rhdrs.get(colwire.CAPABLE_HEADER):
                    self._server_columnar = True
                usage.add("wire_bytes_in", float(len(raw)))
                if "gzip" in (rhdrs.get("Content-Encoding")
                              or "").lower():
                    raw = wire.gunzip_bytes(raw)
                usage.add("bytes_in", float(len(raw)))
                if status >= 300:
                    # non-2xx is an error, named by status: 3xx included
                    # (a redirecting ingress is a config problem this
                    # client won't chase) and deterministic like 4xx —
                    # only 5xx retries
                    detail = raw.decode("utf-8", "replace")[:500]
                    if hdrs.get("Content-Encoding") == "gzip" \
                            and not rhdrs.get(wire.GZIP_CAPABLE_HEADER):
                        # ANY error (4xx or 5xx) to our gzip request
                        # from a server NOT advertising gzip capability
                        # is an old/rolled-back replica choking on the
                        # encoding: forget the sticky capability and
                        # let the retry resend plain
                        self._server_gzip = False
                        shed = False
                        last_err = RPCError(
                            f"{status} to gzip request from a server "
                            f"without gzip capability: {detail}")
                    elif use_columnar \
                            and not rhdrs.get(colwire.CAPABLE_HEADER):
                        # same unlearn for the columnar wire: ANY error
                        # to our columnar request from a server NOT
                        # advertising the capability is an old or
                        # rolled-back replica choking on the encoding —
                        # forget the sticky capability and let the
                        # (granted) retry resend JSON
                        self._server_columnar = False
                        wire_extra = min(wire_extra + 1, 2)
                        obs_metrics.WIRE_FALLBACKS.inc(reason="unlearn")
                        shed = False
                        last_err = RPCError(
                            f"{status} to columnar request from a "
                            f"server without columnar capability: "
                            f"{detail}")
                    elif use_columnar and status == 400:
                        # a columnar-capable server rejected our frames
                        # (checksum/truncation — corrupted in transit):
                        # resend this call as JSON
                        col_fails = 2
                        wire_extra = min(wire_extra + 1, 2)
                        obs_metrics.WIRE_FALLBACKS.inc(reason="corrupt")
                        shed = False
                        last_err = RPCError(
                            f"400 columnar frame reject: {detail}")
                    elif status < 500:
                        raise RPCError(f"{status}: {detail}")
                    else:
                        last_err = RPCError(f"{status}: {detail}")
                        # 503 WITH Retry-After is the shed handshake
                        # (drain / overload): the replica is alive and
                        # telling us to come back later
                        shed = (status == 503
                                and rhdrs.get("Retry-After") is not None)
                        if status == 503 and policy.respect_retry_after:
                            retry_after = parse_retry_after(
                                rhdrs.get("Retry-After"))
                else:
                    return faults.corrupt_bytes(raw) if corrupt else raw
            except _WireError as exc:
                shed = False
                last_err = exc
            except faults.InjectedHTTPError as exc:
                if exc.code < 500:
                    raise RPCError(f"{exc.code}: {exc}") from exc
                shed = False
                last_err = RPCError(f"{exc.code}: {exc}")
            except (urllib.error.URLError, http.client.HTTPException,
                    OSError, TimeoutError) as exc:
                shed = False
                last_err = exc
            attempt += 1
            if attempt < attempts + wire_extra:
                delay = next(delays)
                if retry_after is not None:
                    # the server told us when it expects to recover;
                    # never retry earlier than that
                    delay = max(delay, retry_after)
                if deadline is not None and deadline.remaining() <= delay:
                    raise DeadlineExceeded(
                        f"rpc to {self.base}{path}: deadline of "
                        f"{deadline.budget_s:.3f}s leaves no room to retry "
                        f"(last error: {last_err})",
                        budget_s=deadline.budget_s)
                obs_metrics.RETRY_ATTEMPTS.inc(method=method)
                policy.sleep(delay)
        if shed:
            raise RPCBackpressure(
                f"rpc to {self.base}{path} shed after {attempts} "
                f"attempts: {last_err}")
        raise RPCUnavailable(
            f"rpc to {self.base}{path} failed after {attempts} "
            f"attempts: {last_err}")


# process-wide EndpointSet pool keyed by (urls, token) for default-
# configured clients: the CLI builds a fresh RemoteDriver + RemoteCache
# per artifact (fleet runs: per lane-slot), and without sharing, each
# would open its own sockets — the pool makes "TCP connect once per
# lane, not once per scan" actually hold. A single-URL set routes
# through its one _Conn byte-identically to the pre-fleet client; a
# comma-separated URL becomes a replica set with client-side LB,
# failover, and hedging (trivy_tpu_torch/fleet/endpoints.py). Custom retry
# policies or headers opt out (tests and special callers keep private
# connections).
_CONN_POOL: dict[tuple, object] = {}
_CONN_POOL_LOCK = make_lock("rpc.client._CONN_POOL_LOCK")


def _pooled_set(url: str, token: str | None,
                custom_headers: dict | None,
                retry: RetryPolicy | None):
    from trivy_tpu_torch.fleet.endpoints import EndpointSet, split_urls

    urls = tuple(u.rstrip("/") for u in split_urls(url))
    if retry is not None or custom_headers:
        return EndpointSet(list(urls), token, custom_headers,
                           retry=retry)
    key = (urls, token)
    with _CONN_POOL_LOCK:
        c = _CONN_POOL.get(key)
        if c is None:
            c = _CONN_POOL[key] = EndpointSet(list(urls), token)
        return c


def close_pool() -> None:
    """Close every pooled endpoint set's idle sockets, its health
    prober and its hedge pool (tests, embedding)."""
    with _CONN_POOL_LOCK:
        conns = list(_CONN_POOL.values())
    for c in conns:
        c.close()


class RemoteDriver:
    """Driver implementation that ships the scan to a server
    (reference pkg/rpc/client/client.go:48-73). `url` may name a whole
    replica set (comma-separated) — requests then load-balance with
    failover and hedged tail-latency dispatch (docs/fleet.md)."""

    def __init__(self, url: str, token: str | None = None,
                 custom_headers: dict | None = None,
                 retry: RetryPolicy | None = None):
        self.conn = _pooled_set(url, token, custom_headers, retry)
        # the scan's phases run on the server
        self.stats: dict = {}

    def scan(self, target, artifact_key, blob_keys, options):
        body = wire.scan_request(target, artifact_key, blob_keys, options)
        raw = self.conn.post(SCAN_PATH, body, columnar=lambda:
                             colwire.encode_scan_request(
                                 target, artifact_key, blob_keys,
                                 options))
        if colwire.is_columnar(raw):
            try:
                return colwire.decode_scan_response(raw)
            except colwire.WireFormatError as exc:
                # a columnar response that fails its frame checksums
                # (torn/corrupted in transit): refetch once as JSON
                obs_metrics.WIRE_FALLBACKS.inc(reason="corrupt")
                _log.warn("columnar scan response rejected; "
                          "refetching as JSON", err=str(exc))
                raw = self.conn.post(SCAN_PATH, body, json_only=True)
        return wire.decode_scan_response(raw)

    def close(self) -> None:
        self.conn.close()


class RemoteCache:
    """ArtifactCache over RPC (reference pkg/cache/remote.go:27): analysis
    blobs are written into the SERVER's cache; reads happen server-side."""

    def __init__(self, url: str, token: str | None = None,
                 custom_headers: dict | None = None,
                 retry: RetryPolicy | None = None):
        self.conn = _pooled_set(url, token, custom_headers, retry)

    def put_artifact(self, artifact_id: str, info) -> None:
        self.conn.post(CACHE_PREFIX + "PutArtifact", wire.encode(
            {"artifact_id": artifact_id, "artifact_info": info}
        ))

    def put_blob(self, blob_id: str, blob) -> None:
        self.conn.post(CACHE_PREFIX + "PutBlob", wire.encode(
            {"diff_id": blob_id, "blob_info": blob}
        ), columnar=lambda: colwire.encode_put_blob(blob_id, blob))

    def missing_blobs(self, artifact_id: str, blob_ids: list[str]):
        body = wire.encode(
            {"artifact_id": artifact_id, "blob_ids": blob_ids})
        raw = self.conn.post(
            CACHE_PREFIX + "MissingBlobs", body,
            columnar=lambda: colwire.encode_missing_blobs(
                artifact_id, blob_ids))
        if colwire.is_columnar(raw):
            try:
                return colwire.decode_missing_response(raw)
            except colwire.WireFormatError as exc:
                obs_metrics.WIRE_FALLBACKS.inc(reason="corrupt")
                _log.warn("columnar MissingBlobs response rejected; "
                          "refetching as JSON", err=str(exc))
                raw = self.conn.post(CACHE_PREFIX + "MissingBlobs",
                                     body, json_only=True)
        doc = json.loads(raw)
        return doc.get("missing_artifact", True), \
            doc.get("missing_blob_ids", []) or []

    def delete_blobs(self, blob_ids: list[str]) -> None:
        self.conn.post(CACHE_PREFIX + "DeleteBlobs",
                       wire.encode({"blob_ids": blob_ids}))

    # LocalArtifactCache reads never happen client-side in server mode
    def get_artifact(self, artifact_id: str) -> dict:
        return {}

    def get_blob(self, blob_id: str) -> dict:
        return {}

    def close(self) -> None:
        self.conn.close()
