"""Cross-SERVER layer-analysis dedupe over the redis cache backend
(docs/fleet.md "Shared artifact cache tier").

The in-process ``LayerSingleflight`` makes concurrent scans on
ONE server analyze each unique layer once; its TTL mode gates the RPC
server's MissingBlobs endpoint for concurrent remote clients of that
server. This module extends the same claim protocol across a replica
set: when M servers share one redis cache tier, a layer claim lives in
redis (``SET NX`` with a TTL and the claimant's identity), so a client
of server B parks on a layer a client of server A is analyzing right
now — fleet-wide, each unique layer is analyzed exactly once.

Semantics mirror ``LayerSingleflight`` deliberately:

- first claimer leads; the claim key carries the holder identity (the
  scan's trace id), so a RETRIED request re-leads its own claim
  instead of waiting on itself;
- the claim expires after ``ttl_s`` (leader died mid-analysis): the
  next claimer takes over;
- a follower waits (bounded by the caller's budget) for either the
  blob to land in the shared cache (leader's PutBlob — success) or
  the claim to vanish without a blob (leader failed — the follower
  re-claims and analyzes);
- correctness never depends on the gate: every rung of the failure
  ladder degrades to "this caller analyzes the layer itself".

The fake-redis test server and a real redis both speak the three
commands used here: ``SET key val NX EX n`` / ``GET`` / ``DEL``.

Copy of trivy_tpu/fleet/dedupe.py, whole.
"""

from __future__ import annotations

import os

import time

from trivy_tpu_torch.cache.redis import REDIS_PREFIX, RedisError
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs import metrics as obs_metrics

_log = logger("fleet.dedupe")

CLAIM_PREFIX = f"{REDIS_PREFIX}::claim::"
POLL_S = 0.05


class _RemoteSlot:
    """Follower's handle on another server's in-flight layer analysis.
    Duck-types the ``LayerSingleflight`` slot surface the server's
    MissingBlobs gate consumes: ``slot.event.wait(budget)`` plus the
    ``done`` / ``ok`` verdict fields."""

    __slots__ = ("_gate", "_blob", "done", "ok")

    def __init__(self, gate: "RedisLayerGate", blob_id: str):
        self._gate = gate
        self._blob = blob_id
        self.done = False
        self.ok = False

    @property
    def event(self) -> "_RemoteSlot":
        return self

    def wait(self, budget_s: float) -> bool:
        """Poll until the blob lands (ok), the claim vanishes without a
        blob (leader failed — not ok), or the budget runs out."""
        deadline = time.monotonic() + max(budget_s, 0.0)
        while True:
            try:
                if self._gate.blob_present(self._blob):
                    self.done = self.ok = True
                    return True
                if self._gate.claim_holder(self._blob) is None:
                    # claim expired/released with no blob: leader died
                    self.done, self.ok = True, False
                    return True
            except RedisError as exc:
                # a flaky cache tier must not wedge the scan: treat as
                # "leader unknown" and let the caller analyze
                _log.warn("redis claim poll failed; degrading",
                          err=str(exc))
                self.done, self.ok = True, False
                return True
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            time.sleep(min(POLL_S, remaining))


class RedisLayerGate:
    """``LayerSingleflight``-shaped claim registry backed by redis, so
    the claim set is shared by every server on the cache tier."""

    def __init__(self, cache, ttl_s: float = 300.0):
        self._cache = cache          # RedisCache (owns the RespClient)
        self.ttl_s = ttl_s
        self._anon = f"srv-{os.getpid()}-{id(self):x}"

    # ------------------------------------------------------- primitives

    def _client(self):
        return self._cache._client

    @staticmethod
    def _key(blob_id: str) -> str:
        return CLAIM_PREFIX + blob_id

    def blob_present(self, blob_id: str) -> bool:
        return bool(self._client().execute(
            "EXISTS", f"{REDIS_PREFIX}::blob::{blob_id}"))

    def claim_holder(self, blob_id: str) -> str | None:
        raw = self._client().execute("GET", self._key(blob_id))
        if raw is None:
            return None
        return raw.decode() if isinstance(raw, bytes) else str(raw)

    # --------------------------------------------------------- protocol

    def claim(self, blob_id: str, src_cache=None,
              holder=None) -> tuple[object, bool]:
        """-> (slot, is_leader); mirrors LayerSingleflight.claim."""
        ident = holder or self._anon
        key = self._key(blob_id)
        try:
            ok = self._client().execute(
                "SET", key, ident, "NX", "EX", str(int(self.ttl_s)))
            if ok is not None:
                obs_metrics.FLEET_DEDUPE_CLAIMS.inc(outcome="leader")
                return _RemoteSlot(self, blob_id), True
            cur = self.claim_holder(blob_id)
            if cur is None:
                # expired between SET and GET: take it over
                self._client().execute(
                    "SET", key, ident, "EX", str(int(self.ttl_s)))
                obs_metrics.FLEET_DEDUPE_CLAIMS.inc(outcome="expired")
                return _RemoteSlot(self, blob_id), True
            if holder is not None and cur == holder:
                # a retried request re-leads its own claim (extend TTL)
                self._client().execute(
                    "SET", key, ident, "EX", str(int(self.ttl_s)))
                obs_metrics.FLEET_DEDUPE_CLAIMS.inc(outcome="leader")
                return _RemoteSlot(self, blob_id), True
        except RedisError as exc:
            # gate down ≠ scan down: caller analyzes (duplicate work,
            # correct results)
            _log.warn("redis claim failed; caller analyzes",
                      blob=blob_id, err=str(exc))
            return _RemoteSlot(self, blob_id), True
        obs_metrics.FLEET_DEDUPE_CLAIMS.inc(outcome="follower")
        return _RemoteSlot(self, blob_id), False

    def reclaim(self, blob_id: str, holder=None) -> None:
        """Take over a claim whose holder is presumed dead (a waiter
        timed out on it): overwrite with a fresh TTL so later callers
        park on this caller's live analysis, not the ghost's."""
        try:
            self._client().execute(
                "SET", self._key(blob_id), holder or self._anon,
                "EX", str(int(self.ttl_s)))
            obs_metrics.FLEET_DEDUPE_CLAIMS.inc(outcome="reclaim")
        except RedisError as exc:
            _log.warn("redis reclaim failed", blob=blob_id,
                      err=str(exc))

    def complete(self, blob_id: str) -> None:
        """A PutBlob landed in the shared cache: release the claim so
        followers (polling the blob key) resolve and later claimers
        lead cheaply."""
        try:
            self._client().execute("DEL", self._key(blob_id))
        except RedisError as exc:
            _log.warn("redis claim release failed (TTL will expire it)",
                      blob=blob_id, err=str(exc))

    def inflight(self) -> int:
        """Fleet-wide count of live claims (diagnostics)."""
        try:
            cursor, n = "0", 0
            while True:
                reply = self._client().execute(
                    "SCAN", cursor, "MATCH", CLAIM_PREFIX + "*",
                    "COUNT", "100")
                cursor = (reply[0].decode()
                          if isinstance(reply[0], bytes)
                          else str(reply[0]))
                n += len(reply[1] or [])
                if cursor == "0":
                    return n
        except RedisError:
            return 0


def maybe_distributed_gate(cache, ttl_s: float = 300.0):
    """A RedisLayerGate when `cache` is the redis backend (the shared
    cache tier of a replica set), else None (the in-process gate
    stays)."""
    from trivy_tpu_torch.cache.redis import RedisCache

    if isinstance(cache, RedisCache):
        return RedisLayerGate(cache, ttl_s=ttl_s)
    return None
