"""Degrading drivers: remote-first scan with a local completion
guarantee.

FallbackDriver implements the scanner Driver protocol
(trivy_tpu_torch/scanner/scan.py) around a primary driver (typically
rpc.client.RemoteDriver). It degrades to a lazily-built LocalDriver when
the circuit breaker is open, the deadline budget is already exhausted,
or the primary scan fails — and records why in `degraded_reason`, which
Scanner.scan_artifact stamps into Report.metadata.degraded so consumers
can tell a fallback scan from a primary one.

FallbackCache mirrors every cache write into a local cache while
forwarding to the remote cache best-effort through the same breaker, so
the blobs a degraded scan needs are always present locally. Its
missing_blobs answer is the UNION of both sides' missing sets: a blob
the server already has but the mirror lacks is still (re)analyzed, which
keeps the local fallback self-sufficient.

Copy of trivy_tpu/resilience/fallback.py; FallbackDriver also exposes
the `stats` of the driver that answered the last scan. The local leg is
the port's LocalDriver on the device the caller resolved: it degrades
from the server to this process, never from the card to the CPU.
"""

from __future__ import annotations

from typing import Callable

from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.resilience.breaker import CircuitBreaker
from trivy_tpu_torch.resilience.retry import (
    DeadlineExceeded,
    current_deadline,
    deadline_scope,
)

_log = logger("resilience")


class FallbackDriver:
    """Driver that prefers `primary` and degrades to a local scan."""

    def __init__(self, primary, local_factory: Callable[[], object],
                 breaker: CircuitBreaker | None = None):
        self.primary = primary
        self._local_factory = local_factory
        self._local = None
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=3, recovery_s=30.0, name="rpc")
        self.degraded_reason: str | None = None

    @property
    def stats(self) -> dict:
        """Seconds of the last scan's phases, from the driver that
        answered it (a remote scan's ran on the server: none here)."""
        drv = self._local if self.degraded_reason else self.primary
        return getattr(drv, "stats", {})

    def local(self):
        if self._local is None:
            self._local = self._local_factory()
        return self._local

    def scan(self, target, artifact_key, blob_keys, options):
        self.degraded_reason = None
        reason = self._primary_blocked()
        if reason is None:
            try:
                out = self.primary.scan(
                    target, artifact_key, blob_keys, options)
            except DeadlineExceeded as exc:
                # the CALLER's budget ran out — that says nothing about
                # remote health, so it must not push the breaker open
                reason = str(exc)
            except Exception as exc:
                self.breaker.record_failure()
                reason = f"remote scan failed: {exc}"
            else:
                self.breaker.record_success()
                return out
        _log.warn("degrading to local scan", reason=reason)
        obs_metrics.DEGRADED_TOTAL.inc(component="driver")
        # the fallback is the completion guarantee: it runs with the
        # budget lifted (a deadlined local scan would shed at the next
        # checkpoint and the caller would get nothing at all)
        with deadline_scope(None):
            out = self.local().scan(target, artifact_key, blob_keys, options)
        self.degraded_reason = reason
        return out

    def _primary_blocked(self) -> str | None:
        d = current_deadline()
        if d is not None and d.expired:
            return (f"deadline budget ({d.budget_s:.3f}s) exhausted "
                    "before remote dispatch")
        if not self.breaker.allow():
            return (f"circuit breaker open "
                    f"(retry in {self.breaker.retry_in():.1f}s)")
        return None


class FallbackCache:
    """ArtifactCache that writes locally and forwards best-effort."""

    def __init__(self, remote, local, breaker: CircuitBreaker | None = None):
        self.remote = remote
        self.local = local
        self.breaker = breaker
        self._warned = False

    # ------------------------------------------------------------ writes

    def put_artifact(self, artifact_id: str, info) -> None:
        self.local.put_artifact(artifact_id, info)
        self._forward("put_artifact", artifact_id, info)

    def put_blob(self, blob_id: str, blob) -> None:
        self.local.put_blob(blob_id, blob)
        self._forward("put_blob", blob_id, blob)

    def delete_blobs(self, blob_ids: list[str]) -> None:
        self.local.delete_blobs(blob_ids)
        self._forward("delete_blobs", blob_ids)

    def _forward(self, method: str, *args) -> None:
        if self.breaker is not None and not self.breaker.allow():
            return  # open breaker: don't burn the budget on a dead remote
        try:
            getattr(self.remote, method)(*args)
        except Exception as exc:
            if self.breaker is not None:
                self.breaker.record_failure()
            obs_metrics.DEGRADED_TOTAL.inc(component="cache")
            if not self._warned:
                self._warned = True
                _log.warn("remote cache unavailable; mirroring locally",
                          op=method, err=str(exc))
        else:
            if self.breaker is not None:
                self.breaker.record_success()

    # ------------------------------------------------------------ reads

    def missing_blobs(self, artifact_id: str, blob_ids: list[str]):
        l_missing_a, l_missing = self.local.missing_blobs(
            artifact_id, blob_ids)
        if self.breaker is not None and not self.breaker.allow():
            return l_missing_a, l_missing
        try:
            r_missing_a, r_missing = self.remote.missing_blobs(
                artifact_id, blob_ids)
        except Exception as exc:
            if self.breaker is not None:
                self.breaker.record_failure()
            _log.warn("remote missing_blobs failed; using local answer",
                      err=str(exc))
            return l_missing_a, l_missing
        if self.breaker is not None:
            self.breaker.record_success()
        missing_set = set(r_missing) | set(l_missing)
        missing = [b for b in blob_ids if b in missing_set]
        return (r_missing_a or l_missing_a), missing

    def get_artifact(self, artifact_id: str) -> dict:
        return self.local.get_artifact(artifact_id)

    def get_blob(self, blob_id: str) -> dict:
        return self.local.get_blob(blob_id)

    def close(self) -> None:
        self.local.close()
        try:
            self.remote.close()
        except Exception:
            pass
