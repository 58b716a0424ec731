"""Per-request tenant identity (reference obs/usage.py).

The scan server opens one scope per admitted request, keyed by a hash
of the request's auth token; the match scheduler reads the scope of the
submitting thread to group waiting requests by tenant (per-tenant QoS,
sched/scheduler.py). Worker threads re-establish a captured scope with
`adopt`.

Copy of trivy_tpu/obs/usage.py:76-211 trimmed to the tenant identity:
no cost vector, no per-tenant registry, no journal, no metrics (the
metering is not ported yet).
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import os

ANONYMOUS = "anonymous"

_scope: contextvars.ContextVar["UsageScope | None"] = contextvars.ContextVar(
    "trivy_tpu_torch_usage_scope", default=None)


def enabled() -> bool:
    """TRIVY_TPU_USAGE=0 is the kill switch: no scopes are created, so
    every request counts as the anonymous tenant."""
    return os.environ.get("TRIVY_TPU_USAGE", "") not in ("0", "false")


def tenant_id(token: str | None) -> str:
    """Stable tenant key for an auth token: 16 hex chars of SHA-256.
    The raw token is never logged or exported — only this hash."""
    if not token:
        return ANONYMOUS
    return "t-" + hashlib.sha256(token.encode()).hexdigest()[:16]


class UsageScope:
    """One request's tenant."""

    __slots__ = ("tenant",)

    def __init__(self, tenant: str):
        self.tenant = tenant


def ambient() -> UsageScope | None:
    """The scope of the current context (None = no request scope)."""
    return _scope.get()


def capture() -> UsageScope | None:
    """Snapshot the ambient scope for adoption on another thread."""
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
    """Open a request scope for `tenant` (a tenant_id() hash). A no-op
    yielding None when TRIVY_TPU_USAGE=0."""
    if not enabled():
        yield None
        return
    s = UsageScope(tenant)
    token = _scope.set(s)
    try:
        yield s
    finally:
        _scope.reset(token)
