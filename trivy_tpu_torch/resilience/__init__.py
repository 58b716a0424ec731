"""Resilience layer of the port: deterministic fault injection, retry
policy with decorrelated jitter, per-scan deadline budgets, circuit
breaking, and the degraded local fallback driver (`--fallback`).

Copy of trivy_tpu/resilience/__init__.py; it also exports the fallback
driver and cache. Stdlib only.
"""

from trivy_tpu_torch.resilience.breaker import BreakerOpen, CircuitBreaker
from trivy_tpu_torch.resilience.fallback import FallbackCache, FallbackDriver
from trivy_tpu_torch.resilience.retry import (
    DEADLINE_HEADER,
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
    current_deadline,
    deadline_scope,
)

__all__ = [
    "BreakerOpen",
    "CircuitBreaker",
    "DEADLINE_HEADER",
    "Deadline",
    "DeadlineExceeded",
    "FallbackCache",
    "FallbackDriver",
    "RetryPolicy",
    "current_deadline",
    "deadline_scope",
]
