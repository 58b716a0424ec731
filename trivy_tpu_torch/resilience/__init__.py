"""Resilience layer of the port: deterministic fault injection, retry
policy with decorrelated jitter and per-scan deadline budgets.

Copy of trivy_tpu/resilience/__init__.py without the circuit breaker
and the degraded local fallback driver (`--fallback`), which are not
ported yet. Stdlib only.
"""

from trivy_tpu_torch.resilience.retry import (
    DEADLINE_HEADER,
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
    current_deadline,
    deadline_scope,
)

__all__ = [
    "DEADLINE_HEADER",
    "Deadline",
    "DeadlineExceeded",
    "RetryPolicy",
    "current_deadline",
    "deadline_scope",
]
