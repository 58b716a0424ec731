"""Cross-request continuous batching: the server-side match scheduler
that coalesces concurrent scans' detect batches into shared device
micro-batches (copy of trivy_tpu/sched/__init__.py)."""

from trivy_tpu_torch.sched.scheduler import (
    DEFAULT_MAX_QUEUE,
    DEFAULT_MAX_ROWS,
    DEFAULT_WINDOW_MS,
    MatchScheduler,
    Overloaded,
    SchedEngine,
    enabled,
)

__all__ = [
    "DEFAULT_MAX_QUEUE",
    "DEFAULT_MAX_ROWS",
    "DEFAULT_WINDOW_MS",
    "MatchScheduler",
    "Overloaded",
    "SchedEngine",
    "enabled",
]
