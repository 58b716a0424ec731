"""Unified observability spine (docs/observability.md); copy of
trivy_tpu/obs/__init__.py.

- `obs.metrics`: thread-safe labeled Counter/Gauge/Histogram registry
  with Prometheus text exposition; `obs.metrics.REGISTRY` holds the
  process-wide spine metrics.
- `obs.tracing`: contextvars-based distributed tracer — spans keep
  parentage across worker threads and over the RPC boundary
  (X-Trivy-Trace), export as Chrome trace-event JSON, and feed
  trace_id/span_id/scan_id into log records.
- `obs.attrib`: span-to-resource-lane bottleneck attribution + the
  slow-scan flight recorder (served at /debug/profile, /debug/flight;
  `trivy-tpu profile`).
- `obs.phase(...)`: the one-liner scan instrumentation point — a trace
  span AND a `trivy_tpu_scan_phase_seconds{phase=...}` observation from
  the same clock, so the trace tree, the histogram, and bench.py
  --phase-json all tell the same story. When a trace is live, the
  observation carries the trace id as an OpenMetrics exemplar — a p99
  bucket links to the exact trace that landed there.
"""

from __future__ import annotations

import contextlib
import time

from trivy_tpu_torch.obs import metrics, tracing
from trivy_tpu_torch.obs import attrib  # noqa: F401 — TRIVY_TPU_ATTRIB=1 self-installs

__all__ = ["metrics", "tracing", "attrib", "phase"]


@contextlib.contextmanager
def phase(span_name: str, phase: str | None = None, **meta):
    """Trace span + per-phase latency histogram in one breath. The
    histogram label defaults to the span name; pass `phase=` when the
    metric catalog name differs (e.g. span "apply_layers" is the
    "cache" phase)."""
    t0 = time.perf_counter()
    trace_id = ""
    try:
        with tracing.span(span_name, **meta) as s:
            if s is not None:
                trace_id = s.trace_id
            yield s
    finally:
        metrics.SCAN_PHASE_SECONDS.observe(
            time.perf_counter() - t0, exemplar=trace_id or None,
            phase=phase or span_name)
