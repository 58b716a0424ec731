"""Compatibility shim: the tracer moved to `trivy_tpu_torch.obs.tracing`
(contextvars-based spans with trace/span ids, cross-thread and
cross-RPC parentage, Chrome trace export — see docs/observability.md).

Every historical call site (`from trivy_tpu_torch.utils import trace`) keeps
working; new code should import `trivy_tpu_torch.obs.tracing` directly.
"""

from trivy_tpu_torch.obs.tracing import (  # noqa: F401
    TRACE_HEADER,
    Span,
    add_meta,
    adopt,
    capture,
    chrome_events,
    current,
    current_scan_id,
    enable,
    enabled,
    export_chrome,
    inject_headers,
    parse_trace_header,
    render,
    reset,
    scan_scope,
    server_span,
    set_slow_span_ms,
    span,
    spans,
    timings,
    torch_profile,
)
