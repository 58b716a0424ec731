"""Context-propagating distributed tracing for the scan spine.

Rebuilt from the thread-local `utils/trace.py` seed on `contextvars`:

- Spans carry 128-bit trace ids and 64-bit span ids; children inherit
  the trace id and record their parent's span id, so worker threads
  (`utils/pipeline.py` adopts the submitting context) and fleet lanes
  attach to the submitting scan's span instead of becoming orphaned
  roots.
- The current (trace_id, span_id) propagates over the RPC boundary via
  the `X-Trivy-Trace` header: the client injects it per request, the
  server adopts it as the parent of its handler span, and because ids
  are shared, a remote scan renders as ONE stitched tree (`render()`
  grafts any collected root under the collected span it names as
  parent — in-process client/server tests see the full picture; across
  processes the ids still join via logs and exports).
- `export_chrome(path)` writes Chrome trace-event JSON ("traceEvents"
  with `ph: "X"` complete events) viewable in Perfetto / chrome://tracing.
- A scan id (one per scan_artifact / fleet artifact) rides a second
  contextvar; `log_fields()` hands trace_id/span_id/scan_id to log.py
  so every log line joins the trace.
- `TRIVY_TPU_SLOW_SPAN_MS` logs any span exceeding the threshold even
  when tracing is off (spans then time themselves but collect nothing).

Enabled via --trace / --trace-export (CLI) or TRIVY_TPU_TRACE=1; a
torch.profiler trace of each scan's driver call is written when
TRIVY_TPU_JAX_TRACE_DIR is set (the reference's variable name).

Copy of trivy_tpu/obs/tracing.py; `torch_profile` takes the place of
the reference's `jax_profile`.

Usage:
    with trace.span("scan"):
        with trace.span("inspect"): ...
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
from dataclasses import dataclass, field

from trivy_tpu_torch.analysis.witness import make_lock

TRACE_HEADER = "X-Trivy-Trace"

_enabled = os.environ.get("TRIVY_TPU_TRACE", "") not in ("", "0", "false")


def _env_slow_ms() -> float | None:
    raw = os.environ.get("TRIVY_TPU_SLOW_SPAN_MS", "")
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


_slow_ms: float | None = _env_slow_ms()


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def set_slow_span_ms(ms: float | None) -> None:
    """Override the TRIVY_TPU_SLOW_SPAN_MS threshold (None disables)."""
    global _slow_ms
    _slow_ms = ms


@dataclass
class Span:
    name: str
    trace_id: str = ""
    span_id: str = ""
    parent_id: str = ""
    start: float = 0.0      # perf_counter, for elapsed
    start_ts: float = 0.0   # epoch seconds, for exports
    elapsed: float = 0.0
    tid: int = 0
    children: list["Span"] = field(default_factory=list)
    meta: dict = field(default_factory=dict)


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


# current span + scan id are contextvars: worker threads start from an
# empty context, so nothing leaks between threads, and adopt()/attach()
# copy a captured context in explicitly where propagation is wanted
_current: contextvars.ContextVar[Span | None] = contextvars.ContextVar(
    "trivy_tpu_current_span", default=None)
_scan_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "trivy_tpu_scan_id", default="")
# remote parentage adopted from an incoming X-Trivy-Trace header: the
# next root span opened in this context joins the caller's trace
_remote_link: contextvars.ContextVar[tuple[str, str] | None] = \
    contextvars.ContextVar("trivy_tpu_remote_link", default=None)
# fleet attempt identity (attempt index, endpoint index, kind): set by
# the smart client around hedged/failed-over dispatches so the
# outgoing X-Trivy-Trace header tags WHICH attempt a server-side trace
# fragment belongs to — the cross-replica stitcher joins fragments by
# this tag (docs/observability.md "Fleet observability"). kind "hedge"
# marks a raced duplicate (the server-side tree is a FRAGMENT of one
# scan); kind "failover" marks a sequential retry whose tree is the
# scan's only server-side record and still counts as a scan.
_attempt_tag: contextvars.ContextVar[tuple[int, int, str] | None] = \
    contextvars.ContextVar("trivy_tpu_attempt_tag", default=None)

# finished root spans; generation guards reset() against spans still
# closing on other threads (their append is simply dropped)
_roots: list[Span] = []
_roots_lock = make_lock("obs.tracing._roots_lock")
_generation = 0

# the buffered-root ring bound: a long-running server with tracing on
# (--trace-export, TRIVY_TPU_TRACE=1) used to grow _roots without limit
# until exit; past this many buffered roots the OLDEST trace is dropped
# and counted in trivy_tpu_trace_spans_dropped_total (the export file
# carries the drop count, so a truncated trace is never mistaken for a
# complete one)
MAX_BUFFERED_ROOTS = 4096
_dropped = 0  # spans dropped since the last reset(); guarded by _roots_lock

# completed-root sink (obs.attrib): when set, spans collect and every
# finished ROOT trace is handed to the sink even while classic tracing
# is off — the attribution aggregator and flight recorder see whole
# trees without buffering anything in _roots
_sink = None


def set_sink(fn) -> None:
    """Install (or clear, fn=None) the completed-root-trace sink.
    Owned by obs.attrib — use attrib.acquire()/release() instead of
    calling this directly."""
    global _sink
    _sink = fn


def _span_count(root: Span) -> int:
    n = 0
    stack = [root]
    while stack:
        s = stack.pop()
        n += 1
        stack.extend(s.children)
    return n


def dropped_spans() -> int:
    """Spans evicted from the bounded root buffer since the last
    reset() (mirrored in trivy_tpu_trace_spans_dropped_total)."""
    with _roots_lock:
        return _dropped


class _Noop:
    """Reusable no-op context manager: the disabled-tracing fast path
    allocates nothing per span."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def span(name: str, **meta):
    if not _enabled and _slow_ms is None and _sink is None:
        return _NOOP
    return _span_cm(name, meta)


@contextlib.contextmanager
def _span_cm(name: str, meta: dict):
    sink = _sink
    collect = _enabled or sink is not None
    slow = _slow_ms
    s = Span(name=name, meta=meta, tid=threading.get_ident())
    token = None
    is_root = False
    gen = _generation
    if collect:
        parent = _current.get()
        if parent is not None:
            s.trace_id = parent.trace_id
            s.parent_id = parent.span_id
            parent.children.append(s)  # GIL-atomic append
        else:
            is_root = True
            link = _remote_link.get()
            if link is not None:
                # adopted remote parentage: still collected as a local
                # root; render() stitches it under the caller's span
                # when that span was collected in this process
                s.trace_id, s.parent_id = link
            else:
                s.trace_id = _new_trace_id()
        s.span_id = _new_span_id()
        token = _current.set(s)
    s.start_ts = time.time()
    s.start = time.perf_counter()
    try:
        yield s
    finally:
        s.elapsed = time.perf_counter() - s.start
        if collect:
            _current.reset(token)
            if is_root:
                if _enabled:
                    evicted = None
                    with _roots_lock:
                        if gen == _generation:  # reset() since open: drop
                            _roots.append(s)
                            if len(_roots) > MAX_BUFFERED_ROOTS:
                                evicted = _roots.pop(0)
                    if evicted is not None:
                        # count the evicted tree OUTSIDE the lock (a
                        # large trace walk must not stall concurrent
                        # span closes), once for both sinks
                        n = _span_count(evicted)
                        global _dropped
                        with _roots_lock:
                            _dropped += n
                        _count_dropped(n)
                if sink is not None:
                    try:
                        sink(s)
                    except Exception:
                        # a broken profiler sink must never break the
                        # scan that produced the trace
                        pass
        if slow is not None and s.elapsed * 1000.0 >= slow:
            _log_slow(s)


def _count_dropped(n: int) -> None:
    # lazy import: metrics never imports tracing, but the package
    # __init__ imports both and the counter is only needed on the rare
    # eviction path
    from trivy_tpu_torch.obs import metrics as _metrics

    _metrics.TRACE_SPANS_DROPPED.inc(n)


def _log_slow(s: Span) -> None:
    from trivy_tpu_torch.log import logger  # lazy: log.py lazily imports us

    kv = {"ms": round(s.elapsed * 1000.0, 1)}
    if s.trace_id:
        kv["trace_id"] = s.trace_id
        kv["span_id"] = s.span_id
    logger("trace").warn(f"slow span: {s.name}", **kv)


def add_meta(**meta) -> None:
    s = _current.get()
    if _enabled and s is not None:
        s.meta.update(meta)


def current() -> Span | None:
    """The innermost open span of this context (None when tracing is
    off or no span is open)."""
    return _current.get()


def current_scan_id() -> str:
    return _scan_id.get()


def log_fields() -> dict | None:
    """trace_id/span_id/scan_id for log correlation (only the fields
    that are set; None when there is nothing to report)."""
    s = _current.get()
    sid = _scan_id.get()
    if s is None and not sid:
        return None
    out: dict = {}
    if s is not None:
        out["trace_id"] = s.trace_id
        out["span_id"] = s.span_id
    if sid:
        out["scan_id"] = sid
    return out


# ------------------------------------------------------- cross-thread

def capture():
    """Snapshot the ambient trace context (current span + scan id) in
    the submitting thread; hand the result to adopt() inside a worker
    thread so its spans attach to the submitting scan instead of
    becoming orphaned roots. Cheap: two contextvar reads."""
    s = _current.get()
    sid = _scan_id.get()
    link = _remote_link.get()
    if s is None and not sid and link is None:
        return None
    return (s, sid, link)


@contextlib.contextmanager
def adopt(captured):
    """Install a capture()d context in this thread for the duration."""
    if captured is None:
        yield
        return
    s, sid, link = captured
    tokens = []
    if s is not None:
        tokens.append((_current, _current.set(s)))
    if sid:
        tokens.append((_scan_id, _scan_id.set(sid)))
    if link is not None:
        tokens.append((_remote_link, _remote_link.set(link)))
    try:
        yield
    finally:
        for var, token in reversed(tokens):
            var.reset(token)


@contextlib.contextmanager
def scan_scope(scan_id: str | None = None, force: bool = False):
    """Make a scan id ambient for log correlation. An id already in
    scope is kept unless `force` (fleet lanes force one per artifact;
    the scanner then inherits it)."""
    if scan_id is None:
        if _scan_id.get() and not force:
            yield _scan_id.get()
            return
        from trivy_tpu_torch.utils import uuid as uuid_util

        scan_id = uuid_util.new()
    token = _scan_id.set(scan_id)
    try:
        yield scan_id
    finally:
        _scan_id.reset(token)


# --------------------------------------------------------- RPC boundary

def inject_headers(headers: dict) -> None:
    """Client side: stamp the current span's identity into the outgoing
    request so the server's spans join this trace. Under an
    :func:`attempt_scope` the header additionally carries
    ``-<attempt>.<endpoint>`` so the server-side fragment is
    attributable to ONE dispatch of a hedged/failed-over request."""
    s = _current.get()
    if (_enabled or _sink is not None) and s is not None:
        value = f"{s.trace_id}-{s.span_id}"
        tag = _attempt_tag.get()
        if tag is not None:
            value += f"-{tag[0]}.{tag[1]}"
            if tag[2] == "failover":
                value += ".f"
        headers[TRACE_HEADER] = value


@contextlib.contextmanager
def attempt_scope(attempt: int, endpoint: int, kind: str = "hedge"):
    """Tag every request injected inside this scope with its fleet
    dispatch identity (attempt index + endpoint index). The smart
    client opens one scope per hedged (kind="hedge") or failed-over
    (kind="failover") dispatch; plain single-dispatch requests stay
    untagged (byte-identical header)."""
    token = _attempt_tag.set((int(attempt), int(endpoint), kind))
    try:
        yield
    finally:
        _attempt_tag.reset(token)


def current_attempt_tag() -> tuple[int, int, str] | None:
    """The ambient fleet dispatch identity, or None outside an
    attempt_scope (the RPC client stamps it onto its span meta so the
    stitched cross-replica trace shows which attempt each client-side
    round trip belonged to)."""
    return _attempt_tag.get()


def parse_trace_header(value: str | None) -> tuple[str, str] | None:
    """'<32-hex trace>-<16-hex span>[-<attempt>.<endpoint>]' ->
    (trace_id, parent_span_id). The optional third segment (a fleet
    attempt tag) is parsed separately by :func:`parse_attempt_tag`."""
    if not value:
        return None
    parts = value.split("-")
    if len(parts) < 2 or not parts[0] or not parts[1]:
        return None
    trace_id, span_id = parts[0], parts[1]
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    return trace_id, span_id


def parse_attempt_tag(value: str | None) -> tuple[int, int, str] | None:
    """The '<attempt>.<endpoint>[.f]' segment of an extended trace
    header -> (attempt_index, endpoint_index, kind) where kind is
    "failover" for the ``.f`` suffix and "hedge" otherwise, or None
    when the header is the legacy two-part form (or malformed — never
    an error: tagging only enriches, correctness never depends on
    it)."""
    if not value:
        return None
    parts = value.split("-")
    if len(parts) < 3:
        return None
    fields = parts[2].split(".")
    if len(fields) < 2:
        return None
    try:
        attempt, endpoint = int(fields[0]), int(fields[1])
    except ValueError:
        return None
    kind = "failover" if fields[2:3] == ["f"] else "hedge"
    return attempt, endpoint, kind


@contextlib.contextmanager
def server_span(name: str, header: str | None, **meta):
    """Server side: open a handler span whose parent is the caller's
    span from the X-Trivy-Trace header (fresh root when absent)."""
    link = parse_trace_header(header)
    token = _remote_link.set(link) if link is not None else None
    try:
        with span(name, **meta) as s:
            yield s
    finally:
        if token is not None:
            _remote_link.reset(token)


# ------------------------------------------------------------ lifecycle

def reset() -> None:
    """Drop every collected span, process-wide. Safe to call from any
    thread while spans are open elsewhere (their eventual close is
    discarded by the generation guard) and idempotent when tracing is
    disabled."""
    global _generation, _dropped
    with _roots_lock:
        _generation += 1
        _roots.clear()
        _dropped = 0


def _stitched_roots() -> tuple[list[Span], dict[str, list[Span]]]:
    """Snapshot of collected roots, with roots that name a collected
    span as parent grafted under it (the client RPC span adopts the
    server handler span). Non-destructive: the graft lives in the
    returned extra-children map, not in Span.children."""
    with _roots_lock:
        roots = list(_roots)
    by_id: dict[str, Span] = {}

    def index(s: Span):
        by_id[s.span_id] = s
        for c in s.children:
            index(c)

    for r in roots:
        index(r)
    extra: dict[str, list[Span]] = {}
    top: list[Span] = []
    for r in roots:
        parent = by_id.get(r.parent_id) if r.parent_id else None
        if parent is not None and parent is not r:
            extra.setdefault(parent.span_id, []).append(r)
        else:
            top.append(r)
    return top, extra


def render(out=None) -> str:
    """Render collected spans as an indented tree with timings."""
    lines: list[str] = []
    top, extra = _stitched_roots()

    def walk(s: Span, depth: int):
        extras = "".join(f" {k}={v}" for k, v in s.meta.items())
        lines.append(f"{'  ' * depth}{s.name:<{28 - 2 * depth}} "
                     f"{s.elapsed * 1000:9.1f} ms{extras}")
        for c in s.children:
            walk(c, depth + 1)
        for c in extra.get(s.span_id, ()):
            walk(c, depth + 1)

    for root in top:
        walk(root, 0)
    text = "\n".join(lines)
    if out is not None and text:
        out.write("-- trace " + "-" * 42 + "\n" + text + "\n")
    return text


def spans() -> list[Span]:
    """Flat list of every collected span (roots first, then children)."""
    out: list[Span] = []

    def walk(s: Span):
        out.append(s)
        for c in s.children:
            walk(c)

    with _roots_lock:
        roots = list(_roots)
    for r in roots:
        walk(r)
    return out


def timings() -> dict[str, float]:
    """Aggregate elapsed seconds per span name across the collection —
    the per-phase breakdown bench.py --phase-json dumps."""
    agg: dict[str, float] = {}
    for s in spans():
        agg[s.name] = agg.get(s.name, 0.0) + s.elapsed
    return {k: round(v, 6) for k, v in agg.items()}


def chrome_events(span_list: list[Span] | None = None) -> list[dict]:
    """Chrome trace-event 'complete' (ph=X) events for every collected
    span (or an explicit span list — the flight recorder exports its
    retained traces this way); timestamps in microseconds since epoch."""
    events = []
    for s in (spans() if span_list is None else span_list):
        args = {"trace_id": s.trace_id, "span_id": s.span_id}
        if s.parent_id:
            args["parent_id"] = s.parent_id
        args.update({k: str(v) for k, v in s.meta.items()})
        events.append({
            "name": s.name,
            "ph": "X",
            "ts": round(s.start_ts * 1e6, 1),
            "dur": round(s.elapsed * 1e6, 1),
            "pid": os.getpid(),
            "tid": s.tid,
            "cat": "trivy_tpu",
            "args": args,
        })
    return events


def export_chrome(path: str) -> int:
    """Write the collected spans as Chrome trace-event JSON (open in
    Perfetto / chrome://tracing). Returns the number of events."""
    events = chrome_events()
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           # bounded-buffer honesty: spans evicted by the root ring
           # since the last reset — non-zero means this file is a
           # truncated window, not the whole run
           "spansDropped": dropped_spans()}
    # a user-requested --trace-export artifact, not program state: no
    # atomic write
    # lint: allow[atomic-write] user-requested --trace-export artifact, not program state
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return len(events)


class ProfilerActive(RuntimeError):
    """A device profile was asked for while a torch.profiler session is
    already running in this process (profiler sessions do not nest)."""


#: the reference's knob name, kept so a user's setup carries over
PROFILE_DIR_ENV = "TRIVY_TPU_JAX_TRACE_DIR"
# device profiles captured in this process (torch_profile), the first 1
_profile_sessions = 0
_profile_lock = make_lock("obs.tracing._profile_lock")


@contextlib.contextmanager
def torch_profile():
    """Capture a torch.profiler trace (CPU and, with a card, CUDA
    activities) when TRIVY_TPU_JAX_TRACE_DIR is set, and write it as one
    Chrome trace per call into that directory (viewable in Perfetto /
    chrome://tracing). The reference's `jax_profile`; the variable
    keeps the reference's name. Raises ProfilerActive when a profiler
    session is already running on this thread, as
    `jax.profiler.start_trace` raises on a running trace: the capture
    never skips silently. On an H100 only a process's first profiler
    session is known to hold every kernel event: later ones lose some or
    all of them (PERF.md), so profile a CLI scan, one per process,
    rather than a long-lived server's. Every capture after the process's
    first logs a warning, and each trace records its session number
    under the metadata key `trivy_tpu_profile_session`."""
    global _profile_sessions
    trace_dir = os.environ.get(PROFILE_DIR_ENV, "")
    if not trace_dir:
        yield
        return
    import torch

    if torch._C._autograd._profiler_enabled():
        raise ProfilerActive(
            f"{PROFILE_DIR_ENV} is set but a torch.profiler session is "
            "already active on this thread")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with _profile_lock:
        _profile_sessions += 1
        session = _profile_sessions
    if session > 1:
        from trivy_tpu_torch.log import logger  # lazy: log.py imports us

        logger("trace").warn(
            "device profile after this process's first: a later "
            "torch.profiler session may lose kernel events on a CUDA "
            "card, so this trace may be incomplete", session=session)
    with torch.profiler.profile(activities=activities) as prof:
        prof.add_metadata("trivy_tpu_profile_session", str(session))
        yield
    path = os.path.join(
        trace_dir, f"trivy-tpu-{os.getpid()}-{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
