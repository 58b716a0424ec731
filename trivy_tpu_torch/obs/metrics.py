"""Copy of trivy_tpu/obs/metrics.py: the names, HELP texts and label
sets are the reference's byte for byte (the `fleet_*` and controller
metrics included, emitted by the port's fleet/ modules), so dashboards
read both packages alike.

Labeled metrics registry with Prometheus text exposition.

One `Registry` holds `Counter` / `Gauge` / `Histogram` metrics, each with
a fixed label-name tuple and a bounded number of label-value series (a
runaway label set raises `CardinalityError` instead of silently eating
RSS). All mutation and the exposition render share ONE re-entrant lock
per registry, so `render()` is a consistent snapshot — concurrent scans
cannot produce torn reads of related counters, and multi-field updates
(e.g. the server's scans_total + scan_seconds_sum) can be grouped under
`registry.locked()`.

Two scopes exist by convention:

- `REGISTRY` (module-level): process-wide spine metrics — scan-phase
  latency, RPC client round-trips, retries, breaker state, degraded
  activations, fault-injector fires, cache corruption.
- per-service registries: the RPC server's `Metrics` keeps its own so a
  fresh `Server` starts from zero (tests spin several per process); its
  /metrics response concatenates both scopes.

The exposition writer emits `# HELP` / `# TYPE` for every registered
metric (even before the first sample) in the Prometheus text format
0.0.4 the `/metrics` endpoint advertises.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable

from trivy_tpu_torch.analysis.witness import make_lock

# Fixed default latency buckets (seconds): micro-phases up to the
# 60 s north-star crawl budget.
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0,
)

DEFAULT_MAX_SERIES = 256


class MetricError(ValueError):
    """Metric misuse: bad labels, type clash, duplicate registration."""


class CardinalityError(MetricError):
    """A metric grew more label-value series than its bound allows."""


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render as integers,
    the rest in shortest-round-trip-ish form (0.75 -> "0.75")."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return format(v, ".10g")


def _escape(value: str) -> str:
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _labels_text(names: tuple[str, ...], values: tuple[str, ...],
                 extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Metric:
    """Common series bookkeeping; subclasses define the sample shape."""

    kind = "untyped"

    def __init__(self, registry: "Registry", name: str, help_text: str,
                 labels: tuple[str, ...], max_series: int,
                 collapse_label: tuple[str, int] | None = None):
        self.registry = registry
        self.name = name
        self.help = help_text
        self.label_names = labels
        self.max_series = max_series
        self.collapse_label = collapse_label
        self._collapse_seen: set[str] = set()
        self._series: dict[tuple[str, ...], object] = {}

    def _materialize_unlabeled(self) -> None:
        # an unlabeled metric exposes its zero sample immediately (the
        # hand-rolled server Metrics always rendered "name 0"); labeled
        # metrics stay empty until a label set is first used
        if not self.label_names:
            self._series[()] = self._new_state()

    def _key(self, labels: dict) -> tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise MetricError(
                f"{self.name}: got labels {sorted(labels)!r}, declared "
                f"{sorted(self.label_names)!r}")
        return tuple(str(labels[n]) for n in self.label_names)

    def _collapse(self, key: tuple[str, ...],
                  register: bool = True) -> tuple[str, ...]:
        """Top-N-collapse policy: once `collapse_label=(name, N)` has
        seen N distinct values for that label, every new value is
        rewritten to "other" instead of growing a fresh series — an
        unbounded public label (e.g. tenant) can then never trip
        CardinalityError. No collapse_label (the default) leaves the
        key — and the legacy exposition bytes — untouched.
        `register=False` applies the rewrite without admitting a new
        value (reads must not consume top-N slots)."""
        if self.collapse_label is None:
            return key
        lname, n = self.collapse_label
        try:
            i = self.label_names.index(lname)
        except ValueError:
            return key
        v = key[i]
        if v == "other" or v in self._collapse_seen:
            return key
        if len(self._collapse_seen) >= n:
            return key[:i] + ("other",) + key[i + 1:]
        if register:
            self._collapse_seen.add(v)
        return key

    def _slot(self, labels: dict) -> tuple[str, ...]:
        """Get-or-create the series state for a label set; returns the
        series key (the one label-validation pass per update). Caller
        holds the registry lock."""
        key = self._collapse(self._key(labels))
        if key not in self._series:
            if len(self._series) >= self.max_series:
                raise CardinalityError(
                    f"{self.name}: more than {self.max_series} label "
                    f"sets (runaway label values? latest: {key!r})")
            self._series[key] = self._new_state()
        return key

    def _new_state(self):
        raise NotImplementedError

    def clear(self) -> None:
        with self.registry._lock:
            self._series.clear()
            self._collapse_seen.clear()

    # rendering -------------------------------------------------------

    def _om_family(self) -> tuple[str, str]:
        """(family name, type) for the OpenMetrics metadata lines.
        OpenMetrics names a counter FAMILY without the `_total` suffix
        (samples keep it); a counter whose name cannot be suffixed that
        way (legacy `*_seconds_sum`) degrades to `unknown`, which has
        no naming constraints — the sample names themselves never
        change in either exposition."""
        if self.kind == "counter":
            if self.name.endswith("_total"):
                return self.name[: -len("_total")], "counter"
            return self.name, "unknown"
        return self.name, self.kind

    def _render(self, out: list[str], om: bool = False) -> None:
        if om:
            family, kind = self._om_family()
            out.append(f"# HELP {family} {self.help}")
            out.append(f"# TYPE {family} {kind}")
        else:
            out.append(f"# HELP {self.name} {self.help}")
            out.append(f"# TYPE {self.name} {self.kind}")
        for key in sorted(self._series):
            self._render_series(out, key, self._series[key], om=om)

    def _render_series(self, out: list[str], key, state,
                       om: bool = False) -> None:
        out.append(
            f"{self.name}{_labels_text(self.label_names, key)} "
            f"{_fmt(state)}")


class Counter(_Metric):
    kind = "counter"

    def _new_state(self) -> float:
        return 0.0

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise MetricError(f"{self.name}: counters only go up")
        with self.registry._lock:
            self._series[self._slot(labels)] += amount

    def value(self, **labels) -> float:
        with self.registry._lock:
            key = self._collapse(self._key(labels), register=False)
            return float(self._series.get(key, 0.0))


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._fn: Callable[[], float] | None = None

    def _new_state(self) -> float:
        return 0.0

    def set(self, value: float, **labels) -> None:
        with self.registry._lock:
            self._series[self._slot(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self.registry._lock:
            self._series[self._slot(labels)] += amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Evaluate `fn` at render time (unlabeled gauges only) — for
        values derived from ambient state, e.g. DB generation age."""
        if self.label_names:
            raise MetricError(
                f"{self.name}: set_function needs an unlabeled gauge")
        self._fn = fn

    def value(self, **labels) -> float:
        with self.registry._lock:
            if self._fn is not None:
                return float(self._fn())
            return float(self._series.get(self._key(labels), 0.0))

    def _render(self, out: list[str], om: bool = False) -> None:
        if self._fn is not None:
            try:
                val = float(self._fn())
            except Exception:
                return  # a broken callback must not break /metrics
            out.append(f"# HELP {self.name} {self.help}")
            out.append(f"# TYPE {self.name} {self.kind}")
            out.append(f"{self.name} {_fmt(val)}")
            return
        super()._render(out, om=om)


class _HistState:
    __slots__ = ("counts", "total", "count", "exemplars")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # cumulative at render, raw here
        self.total = 0.0
        self.count = 0
        # per-raw-bucket (trace_id, value, epoch_ts) — the last traced
        # observation that landed in each bucket; only materialized
        # once an exemplar is actually recorded, rendered only in the
        # OpenMetrics exposition (the 0.0.4 bytes never change)
        self.exemplars: list | None = None


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, registry, name, help_text, labels, max_series,
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(registry, name, help_text, labels, max_series)
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise MetricError(f"{name}: histogram needs >= 1 bucket")
        if len(set(bounds)) != len(bounds):
            raise MetricError(f"{name}: duplicate bucket bounds")
        self.buckets = tuple(bounds)

    def _new_state(self) -> _HistState:
        return _HistState(len(self.buckets) + 1)  # +1 for +Inf

    def observe(self, value: float, exemplar: str | None = None,
                **labels) -> None:
        """Record one observation. `exemplar` is an optional trace id:
        the OpenMetrics exposition links the bucket this value lands in
        to that trace (`... # {trace_id="…"} value ts`), so a p99
        bucket names the exact scan that put it there."""
        value = float(value)
        with self.registry._lock:
            state: _HistState = self._series[self._slot(labels)]  # type: ignore[assignment]
            i = 0
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    break
            else:
                i = len(self.buckets)
            state.counts[i] += 1
            state.total += value
            state.count += 1
            if exemplar:
                if state.exemplars is None:
                    state.exemplars = [None] * len(state.counts)
                state.exemplars[i] = (str(exemplar), value, time.time())

    def snapshot(self, **labels) -> tuple[list[int], float, int]:
        """(cumulative bucket counts incl. +Inf, sum, count)."""
        with self.registry._lock:
            state = self._series.get(self._key(labels))
            if state is None:
                return [0] * (len(self.buckets) + 1), 0.0, 0
            cum, running = [], 0
            for c in state.counts:
                running += c
                cum.append(running)
            return cum, state.total, state.count

    @staticmethod
    def _exemplar_text(state: _HistState, i: int, om: bool) -> str:
        if not om or state.exemplars is None or state.exemplars[i] is None:
            return ""
        trace_id, value, ts = state.exemplars[i]
        return (f' # {{trace_id="{_escape(trace_id)}"}} '
                f"{_fmt(value)} {ts:.3f}")

    def _render_series(self, out: list[str], key,
                       state: _HistState, om: bool = False) -> None:
        running = 0
        for i, (bound, c) in enumerate(zip(self.buckets, state.counts)):
            running += c
            out.append(
                f"{self.name}_bucket"
                f"{_labels_text(self.label_names, key, (('le', _fmt(bound)),))}"
                f" {running}" + self._exemplar_text(state, i, om))
        running += state.counts[-1]
        out.append(
            f"{self.name}_bucket"
            f"{_labels_text(self.label_names, key, (('le', '+Inf'),))}"
            f" {running}"
            + self._exemplar_text(state, len(self.buckets), om))
        lbl = _labels_text(self.label_names, key)
        out.append(f"{self.name}_sum{lbl} {_fmt(state.total)}")
        out.append(f"{self.name}_count{lbl} {state.count}")


class Registry:
    """A named, typed metric namespace with one lock for everything."""

    def __init__(self):
        # RLock: multi-metric updates group under locked() while each
        # single inc stays safe on its own
        self._lock = make_lock("obs.metrics._lock", threading.RLock())
        self._metrics: dict[str, _Metric] = {}

    def locked(self):
        """Hold the registry lock across several updates so a concurrent
        render can't observe them half-applied."""
        return self._lock

    def _register(self, cls, name: str, help_text: str,
                  labels: tuple[str, ...], max_series: int,
                  **kwargs) -> _Metric:
        labels = tuple(labels)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.label_names != labels):
                    raise MetricError(
                        f"metric {name!r} re-registered with a different "
                        "type or label set")
                return existing
            m = cls(self, name, help_text, labels, max_series, **kwargs)
            m._materialize_unlabeled()
            self._metrics[name] = m
            return m

    def counter(self, name: str, help_text: str,
                labels: tuple[str, ...] = (),
                max_series: int = DEFAULT_MAX_SERIES,
                collapse_label: tuple[str, int] | None = None) -> Counter:
        return self._register(Counter, name, help_text, labels, max_series,
                              collapse_label=collapse_label)

    def gauge(self, name: str, help_text: str,
              labels: tuple[str, ...] = (),
              max_series: int = DEFAULT_MAX_SERIES,
              collapse_label: tuple[str, int] | None = None) -> Gauge:
        return self._register(Gauge, name, help_text, labels, max_series,
                              collapse_label=collapse_label)

    def histogram(self, name: str, help_text: str,
                  labels: tuple[str, ...] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS,
                  max_series: int = DEFAULT_MAX_SERIES) -> Histogram:
        return self._register(Histogram, name, help_text, labels,
                              max_series, buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def render(self) -> bytes:
        """Prometheus text exposition 0.0.4, generated under ONE lock
        acquisition: the response is a consistent point-in-time snapshot
        even while scans are incrementing counters concurrently."""
        out: list[str] = []
        with self._lock:
            for name in self._metrics:  # registration order is stable
                self._metrics[name]._render(out)
        return ("\n".join(out) + "\n").encode()

    def render_openmetrics(self, eof: bool = True) -> bytes:
        """OpenMetrics-flavored exposition: the same series as
        :meth:`render` plus trace-id **exemplars** on histogram buckets
        and the `# EOF` terminator. Served from `/metrics` only under
        `Accept: application/openmetrics-text` content negotiation —
        the default 0.0.4 bytes never change (golden-tested).
        `eof=False` lets a caller concatenate several registries into
        one exposition with a single terminator."""
        out: list[str] = []
        with self._lock:
            for name in self._metrics:
                self._metrics[name]._render(out, om=True)
        text = "\n".join(out) + "\n"
        if eof:
            text += "# EOF\n"
        return text.encode()


# ---------------------------------------------------------------- spine

REGISTRY = Registry()

SCAN_PHASE_SECONDS = REGISTRY.histogram(
    "trivy_tpu_scan_phase_seconds",
    "Wall-clock seconds per scan phase (inspect/cache/detect/secret/report)",
    labels=("phase",))
RPC_CLIENT_SECONDS = REGISTRY.histogram(
    "trivy_tpu_rpc_client_seconds",
    "RPC client round-trip seconds per attempt, by twirp method",
    labels=("method",))
RETRY_ATTEMPTS = REGISTRY.counter(
    "trivy_tpu_retry_attempts_total",
    "RPC retry attempts (excludes each call's first attempt)",
    labels=("method",))
DEGRADED_TOTAL = REGISTRY.counter(
    "trivy_tpu_degraded_total",
    "Degraded-mode activations by component "
    "(driver=local fallback scan, cache=local-only mirror, "
    "engine=host-oracle after device loss, "
    "secret=host scanner after a device-screen failure)",
    labels=("component",))
FAULT_FIRES = REGISTRY.counter(
    "trivy_tpu_fault_injections_total",
    "Fault-injector rule firings by configured site and action",
    labels=("site", "action"))
BREAKER_STATE = REGISTRY.gauge(
    "trivy_tpu_breaker_state",
    "Circuit breaker state (0=closed, 1=half-open, 2=open)",
    labels=("name",))
BREAKER_TRANSITIONS = REGISTRY.counter(
    "trivy_tpu_breaker_transitions_total",
    "Circuit breaker transitions into each state",
    labels=("name", "state"))
CACHE_CORRUPT = REGISTRY.counter(
    "trivy_tpu_cache_corrupt_total",
    "Corrupt cache entries evicted (self-healing reads)")
COMPILE_CACHE_HITS = REGISTRY.counter(
    "trivy_tpu_compile_cache_hits_total",
    "Compiled advisory-DB tensor sets loaded from the persistent cache "
    "(warm start skipped a full recompile)")
COMPILE_CACHE_MISSES = REGISTRY.counter(
    "trivy_tpu_compile_cache_misses_total",
    "Compiled-DB cache lookups that fell back to a full recompile "
    "(absent, parameter mismatch, or corrupt-quarantined entry)")
PIPELINE_OCCUPANCY = REGISTRY.gauge(
    "trivy_tpu_pipeline_occupancy",
    "Fraction of the last pipelined crawl's wall-clock x stages the "
    "executor's stages were busy (1.0 = encode/device/rescreen fully "
    "overlapped; ~1/3 = serial)")
ANALYSIS_PIPELINE_OCCUPANCY = REGISTRY.gauge(
    "trivy_tpu_analysis_pipeline_occupancy",
    "Fraction of the last layer-analysis pipeline's wall-clock x lanes "
    "the fetch/walk stages were busy (1.0 = fetch of layer N+1 fully "
    "overlapped with analysis of layer N; ~0.5 = serial)")
ANALYSIS_LANE_BUSY = REGISTRY.gauge(
    "trivy_tpu_analysis_lane_busy",
    "Per-lane busy fraction of the last multi-lane layer-analysis run "
    "(lane k's walk seconds / scan wall seconds; lane counts are "
    "clamped to 32 so the label set stays bounded)",
    labels=("lane",), max_series=40)
LAYERS_ANALYZED = REGISTRY.counter(
    "trivy_tpu_layers_analyzed_total",
    "Container layers actually walked+analyzed (cache misses that this "
    "process led)")
LAYER_DEDUPE_HITS = REGISTRY.counter(
    "trivy_tpu_layer_dedupe_hits_total",
    "Layers satisfied without analysis: content-addressed blob-cache "
    "hits plus singleflight followers that reused a concurrent scan's "
    "completed analysis")
LAYER_DEDUPE_INFLIGHT_WAITS = REGISTRY.counter(
    "trivy_tpu_layer_dedupe_inflight_waits_total",
    "Times a scan waited on another scan's in-flight analysis of the "
    "same layer instead of analyzing it itself (in-process singleflight "
    "and the server-side MissingBlobs gate)")
SCHED_BATCH_ROWS = REGISTRY.histogram(
    "trivy_tpu_sched_batch_rows",
    "Package-query rows per coalesced match-scheduler micro-batch",
    buckets=(64, 256, 1024, 4096, 16384, 65536, 262144))
SCHED_COALESCED = REGISTRY.histogram(
    "trivy_tpu_sched_coalesced_requests",
    "Distinct scan requests coalesced into one scheduler micro-batch",
    buckets=(1, 2, 4, 8, 16, 32, 64))
SCHED_QUEUE_DEPTH = REGISTRY.gauge(
    "trivy_tpu_sched_queue_depth",
    "Scan requests waiting in the match-scheduler submission queue")
SCHED_WAIT_SECONDS = REGISTRY.histogram(
    "trivy_tpu_sched_wait_seconds",
    "Queue wait from scheduler submission to first micro-batch dispatch",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 1.0, 5.0))
MESH_SHAPE = REGISTRY.gauge(
    "trivy_tpu_mesh_shape",
    "Serving-mesh topology by axis (axis=data: query-parallel groups, "
    "axis=db: advisory shards — GLOBAL across hosts on the distributed "
    "MeshDB, axis=hosts: DCN processes); absent/0 = single-chip path",
    labels=("axis",))
MESH_SHARD_DISPATCH_SECONDS = REGISTRY.histogram(
    "trivy_tpu_mesh_shard_dispatch_seconds",
    "Per-shard dispatch+collect wall seconds of the mesh match path "
    "(includes retries and the host fallback of a degraded shard)",
    labels=("shard",),
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             1.0, 5.0))
MESH_SHARD_RETRIES = REGISTRY.counter(
    "trivy_tpu_mesh_shard_retries_total",
    "Mesh shard dispatches retried after a shard-local failure "
    "(before any degradation)",
    labels=("shard",))
MESH_SHARD_DEGRADATIONS = REGISTRY.counter(
    "trivy_tpu_mesh_shard_degradations_total",
    "Mesh shards degraded to the host oracle after retries were "
    "exhausted or the shard's device was lost (zero finding diff; the "
    "healthy shards keep serving on-device)",
    labels=("shard",))
MESH_RERESOLVES = REGISTRY.counter(
    "trivy_tpu_mesh_reresolves_total",
    "Explicit control-plane mesh recoveries (the fleet controller's "
    "mesh_reresolve action): scope=shard re-residented degraded local "
    "shard slices on their devices, scope=host re-partitioned the "
    "distributed MeshDB over surviving DCN hosts",
    labels=("scope",))
DCN_HOST_DISPATCH_SECONDS = REGISTRY.histogram(
    "trivy_tpu_dcn_host_dispatch_seconds",
    "Per-remote-host dispatch+collect wall seconds of the distributed "
    "MeshDB (the cross-host wait, incl. retries; a degraded host's "
    "mask recompute is in the merge, not here)",
    labels=("host",),
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             1.0, 5.0, 30.0))
DCN_HOST_DEGRADATIONS = REGISTRY.counter(
    "trivy_tpu_dcn_host_degradations_total",
    "Remote hosts whose whole advisory slice degraded to the "
    "coordinator's bit-identical host mask (worker death, transport "
    "timeout, or injected engine.host fault; surviving hosts keep "
    "serving on-device, zero finding diff)",
    labels=("host",))
DCN_MERGE_SECONDS = REGISTRY.histogram(
    "trivy_tpu_dcn_merge_seconds",
    "Coordinator-side merge of per-host shard bitmaps into the global "
    "mask stack the host-merge decoder consumes (unpack + degraded-"
    "host mask recompute)",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 1.0))
DELTA_DIFF_SECONDS = REGISTRY.histogram(
    "trivy_tpu_delta_diff_seconds",
    "Advisory-delta diff duration on a DB generation promote "
    "(fingerprint load + touched-key computation)")
DELTA_REMATCH_SECONDS = REGISTRY.histogram(
    "trivy_tpu_delta_rematch_seconds",
    "Delta re-score duration: affected artifacts re-matched through "
    "the engine's micro-batch path after a generation promote")
DELTA_TOUCHED_KEYS = REGISTRY.gauge(
    "trivy_tpu_delta_touched_keys",
    "Advisory (space, name) keys whose content changed in the most "
    "recent generation promote's delta diff")
DELTA_REMATCHED = REGISTRY.counter(
    "trivy_tpu_delta_rematched_artifacts_total",
    "Journaled artifacts re-matched by delta re-scores (incremental "
    "passes count only the affected subset)")
DELTA_FULL_RESCANS = REGISTRY.counter(
    "trivy_tpu_delta_full_rescans_total",
    "Delta re-scores that degraded to re-matching every indexed "
    "artifact, by reason (schema change, missing fingerprints, "
    "injected fault, degraded index, threshold, verify mismatch)",
    labels=("reason",))
DELTA_EVENTS = REGISTRY.counter(
    "trivy_tpu_delta_events_total",
    "Finding edges emitted by delta re-scores (kind=introduced: new "
    "finding on a frozen artifact; kind=resolved: finding retracted "
    "by the new advisory generation)",
    labels=("kind",))
DELTA_SHEDS = REGISTRY.counter(
    "trivy_tpu_delta_sheds_total",
    "Delta re-scores shed or deferred: wall-time budget expired "
    "mid-sweep, or a promote landed while a re-score was running "
    "(queued, not stacked)")
SECRET_PROBE_DEVICE = REGISTRY.gauge(
    "trivy_tpu_secret_probe_device",
    "Hybrid secret probe verdict: 1 = the device anchor screen's "
    "share-weighted time beat the host path (hybrid keeps its device "
    "share), 0 = host-only; absent until the one-shot probe runs")
SECRET_PROBE_MBPS = REGISTRY.gauge(
    "trivy_tpu_secret_probe_mb_per_s",
    "Hybrid secret probe throughput by path (path=device: anchor "
    "screen on the accelerator; path=host: native-AC host scan) on "
    "the probe corpus",
    labels=("path",))
SECRET_DEVICE_SHARE = REGISTRY.gauge(
    "trivy_tpu_secret_device_share",
    "Byte fraction of the last hybrid secret scan actually handed to "
    "the device screen (0 = the probe or a device failure routed "
    "everything to the host path)")
SECRET_STREAM_FILES = REGISTRY.counter(
    "trivy_tpu_secret_stream_files_total",
    "Files scanned through the streaming chunked secret path "
    "(size over the whole-file threshold; byte-identical findings)")
SECRET_STREAM_BYTES = REGISTRY.counter(
    "trivy_tpu_secret_stream_bytes_total",
    "Bytes consumed by the streaming chunked secret path")
SECRET_NFA_CACHE_HITS = REGISTRY.counter(
    "trivy_tpu_secret_nfa_cache_hits_total",
    "Compiled secret-NFA programs loaded from the persistent "
    "compiled-artifact cache (warm start skipped rule compilation)")
SECRET_NFA_CACHE_MISSES = REGISTRY.counter(
    "trivy_tpu_secret_nfa_cache_misses_total",
    "Compiled secret-NFA cache lookups that fell back to compiling "
    "the ruleset (absent, version mismatch, or corrupt-quarantined)")
SECRET_SCHED_BATCH_CHUNKS = REGISTRY.histogram(
    "trivy_tpu_secret_sched_batch_chunks",
    "16 KiB device chunks per coalesced secret anchor-screen "
    "micro-batch (the packed super-buffer the kernel scans at once)",
    buckets=(16, 64, 256, 1024, 4096, 16384))
SECRET_SCHED_COALESCED = REGISTRY.histogram(
    "trivy_tpu_secret_sched_coalesced_requests",
    "Distinct concurrent scans coalesced into one secret anchor-"
    "screen micro-batch",
    buckets=(1, 2, 4, 8, 16, 32))
TRACE_SPANS_DROPPED = REGISTRY.counter(
    "trivy_tpu_trace_spans_dropped_total",
    "Collected trace spans evicted by the bounded root-trace buffer "
    "(a long-running server with tracing on keeps the newest "
    "MAX_BUFFERED_ROOTS traces; the Chrome export notes this count)")
FLEET_REQUESTS = REGISTRY.counter(
    "trivy_tpu_fleet_requests_total",
    "Requests dispatched per fleet endpoint (the smart client's "
    "load-balanced + hedged dispatches; endpoint = index within the "
    "set, stable across membership changes)",
    labels=("endpoint",))
FLEET_FAILOVERS = REGISTRY.counter(
    "trivy_tpu_fleet_failovers_total",
    "Requests retried on a different replica after a transport-level "
    "failure on the first choice")
FLEET_HEDGES = REGISTRY.counter(
    "trivy_tpu_fleet_hedges_total",
    "Hedged scan dispatches by outcome: won (the hedge's response was "
    "used), lost (the primary answered first after all), denied (the "
    "hedge budget refused to fire one)",
    labels=("outcome",))
FLEET_ENDPOINT_HEALTH = REGISTRY.gauge(
    "trivy_tpu_fleet_endpoint_healthy",
    "Per-endpoint health from the /readyz JSON prober (1 ready, "
    "0 not ready/unreachable/removed)",
    labels=("endpoint",))
FLEET_REPLICA_HEALTHY = REGISTRY.gauge(
    "trivy_tpu_fleet_replica_healthy",
    "Per-endpoint ROUTABLE verdict after a health-prober pass: 1 = the "
    "picker will route to this replica (ready AND its circuit breaker "
    "is not open), 0 = skipped (not ready, unreachable, or breaker "
    "open) — the raw /readyz verdict alone is "
    "trivy_tpu_fleet_endpoint_healthy",
    labels=("endpoint",))
FLEET_PROBE_SECONDS = REGISTRY.histogram(
    "trivy_tpu_fleet_probe_seconds",
    "Wall seconds per background /readyz health probe, by endpoint — "
    "a replica whose probe latency is an outlier vs the fleet median "
    "is flagged as replica skew in the fleet event log",
    labels=("endpoint",),
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             1.0, 5.0))
FLEET_EVENTS = REGISTRY.counter(
    "trivy_tpu_fleet_events_total",
    "Fleet ops events emitted into the event bus by kind (the durable "
    "journal + /events tail carry the full records — docs/fleet.md "
    "'Event catalog')",
    labels=("kind",))
FLEET_DEDUPE_CLAIMS = REGISTRY.counter(
    "trivy_tpu_fleet_dedupe_claims_total",
    "Distributed (redis-backed) layer-claim outcomes across the "
    "replica set: leader (this server's client analyzes), follower "
    "(parked on another server's in-flight analysis), expired "
    "(took over a dead leader's claim), reclaim (waiter timeout "
    "takeover)",
    labels=("outcome",))
FLEET_ROLLOUTS = REGISTRY.counter(
    "trivy_tpu_fleet_rollouts_total",
    "Coordinated advisory-DB rollouts by outcome (completed, "
    "rolled_back, noop)",
    labels=("outcome",))
FLEET_ROLLOUT_STAGE_SECONDS = REGISTRY.histogram(
    "trivy_tpu_fleet_rollout_stage_seconds",
    "Wall seconds per rollout stage (plan, canary, probe, roll, "
    "rescore, rollback) — the sum is the fleet's refresh window, vs "
    "the reference's full-fleet quiesce",
    labels=("stage",))
CONTROLLER_TICKS = REGISTRY.counter(
    "trivy_tpu_fleet_controller_ticks_total",
    "Fleet-controller control passes (observe -> reconcile -> decide "
    "-> act), including passes that decided nothing — liveness signal "
    "for the self-driving loop (docs/fleet.md 'Self-driving fleet')")
CONTROLLER_ACTIONS = REGISTRY.counter(
    "trivy_tpu_fleet_controller_actions_total",
    "Fleet-controller actions by kind (the fleet.controller.ACTIONS "
    "vocabulary) and outcome (applied, dry_run, reconciled, dropped, "
    "failed) — each also journaled and emitted as a "
    "controller_action ops event",
    labels=("kind", "outcome"))
CONTROLLER_REPLICAS = REGISTRY.gauge(
    "trivy_tpu_fleet_controller_replicas",
    "Replica count the fleet controller observed on its latest pass — "
    "the autoscaler's actual, to compare against the min/max policy "
    "bounds")
ATTRIB_LANE_SECONDS = REGISTRY.counter(
    "trivy_tpu_attrib_lane_seconds_total",
    "Resource-lane attribution seconds accumulated from completed "
    "scan traces (kind=busy: wall-clock union the lane's spans "
    "covered; kind=critical: the lane's slice of the per-scan "
    "critical-path partition) — docs/observability.md "
    "'Attribution & profiling'",
    labels=("lane", "kind"))


def _tenant_top_n() -> int:
    """Tenant-label collapse bound (TRIVY_TPU_USAGE_TOP_N, read once
    at import): the tenant label is attacker-controlled on a public
    server, so every tenant metric collapses past this many distinct
    values instead of risking CardinalityError."""
    import os
    try:
        return max(1, int(os.environ.get("TRIVY_TPU_USAGE_TOP_N", "")
                          or 64))
    except ValueError:
        return 64


TENANT_SCANS = REGISTRY.counter(
    "trivy_tpu_tenant_scans_total",
    "Scan RPCs served to completion per tenant (tenant = 16-hex-char "
    "SHA-256 prefix of the auth token; 'anonymous' = no token, "
    "'other' = beyond the TRIVY_TPU_USAGE_TOP_N collapse bound) — "
    "docs/observability.md 'Usage metering'",
    labels=("tenant",),
    collapse_label=("tenant", _tenant_top_n()))
TENANT_SHEDS = REGISTRY.counter(
    "trivy_tpu_tenant_sheds_total",
    "Requests shed with 503 per tenant (overload, deadline expiry, "
    "draining) — shed demand is metered so overload cannot hide a "
    "tenant's load",
    labels=("tenant",),
    collapse_label=("tenant", _tenant_top_n()))
TENANT_QUERIES = REGISTRY.counter(
    "trivy_tpu_tenant_queries_total",
    "Rows submitted to the match/secret schedulers per tenant",
    labels=("tenant",),
    collapse_label=("tenant", _tenant_top_n()))
TENANT_ROWS_MATCHED = REGISTRY.counter(
    "trivy_tpu_tenant_rows_matched_total",
    "Device advisory rows matched per tenant",
    labels=("tenant",),
    collapse_label=("tenant", _tenant_top_n()))
TENANT_WIRE_BYTES = REGISTRY.counter(
    "trivy_tpu_tenant_wire_bytes_total",
    "Bytes on the RPC wire per tenant and direction (post-gzip; the "
    "pre-compression payload bytes live in the /debug/usage cost "
    "vector)",
    labels=("tenant", "direction"),
    collapse_label=("tenant", _tenant_top_n()))
TENANT_LANE_SECONDS = REGISTRY.counter(
    "trivy_tpu_tenant_lane_seconds_total",
    "Attribution-lane busy seconds per tenant — conservation "
    "invariant: summed over tenants this equals "
    "trivy_tpu_attrib_lane_seconds_total{kind='busy'} per lane "
    "(machine-asserted by /debug/usage and bench.py --usage)",
    labels=("tenant", "lane"),
    collapse_label=("tenant", _tenant_top_n()))
QOS_QUEUE_SHEDS = REGISTRY.counter(
    "trivy_tpu_qos_queue_sheds_total",
    "Scheduler submissions shed at a tenant's queue-depth cap "
    "(TRIVY_TPU_QOS_TENANT_QUEUE) — the per-tenant slice of the "
    "sheds cost-vector field, so a greedy tenant's rejected demand "
    "is visible separately from global overload",
    labels=("tenant",),
    collapse_label=("tenant", _tenant_top_n()))
QOS_ACTIVE_TENANTS = REGISTRY.gauge(
    "trivy_tpu_qos_active_tenants",
    "Distinct tenants with queued work in the last match-scheduler "
    "batch compose (the fair-share width of the current interleave)")
WIRE_REQUESTS = REGISTRY.counter(
    "trivy_tpu_wire_requests_total",
    "RPC bodies by negotiated wire format (json | columnar) and "
    "direction (out = request sent by this client, in = request "
    "served by this server) — docs/performance.md 'Binary columnar "
    "wire'",
    labels=("format", "direction"))
WIRE_FALLBACKS = REGISTRY.counter(
    "trivy_tpu_wire_fallbacks_total",
    "Columnar-to-JSON fallbacks by reason (unlearn = 4xx from a "
    "replica not advertising the capability — rollback handling; "
    "corrupt = frame checksum reject; error = columnar wire error "
    "after its one retry; drop = injected renegotiate)",
    labels=("reason",))
WIRE_FRAMES = REGISTRY.counter(
    "trivy_tpu_wire_frames_total",
    "Columnar frames encoded/decoded by direction (out/in); the "
    "streaming scan response counts one frame per result table",
    labels=("direction",))
