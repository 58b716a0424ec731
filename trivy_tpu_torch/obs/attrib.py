"""Span-to-resource-lane bottleneck attribution + slow-scan flight
recorder (docs/observability.md "Attribution & profiling").

Every span the pipeline already emits is classified into a fixed
taxonomy of **resource lanes** and accumulated per scan and fleet-wide,
answering the question the roadmap's north-star bench keeps asking:
*which lane bounds the run* — fetch I/O, host encode, device dispatch,
device wait, host crunch, queue wait, or report rendering.

Two numbers per lane, from one streaming pass over each completed
root trace:

- **busy seconds** — the wall-clock union of that lane's span
  intervals (overlapping spans of one lane count once);
- **critical seconds** — the lane's slice of an exact partition of the
  scan's wall clock: every instant is attributed to the single
  highest-priority lane active at that moment (work lanes outrank
  waits; see ``PRIORITY``), instants with no classified span are
  ``other``.  Critical slices + other == wall, so per-scan lane
  occupancies can never sum past the wall clock.

The taxonomy is machine-checked both ways by the ``span-taxonomy``
lint rule: every span name this module classifies must be emitted by
an instrumented call site under ``trivy_tpu/`` and vice versa, so the
shared vocabulary cannot silently rot.

Copy of trivy_tpu/obs/attrib.py. The taxonomy is the reference's byte
for byte, so profiles of either package read alike; of its ``fleet*``
names only the fleet scan mode's (``fleet``, ``fleet.artifact``) have
no emitter in the port yet.
``tests/test_torch_obs.py`` runs the lint rule over the port.

Wiring: :func:`acquire` installs a completed-root sink into
``obs.tracing`` (refcounted — the RPC server holds it for its
lifetime; ``TRIVY_TPU_ATTRIB=0`` kills it, ``=1`` forces it on for
one-shot CLI runs).  With the sink installed spans collect even while
classic tracing is off, but nothing is buffered beyond the flight
recorder's bounded ring of the N slowest scan traces
(``TRIVY_TPU_FLIGHT_RECORDER_N``), exportable as Chrome trace JSON
from the live server at ``GET /debug/flight`` without ``--trace-export``
having been set at startup.  ``GET /debug/profile`` serves
:func:`Aggregator.snapshot`; ``trivy-tpu profile URL`` renders it.
"""

from __future__ import annotations

import heapq
import os
from collections import deque

from trivy_tpu_torch.analysis.witness import make_lock
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import tracing
from trivy_tpu_torch.obs import usage

# ------------------------------------------------------------ taxonomy

# the fixed resource lanes every classified span accumulates into
LANES = (
    "fetch_io",         # registry/layer/network reads (incl. RPC waits)
    "host_encode",      # query -> tensor encode on the host
    "device_dispatch",  # composing + launching device micro-batches
    "device_wait",      # blocked on device results (shard/screen collect)
    "host_crunch",      # host-side analysis/decode/verify/post-process
    "queue_wait",       # parked behind another lane (scheduler queue,
                        # layer-dedupe singleflight, fetch starvation)
    "report",           # rendering/serializing the finished report
)

# exact span name -> lane (the span-taxonomy lint rule enforces that
# every entry is emitted somewhere under trivy_tpu_torch/ and every literal
# span name emitted there appears here or in SPAN_STRUCTURAL)
SPAN_LANES = {
    "analysis.fetch": "fetch_io",
    "rekor_sbom_discovery": "fetch_io",
    "analysis.walk": "host_crunch",
    "analysis.lane": "host_crunch",
    "analysis.split": "host_crunch",
    "analysis.apply": "host_crunch",
    "apply_layers": "host_crunch",
    "secret_results": "host_crunch",
    "post_hooks": "host_crunch",
    "delta.diff": "host_crunch",
    "pipeline.crunch": "host_crunch",
    "pipeline.finalize": "host_crunch",
    "pipeline.encode": "host_encode",
    "sched.enqueue": "queue_wait",
    "sched.collect": "queue_wait",
    "analysis.await_fetch": "queue_wait",
    "analysis.await_lane": "queue_wait",
    "analysis.dedupe.wait": "queue_wait",
    "sched.batch": "device_dispatch",
    "engine.dispatch": "device_dispatch",
    "engine.shard": "device_wait",
    "engine.host": "device_wait",
    "dcn.merge": "host_crunch",
    "secret.screen": "device_wait",
    "fleet.hedge": "fetch_io",
    "fleet.probe": "fetch_io",
    "fleet.attempt": "fetch_io",
    "report": "report",
}

# structural spans: timed containers whose children carry the lanes —
# classified so the taxonomy is total, but attributed to no lane (their
# un-covered self-time surfaces as `other`)
SPAN_STRUCTURAL = {
    "scan",
    "scan_artifact",
    "driver.scan",
    "inspect",
    "detect",
    "server.scan",
    "fleet",
    "fleet.artifact",
    "monitor.promote",
    "watch.rescore",
    "delta.rematch",
    "fleet.rollout",
    "fleet.control",
}

# dynamic span families (f-string names) -> lane, matched by prefix
SPAN_PREFIX_LANES = (
    ("rpc.", "fetch_io"),
)

# critical-path tie-break, highest first: at any instant the single
# charged lane is the most "actively working" one — work lanes outrank
# waits (a host busy crunching while a fetch is parked is host-bound,
# not fetch-bound), and among waits the device outranks the network
# outranks the queue
PRIORITY = (
    "device_dispatch",
    "host_encode",
    "host_crunch",
    "report",
    "device_wait",
    "fetch_io",
    "queue_wait",
)

# root span names that constitute ONE scan for per-scan records and the
# flight recorder (other roots — watch re-scores, promotes — still
# accumulate into the fleet totals)
SCAN_ROOTS = {"scan", "scan_artifact", "server.scan", "fleet.artifact"}


def classify(name: str) -> str | None:
    """-> lane for a span name, or None (structural/unknown)."""
    lane = SPAN_LANES.get(name)
    if lane is not None:
        return lane
    for prefix, plane in SPAN_PREFIX_LANES:
        if name.startswith(prefix):
            return plane
    return None


# ------------------------------------------------- per-trace attribution

def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    intervals.sort()
    out: list[tuple[float, float]] = []
    for lo, hi in intervals:
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def attribute_root(root) -> dict:
    """One completed root trace -> per-lane busy/critical seconds.

    Busy = union of the lane's span intervals (clipped to the root's
    window).  Critical = an exact partition of the root window: each
    elementary segment goes to the highest-PRIORITY active lane, the
    uncovered remainder to ``other``.  Guaranteed:
    sum(critical) + other == wall (so lane occupancies never sum past
    the wall clock of the scan)."""
    t0, t1 = root.start, root.start + root.elapsed
    per_lane: dict[str, list[tuple[float, float]]] = {}
    stack = [root]
    while stack:
        s = stack.pop()
        lane = classify(s.name)
        if lane is not None and s is not root:
            lo, hi = max(s.start, t0), min(s.start + s.elapsed, t1)
            if hi > lo:
                per_lane.setdefault(lane, []).append((lo, hi))
        stack.extend(s.children)
    merged = {lane: _merge(iv) for lane, iv in per_lane.items()}
    busy = {lane: sum(hi - lo for lo, hi in iv)
            for lane, iv in merged.items()}

    # elementary-segment sweep for the critical partition. Cuts and
    # every lane's merged interval list are sorted, so one forward
    # pointer per lane keeps the whole sweep linear in the span count
    # — this runs synchronously at every root-span close on the scan
    # thread, so no O(spans^2) rescans of the interval lists
    points = {t0, t1}
    for iv in merged.values():
        for lo, hi in iv:
            points.add(lo)
            points.add(hi)
    cuts = sorted(points)
    crit = dict.fromkeys(merged, 0.0)
    other = 0.0
    active_lanes = [lane for lane in PRIORITY if lane in merged]
    cursor = dict.fromkeys(active_lanes, 0)
    for a, b in zip(cuts, cuts[1:]):
        seg = b - a
        if seg <= 0:
            continue
        for lane in active_lanes:
            iv = merged[lane]
            i = cursor[lane]
            while i < len(iv) and iv[i][1] <= a:
                i += 1
            cursor[lane] = i
            # cuts include every interval endpoint, so covering the
            # segment start covers the whole segment
            if i < len(iv) and iv[i][0] <= a:
                crit[lane] += seg
                break
        else:
            other += seg
    wall = max(root.elapsed, 0.0)
    dominant = "other"
    best = other
    for lane, v in crit.items():
        if v > best:
            dominant, best = lane, v
    return {
        "name": root.name,
        "trace_id": root.trace_id,
        "scan_id": tracing.current_scan_id(),
        "wall_s": wall,
        "busy": busy,
        "crit": crit,
        "other_s": other,
        "dominant": dominant,
    }


# ------------------------------------------------------ flight recorder

def flight_n() -> int:
    """Ring size of the slow-scan flight recorder (0 disables it)."""
    raw = os.environ.get("TRIVY_TPU_FLIGHT_RECORDER_N", "")
    if not raw:
        return 8
    try:
        return max(int(raw), 0)
    except ValueError:
        return 8


#: bounded ring of retained fleet-attempt trace fragments (hedged /
#: failed-over dispatches tagged by the smart client) — kept SEPARATE
#: from the slowest-scan heap so a losing hedge attempt never pollutes
#: the per-scan records, yet stays pullable for cross-replica stitching
FRAGMENT_RING = 32


class FlightRecorder:
    """Bounded ring of the N slowest scan traces seen since the last
    reset — a live server keeps whole trace trees for exactly the scans
    an operator will ask about, exportable as Chrome trace JSON from
    `/debug/flight` without tracing having been enabled at startup.

    Internally a min-heap keyed on wall seconds: a new scan evicts the
    CURRENT FASTEST retained trace once the ring is full, so the ring
    converges on the true top-N slowest.

    A second, separate ring retains fleet-attempt FRAGMENTS: server-
    side trees of hedged/failed-over dispatches (tagged with their
    attempt identity by the smart client). Fragments are not scans —
    the losing attempt of a hedge race must not masquerade as a slow
    scan — but the cross-replica stitcher (fleet/telemetry.py) pulls
    them from `/debug/flight` to rebuild ONE trace per hedged request."""

    def __init__(self):
        self._lock = make_lock("obs.attrib.flight._lock")
        self._heap: list[tuple[float, int, dict, object]] = []
        self._seq = 0
        self._fragments: deque = deque(maxlen=FRAGMENT_RING)

    def offer(self, root, rec: dict) -> None:
        n = flight_n()
        if n <= 0:
            return
        with self._lock:
            self._seq += 1
            entry = (rec["wall_s"], self._seq, rec, root)
            if len(self._heap) < n:
                heapq.heappush(self._heap, entry)
            elif entry[0] > self._heap[0][0]:
                heapq.heapreplace(self._heap, entry)
            # trim if the knob shrank between offers
            while len(self._heap) > n:
                heapq.heappop(self._heap)

    def offer_fragment(self, root, rec: dict) -> None:
        """Retain a fleet-attempt fragment for the stitcher (newest
        FRAGMENT_RING kept; disabled with the recorder itself)."""
        if flight_n() <= 0:
            return
        with self._lock:
            self._fragments.append((rec, root))

    def records(self) -> list[dict]:
        """Retained scan records, slowest first (fragments excluded)."""
        with self._lock:
            entries = sorted(self._heap, reverse=True)
        return [rec for _w, _s, rec, _r in entries]

    def fragment_records(self) -> list[dict]:
        with self._lock:
            return [rec for rec, _r in self._fragments]

    def chrome_doc(self) -> dict:
        """Chrome trace-event JSON of every retained trace (slowest
        first) plus the fleet-attempt fragments, the same shape
        --trace-export writes."""
        with self._lock:
            entries = sorted(self._heap, reverse=True)
            fragments = list(self._fragments)
        flat = []
        for _w, _s, _rec, root in entries:
            stack = [root]
            while stack:
                s = stack.pop()
                flat.append(s)
                stack.extend(s.children)
        for _rec, root in fragments:
            stack = [root]
            while stack:
                s = stack.pop()
                flat.append(s)
                stack.extend(s.children)
        return {"traceEvents": tracing.chrome_events(flat),
                "displayTimeUnit": "ms",
                "flightRecorder": {"n": flight_n(),
                                   "traces": len(entries),
                                   "fragments": len(fragments)}}

    def reset(self) -> None:
        with self._lock:
            self._heap.clear()
            self._fragments.clear()


# ----------------------------------------------------------- aggregator

_RECENT = 64


class Aggregator:
    """Streaming fleet-wide accumulator: every completed root trace is
    attributed once and folded into per-lane totals, a bounded ring of
    recent per-scan records, and the flight recorder."""

    def __init__(self):
        self._lock = make_lock("obs.attrib._lock")
        self.flight = FlightRecorder()
        self._reset_locked()

    def _reset_locked(self) -> None:
        self._busy = dict.fromkeys(LANES, 0.0)
        self._crit = dict.fromkeys(LANES, 0.0)
        self._other = 0.0
        self._wall = 0.0
        self._scans = 0
        self._roots = 0
        self._fragments = 0
        self._recent: deque = deque(maxlen=_RECENT)

    def reset(self) -> None:
        with self._lock:
            self._reset_locked()
        self.flight.reset()

    def observe_root(self, root) -> None:
        """The obs.tracing sink: classify one finished root trace.

        A root carrying a HEDGE attempt tag (``server.scan`` adopted
        from one side of a raced dispatch) is a FRAGMENT of a scan
        whose real root lives on the client: its lanes still fold into
        the fleet totals (the server really did the work), but it is
        not counted as a scan, never enters the per-scan records or
        the slowest-scan ring — a losing hedge attempt must not
        masquerade as an independent slow scan — and is retained in
        the fragment ring for the cross-replica stitcher instead. A
        FAILOVER retry (meta ``failover_attempt``) stays a full scan:
        it is the scan's only server-side record."""
        rec = attribute_root(root)
        is_fragment = (root.name in SCAN_ROOTS
                       and root.meta.get("attempt") is not None)
        is_scan = root.name in SCAN_ROOTS and not is_fragment
        with self._lock:
            self._roots += 1
            self._wall += rec["wall_s"]
            self._other += rec["other_s"]
            for lane, v in rec["busy"].items():
                self._busy[lane] += v
            for lane, v in rec["crit"].items():
                self._crit[lane] += v
            if is_scan:
                self._scans += 1
                self._recent.append(rec)
            if is_fragment:
                self._fragments += 1
        for lane, v in rec["busy"].items():
            if v > 0:
                obs_metrics.ATTRIB_LANE_SECONDS.inc(v, lane=lane,
                                                    kind="busy")
        # conservation hook: the same busy vector the attribution spine
        # just counted is handed to usage metering on this thread — the
        # one that closed the root span, where the request's tenant
        # scope is still ambient — so per-tenant lane-seconds sum to
        # the fleet attribution totals by construction
        usage.add_lanes(rec["busy"])
        for lane, v in rec["crit"].items():
            if v > 0:
                obs_metrics.ATTRIB_LANE_SECONDS.inc(v, lane=lane,
                                                    kind="critical")
        if is_scan:
            self.flight.offer(root, rec)
        elif is_fragment:
            self.flight.offer_fragment(root, rec)

    @staticmethod
    def _round_rec(rec: dict) -> dict:
        return {
            "name": rec["name"],
            "trace_id": rec["trace_id"],
            "scan_id": rec["scan_id"],
            "wall_s": round(rec["wall_s"], 6),
            "busy": {k: round(v, 6) for k, v in rec["busy"].items()},
            "crit": {k: round(v, 6) for k, v in rec["crit"].items()},
            "other_s": round(rec["other_s"], 6),
            "dominant": rec["dominant"],
        }

    def verdict(self) -> str:
        """Roofline-style 'bound by X' verdict over the fleet totals."""
        with self._lock:
            if not self._roots:
                return "no traces observed"
            crit = dict(self._crit)
            other = self._other
            wall = self._wall
        lane = max(crit, key=crit.get)  # LANES order breaks ties
        if other >= crit[lane]:
            share = other / wall if wall else 0.0
            return (f"bound by untracked time ({share:.0%} of wall "
                    "outside classified spans)")
        share = crit[lane] / wall if wall else 0.0
        return f"bound by {lane} ({share:.0%} of the critical path)"

    def snapshot(self) -> dict:
        """The /debug/profile document (JSON-safe)."""
        with self._lock:
            lanes = {
                lane: {
                    "busy_s": round(self._busy[lane], 6),
                    "crit_s": round(self._crit[lane], 6),
                    "crit_share": round(
                        self._crit[lane] / self._wall, 4)
                    if self._wall else 0.0,
                }
                for lane in LANES
            }
            doc = {
                "enabled": enabled(),
                "scans": self._scans,
                "roots": self._roots,
                "fragments": self._fragments,
                "wall_s": round(self._wall, 6),
                "other_s": round(self._other, 6),
                "lanes": lanes,
                "recent": [self._round_rec(r) for r in self._recent],
            }
        doc["verdict"] = self.verdict()
        doc["flight"] = {
            "n": flight_n(),
            "slowest": [
                {"name": r["name"], "trace_id": r["trace_id"],
                 "scan_id": r["scan_id"],
                 "wall_s": round(r["wall_s"], 6),
                 "dominant": r["dominant"]}
                for r in self.flight.records()
            ],
        }
        return doc


AGG = Aggregator()

# --------------------------------------------------------- installation

_refs = 0
_refs_lock = make_lock("obs.attrib._refs_lock")


def _kill_switched() -> bool:
    return os.environ.get("TRIVY_TPU_ATTRIB", "") in ("0", "false")


def enabled() -> bool:
    return tracing._sink is not None


def acquire() -> bool:
    """Refcounted enable: install the attribution sink (a no-op under
    the TRIVY_TPU_ATTRIB=0 kill switch). The RPC server holds one ref
    for its lifetime; pair every acquire with a release()."""
    if _kill_switched():
        return False
    global _refs
    with _refs_lock:
        _refs += 1
        tracing.set_sink(AGG.observe_root)
    return True


def release() -> None:
    global _refs
    with _refs_lock:
        if _refs > 0:
            _refs -= 1
        if _refs == 0 and not _env_forced():
            tracing.set_sink(None)


def _env_forced() -> bool:
    """TRIVY_TPU_ATTRIB=1 keeps attribution on for one-shot CLI runs
    with no server holding a ref."""
    raw = os.environ.get("TRIVY_TPU_ATTRIB", "")
    return raw not in ("", "0", "false")


if _env_forced():  # opt-in for CLI scans: TRIVY_TPU_ATTRIB=1
    tracing.set_sink(AGG.observe_root)
