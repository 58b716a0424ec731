"""Fleet metrics/attribution federation + cross-replica trace
stitching (docs/fleet.md "Fleet observability control plane",
docs/observability.md "Fleet observability").

Every observability signal — the metric registry,
the attribution lanes, the flight recorder — is per-process. This
module composes N replicas' signals into ONE fleet view:

- **Metrics federation** — scrape every replica's ``/metrics`` (the
  OpenMetrics variant, so histogram exemplars survive) and merge into
  one exposition: every per-replica series is re-emitted with a
  ``replica`` label, and counter/histogram families additionally get
  an aggregate series (no ``replica`` label) whose value is the SUM of
  the per-replica scrapes — counters summed, histogram buckets merged
  bound-for-bound. Gauges are never summed (two breakers in state 1 do
  not make a state-2 breaker). The single-server exposition itself is
  untouched byte-for-byte: federation happens in the scraper.
- **Attribution federation** — merge every replica's
  ``/debug/profile`` lane totals into a fleet-wide roofline verdict
  ("bound by <lane>") with per-replica sub-reports.
- **Trace stitching** — pull every replica's flight recorder
  (``/debug/flight``) and join the fragments of hedged/failed-over
  requests — tagged with their attempt identity by the smart client
  (obs.tracing.attempt_scope) — into ONE Chrome trace: one process row
  per replica, the losing attempt marked ``cancelled``, and no orphan
  roots (fragments whose client-side parent is absent get a
  synthesized ``fleet.stitch`` container instead of dangling).
- **FederationServer** — the token-gated control-plane endpoint
  (``trivy-tpu fleet serve``): ``/metrics`` (federated exposition),
  ``/profile`` (fleet attribution + SLO state), ``/flight`` (stitched
  trace), ``/events`` (the ops event ring/journal tail).
- **FleetMonitor** — the control-plane loop: health-probes the fleet
  (skew detection via fleet.slo.SkewDetector), folds federated
  availability deltas into the SLO engine, and evaluates burn-rate
  alerts each tick.

Copy of trivy_tpu/fleet/telemetry.py. It federates replicas of either
package: their /metrics catalogs, /debug/profile lanes and Chrome trace
documents are the same shapes (the trace category stays "trivy_tpu").
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

from trivy_tpu_torch.analysis.witness import make_lock
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from trivy_tpu_torch.fleet import slo as slo_mod
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs.metrics import _fmt

_log = logger("fleet.telemetry")

OPENMETRICS_ACCEPT = "application/openmetrics-text"


class FederationError(Exception):
    """A replica scrape failed or an exposition did not parse."""


# ------------------------------------------------------------- scraping


def _get(url: str, token: str | None = None, accept: str | None = None,
         timeout: float = 10.0) -> bytes:
    headers = {}
    if token:
        headers["Trivy-Token"] = token
    if accept:
        headers["Accept"] = accept
    req = urllib.request.Request(url, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.read()
    except urllib.error.HTTPError as exc:
        with exc:
            detail = exc.read().decode("utf-8", "replace")[:200]
        raise FederationError(f"{url} -> HTTP {exc.code}: {detail}")
    except (OSError, ValueError) as exc:
        raise FederationError(f"{url} unreachable: {exc}")


def scrape_metrics(url: str, token: str | None = None,
                   timeout: float = 10.0) -> str:
    """One replica's ``/metrics`` in the OpenMetrics flavor (exemplars
    preserved); the replica's default 0.0.4 bytes are never involved."""
    return _get(url.rstrip("/") + "/metrics", token=token,
                accept=OPENMETRICS_ACCEPT, timeout=timeout).decode()


def fetch_profile(url: str, token: str | None = None,
                  timeout: float = 10.0) -> dict:
    return json.loads(_get(url.rstrip("/") + "/debug/profile",
                           token=token, timeout=timeout))


def fetch_flight(url: str, token: str | None = None,
                 timeout: float = 10.0) -> dict:
    return json.loads(_get(url.rstrip("/") + "/debug/flight",
                           token=token, timeout=timeout))


def fetch_usage(url: str, token: str | None = None,
                timeout: float = 10.0) -> dict:
    return json.loads(_get(url.rstrip("/") + "/debug/usage",
                           token=token, timeout=timeout))


# -------------------------------------------------------------- parsing


@dataclass
class Sample:
    name: str                      # full sample name (incl. _bucket…)
    labels: tuple                  # ((k, v), ...) sorted
    value: float
    exemplar: str = ""             # raw OpenMetrics exemplar suffix


@dataclass
class Family:
    name: str                      # family (metadata) name
    kind: str = "untyped"
    help: str = ""
    samples: list = field(default_factory=list)


def _parse_labels(text: str) -> tuple:
    """``a="x",b="y"`` -> ((a, x), (b, y)) sorted; handles escapes."""
    out = []
    i = 0
    n = len(text)
    while i < n:
        eq = text.index("=", i)
        key = text[i:eq].strip().lstrip(",").strip()
        i = eq + 1
        if text[i] != '"':
            raise FederationError(f"bad label value near {text[i:]!r}")
        i += 1
        buf = []
        while i < n:
            c = text[i]
            if c == "\\" and i + 1 < n:
                nxt = text[i + 1]
                buf.append({"n": "\n", "\\": "\\", '"': '"'}
                           .get(nxt, "\\" + nxt))
                i += 2
                continue
            if c == '"':
                i += 1
                break
            buf.append(c)
            i += 1
        out.append((key, "".join(buf)))
        while i < n and text[i] in ", ":
            i += 1
    return tuple(sorted(out))


def parse_exposition(text: str) -> list:
    """Prometheus 0.0.4 / OpenMetrics text -> ordered ``Family`` list.
    Exemplar suffixes (``# {...} v ts``) ride along verbatim on their
    sample so federation re-emits them untouched."""
    families: list[Family] = []
    by_name: dict[str, Family] = {}

    def family(name: str) -> Family:
        fam = by_name.get(name)
        if fam is None:
            fam = by_name[name] = Family(name)
            families.append(fam)
        return fam

    current: Family | None = None
    for line in text.splitlines():
        line = line.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                fam = family(parts[2])
                if parts[1] == "TYPE":
                    fam.kind = parts[3] if len(parts) > 3 else "untyped"
                    current = fam
                else:
                    fam.help = parts[3] if len(parts) > 3 else ""
                    current = fam
            continue  # comments, # EOF, # UNIT
        exemplar = ""
        body = line
        if " # " in line:  # OpenMetrics exemplar suffix
            body, _sep, ex = line.partition(" # ")
            exemplar = "# " + ex
        if "{" in body:
            name = body[:body.index("{")]
            rest = body[body.index("{") + 1:]
            close = rest.rindex("}")
            labels = _parse_labels(rest[:close]) if rest[:close] else ()
            value_text = rest[close + 1:].strip()
        else:
            name, _sep, value_text = body.partition(" ")
            labels = ()
        value_text = value_text.split()[0] if value_text else "0"
        try:
            value = float(value_text)
        except ValueError:
            raise FederationError(f"bad sample line {line!r}")
        # samples attach to the family whose metadata most recently
        # opened (histogram _bucket/_sum/_count share one family);
        # a bare sample with no metadata opens its own
        fam = current
        if fam is None or not name.startswith(fam.name):
            fam = by_name.get(name) or family(name)
        fam.samples.append(Sample(name, labels, value, exemplar))
    return families


# ----------------------------------------------------------- federation

#: family kinds whose samples are monotone counts — safe (and
#: meaningful) to sum across replicas. "unknown" covers the legacy
#: ``*_seconds_sum`` counters the OpenMetrics renderer cannot name as
#: counter families; their summable suffix is checked per sample.
_SUMMABLE_KINDS = {"counter", "histogram"}
_SUMMABLE_SUFFIXES = ("_total", "_sum", "_count", "_bucket")


def _summable(fam: Family, sample: Sample) -> bool:
    if fam.kind in _SUMMABLE_KINDS:
        return True
    return fam.kind == "unknown" and sample.name.endswith(
        _SUMMABLE_SUFFIXES)


class Federation:
    """The merged fleet exposition + programmatic totals."""

    def __init__(self, replicas: list):
        self.replicas = list(replicas)          # replica labels, ordered
        self.families: list[Family] = []        # union, first-seen order
        self._by_name: dict[str, Family] = {}
        # (sample_name, labels) -> summed value across replicas
        self.totals: dict[tuple, float] = {}
        # (sample_name, labels) -> [(replica, Sample), ...]
        self._per_replica: dict[tuple, list] = {}

    def _family(self, src: Family) -> Family:
        fam = self._by_name.get(src.name)
        if fam is None:
            fam = self._by_name[src.name] = Family(
                src.name, src.kind, src.help)
            self.families.append(fam)
        return fam

    def add(self, replica: str, families: list) -> None:
        for src in families:
            fam = self._family(src)
            for s in src.samples:
                key = (s.name, s.labels)
                self._per_replica.setdefault(key, []).append((replica, s))
                if _summable(src, s):
                    self.totals[key] = self.totals.get(key, 0.0) + s.value

    def total(self, sample_name: str, **labels) -> float:
        key = (sample_name,
               tuple(sorted((k, str(v)) for k, v in labels.items())))
        return self.totals.get(key, 0.0)

    @staticmethod
    def _labels_text(labels: tuple) -> str:
        if not labels:
            return ""
        from trivy_tpu_torch.obs.metrics import _escape

        return ("{" + ",".join(f'{k}="{_escape(v)}"'
                               for k, v in labels) + "}")

    def render(self, eof: bool = True) -> bytes:
        """The federated exposition: per family, the aggregate (summed)
        series first — no ``replica`` label — then every per-replica
        series with ``replica`` appended (exemplars preserved)."""
        out: list[str] = []
        for fam in self.families:
            out.append(f"# HELP {fam.name} {fam.help}".rstrip())
            out.append(f"# TYPE {fam.name} {fam.kind}")
            seen: set = set()
            per_replica_lines: list[str] = []
            for src_fam, key, entries in self._family_entries(fam):
                if key in seen:
                    continue
                seen.add(key)
                name, labels = key
                if key in self.totals:
                    out.append(
                        f"{name}{self._labels_text(labels)} "
                        f"{_fmt(self.totals[key])}")
                for replica, s in entries:
                    ltext = self._labels_text(
                        labels + (("replica", replica),))
                    suffix = f" {s.exemplar}" if s.exemplar else ""
                    per_replica_lines.append(
                        f"{name}{ltext} {_fmt(s.value)}{suffix}")
            out.extend(per_replica_lines)
        text = "\n".join(out) + "\n"
        if eof:
            text += "# EOF\n"
        return text.encode()

    def _family_entries(self, fam: Family):
        """Stable iteration of this family's (key, entries) in the
        order samples were first seen across the scrapes."""
        emitted: set = set()
        for key, entries in self._per_replica.items():
            name = key[0]
            if not self._belongs(fam, name) or key in emitted:
                continue
            emitted.add(key)
            yield fam, key, entries

    def _belongs(self, fam: Family, sample_name: str) -> bool:
        if sample_name == fam.name:
            return True
        if not sample_name.startswith(fam.name):
            return False
        rest = sample_name[len(fam.name):]
        # histogram/summary component or the OM counter `_total` suffix
        return rest in ("_bucket", "_sum", "_count", "_total")


def federate(scrapes: list) -> Federation:
    """``[(replica_label, exposition_text), ...]`` -> Federation."""
    fed = Federation([label for label, _ in scrapes])
    for label, text in scrapes:
        fed.add(label, parse_exposition(text))
    return fed


def federate_endpoints(endpoints: list, token: str | None = None,
                       timeout: float = 10.0) -> Federation:
    """Scrape + merge every replica's /metrics. A replica that fails
    to scrape is reported inside the exposition (its series are
    simply absent) rather than failing the whole federation — the
    operator is usually asking BECAUSE a replica is sick."""
    scrapes = []
    errors = {}
    for i, ep in enumerate(endpoints):
        try:
            scrapes.append((str(i), scrape_metrics(ep, token=token,
                                                   timeout=timeout)))
        except FederationError as exc:
            errors[str(i)] = str(exc)
            _log.warn("metrics scrape failed", endpoint=ep, err=str(exc))
    fed = federate(scrapes)
    fed.errors = errors  # type: ignore[attr-defined]
    return fed


# -------------------------------------------------- profile federation


def federate_profiles(profiles: list) -> dict:
    """``[(replica_label, /debug/profile doc), ...]`` -> the fleet
    attribution document: lane totals summed, one roofline verdict,
    per-replica sub-docs."""
    from trivy_tpu_torch.obs.attrib import LANES

    busy = dict.fromkeys(LANES, 0.0)
    crit = dict.fromkeys(LANES, 0.0)
    wall = other = 0.0
    scans = roots = 0
    replicas = {}
    for label, doc in profiles:
        replicas[label] = doc
        wall += doc.get("wall_s", 0.0)
        other += doc.get("other_s", 0.0)
        scans += doc.get("scans", 0)
        roots += doc.get("roots", 0)
        for lane, row in (doc.get("lanes") or {}).items():
            if lane in busy:
                busy[lane] += row.get("busy_s", 0.0)
                crit[lane] += row.get("crit_s", 0.0)
    if roots == 0:
        verdict = "no traces observed"
    else:
        lane = max(crit, key=crit.get)
        if other >= crit[lane]:
            share = other / wall if wall else 0.0
            verdict = (f"bound by untracked time ({share:.0%} of wall "
                       "outside classified spans)")
        else:
            share = crit[lane] / wall if wall else 0.0
            verdict = (f"bound by {lane} ({share:.0%} of the critical "
                       "path)")
    return {
        "replicas": replicas,
        "fleet": {
            "scans": scans,
            "roots": roots,
            "wall_s": round(wall, 6),
            "other_s": round(other, 6),
            "lanes": {lane: {"busy_s": round(busy[lane], 6),
                             "crit_s": round(crit[lane], 6),
                             "crit_share": round(crit[lane] / wall, 4)
                             if wall else 0.0}
                      for lane in LANES},
            "verdict": verdict,
        },
    }


# ---------------------------------------------------- usage federation


def federate_usage(usages: list) -> dict:
    """``[(replica_label, /debug/usage doc), ...]`` -> the fleet usage
    document: per-tenant cost vectors summed across replicas (tenant
    hashes are replica-independent — the same token hashes identically
    everywhere, so cross-replica summing is exact), per-replica
    sub-docs, fleet totals, and a conservation roll-up that is the SUM
    of the replica-local comparisons (each replica checks its own
    tenant-lane-seconds against its own attribution spine; the fleet
    view just reports whether every replica held)."""
    tenants: dict[str, dict] = {}
    totals: dict = {"fields": {}, "lanes": {}}
    replicas = {}
    tenant_lane_s = attrib_lane_s = 0.0
    ok = True
    for label, doc in usages:
        replicas[label] = doc
        for tenant, rec in (doc.get("tenants") or {}).items():
            slot = tenants.setdefault(tenant, {"fields": {}, "lanes": {}})
            for k, v in (rec.get("fields") or {}).items():
                slot["fields"][k] = slot["fields"].get(k, 0.0) + v
                totals["fields"][k] = totals["fields"].get(k, 0.0) + v
            for k, v in (rec.get("lanes") or {}).items():
                slot["lanes"][k] = slot["lanes"].get(k, 0.0) + v
                totals["lanes"][k] = totals["lanes"].get(k, 0.0) + v
        cons = doc.get("conservation") or {}
        tenant_lane_s += cons.get("tenant_lane_s", 0.0)
        attrib_lane_s += cons.get("attrib_lane_s", 0.0)
        if cons and not cons.get("ok", True):
            ok = False
    return {
        "replicas": replicas,
        "fleet": {
            "tenants": tenants,
            "totals": totals,
            "conservation": {
                "tenant_lane_s": round(tenant_lane_s, 6),
                "attrib_lane_s": round(attrib_lane_s, 6),
                "ok": ok,
            },
        },
    }


def federate_usage_endpoints(endpoints: list, token: str | None = None,
                             timeout: float = 10.0) -> dict:
    """Fetch + merge every replica's /debug/usage; unreachable replicas
    are reported in ``errors`` instead of failing the federation."""
    usages = []
    errors = {}
    for ep in endpoints:
        ep = ep.rstrip("/")
        try:
            usages.append((ep, fetch_usage(ep, token=token,
                                           timeout=timeout)))
        except FederationError as exc:
            errors[ep] = str(exc)
            _log.warn("usage fetch failed", endpoint=ep, err=str(exc))
    doc = federate_usage(usages)
    doc["errors"] = errors
    return doc


# ------------------------------------------------------ trace stitching


def stitch_flight(docs: list, trace_id: str | None = None) -> dict:
    """``[(replica_label, /debug/flight chrome doc), ...]`` -> ONE
    Chrome trace document:

    - one process row per replica (``pid`` = replica ordinal, named via
      ``process_name`` metadata events), events deduplicated by span id
      (loopback test rigs share one recorder across replicas);
    - hedge/failover fragments — ``server.scan`` roots tagged with
      their attempt identity — joined to the client trace they belong
      to; the LOSING attempt's whole subtree is marked
      ``args.cancelled`` (the client stamps ``cancelled`` on its
      ``fleet.attempt`` span the moment the race resolves);
    - zero orphan roots: any trace whose fragments' client-side parent
      is not in the document gets a synthesized ``fleet.stitch``
      container spanning them, so nothing dangles;
    - optional ``trace_id`` filter: only that trace's events.
    """
    events: list[dict] = []
    seen_spans: set = set()
    replica_of: dict[str, int] = {}
    for ordinal, (label, doc) in enumerate(docs):
        replica_of[label] = ordinal
        for ev in doc.get("traceEvents", ()):
            args = ev.get("args") or {}
            span_id = args.get("span_id")
            if trace_id and args.get("trace_id") != trace_id:
                continue
            if span_id:
                if span_id in seen_spans:
                    continue
                seen_spans.add(span_id)
            ev = dict(ev, pid=ordinal, args=dict(args))
            events.append(ev)

    by_span = {e["args"]["span_id"]: e for e in events
               if e["args"].get("span_id")}
    children: dict[str, list] = {}
    for e in events:
        parent = e["args"].get("parent_id")
        if parent:
            children.setdefault(parent, []).append(e)

    # which attempt lost each race: the client's fleet.attempt spans
    # carry a best-effort `cancelled` stamp, and the fleet.hedge span
    # records the `winner` endpoint the instant the race resolves —
    # every same-trace hedged attempt on any OTHER endpoint is the
    # loser (this second source is immune to the loser's span closing
    # before the stamp lands)
    cancelled: set = set()
    hedged_eps: dict = {}  # trace_id -> {endpoint, ...} of attempts
    for e in events:
        args = e["args"]
        if e.get("name") == "server.scan" and args.get("attempt") \
                is not None and args.get("endpoint") is not None:
            hedged_eps.setdefault(args.get("trace_id"), set()).add(
                str(args["endpoint"]))
    for e in events:
        args = e["args"]
        if args.get("cancelled") and args.get("endpoint") is not None:
            cancelled.add((args.get("trace_id"), str(args["endpoint"])))
        if e.get("name") == "fleet.hedge" and args.get("winner") \
                is not None:
            tid = args.get("trace_id")
            for ep in hedged_eps.get(tid, ()):
                if ep != str(args["winner"]):
                    cancelled.add((tid, ep))

    def mark(ev: dict) -> int:
        ev["args"]["cancelled"] = "1"
        n = 1
        for child in children.get(ev["args"].get("span_id", ""), ()):
            n += mark(child)
        return n

    cancelled_events = 0
    fragments = 0
    for e in events:
        args = e["args"]
        if args.get("attempt") is None or e.get("name") != "server.scan":
            continue
        fragments += 1
        if (args.get("trace_id"), str(args.get("endpoint"))) in cancelled:
            cancelled_events += mark(e)

    # orphan adoption: group trace fragments whose parent span is not
    # in the doc; when the trace has no true local root either, a
    # synthesized container spans them so the stitched file never
    # shows a dangling root. orphan_roots counts what remains AFTER
    # adoption and synthesis — dangling events the stitcher could not
    # bind to anything (no trace id to group by) — so the zero-orphan
    # exit gates measure the stitcher's actual coverage
    traces: dict[str, list] = {}
    ungrouped: list = []
    for e in events:
        tid = e["args"].get("trace_id")
        if tid:
            traces.setdefault(tid, []).append(e)
        elif e["args"].get("parent_id") \
                and e["args"]["parent_id"] not in by_span:
            ungrouped.append(e)
    synthesized = []
    orphan_roots = len(ungrouped)
    for tid, group in traces.items():
        unresolved = [e for e in group
                      if e["args"].get("parent_id")
                      and e["args"]["parent_id"] not in by_span]
        has_root = any(not e["args"].get("parent_id") for e in group)
        if unresolved and not has_root:
            # pure remote fragments (client trace not in any pulled
            # recorder): bind them under one synthesized container so
            # the stitched file never shows a dangling root
            t0 = min(e["ts"] for e in group)
            t1 = max(e["ts"] + e.get("dur", 0) for e in group)
            synthesized.append({
                "name": "fleet.stitch",
                "ph": "X", "ts": t0, "dur": max(t1 - t0, 0),
                "pid": unresolved[0]["pid"], "tid": 0,
                "cat": "trivy_tpu",
                "args": {"trace_id": tid, "synthesized": "1",
                         "fragments": len(unresolved)},
            })
        # unresolved-with-root fragments are ADOPTED: the trace's own
        # (client) root anchors the view

    meta_events = [
        {"ph": "M", "name": "process_name", "pid": ordinal, "tid": 0,
         "args": {"name": f"replica {ordinal} ({label})"}}
        for label, ordinal in sorted(replica_of.items(),
                                     key=lambda kv: kv[1])
    ]
    return {
        "traceEvents": meta_events + events + synthesized,
        "displayTimeUnit": "ms",
        "stitch": {
            "replicas": len(docs),
            "traces": len(traces),
            "fragments": fragments,
            "cancelled_spans": cancelled_events,
            "synthesized_roots": len(synthesized),
            "orphan_roots": orphan_roots,
        },
    }


def stitch_endpoints(endpoints: list, token: str | None = None,
                     trace_id: str | None = None) -> dict:
    docs = []
    for ep in endpoints:
        try:
            docs.append((ep.rstrip("/"), fetch_flight(ep, token=token)))
        except FederationError as exc:
            _log.warn("flight fetch failed", endpoint=ep, err=str(exc))
    return stitch_flight(docs, trace_id=trace_id)


def probe_quantiles(latencies: list) -> dict:
    """p50/p99 over a list of probe latencies (seconds) — the skew
    signal the fleet controller tunes the hedge budget from.  Returns
    an empty dict when there are fewer than 3 samples (a quantile over
    1-2 probes is noise, not signal)."""
    lats = sorted(float(x) for x in latencies if x is not None)
    if len(lats) < 3:
        return {}
    p50 = lats[len(lats) // 2]
    p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
    return {"p50_s": p50, "p99_s": p99,
            "skew": p99 / max(p50, 1e-9)}


# -------------------------------------------------------- fleet monitor


class FleetMonitor:
    """The control-plane observation loop (one instance per
    ``trivy-tpu fleet serve`` / test): each ``tick`` health-probes the
    fleet, feeds the skew detector, folds the federated scan counters'
    deltas into the SLO engine as availability samples, and evaluates
    the burn-rate alerts."""

    def __init__(self, endpoints: list, token: str | None = None,
                 engine: "slo_mod.SLOEngine | None" = None):
        self.endpoints = [e.rstrip("/") for e in endpoints]
        self.token = token
        self.engine = engine or slo_mod.SLOEngine()
        self.skew = slo_mod.SkewDetector()
        self._last_counters: dict[str, tuple[float, float]] = {}
        self._health: dict[str, bool] = {}

    def _probe(self) -> list[dict]:
        from trivy_tpu_torch.fleet.endpoints import readyz_doc

        statuses = []
        for ep in self.endpoints:
            t0 = time.monotonic()
            doc = readyz_doc(ep, token=self.token)
            lat = time.monotonic() - t0
            ready = bool(doc.get("ready")) if doc else False
            statuses.append({
                "endpoint": ep,
                "ready": ready,
                "generation": doc.get("generation") if doc else None,
                "mesh": doc.get("mesh") if doc else None,
                "probe_s": lat,
            })
            # health flips land in the journal (a replica outage is
            # the first thing an incident replay must show)
            if self._health.get(ep) != ready:
                if ep in self._health or not ready:
                    slo_mod.emit_event(
                        "probe_health", endpoint=ep, healthy=ready,
                        status=str((doc or {}).get(
                            "status", "unreachable")))
                self._health[ep] = ready
            # the probe itself is an availability sample: an
            # unreachable/unready replica burns budget even when no
            # client happens to be scanning
            self.engine.record(ready, latency_s=lat)
        return statuses

    def _record_scan_deltas(self) -> None:
        for i, ep in enumerate(self.endpoints):
            try:
                fams = parse_exposition(
                    scrape_metrics(ep, token=self.token))
            except FederationError:
                continue  # unreachability already sampled by the probe
            scans = errors = 0.0
            for fam in fams:
                for s in fam.samples:
                    if s.name == "trivy_tpu_scans_total":
                        scans += s.value
                    elif s.name == "trivy_tpu_scan_errors_total":
                        errors += s.value
            prev = self._last_counters.get(ep)
            self._last_counters[ep] = (scans, errors)
            if prev is None:
                continue
            d_scans = max(scans - prev[0], 0.0)
            d_errors = max(errors - prev[1], 0.0)
            self.engine.record_counts(int(d_scans - d_errors),
                                      int(d_errors))

    def tick(self, now: float | None = None) -> dict:
        statuses = self._probe()
        self.skew.observe(statuses)
        self._record_scan_deltas()
        state = self.engine.evaluate(now=now)
        return {"statuses": statuses, "slo": state}


# ----------------------------------------------------- federation server


def _make_fed_handler(server: "FederationServer"):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            _log.debug("http " + (fmt % args))

        def _reply(self, code: int, body: bytes,
                   ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _authed(self) -> bool:
            if not server.token:
                return True
            return self.headers.get("Trivy-Token") == server.token

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, b"ok", "text/plain")
                return
            if not self._authed():
                self._reply(401, json.dumps(
                    {"error": "invalid token"}).encode())
                return
            try:
                if self.path.startswith("/metrics"):
                    fed = federate_endpoints(server.endpoints,
                                             token=server.upstream_token)
                    self._reply(200, fed.render(),
                                f"{OPENMETRICS_ACCEPT}; version=1.0.0; "
                                "charset=utf-8")
                elif self.path.startswith("/profile"):
                    profiles = []
                    for ep in server.endpoints:
                        try:
                            profiles.append((ep, fetch_profile(
                                ep, token=server.upstream_token)))
                        except FederationError:
                            pass
                    doc = federate_profiles(profiles)
                    if server.monitor is not None:
                        doc["slo"] = server.monitor.engine.evaluate()
                    self._reply(200, json.dumps(doc).encode())
                elif self.path.startswith("/usage"):
                    self._reply(200, json.dumps(federate_usage_endpoints(
                        server.endpoints,
                        token=server.upstream_token)).encode())
                elif self.path.startswith("/flight"):
                    self._reply(200, json.dumps(stitch_endpoints(
                        server.endpoints,
                        token=server.upstream_token)).encode())
                elif self.path.startswith("/events"):
                    from urllib.parse import parse_qs, urlsplit

                    q = parse_qs(urlsplit(self.path).query)
                    try:
                        since = int((q.get("since") or ["0"])[0])
                    except ValueError:
                        self._reply(400, json.dumps(
                            {"error": "bad since cursor"}).encode())
                        return
                    nxt, events = slo_mod.events_since(since)
                    self._reply(200, json.dumps(
                        {"next": nxt, "events": events}).encode())
                else:
                    self._reply(404, json.dumps(
                        {"error": "not found"}).encode())
            except Exception as exc:  # surface, never kill the server
                _log.warn("federation request failed", path=self.path,
                          err=str(exc))
                self._reply(500, json.dumps({"error": str(exc)}).encode())

    return Handler


class FederationServer:
    """The fleet observability control plane's serving surface: a
    token-gated endpoint federating N replicas on demand. ``token``
    gates INCOMING requests; ``upstream_token`` authenticates the
    scrapes against the replicas (defaults to the same token)."""

    def __init__(self, endpoints: list, host: str = "localhost",
                 port: int = 0, token: str | None = None,
                 upstream_token: str | None = None,
                 monitor: FleetMonitor | None = None,
                 monitor_interval_s: float = 5.0):
        self.endpoints = [e.rstrip("/") for e in endpoints]
        self.token = token
        self.upstream_token = (token if upstream_token is None
                               else upstream_token)
        self.monitor = monitor
        self.monitor_interval_s = monitor_interval_s
        self.httpd = ThreadingHTTPServer((host, port),
                                         _make_fed_handler(self))
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._monitor_lock = make_lock(
            "fleet.telemetry.FederationServer._monitor_lock")

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> None:
        # lint: allow[tracing-capture] control-plane accept loop: no ambient scan context exists here
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)
        if self.monitor is not None and self.monitor_interval_s > 0:
            # lint: allow[tracing-capture] background monitor loop owns its own context; nothing to propagate
            w = threading.Thread(target=self._monitor_loop, daemon=True)
            w.start()
            self._threads.append(w)
        _log.info("federation endpoint listening", addr=self.address,
                  replicas=len(self.endpoints))

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.monitor_interval_s):
            try:
                with self._monitor_lock:
                    self.monitor.tick()
            except Exception as exc:
                _log.warn("fleet monitor tick failed", err=str(exc))

    def shutdown(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
