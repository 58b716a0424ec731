"""Port parity, the fleet observability control plane:
trivy_tpu_torch's fleet/telemetry.py (metrics, profile and usage
federation, cross-replica trace stitching, the federation endpoint, the
fleet monitor) and fleet/slo.py (the ops event bus and its durable
journal, the burn-rate SLO engine, the skew detector), with the
`profile`, `usage`, `fleet metrics`, `fleet profile` and `fleet events`
commands, against the JAX package's.

Every shape of tests/test_fleetobs.py, and tests/test_dcn.py's
`test_skew_detector_emits_on_host_degradation`, runs in both packages
(the port's engines on device="cpu", the reference's on its host path);
what each observes (federated totals and expositions, stitch summaries,
ops-event journals, command output) must be equal, times, ids and
addresses masked.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import time
import urllib.request

import pytest
from test_torch_fleet import (
    PKGS,
    PORT,
    close_pools,
    engine_of,
    mask,
    same,
)
from test_torch_fleet import _one_thread  # noqa: F401 — fixture

NPM_BUCKET = "npm::GitHub Security Advisory Npm"


def _reset_all() -> None:
    for P in PKGS:
        P.faults.reset()
        P.slo.reset_bus()
        P.attrib.AGG.reset()
        importlib.import_module(f"{P.root}.obs.usage").USAGE.reset()


@pytest.fixture(autouse=True)
def _clean_state():
    _reset_all()
    yield
    _reset_all()
    close_pools()


def mk_db(P, n: int = 4):
    db = P.store.AdvisoryDB()
    for i in range(n):
        db.put_advisory(
            NPM_BUCKET, f"pkg{i}",
            P.model.Advisory(vulnerability_id=f"CVE-2026-{i:04d}",
                             fixed_version="2.0.0",
                             vulnerable_versions=["<2.0.0"]))
    db.meta = P.store.Metadata(updated_at="2026-01-01")
    return db


def npm_blob(names: list[str]) -> dict:
    return {"schema_version": 2, "applications": [{
        "type": "npm", "file_path": "package-lock.json",
        "packages": [{"id": f"{n}@1.0.0", "name": n, "version": "1.0.0"}
                     for n in names]}]}


class TwoServers:
    def __init__(self, P):
        self.P = P
        engine = engine_of(P, mk_db(P))
        cache = P.cache.MemoryCache()
        cache.put_blob("sha256:b1", npm_blob(["pkg0", "pkg2"]))
        self.servers = [P.server.Server(engine, cache, host="localhost",
                                        port=0) for _ in range(2)]

    def __enter__(self):
        for s in self.servers:
            s.start()
        return self.servers

    def __exit__(self, *exc):
        close_pools()
        for s in self.servers:
            s.shutdown()


def scan_via(P, addr_or_set, key: str = "sha256:b1") -> bytes:
    body = P.wire.scan_request("img1", "", [key], P.scan.ScanOptions())
    if isinstance(addr_or_set, str):
        es = P.endpoints.EndpointSet([addr_or_set], health_interval_s=0)
        try:
            return es.post(P.server.SCAN_PATH, body)
        finally:
            es.close()
    return addr_or_set.post(P.server.SCAN_PATH, body)


def _events(P) -> list:
    _nxt, events = P.slo.events_since(0)
    return [{k: v for k, v in e.items() if k not in ("ts", "seq")}
            for e in events]


# ========================================================== federation


def _counter_totals(P):
    with TwoServers(P) as srv:
        scan_via(P, srv[0].address)
        scan_via(P, srv[0].address)
        scan_via(P, srv[1].address)
        scrapes = [(str(i), P.telemetry.scrape_metrics(s.address))
                   for i, s in enumerate(srv)]
        per_replica = 0.0
        for _label, text in scrapes:
            for fam in P.telemetry.parse_exposition(text):
                for sample in fam.samples:
                    if sample.name == "trivy_tpu_scans_total":
                        per_replica += sample.value
        fed = P.telemetry.federate(scrapes)
        total = fed.total("trivy_tpu_scans_total")
        assert total == per_replica == 3.0
        out = fed.render().decode()
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("trivy_tpu_scans_total")]
        assert lines == ["trivy_tpu_scans_total 3",
                         'trivy_tpu_scans_total{replica="0"} 2',
                         'trivy_tpu_scans_total{replica="1"} 1']
        assert out.endswith("# EOF\n")
        families = sorted({ln.split()[2] for ln in out.splitlines()
                           if ln.startswith("# TYPE")})
        return total, lines, families


class TestFederation:
    def test_counter_totals_equal_sum_of_scrapes(self):
        same(_counter_totals)

    def test_histogram_buckets_merge_and_exemplars_survive(self):
        exp_a = (
            "# HELP lat_seconds latency\n"
            "# TYPE lat_seconds histogram\n"
            'lat_seconds_bucket{le="0.1"} 2 # {trace_id="aa"} 0.05 1.0\n'
            'lat_seconds_bucket{le="+Inf"} 3\n'
            "lat_seconds_sum 0.4\n"
            "lat_seconds_count 3\n")
        exp_b = (
            "# HELP lat_seconds latency\n"
            "# TYPE lat_seconds histogram\n"
            'lat_seconds_bucket{le="0.1"} 5\n'
            'lat_seconds_bucket{le="+Inf"} 7\n'
            "lat_seconds_sum 1.1\n"
            "lat_seconds_count 7\n")

        def run(P):
            fed = P.telemetry.federate([("0", exp_a), ("1", exp_b)])
            assert fed.total("lat_seconds_bucket", le="0.1") == 7
            assert fed.total("lat_seconds_bucket", le="+Inf") == 10
            assert fed.total("lat_seconds_count") == 10
            out = fed.render().decode()
            assert 'lat_seconds_bucket{le="0.1"} 7' in out
            assert ('lat_seconds_bucket{le="0.1",replica="0"} 2 '
                    '# {trace_id="aa"} 0.05 1.0') in out
            assert "lat_seconds_sum 1.5" in out
            return out
        same(run)

    def test_gauges_are_never_summed(self):
        exp = ("# HELP breaker_state state\n"
               "# TYPE breaker_state gauge\n"
               "breaker_state 1\n")

        def run(P):
            fed = P.telemetry.federate([("0", exp), ("1", exp)])
            out = fed.render().decode()
            assert 'breaker_state{replica="0"} 1' in out
            assert "\nbreaker_state 1\n" not in out
            assert "\nbreaker_state 2\n" not in out
            assert fed.total("breaker_state") == 0.0
            return out
        same(run)

    def test_single_server_legacy_exposition_untouched(self):
        def run(P):
            with TwoServers(P) as srv:
                with urllib.request.urlopen(srv[0].address + "/metrics",
                                            timeout=10) as r:
                    body = r.read().decode()
                    ctype = r.headers.get("Content-Type")
            assert "version=0.0.4" in ctype and "replica=" not in body
            return ctype
        same(run)

    def test_federate_endpoints_survives_a_dead_replica(self):
        def run(P):
            with TwoServers(P) as srv:
                scan_via(P, srv[0].address)
                fed = P.telemetry.federate_endpoints(
                    [srv[0].address, "http://127.0.0.1:1"])
                total = fed.total("trivy_tpu_scans_total")
                assert total >= 1.0 and list(fed.errors) == ["1"]
                return total, list(fed.errors)
        same(run)

    def test_federate_profiles_verdict(self):
        def run(P):
            lanes_a = {lane: {"busy_s": 0.0, "crit_s": 0.0}
                       for lane in P.attrib.LANES}
            lanes_a["fetch_io"] = {"busy_s": 3.0, "crit_s": 3.0}
            doc = P.telemetry.federate_profiles([
                ("r0", {"scans": 2, "roots": 2, "wall_s": 4.0,
                        "other_s": 0.5, "lanes": lanes_a}),
                ("r1", {"scans": 1, "roots": 1, "wall_s": 2.0,
                        "other_s": 0.1, "lanes": {}}),
            ])
            assert doc["fleet"]["scans"] == 3
            assert doc["fleet"]["lanes"]["fetch_io"]["crit_s"] == 3.0
            assert doc["fleet"]["verdict"].startswith("bound by fetch_io")
            return doc
        same(run)

    def test_federate_usage_sums_tenants(self):
        """Tenant vectors of two replicas sum (tenant hashes are
        replica-independent), in both packages alike."""
        def run(P):
            with TwoServers(P) as srv:
                scan_via(P, srv[0].address)
                scan_via(P, srv[1].address)
                doc = P.telemetry.federate_usage_endpoints(
                    [s.address for s in srv])
            fleet = doc["fleet"]
            scans = {t: r["fields"].get("scans")
                     for t, r in fleet["tenants"].items()}
            # both replicas live in this one process and share its
            # usage registry: each reports both scans
            assert sum(v or 0 for v in scans.values()) == 4
            return scans, sorted(fleet), doc.get("errors")
        same(run)


# =========================================================== stitching


def _hedged_scan(P, servers, root_name: str = "scan_artifact") -> bytes:
    """One hedged scan with replica 0 slowed: the primary dispatch
    eats the delay, the hedge races endpoint 1 and wins."""
    P.faults.install_spec("fleet.endpoint.0:delay=0.4")
    es = P.endpoints.EndpointSet([s.address for s in servers],
                                 hedge_s=0.05, hedge_budget=1.0,
                                 health_interval_s=0)
    try:
        with P.tracing.span(root_name):
            out = scan_via(P, es)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if len(P.attrib.AGG.flight.fragment_records()) >= 2:
                break
            time.sleep(0.02)
        return out
    finally:
        P.faults.reset()
        es.close()


def _stitched(P):
    with TwoServers(P) as srv:
        _hedged_scan(P, srv)
        docs = [(s.address, json.loads(P.telemetry._get(
            s.address + "/debug/flight"))) for s in srv]
        for _addr, doc in docs:
            assert doc["flightRecorder"]["fragments"] == 2
        stitched = P.telemetry.stitch_flight(docs)
        st = stitched["stitch"]
        assert (st["traces"], st["fragments"], st["orphan_roots"]) \
            == (1, 2, 0)
        assert st["cancelled_spans"] >= 1
        frags = [e for e in stitched["traceEvents"]
                 if e.get("name") == "server.scan"]
        assert {e["args"]["attempt"] for e in frags} == {"0", "1"}
        by_ep = {e["args"]["endpoint"]: e for e in frags}
        assert by_ep["0"]["args"].get("cancelled") == "1"
        assert "cancelled" not in by_ep["1"]["args"]
        names = [e for e in stitched["traceEvents"] if e.get("ph") == "M"]
        assert len(names) == 2
        hedges = [e for e in _events(P) if e["kind"] == "hedge"]
        assert any(e.get("outcome") == "won" for e in hedges)
        addrs = [s.address for s in srv]
        return (st["traces"], st["fragments"], st["orphan_roots"],
                sorted((e["args"]["attempt"], e["args"]["endpoint"],
                        e["args"].get("cancelled")) for e in frags),
                mask(hedges, addrs))


def _trace_hygiene(P):
    P.tracing.enable(True)
    P.tracing.reset()
    try:
        with TwoServers(P) as srv:
            _hedged_scan(P, srv)
            top, _extra = P.tracing._stitched_roots()
            assert [t.name for t in top] == ["scan_artifact"]
    finally:
        P.tracing.enable(False)
        P.tracing.reset()
    snap = P.attrib.AGG.snapshot()
    assert snap["scans"] == 1 and snap["fragments"] == 2
    names = [r["name"] for r in P.attrib.AGG.flight.records()]
    assert "server.scan" not in names
    frags = [r["name"] for r in P.attrib.AGG.flight.fragment_records()]
    assert frags == ["server.scan", "server.scan"]
    return snap["scans"], snap["fragments"], names, frags


def _failover_full_scan(P):
    with TwoServers(P) as srv:
        P.faults.install_spec("fleet.endpoint.0:drop")
        es = P.endpoints.EndpointSet([s.address for s in srv], hedge_s=0,
                                     health_interval_s=0)
        try:
            with P.tracing.span("scan_artifact"):
                scan_via(P, es)
        finally:
            P.faults.reset()
            es.close()
        snap = P.attrib.AGG.snapshot()
        assert snap["scans"] == 2 and snap["fragments"] == 0
        assert P.attrib.AGG.flight.fragment_records() == []
        server_recs = [r for r in P.attrib.AGG.flight.records()
                       if r["name"] == "server.scan"]
        assert len(server_recs) == 1
        kinds = [e["kind"] for e in _events(P)]
        assert "failover" in kinds
        return snap["scans"], snap["fragments"], kinds


class TestStitching:
    def test_hedged_scan_one_stitched_trace_loser_cancelled(self):
        same(_stitched)

    def test_hedge_loser_trace_hygiene(self):
        same(_trace_hygiene)

    def test_failover_retry_stays_a_full_scan(self):
        same(_failover_full_scan)

    def test_stitch_derives_loser_from_hedge_winner_meta(self):
        def frag(ep, span_id):
            return {"name": "server.scan", "ph": "X", "ts": 1.0,
                    "dur": 2.0, "pid": 0, "tid": 1,
                    "args": {"trace_id": "t1", "span_id": span_id,
                             "parent_id": "root", "attempt": ep,
                             "endpoint": ep}}
        doc = {"traceEvents": [
            {"name": "scan_artifact", "ph": "X", "ts": 0.0, "dur": 5.0,
             "pid": 0, "tid": 1,
             "args": {"trace_id": "t1", "span_id": "root"}},
            {"name": "fleet.hedge", "ph": "X", "ts": 0.5, "dur": 2.0,
             "pid": 0, "tid": 1,
             "args": {"trace_id": "t1", "span_id": "h1",
                      "parent_id": "root", "winner": "1"}},
            frag("0", "s0"), frag("1", "s1"),
        ]}

        def run(P):
            stitched = P.telemetry.stitch_flight(
                [("r0", json.loads(json.dumps(doc)))])
            frags = {e["args"]["endpoint"]: e
                     for e in stitched["traceEvents"]
                     if e.get("name") == "server.scan"}
            assert frags["0"]["args"].get("cancelled") == "1"
            assert "cancelled" not in frags["1"]["args"]
            assert stitched["stitch"]["orphan_roots"] == 0
            return stitched
        same(run)

    def test_env_journal_knob_installs_lazily(self, tmp_path,
                                              monkeypatch):
        def run(P):
            path = str(tmp_path / f"client-events-{P.name}.jsonl")
            monkeypatch.setenv("TRIVY_TPU_FLEET_EVENTS_JOURNAL", path)
            P.slo.reset_bus()
            try:
                P.slo.emit_event("failover", endpoint="http://a",
                                 attempt=1)
            finally:
                P.slo.reset_bus()
                monkeypatch.delenv("TRIVY_TPU_FLEET_EVENTS_JOURNAL")
            events = P.slo.OpsEventLog.read(path)
            assert [e["kind"] for e in events] == ["failover"]
            return mask(events)
        same(run)

    def test_unstitchable_fragment_gets_synthesized_root(self):
        doc = {"traceEvents": [{
            "name": "server.scan", "ph": "X", "ts": 1.0, "dur": 5.0,
            "pid": 1, "tid": 1,
            "args": {"trace_id": "t1", "span_id": "s1",
                     "parent_id": "gone", "attempt": "1",
                     "endpoint": "1"},
        }]}

        def run(P):
            stitched = P.telemetry.stitch_flight(
                [("r0", json.loads(json.dumps(doc)))])
            st = stitched["stitch"]
            assert st["synthesized_roots"] == 1
            assert st["orphan_roots"] == 0
            assert any(e["name"] == "fleet.stitch"
                       for e in stitched["traceEvents"])
            return stitched
        same(run)


# ================================================= SLO + ops event log


def _journal_torn_tail(P, tmp_path):
    path = str(tmp_path / f"events-{P.name}.jsonl")
    assert P.slo.install_journal(path) == []
    P.slo.emit_event("failover", endpoint="http://a", attempt=1)
    P.slo.emit_event("hedge", outcome="lost")
    P.slo.uninstall_journal()
    with open(path, "ab") as f:
        f.write(b'{"kind": "hedge", "torn tail with no newline')
    events = P.slo.OpsEventLog.read(path)
    assert [e["kind"] for e in events] == ["failover", "hedge"]
    past = P.slo.install_journal(path)
    assert [e["kind"] for e in past] == ["failover", "hedge"]
    ev = P.slo.emit_event("hedge", outcome="won")
    assert ev["seq"] > past[-1]["seq"]
    P.slo.uninstall_journal()
    with open(path, "rb") as f:
        raw = f.read()
    return mask(P.slo.OpsEventLog.read(path)), len(raw.splitlines())


def _tail_rotation(P, tmp_path):
    path = str(tmp_path / f"events-{P.name}.jsonl")
    assert P.slo.install_journal(path) == []
    for i in range(6):
        P.slo.emit_event("hedge", outcome="won", n=i)
    tail = P.slo.JournalTail(path, since=0)
    try:
        first = tail.poll()
        assert [e["n"] for e in first] == list(range(6))
        ino_before = os.stat(path).st_ino
        P.slo.uninstall_journal()
        log, _past = P.slo.OpsEventLog.open(path)
        kept = log.compact(keep_last=2)
        log.close()
        assert [e["n"] for e in kept] == [4, 5]
        assert os.stat(path).st_ino != ino_before
        assert tail.poll() == []
        past = P.slo.install_journal(path)
        assert [e["n"] for e in past] == [4, 5]
        P.slo.emit_event("hedge", outcome="lost", n=6)
        P.slo.emit_event("hedge", outcome="lost", n=7)
        after = tail.poll()
        assert [e["n"] for e in after] == [6, 7]
        seqs = [e["seq"] for e in first + after]
        assert seqs == sorted(set(seqs))
    finally:
        tail.close()
        P.slo.uninstall_journal()
    fresh = P.slo.JournalTail(path, since=0)
    try:
        rest = fresh.poll()
        assert [e["n"] for e in rest] == [4, 5, 6, 7]
    finally:
        fresh.close()
    return mask([first, after, rest])


def _burn_rate(P, tmp_path):
    with TwoServers(P) as srv:
        path = str(tmp_path / f"slo-events-{P.name}.jsonl")
        P.slo.install_journal(path)
        clock = [1000.0]
        engine = P.slo.SLOEngine(target=0.9, windows=((10.0, 2.0, 2.0),),
                                 clock=lambda: clock[0])
        monitor = P.telemetry.FleetMonitor([s.address for s in srv],
                                           engine=engine)
        states = [monitor.tick()["slo"]["firing"]]
        srv[1].service.start_drain()
        for _ in range(12):
            clock[0] += 0.2
            state = monitor.tick()
        states.append(state["slo"]["firing"])
        srv[1].service.draining = False
        for _ in range(30):
            clock[0] += 0.5
            state = monitor.tick()
        states.append(state["slo"]["firing"])
        assert states == [False, True, False]
        P.slo.uninstall_journal()
        with open(path, "ab") as f:
            f.write(b'{"kind": "slo_burn", "state": "torn')
        replayed = P.slo.OpsEventLog.read(path)
        burns = [e["state"] for e in replayed if e["kind"] == "slo_burn"]
        assert burns == ["firing", "resolved"]
        flips = [e["healthy"] for e in replayed
                 if e["kind"] == "probe_health"]
        assert False in flips and True in flips
        addrs = [s.address for s in srv]
        return states, burns, flips, mask(
            [{k: v for k, v in e.items()
              if k not in ("burn", "budget", "rate", "ratio")}
             for e in replayed if e["kind"] == "probe_health"], addrs)


class TestOpsEventLog:
    def test_unknown_kind_rejected(self):
        def run(P):
            with pytest.raises(ValueError, match="unknown fleet event") \
                    as exc:
                P.slo.emit_event("made_up_kind")
            return str(exc.value)
        same(run)

    def test_kill_switch_disables_emission(self, monkeypatch):
        monkeypatch.setenv("TRIVY_TPU_FLEET_EVENTS", "0")

        def run(P):
            assert P.slo.emit_event("hedge", outcome="won") is None
            assert _events(P) == []
            return True
        same(run)

    def test_journal_append_and_torn_tail_replay(self, tmp_path):
        same(_journal_torn_tail, tmp_path)

    def test_journal_tail_survives_compaction_rotation(self, tmp_path):
        same(_tail_rotation, tmp_path)

    def test_burn_rate_fires_and_clears_journaled_across_restart(
            self, tmp_path):
        same(_burn_rate, tmp_path)

    def test_event_catalog_equals_the_reference(self):
        """The closed event vocabulary is the reference's."""
        same(lambda P: P.slo.EVENTS)


# =================================================== probe observability


def _probe_gauges(P):
    with TwoServers(P) as srv:
        es = P.endpoints.EndpointSet([s.address for s in srv],
                                     health_interval_s=0)
        try:
            es.probe_health()
            healthy = []
            for ep in es._live():
                healthy.append(P.metrics.FLEET_REPLICA_HEALTHY.value(
                    endpoint=str(ep.index)))
                _cum, _total, count = \
                    P.metrics.FLEET_PROBE_SECONDS.snapshot(
                        endpoint=str(ep.index))
                assert count >= 1
            assert healthy == [1.0, 1.0]
            srv[1].service.start_drain()
            es.probe_health()
            idx = str(es._live()[1].index)
            after = P.metrics.FLEET_REPLICA_HEALTHY.value(endpoint=idx)
            assert after == 0.0
            flips = [e for e in _events(P) if e["kind"] == "probe_health"]
            assert any(e["healthy"] is False for e in flips)
            return healthy, after, mask(flips, [s.address for s in srv])
        finally:
            srv[1].service.draining = False
            es.close()


def _generation_skew(P, monkeypatch):
    es = P.endpoints.EndpointSet(["http://a:1", "http://b:2"],
                                 health_interval_s=0)
    docs = {"http://a:1": {"ready": True, "generation": "sha256-g1"},
            "http://b:2": {"ready": True, "generation": "sha256-g2"}}
    monkeypatch.setattr(P.endpoints, "readyz_doc",
                        lambda url, token=None, timeout=2.0: docs[url])
    try:
        es.probe_health()
        es.probe_health()  # same skew again: no duplicate event
        skew = [e for e in _events(P) if e["kind"] == "replica_skew"]
        assert len(skew) == 1
        assert skew[0]["reason"] == "generation_mismatch"
        assert set(skew[0]["generations"]) == {"sha256-g1", "sha256-g2"}
        docs["http://b:2"] = {"ready": True, "generation": "sha256-g1"}
        es.probe_health()
        es.probe_health()
        skew = [e for e in _events(P) if e["kind"] == "replica_skew"]
        assert [s["reason"] for s in skew] == [
            "generation_mismatch", "generation_converged"]
        return skew
    finally:
        es.close()


def _host_degradation(P):
    """tests/test_dcn.py's shape: a host-degradation transition on
    /readyz's mesh fires one shard_degraded event, its recovery one
    more."""
    events = []
    orig = P.slo.emit_event

    def capture(kind, **fields):
        events.append((kind, fields))
        return orig(kind, **fields)

    det = P.slo.SkewDetector()
    base = {"endpoint": "http://r0", "ready": True,
            "generation": "sha256-aaa", "probe_s": 0.01}
    healthy = dict(base, mesh={"shape": "2x1x2", "degraded": [],
                               "hosts": 2, "degraded_hosts": []})
    lost = dict(base, mesh={"shape": "2x1x2", "degraded": [],
                            "hosts": 2, "degraded_hosts": [1]})
    P.slo.emit_event = capture
    try:
        det.observe([healthy])
        assert not [e for e in events if e[0] == "shard_degraded"]
        det.observe([lost])  # the transition fires exactly once
        det.observe([lost])
        got = [e for e in events if e[0] == "shard_degraded"]
        assert len(got) == 1
        assert got[0][1]["hosts"] == [1] and not got[0][1]["recovered"]
        det.observe([healthy])  # recovery fires once
        got = [e for e in events if e[0] == "shard_degraded"]
        assert len(got) == 2 and got[1][1]["recovered"]
    finally:
        P.slo.emit_event = orig
    return events


class TestProbeObservability:
    def test_probe_sets_gauges_and_latency_histogram(self):
        same(_probe_gauges)

    def test_generation_mismatch_emits_replica_skew(self, monkeypatch):
        same(_generation_skew, monkeypatch)

    def test_skew_detector_emits_on_host_degradation(self):
        same(_host_degradation)

    def test_skew_detector_reads_a_port_servers_degraded_hosts(self):
        """The detector reads the degraded hosts the port's /readyz
        serves for a distributed MeshDB (its `mesh.degraded_hosts`)."""
        engine = engine_of(PORT, mk_db(PORT))
        srv = PORT.server.Server(engine, PORT.cache.MemoryCache(),
                                 host="localhost", port=0)
        health = {"shape": "2x1x1", "data": 1, "db": 2, "degraded": [],
                  "hosts": 2, "degraded_hosts": [1]}
        engine.shard_health = lambda: health
        srv.start()
        try:
            es = PORT.endpoints.EndpointSet([srv.address],
                                            health_interval_s=0)
            es._fleet_on = True
            try:
                es.probe_health()
            finally:
                es.close()
        finally:
            srv.shutdown()
        degraded = [e for e in _events(PORT)
                    if e["kind"] == "shard_degraded"]
        assert len(degraded) == 1 and degraded[0]["hosts"] == [1]


# ================================================================= CLI


def _profile_multi(P, tmp_path, capsys):
    with TwoServers(P) as srv:
        _hedged_scan(P, srv)
        flight = tmp_path / f"stitched-{P.name}.json"
        rc = P.cli.main(["--quiet", "profile",
                         ",".join(s.address for s in srv),
                         "--flight", str(flight)])
        assert rc == 0
        out = capsys.readouterr().out
        assert "-- fleet (2 replica(s)" in out
        assert "fleet verdict:" in out and out.count("-- replica ") == 2
        doc = json.loads(flight.read_text())
        assert doc["stitch"]["orphan_roots"] == 0
        assert doc["stitch"]["fragments"] == 2
        # the rows' first words (the sections, every lane, the
        # verdict); the numbers are timings
        rows = [ln.split()[0] for ln in out.splitlines()]
        stitch = {k: v for k, v in doc["stitch"].items()
                  if k != "cancelled_spans"}
        return rows, stitch


def _fleet_metrics(P, tmp_path, capsys):
    with TwoServers(P) as srv:
        scan_via(P, srv[0].address)
        out_file = tmp_path / f"fed-{P.name}.txt"
        rc = P.cli.main(["--quiet", "fleet", "metrics",
                         ",".join(s.address for s in srv),
                         "--output", str(out_file)])
        assert rc == 0
        body = out_file.read_text()
        assert 'replica="0"' in body and 'replica="1"' in body
        assert "trivy_tpu_scans_total 1" in body
        return sorted(ln for ln in body.splitlines()
                      if ln.startswith("trivy_tpu_scans_total"))


def _fleet_events(P, tmp_path, capsys):
    path = str(tmp_path / f"ev-{P.name}.jsonl")
    P.slo.install_journal(path)
    P.slo.emit_event("db_swap", endpoint="http://a",
                     serving="sha256-g2", reloaded=True)
    P.slo.uninstall_journal()
    rc = P.cli.main(["--quiet", "fleet", "events", "--journal", path])
    assert rc == 0
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.splitlines() if ln.strip()]
    assert [e["kind"] for e in lines] == ["db_swap"]
    return mask(lines)


def _rollout_journal(P, tmp_path, capsys):
    db = mk_db(P)
    root = str(tmp_path / P.name / "db")
    gen = os.path.join(P.generations.generations_root(root), "sha256-g1")
    db.save(gen)
    P.generations.promote(root, gen)
    srv = P.server.Server(engine_of(P, db), P.cache.MemoryCache(),
                          host="localhost", port=0, db_path=root)
    srv.start()
    journal = str(tmp_path / P.name / "rollout-ev.jsonl")
    try:
        rc = P.cli.main(["--quiet", "fleet", "rollout", srv.address,
                         "--db-path", root, "--journal", journal])
        assert rc == 0
        capsys.readouterr()
    finally:
        close_pools()
        srv.shutdown()
        P.slo.uninstall_journal()
    events = P.slo.OpsEventLog.read(journal)
    assert any(e["kind"] == "rollout_stage" and e["stage"] == "plan"
               for e in events)
    return mask(events, [srv.address])


def _usage_multi(P, capsys):
    """`usage R1,R2` federates the replica set. Both replicas share this
    process's usage registry and attribution, so the conservation check
    reads whatever earlier tests of the process left in the attribution:
    its verdict (and so the exit code) is not compared."""
    with TwoServers(P) as srv:
        scan_via(P, srv[0].address)
        scan_via(P, srv[1].address)
        urls = ",".join(s.address for s in srv)
        P.cli.main(["--quiet", "usage", urls])
        table = capsys.readouterr().out.splitlines()
        assert table[0] == "fleet usage (2 replicas, 1 tenants)"
        assert table[-1].startswith("conservation: tenant lane-seconds")
        P.cli.main(["--quiet", "usage", urls, "--json"])
        doc = json.loads(capsys.readouterr().out)
        tenants = doc["fleet"]["tenants"]
        scans = {t: r["fields"]["scans"] for t, r in tenants.items()}
        assert scans == {"anonymous": 4.0}
        rows = [ln.split()[:3] for ln in table[1:-1]]
        return table[0], rows, sorted(doc), sorted(doc["fleet"])


class TestCli:
    def test_profile_multi_endpoint_with_stitched_flight(self, tmp_path,
                                                         capsys):
        same(_profile_multi, tmp_path, capsys)

    def test_fleet_metrics_cli(self, tmp_path, capsys):
        same(_fleet_metrics, tmp_path, capsys)

    def test_fleet_events_cli(self, tmp_path, capsys):
        same(_fleet_events, tmp_path, capsys)

    def test_rollout_journals_stage_events(self, tmp_path, capsys):
        same(_rollout_journal, tmp_path, capsys)

    def test_usage_multi_endpoint_federates(self, capsys):
        same(_usage_multi, capsys)

    def test_fleet_profile_subcommand_equals_profile_of_a_set(self,
                                                              capsys):
        """`fleet profile R1,R2` renders what `profile R1,R2` does."""
        def run(P):
            with TwoServers(P) as srv:
                scan_via(P, srv[0].address)
                urls = ",".join(s.address for s in srv)
                assert P.cli.main(["--quiet", "fleet", "profile", urls,
                                   "--json"]) == 0
                a = json.loads(capsys.readouterr().out)
                assert P.cli.main(["--quiet", "profile", urls,
                                   "--json"]) == 0
                b = json.loads(capsys.readouterr().out)
                assert sorted(a) == sorted(b) == ["fleet", "replicas"]
                return sorted(a["fleet"]), a["fleet"]["scans"]
        same(run)


# ================================================== federation endpoint


def _federation_server(P):
    with TwoServers(P) as srv:
        scan_via(P, srv[0].address)
        P.slo.emit_event("hedge", outcome="denied")
        fed = P.telemetry.FederationServer([s.address for s in srv],
                                           token="fedtok")
        fed.start()
        try:
            with pytest.raises(P.telemetry.FederationError, match="401"):
                P.telemetry._get(fed.address + "/metrics")
            body = P.telemetry._get(fed.address + "/metrics",
                                    token="fedtok").decode()
            assert "trivy_tpu_scans_total 1" in body
            assert 'replica="0"' in body
            prof = json.loads(P.telemetry._get(fed.address + "/profile",
                                               token="fedtok"))
            assert "fleet" in prof and "replicas" in prof
            ev = json.loads(P.telemetry._get(
                fed.address + "/events?since=0", token="fedtok"))
            assert [e["kind"] for e in ev["events"]] == ["hedge"]
            flight = json.loads(P.telemetry._get(fed.address + "/flight",
                                                 token="fedtok"))
            assert "stitch" in flight
            return sorted(prof), mask(ev), sorted(flight)
        finally:
            fed.shutdown()


class TestFederationServer:
    def test_token_gate_and_surfaces(self):
        same(_federation_server)

