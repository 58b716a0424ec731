"""Port parity, the fleet serving tier: trivy_tpu_torch's EndpointSet
(the replica-set smart client behind rpc/client.py), the `/fleet/*`
control surface of the scan server, the coordinated advisory-DB rollout
and the `fleet status` / `fleet rollout` commands, against the JAX
package's on the same seeded inputs.

Every shape of tests/test_fleet.py but the redis layer gate's (those
are tests/test_torch_redis.py's) runs in both packages (the port's engines on device="cpu", so the match
kernel's plain version answers; the reference's on its host path), and
what each run observes (scan response bytes, `/readyz` documents,
rollout reports, `fleet status` JSON, monitor events, metric deltas)
must be equal, times and addresses masked. Across packages: a replica
set that mixes a port server and a reference server, and each package's
`fleet rollout` against the other's servers. The port's own rule: a
device error during `/fleet/reresolve` answers 500 naming it, where the
reference answers a 200 "try again".

The tolerance is exact equality. Every server is shut down and every
endpoint set closed in a finalizer; servers listen on port 0.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
NPM_BUCKET = "npm::GitHub Security Advisory Npm"

_MODULES = {
    "cache": "cache.cache", "generations": "db.generations",
    "model": "db.model", "store": "db.store", "eng": "detector.engine",
    "endpoints": "fleet.endpoints", "rollout": "fleet.rollout",
    "slo": "fleet.slo", "telemetry": "fleet.telemetry",
    "ctrl": "fleet.controller", "metrics": "obs.metrics",
    "attrib": "obs.attrib", "tracing": "obs.tracing",
    "faults": "resilience.faults", "breaker": "resilience.breaker",
    "fallback": "resilience.fallback", "retry": "resilience.retry",
    "wire": "rpc.wire", "client": "rpc.client", "server": "rpc.server",
    "compile_cache": "tensorize.cache", "scan": "types.scan",
    "cli": "cli.main", "run": "cli.run", "local": "scanner.local",
    "scanner": "scanner.scan", "art_base": "artifact.base",
    "appendlog": "durability.appendlog",
    "secret_scanner": "secret.scanner",
}


def _namespace(root: str) -> SimpleNamespace:
    ns = SimpleNamespace(root=root)
    for attr, mod in _MODULES.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    ns.port = root == "trivy_tpu_torch"
    ns.name = "port" if ns.port else "ref"
    return ns


REF = _namespace("trivy_tpu")
PORT = _namespace("trivy_tpu_torch")
PKGS = (REF, PORT)


def engine_of(P, db):
    """The match engine each side serves from: the port's on the CPU
    through the match kernel's plain version, the reference's on its
    host path (as its own fleet tests run it)."""
    if P.port:
        return P.eng.MatchEngine(db, device="cpu")
    return P.eng.MatchEngine(db, use_device=False)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and idle OpenMP workers spin on cores their neighbours' timing
    tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close_pools() -> None:
    """Close both packages' pooled endpoint sets (their sockets, health
    probers and hedge pools)."""
    for P in PKGS:
        with P.client._CONN_POOL_LOCK:
            pooled = list(P.client._CONN_POOL.values())
        for c in pooled:
            c.close()


@pytest.fixture(autouse=True)
def _reset():
    for P in PKGS:
        P.faults.reset()
        P.slo.reset_bus()
    yield
    for P in PKGS:
        P.faults.reset()
        P.slo.reset_bus()
    close_pools()


# ------------------------------------------------------------- helpers


TIME_KEYS = frozenset({"ts", "seconds", "wall_s", "probe_s", "time",
                       "elapsed_s", "trace_id", "span_id", "id_hex"})


def mask(obj, addrs=()):
    """`obj` with every time or id field replaced by a placeholder and
    each address of `addrs` by its index (R0, R1, ...)."""
    if isinstance(obj, dict):
        return {k: ("T" if k in TIME_KEYS else mask(v, addrs))
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [mask(v, addrs) for v in obj]
    if isinstance(obj, str):
        for i, a in enumerate(addrs):
            obj = obj.replace(a.rstrip("/"), f"R{i}")
        return re.sub(r"http://127\.0\.0\.1:\d+", "URL", obj)
    return obj


def same(fn, *args, **kw):
    """Run `fn(P, ...)` for the reference and the port; their
    observations must be equal. -> the port's."""
    got = {P.name: fn(P, *args, **kw) for P in PKGS}
    assert got["port"] == got["ref"]
    return got["port"]


def adv(P, vid: str, fixed: str = "2.0.0"):
    return P.model.Advisory(vulnerability_id=vid, fixed_version=fixed,
                            vulnerable_versions=[f"<{fixed}"])


def mk_db(P, n: int = 6, drop: set | None = None,
          updated: str = "2026-01-01"):
    db = P.store.AdvisoryDB()
    for i in range(n):
        name = f"pkg{i}"
        if drop and name in drop:
            continue
        db.put_advisory(NPM_BUCKET, name, adv(P, f"CVE-2024-{i:04d}"))
    db.meta = P.store.Metadata(updated_at=updated)
    return db


def npm_blob(names: list[str], version: str = "1.0.0") -> dict:
    return {"schema_version": 2, "applications": [{
        "type": "npm", "file_path": "package-lock.json",
        "packages": [{"id": f"{n}@{version}", "name": n,
                      "version": version} for n in names]}]}


def scan_bytes(P, poster, target: str, key: str) -> bytes:
    body = P.wire.scan_request(target, "", [key], P.scan.ScanOptions())
    return poster.post(P.server.SCAN_PATH, body)


@contextlib.contextmanager
def two_servers(P, n: int = 2, **kw):
    """`n` live replicas of package P sharing one engine and cache (the
    minimal replica set), with the blobs both can serve."""
    engine = engine_of(P, mk_db(P))
    cache = P.cache.MemoryCache()
    cache.put_blob("sha256:b1", npm_blob(["pkg0", "pkg3"]))
    cache.put_blob("sha256:b2", npm_blob(["pkg1"]))
    servers = [P.server.Server(engine, cache, host="localhost", port=0,
                               **kw) for _ in range(n)]
    for s in servers:
        s.start()
    try:
        yield servers
    finally:
        close_pools()
        for s in servers:
            s.shutdown()


@contextlib.contextmanager
def endpoint_set(P, urls, **kw):
    es = P.endpoints.EndpointSet(urls, **kw)
    try:
        yield es
    finally:
        es.close()


def oracle_bytes(P, addr: str, key: str = "sha256:b1") -> bytes:
    with endpoint_set(P, [addr], health_interval_s=0) as single:
        return scan_bytes(P, single, "img1", key)


# ======================================================== endpoint set


def test_split_urls():
    same(lambda P: P.endpoints.split_urls("http://a:1, http://b:2 ,"))
    assert PORT.endpoints.split_urls("http://a:1, http://b:2 ,") == \
        ["http://a:1", "http://b:2"]


def _lb_round_robin(P):
    with two_servers(P) as srv:
        addrs = [s.address for s in srv]
        oracle = oracle_bytes(P, addrs[0])
        with endpoint_set(P, addrs, hedge_s=0, health_interval_s=0) as es:
            got = [scan_bytes(P, es, "img1", "sha256:b1")
                   for _ in range(6)]
        assert got == [oracle] * 6
        # both replicas actually served traffic
        served = [s.service.metrics.scans_total for s in srv]
        assert all(n >= 3 for n in served)
        return oracle, served


def test_lb_round_robin_zero_diff():
    same(_lb_round_robin)


def _failover(P):
    with two_servers(P) as srv:
        addrs = [s.address for s in srv]
        base = P.metrics.FLEET_FAILOVERS.value()
        oracle = oracle_bytes(P, addrs[1])
        P.faults.install_spec("fleet.endpoint.0:drop")
        with endpoint_set(P, addrs, hedge_s=0, health_interval_s=0) as es:
            got = [scan_bytes(P, es, "img1", "sha256:b1")
                   for _ in range(6)]
            state = es._live()[0].breaker.state
        assert got == [oracle] * 6
        failovers = P.metrics.FLEET_FAILOVERS.value() - base
        assert failovers > 0
        # the drop fires before the wire: replica 0 never saw a scan
        assert srv[0].service.metrics.scans_total == 0
        # repeated failures opened replica 0's breaker
        assert state == "open"
        _nxt, events = P.slo.events_since(0)
        kinds = [e["kind"] for e in events]
        return oracle, failovers, state, kinds


def test_failover_on_dropped_endpoint():
    same(_failover)


def _drain_shed(P):
    with two_servers(P) as srv:
        addrs = [s.address for s in srv]
        srv[0].service.start_drain()
        oracle = oracle_bytes(P, addrs[1])
        with endpoint_set(P, addrs, hedge_s=0, health_interval_s=0) as es:
            got = [scan_bytes(P, es, "img1", "sha256:b1")
                   for _ in range(6)]
            state = es._live()[0].breaker.state
        assert got == [oracle] * 6
        shed = srv[0].service.metrics.scans_shed_total
        # round-robin offered the draining replica traffic, yet its
        # breaker saw only the deliberate-shed successes
        assert shed >= 3 and state == "closed"
        return oracle, shed, state


def test_draining_replica_shed_is_backpressure_not_failure():
    same(_drain_shed)


def _hedged(P):
    with two_servers(P) as srv:
        addrs = [s.address for s in srv]
        oracle = oracle_bytes(P, addrs[1])
        won0 = P.metrics.FLEET_HEDGES.value(outcome="won")
        P.faults.install_spec("fleet.endpoint.0:delay=0.5")
        with endpoint_set(P, addrs, hedge_s=0.05, hedge_budget=1.0,
                          health_interval_s=0) as hedged, \
                endpoint_set(P, addrs, hedge_s=0,
                             health_interval_s=0) as unhedged:
            for _ in range(6):
                t0 = time.monotonic()
                assert scan_bytes(P, hedged, "img1", "sha256:b1") == oracle
                assert time.monotonic() - t0 < 0.45  # never eats the delay
            slow = 0
            for _ in range(4):
                t0 = time.monotonic()
                assert scan_bytes(P, unhedged, "img1",
                                  "sha256:b1") == oracle
                if time.monotonic() - t0 >= 0.45:
                    slow += 1
        P.faults.reset()
        assert slow >= 1  # round-robin hit the slow replica unhedged
        won = P.metrics.FLEET_HEDGES.value(outcome="won") - won0
        assert won > 0
        return oracle


def test_hedged_requests_cut_tail_latency():
    same(_hedged)


def _hedge_denied(P):
    with two_servers(P) as srv:
        addrs = [s.address for s in srv]
        denied0 = P.metrics.FLEET_HEDGES.value(outcome="denied")
        P.faults.install_spec("fleet.endpoint.0:delay=0.3")
        hit_delay = 0
        outs = []
        with endpoint_set(P, addrs, hedge_s=0.02, hedge_budget=0.0,
                          health_interval_s=0) as es:
            for _ in range(4):
                t0 = time.monotonic()
                outs.append(scan_bytes(P, es, "img1", "sha256:b1"))
                if time.monotonic() - t0 >= 0.28:
                    hit_delay += 1
        P.faults.reset()
        assert hit_delay >= 1  # zero budget: the delay is eaten
        denied = P.metrics.FLEET_HEDGES.value(outcome="denied") - denied0
        assert denied > 0
        return outs, denied


def test_hedge_budget_denies():
    same(_hedge_denied)


def _retire(P):
    with two_servers(P) as srv:
        addrs = [s.address for s in srv]
        with endpoint_set(P, addrs, hedge_s=0, health_interval_s=0) as es:
            for _ in range(4):  # both endpoints get a keep-alive socket
                scan_bytes(P, es, "img1", "sha256:b1")
            ep0 = es._live()[0]
            assert ep0.conn._all_conns
            before = srv[0].service.metrics.scans_total
            es.set_endpoints([addrs[1]])
            assert ep0.removed and ep0.conn._retired
            assert not ep0.conn._all_conns  # sockets torn down
            # this thread still holds ep0's conn in its thread-local; a
            # request on it must fail, not quietly reopen
            with pytest.raises(P.client.RPCUnavailable) as exc:
                ep0.conn.post_once(P.server.SCAN_PATH, P.wire.scan_request(
                    "img1", "", ["sha256:b1"], P.scan.ScanOptions()))
            outs = [scan_bytes(P, es, "img1", "sha256:b1")
                    for _ in range(4)]
            assert srv[0].service.metrics.scans_total == before
            return mask(str(exc.value), addrs), outs, es.urls == [addrs[1]]


def test_endpoint_retire_no_resurrection():
    same(_retire)


def _remote_driver(P):
    with two_servers(P) as srv:
        addrs = [s.address for s in srv]
        fleet_driver = P.client.RemoteDriver(",".join(addrs))
        single_driver = P.client.RemoteDriver(addrs[0])
        r1, os1 = fleet_driver.scan("img1", "", ["sha256:b1"],
                                    P.scan.ScanOptions())
        r2, os2 = single_driver.scan("img1", "", ["sha256:b1"],
                                     P.scan.ScanOptions())
        b1, b2 = P.wire.scan_response(r1, os1), P.wire.scan_response(r2, os2)
        assert b1 == b2
        # default-configured clients share the pooled set per (urls, token)
        assert P.client.RemoteCache(",".join(addrs)).conn is fleet_driver.conn
        fleet_driver.close()
        single_driver.close()
        return b1


def test_remote_driver_accepts_replica_set():
    same(_remote_driver)


# ============================================================= readyz


def _readyz(P):
    P.secret_scanner.reset_hybrid_probe()
    with two_servers(P) as srv:
        addr = srv[0].address
        svc = srv[0].service
        with urllib.request.urlopen(addr + "/readyz", timeout=10) as r:
            text = r.read()
            ctype = r.headers.get("Content-Type")
        assert text == b"ok" and text.decode() == svc.ready()[1]
        assert "text/plain" in ctype
        req = urllib.request.Request(
            addr + "/readyz", headers={"Accept": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            doc = json.loads(r.read())
            jtype = r.headers.get("Content-Type")
        assert "application/json" in jtype
        assert doc["ready"] is True and doc["status"] == svc.ready()[1]
        assert doc["draining"] is False and doc["inflight"] == 0
        assert doc["generation"] is None and doc["monitor"] is False
        return text, ctype, jtype, doc


def test_readyz_text_golden_and_json():
    same(_readyz)


def _readyz_draining(P):
    with two_servers(P) as srv:
        s = srv[1]
        s.service.start_drain()
        req = urllib.request.Request(
            s.address + "/readyz", headers={"Accept": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=10)
        assert exc.value.code == 503
        with exc.value:
            doc = json.loads(exc.value.read())
        assert doc["ready"] is False and doc["draining"] is True
        return doc


def test_readyz_json_not_ready_when_draining():
    same(_readyz_draining)


# ============================================================ rollout


def gen_dir(P, root: str, name: str) -> str:
    return os.path.join(P.generations.generations_root(root), name)


def install_gen(P, root: str, name: str, db) -> str:
    gen = gen_dir(P, root, name)
    db.save(gen)
    P.generations.promote(root, gen)
    return gen


class FleetEnv:
    """`n` live replicas of package P over one generation-managed DB
    root and a shared cache, with per-replica monitor indexes and probe
    blobs (tests/test_fleet.py's FleetEnv)."""

    def __init__(self, P, tmp_path, n: int = 2, monitor: bool = True,
                 server_pkg=None):
        self.P = P
        S = server_pkg or P
        self.S = S
        tmp_path.mkdir(parents=True, exist_ok=True)
        self.root = str(tmp_path / "db")
        self.db1 = mk_db(S)
        install_gen(S, self.root, "sha256-g1", self.db1)
        self.d1 = S.compile_cache.db_digest(self.root)
        self.cache = S.cache.MemoryCache()
        # probe artifact (pkg1: untouched by the refreshes below) and a
        # monitored artifact (pkg0: dropped by the good refresh)
        self.cache.put_blob("sha256:probe", npm_blob(["pkg1"]))
        self.cache.put_blob("sha256:mon", npm_blob(["pkg0"]))
        self.engine = engine_of(S, self.db1)
        self.servers = []
        for i in range(n):
            self.servers.append(S.server.Server(
                self.engine, self.cache, host="localhost", port=0,
                db_path=self.root, db_reload_interval=3600.0,
                monitor_index=(str(tmp_path / f"idx{i}.jsonl")
                               if monitor else None)))
        for s in self.servers:
            s.start()
        if monitor:
            # per-replica index slices: replica i recorded the scans it
            # served (img-mon<i> holding pkg<3i>)
            for i, s in enumerate(self.servers):
                pname = f"pkg{i * 3}"
                qs = [S.eng.PkgQuery("npm::", pname, "1.0.0", "npm")]
                keys = self.engine.match_keys([qs])[0]
                s.service.monitor.index.update(
                    f"img-mon{i}", [("npm::", pname, "1.0.0", "npm")],
                    keys, db_digest=self.d1)
                s.service.monitor.index.set_state(self.d1)

    @property
    def addrs(self) -> list[str]:
        return [s.address for s in self.servers]

    @property
    def probe(self) -> dict:
        return {"target": "probe", "artifact_id": "",
                "blob_ids": ["sha256:probe"], "options": {}}

    def serving(self) -> list[str]:
        return [s.get("generation")
                for s in self.P.rollout.fleet_status(self.addrs)]

    def scan_all(self, key: str = "sha256:probe") -> list[bytes]:
        out = []
        for addr in self.addrs:
            with endpoint_set(self.S, [addr], health_interval_s=0) as es:
                out.append(scan_bytes(self.S, es, "t", key))
        return out

    def events(self, i: int, timeout: float = 30.0) -> list:
        deadline = time.monotonic() + timeout
        events = []
        while time.monotonic() < deadline:
            _nxt, events = self.servers[i].service.monitor.events_since(0)
            if events:
                break
            time.sleep(0.05)
        return [(e["artifact"], e["vuln_id"], e["event"]) for e in events]

    def shutdown(self):
        close_pools()
        for s in self.servers:
            s.shutdown()


@contextlib.contextmanager
def fleet_env(P, tmp_path, **kw):
    env = FleetEnv(P, tmp_path, **kw)
    try:
        yield env
    finally:
        env.shutdown()


def _rollout_completed(P, tmp_path, server_pkg=None):
    with fleet_env(P, tmp_path / P.name, n=2,
                   server_pkg=server_pkg) as env:
        S = env.S
        before = env.scan_all()
        assert env.serving() == ["sha256-g1", "sha256-g1"]
        install_gen(S, env.root, "sha256-g2",
                    mk_db(S, drop={"pkg0", "pkg3"}, updated="2026-01-02"))
        report = P.rollout.run_rollout(env.root, env.addrs,
                                       probes=[env.probe])
        assert report.outcome == "completed"
        assert (report.target, report.previous) == ("sha256-g2",
                                                    "sha256-g1")
        assert report.probe_diffs == 0
        assert env.serving() == ["sha256-g2", "sha256-g2"]
        after = env.scan_all()
        assert after == before and after[0] == after[1]
        mon = env.scan_all("sha256:mon")
        assert mon[0] == mon[1] and b"CVE-2024-0000" not in mon[0]
        # one refresh re-scored each replica's own slice once
        assert report.rescored_on == env.addrs
        events = [env.events(0), env.events(1)]
        assert events == [[("img-mon0", "CVE-2024-0000", "resolved")],
                          [("img-mon1", "CVE-2024-0003", "resolved")]]
        # nothing left parked: a second trigger is a no-op
        again = [s.service.trigger_pending_rescore()
                 for s in env.servers]
        assert all(a["rescored"] is False for a in again)
        return (mask(report.doc(), env.addrs), before, after, mon, events,
                again)


def test_rollout_completed_with_fleet_wide_rescore_once(tmp_path):
    same(_rollout_completed, tmp_path)


def _rollout_rejected(P, tmp_path):
    with fleet_env(P, tmp_path / P.name, n=2, monitor=False) as env:
        before = env.scan_all()
        bad = P.store.AdvisoryDB()
        bad.meta = P.store.Metadata(updated_at="2026-01-03")
        bad_dir = install_gen(P, env.root, "sha256-bad", bad)
        stop = threading.Event()
        scan_errs: list = []

        def background_scans():
            # the fleet keeps serving during the whole episode
            try:
                with endpoint_set(P, env.addrs, hedge_s=0,
                                  health_interval_s=0) as es:
                    while not stop.is_set():
                        if scan_bytes(P, es, "t",
                                      "sha256:probe") != before[0]:
                            scan_errs.append("diff")
                        time.sleep(0.01)
            except Exception as exc:  # noqa: BLE001 — asserted below
                scan_errs.append(exc)

        t = threading.Thread(target=background_scans)
        t.start()
        try:
            report = P.rollout.run_rollout(env.root, env.addrs)
        finally:
            stop.set()
            t.join(timeout=30)
        assert not scan_errs
        assert report.outcome == "rolled_back"
        assert env.serving() == ["sha256-g1", "sha256-g1"]
        assert env.scan_all() == before
        assert not os.path.isdir(bad_dir)
        assert P.generations.is_quarantined(env.root, "sha256-bad")
        assert os.path.basename(os.path.realpath(
            P.generations.last_good_path(env.root))) == "sha256-g1"
        return mask(report.doc(), env.addrs), before


def test_rollout_rejected_candidate_rolls_back(tmp_path):
    same(_rollout_rejected, tmp_path)


def _rollout_probe_diff(P, tmp_path, server_pkg=None):
    with fleet_env(P, tmp_path / P.name, n=2, monitor=False,
                   server_pkg=server_pkg) as env:
        S = env.S
        before = env.scan_all()
        install_gen(S, env.root, "sha256-wrong",
                    mk_db(S, drop={"pkg1"}, updated="2026-01-04"))
        report = P.rollout.run_rollout(env.root, env.addrs,
                                       probes=[env.probe])
        assert report.outcome == "rolled_back" and report.probe_diffs == 1
        assert env.serving() == ["sha256-g1", "sha256-g1"]
        assert env.scan_all() == before
        assert P.generations.is_quarantined(env.root, "sha256-wrong")
        return mask(report.doc(), env.addrs), before


def test_rollout_probe_diff_rolls_back(tmp_path):
    same(_rollout_probe_diff, tmp_path)


def _rollout_roll_failure(P, tmp_path):
    with fleet_env(P, tmp_path / P.name, n=3, monitor=False) as env:
        install_gen(P, env.root, "sha256-g2",
                    mk_db(P, drop={"pkg0"}, updated="2026-01-02"))
        # stage fires: plan@1, canary@2, roll@3 (first non-canary)
        P.faults.install_spec("fleet.rollout:error@3")
        report = P.rollout.run_rollout(env.root, env.addrs)
        P.faults.reset()
        assert report.outcome == "rolled_back"
        assert env.serving() == ["sha256-g1"] * 3
        # a controller-level failure does not quarantine the target
        assert not P.generations.is_quarantined(env.root, "sha256-g2")
        P.generations.promote(env.root, gen_dir(P, env.root, "sha256-g2"))
        report2 = P.rollout.run_rollout(env.root, env.addrs)
        assert report2.outcome == "completed"
        assert env.serving() == ["sha256-g2"] * 3
        return mask([report.doc(), report2.doc()], env.addrs)


def test_rollout_roll_stage_failure_rolls_back(tmp_path):
    same(_rollout_roll_failure, tmp_path)


def _rollout_noop(P, tmp_path):
    with fleet_env(P, tmp_path / P.name, n=2, monitor=False) as env:
        report = P.rollout.run_rollout(env.root, env.addrs)
        assert report.outcome == "noop"
        env.servers[1].service.start_drain()
        with pytest.raises(P.rollout.RolloutError, match="not ready") as e:
            P.rollout.run_rollout(env.root, env.addrs)
        return mask(report.doc(), env.addrs), mask(str(e.value), env.addrs)


def test_rollout_noop_and_not_ready(tmp_path):
    same(_rollout_noop, tmp_path)


def _pending_rescore(P, tmp_path):
    with fleet_env(P, tmp_path / P.name, n=1) as env:
        svc = env.servers[0].service
        install_gen(P, env.root, "sha256-g2",
                    mk_db(P, drop={"pkg0"}, updated="2026-01-02"))
        assert svc.maybe_reload_db(rescore=False) is True
        assert svc.monitor.events_since(0) == (0, [])  # parked
        assert svc._pending_rescore is not None
        # the parked swap keeps the baseline digest the re-score needs
        assert svc._pending_rescore[0] == env.d1
        out = svc.trigger_pending_rescore()
        assert out == {"rescored": True}
        events = env.events(0)
        assert events
        out2 = svc.trigger_pending_rescore()
        assert out2 == {"rescored": False, "reason": "no pending swap"}
        return events, out, out2


def test_pending_rescore_consumed_once(tmp_path):
    same(_pending_rescore, tmp_path)


def _post(url: str, body: bytes = b"{}", token: str | None = None):
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Trivy-Token"] = token
    req = urllib.request.Request(url, data=body, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        with exc:
            return exc.code, json.loads(exc.read())


def _reload_token_gated(P):
    with two_servers(P, n=1, token="s3cret") as (srv,):
        denied = _post(srv.address + "/fleet/reload")
        assert denied[0] == 401
        ok = _post(srv.address + "/fleet/reload", token="s3cret")
        assert ok[0] == 200 and ok[1]["reloaded"] is False
        return denied, ok


def test_fleet_reload_endpoint_token_gated():
    same(_reload_token_gated)


def _cli_status_and_rollout(P, tmp_path, capsys, server_pkg=None):
    with fleet_env(P, tmp_path / P.name, n=2, monitor=False,
                   server_pkg=server_pkg) as env:
        S = env.S
        rc = P.cli.main(["--quiet", "fleet", "status", ",".join(env.addrs)])
        assert rc == 0
        status = json.loads(capsys.readouterr().out)
        assert len(status) == 2 and all(s["ready"] for s in status)
        install_gen(S, env.root, "sha256-g2",
                    mk_db(S, drop={"pkg0"}, updated="2026-01-02"))
        probes_file = tmp_path / P.name / "probes.json"
        probes_file.write_text(json.dumps([env.probe]))
        report_file = tmp_path / P.name / "report.json"
        rc = P.cli.main(["--quiet", "fleet", "rollout",
                         ",".join(env.addrs), "--db-path", env.root,
                         "--probes", str(probes_file),
                         "--output", str(report_file)])
        assert rc == 0
        captured = capsys.readouterr()
        doc = json.loads(report_file.read_text())
        assert doc["outcome"] == "completed"
        assert doc["probes"] == 1 and doc["probe_diffs"] == 0
        assert json.loads(captured.out) == doc
        stages = [json.loads(ln) for ln in captured.err.splitlines()
                  if ln.startswith("{")]
        assert env.serving() == ["sha256-g2", "sha256-g2"]
        return (mask(status, env.addrs), mask(doc, env.addrs),
                mask(stages, env.addrs))


def test_fleet_cli_status_and_rollout(tmp_path, capsys):
    same(_cli_status_and_rollout, tmp_path, capsys)


def _status_shape(P):
    with two_servers(P) as srv:
        addrs = [s.address for s in srv]
        status = P.rollout.fleet_status(addrs)
        assert len(status) == 2 and all(s["ready"] for s in status)
        assert all("endpoint" in s and "status" in s for s in status)
        dead = P.rollout.fleet_status(["http://127.0.0.1:1"])
        assert dead[0]["ready"] is False
        return mask(status, addrs), dead


def test_fleet_status_cli_shape():
    same(_status_shape)


def _jitter(P):
    with endpoint_set(P, ["http://127.0.0.1:1"], hedge_s=0,
                      health_interval_s=0) as es:
        es._health_interval_s = 4.0
        lo, cap = 2.0, 6.0
        prev = 4.0
        draws = []
        for _ in range(400):
            prev = es._next_probe_delay(prev)
            draws.append(prev)
            assert lo <= prev <= cap
        # centered on the configured interval
        assert abs(sum(draws) / len(draws) - 4.0) < 0.25
        # growth bound: from a tiny previous delay at most 3x
        for _ in range(200):
            d = es._next_probe_delay(0.1)
            assert lo <= d <= min(lo * 3.0, cap)
    # decorrelation: two sets built alike must not share an RNG
    with endpoint_set(P, ["http://127.0.0.1:1"], hedge_s=0,
                      health_interval_s=0) as a, \
            endpoint_set(P, ["http://127.0.0.1:1"], hedge_s=0,
                         health_interval_s=0) as b:
        a._health_interval_s = b._health_interval_s = 4.0
        seq_a = [a._next_probe_delay(4.0) for _ in range(8)]
        seq_b = [b._next_probe_delay(4.0) for _ in range(8)]
        assert seq_a != seq_b
    return lo, cap


def test_probe_delay_decorrelated_jitter():
    same(_jitter)


def _drain_endpoint(P):
    with two_servers(P, n=1, token="s3cret") as (srv,):
        status, doc = _post(srv.address + "/fleet/drain",
                            json.dumps({"timeout_s": 5}).encode(),
                            token="s3cret")
        assert (status, doc) == (200, {"draining": True, "inflight": 0})
        assert srv.service.draining
        ready = srv.service.ready()
        assert ready == (False, "draining")
        return doc, ready


def test_fleet_drain_endpoint():
    same(_drain_endpoint)


def _reresolve_no_mesh(P):
    with two_servers(P, n=1) as (srv,):
        status, doc = _post(srv.address + "/fleet/reresolve")
        assert (status, doc) == (200, {"reresolved": False, "mesh": None})
        assert srv.service.ready()[0]
        return doc


def test_fleet_reresolve_endpoint_no_mesh():
    same(_reresolve_no_mesh)


def _unknown_fleet_method(P):
    with two_servers(P, n=1) as (srv,):
        return _post(srv.address + "/fleet/scale")


def test_unknown_fleet_method_answers_404():
    assert same(_unknown_fleet_method)[0] == 404


# ================================================== /fleet/reresolve


def _mesh_engine(P, db):
    """A 1x2 serving mesh over the CPU (the port) or two of the
    reference's host devices."""
    if P.port:
        return P.eng.MatchEngine(db, device="cpu", mesh_spec="1x2")
    return P.eng.MatchEngine(db, mesh_spec="1x2")


def _degrade_shard(P, engine, shard: int = 1) -> None:
    with engine._mdb._lock:
        engine._mdb.degraded.add(shard)


def _reresolve_mesh(P):
    """A degraded shard re-resolves onto its device through the fleet
    surface, in both packages alike."""
    db = mk_db(P)
    engine = _mesh_engine(P, db)
    cache = P.cache.MemoryCache()
    cache.put_blob("sha256:b1", npm_blob(["pkg0", "pkg3"]))
    srv = P.server.Server(engine, cache, host="localhost", port=0)
    srv.start()
    try:
        before = oracle_bytes(P, srv.address)
        _degrade_shard(P, engine)
        status, doc = _post(srv.address + "/fleet/reresolve")
        assert status == 200 and doc["reresolved"] is True
        assert doc["mesh"]["degraded"] == []
        assert oracle_bytes(P, srv.address) == before
        return status, doc, before
    finally:
        close_pools()
        srv.shutdown()


def test_fleet_reresolve_restores_a_degraded_shard():
    same(_reresolve_mesh)


@contextlib.contextmanager
def _patched(module: str, name: str, fn):
    mod = importlib.import_module(module)
    orig = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def _raise(exc: Exception):
    def boom(*a, **k):
        raise exc
    return boom


def test_fleet_reresolve_device_error_answers_500_naming_it(monkeypatch):
    """The port's departure on purpose: a CUDA error during a re-resolve
    answers 500 naming the device error, never the reference's 200
    `{"reresolved": false, "error": ...}` that a controller reads as
    "try again later"; the shard stays degraded on the host mask and the
    server keeps serving exact results."""
    db = mk_db(PORT)
    engine = _mesh_engine(PORT, db)
    cache = PORT.cache.MemoryCache()
    cache.put_blob("sha256:b1", npm_blob(["pkg0", "pkg3"]))
    srv = PORT.server.Server(engine, cache, host="localhost", port=0)
    srv.start()
    try:
        before = oracle_bytes(PORT, srv.address)
        _degrade_shard(PORT, engine)
        with _patched("trivy_tpu_torch.ops.match", "shard_device_db",
                      _raise(RuntimeError("CUDA error: an illegal memory "
                                          "access was encountered"))):
            status, doc = _post(srv.address + "/fleet/reresolve")
            # the controller's actuator turns the 500 into a failed
            # action (its intent stays pending: observe only)
            act = PORT.ctrl.HttpFleetActuator([srv.address])
            with pytest.raises(PORT.ctrl.ActuatorError, match="HTTP 500"):
                act.reresolve_mesh(srv.address)
        assert status == 500
        assert doc["error"].startswith("device error during mesh "
                                       "re-resolve: shard 1 upload")
        assert "CUDA error: an illegal memory access" in doc["error"]
        assert engine.shard_health()["degraded"] == [1]
        assert oracle_bytes(PORT, srv.address) == before
    finally:
        close_pools()
        srv.shutdown()


def test_fleet_reresolve_other_failure_keeps_the_reference_reply():
    """A failure that is not the device's (here the host-side slicing
    of the table) keeps the reference's 200 reply."""
    def run(P):
        engine = _mesh_engine(P, mk_db(P))
        srv = P.server.Server(engine, P.cache.MemoryCache(),
                              host="localhost", port=0)
        srv.start()
        try:
            _degrade_shard(P, engine)
            with _patched(f"{P.root}.ops.match", "host_shards",
                          _raise(ValueError("slicing failed"))):
                status, doc = _post(srv.address + "/fleet/reresolve")
            assert status == 200 and doc["reresolved"] is False
            assert doc["error"] == "slicing failed"
            assert doc["mesh"]["degraded"] == [1]
            return status, doc
        finally:
            close_pools()
            srv.shutdown()
    same(run)


def test_device_error_in_a_dcn_worker_is_a_device_error():
    """A DCN worker's device error (its match or its slice upload) is a
    device.DeviceError, so a re-resolve that meets it answers 500 too."""
    from trivy_tpu_torch.device import DeviceError
    from trivy_tpu_torch.ops import dcn

    assert issubclass(dcn.WorkerDeviceError, DeviceError)
    assert issubclass(DeviceError, RuntimeError)


# ====================================================== across packages


def _mixed_set(P):
    """A replica set of one port server and one reference server, both
    on the same DB content: round robin, failover and hedging through P's
    endpoint set return the single servers' bytes."""
    srvs, engines = [], []
    for S in (PORT, REF):
        engine = engine_of(S, mk_db(S))
        cache = S.cache.MemoryCache()
        cache.put_blob("sha256:b1", npm_blob(["pkg0", "pkg3"]))
        srv = S.server.Server(engine, cache, host="localhost", port=0)
        srv.start()
        srvs.append(srv)
        engines.append(engine)
    try:
        addrs = [s.address for s in srvs]
        oracles = [oracle_bytes(P, a) for a in addrs]
        assert oracles[0] == oracles[1]
        with endpoint_set(P, addrs, hedge_s=0, health_interval_s=0) as es:
            rr = [scan_bytes(P, es, "img1", "sha256:b1") for _ in range(4)]
        assert rr == [oracles[0]] * 4
        assert all(s.service.metrics.scans_total >= 2 for s in srvs)
        for i in (0, 1):
            P.faults.install_spec(f"fleet.endpoint.{i}:drop")
            with endpoint_set(P, addrs, hedge_s=0,
                              health_interval_s=0) as es:
                fo = [scan_bytes(P, es, "img1", "sha256:b1")
                      for _ in range(3)]
            P.faults.reset()
            assert fo == [oracles[0]] * 3
        P.faults.install_spec("fleet.endpoint.0:delay=0.4")
        with endpoint_set(P, addrs, hedge_s=0.05, hedge_budget=1.0,
                          health_interval_s=0) as es:
            hedged = scan_bytes(P, es, "img1", "sha256:b1")
        P.faults.reset()
        assert hedged == oracles[0]
        return oracles[0]
    finally:
        close_pools()
        for s in srvs:
            s.shutdown()


def test_replica_set_mixing_a_port_and_a_reference_server():
    same(_mixed_set)


@pytest.mark.parametrize("driver,servers", [("port", "ref"),
                                            ("ref", "port")])
def test_fleet_rollout_against_the_other_packages_servers(tmp_path,
                                                          driver, servers):
    """Each package's rollout drives the other's servers: the report,
    the scans and the monitor events equal the same-package rollout's."""
    D = PORT if driver == "port" else REF
    S = PORT if servers == "port" else REF
    cross = _rollout_completed(D, tmp_path / "cross", server_pkg=S)
    own = _rollout_completed(S, tmp_path / "own")
    assert cross == own


@pytest.mark.parametrize("driver,servers", [("port", "ref"),
                                            ("ref", "port")])
def test_fleet_cli_against_the_other_packages_servers(tmp_path, capsys,
                                                      driver, servers):
    """`fleet status` and `fleet rollout` of each package's CLI against
    the other's servers, equal to the same-package run."""
    D = PORT if driver == "port" else REF
    S = PORT if servers == "port" else REF
    cross = _cli_status_and_rollout(D, tmp_path / "cross", capsys,
                                    server_pkg=S)
    own = _cli_status_and_rollout(S, tmp_path / "own", capsys)
    assert cross == own


# ================================================ CLI over a replica set


SBOM = {
    "bomFormat": "CycloneDX", "specVersion": "1.5", "version": 1,
    "metadata": {"component": {"type": "application", "name": "app"}},
    "components": [
        {"type": "library", "name": f"pkg{i}", "version": "1.0.0",
         "purl": f"pkg:npm/pkg{i}@1.0.0", "bom-ref": f"pkg{i}"}
        for i in range(6)],
}


@pytest.fixture()
def sbom_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", "2024-01-01T00:00:00+00:00")
    bom = tmp_path / "bom.json"
    bom.write_text(json.dumps(SBOM))
    db_dir = tmp_path / "db"
    mk_db(PORT).save(str(db_dir))
    yield {"bom": str(bom), "db": str(db_dir), "tmp": tmp_path}
    for P in PKGS:
        P.run._ENGINE_CACHE.clear()


def _cli_replica_set(P, env, capsys, monkeypatch):
    """`sbom --server R1,R2` with both replicas serving, with R1 drained
    through /fleet/drain (failover), and with hedging forced: each
    report equals the standalone scan's bytes."""
    dev = ["--device", "cpu"] if P.port else ["--no-tpu"]
    common = ["--quiet", "--format", "json", "--cache-dir",
              str(env["tmp"] / f"c-{P.name}")]
    assert P.cli.main(["sbom", env["bom"], "--db-path", env["db"],
                       *common, *dev]) == 0
    direct = capsys.readouterr().out
    db = P.store.AdvisoryDB.load(env["db"])
    engine = engine_of(P, db)
    # one cache tier behind both replicas: a client's PutBlob may land
    # on either, its scan on the other
    cache = P.cache.MemoryCache()
    srvs = [P.server.Server(engine, cache, host="localhost", port=0)
            for _ in range(2)]
    for s in srvs:
        s.start()
    try:
        urls = ",".join(s.address for s in srvs)
        outs = []
        for step in ("both", "drained", "hedged"):
            if step == "drained":
                assert _post(srvs[0].address + "/fleet/drain",
                             json.dumps({"timeout_s": 5}).encode())[0] \
                    == 200
            if step == "hedged":
                srvs[0].service.draining = False
                monkeypatch.setenv("TRIVY_TPU_FLEET_HEDGE_MS", "1")
                monkeypatch.setenv("TRIVY_TPU_FLEET_HEDGE_BUDGET", "1")
                P.faults.install_spec("fleet.endpoint.0:delay=0.3")
            close_pools()
            P.client._CONN_POOL.clear()
            assert P.cli.main(["sbom", env["bom"], "--server", urls,
                               *common, *dev]) == 0
            outs.append(capsys.readouterr().out)
            P.faults.reset()
        assert outs == [direct] * 3
        # replica 1 served the drained step; a hedge's loser may still
        # be finishing on replica 0
        assert srvs[1].service.metrics.scans_total >= 2
        return direct
    finally:
        close_pools()
        P.client._CONN_POOL.clear()
        for s in srvs:
            s.shutdown()


def test_sbom_over_a_replica_set_equals_the_direct_scan(sbom_env, capsys,
                                                        monkeypatch):
    same(_cli_replica_set, sbom_env, capsys, monkeypatch)


# ============================================================== on a card


_CARD_FLEET = r"""
import json, sys
from trivy_tpu_torch.cache.cache import MemoryCache
from trivy_tpu_torch.db.model import Advisory
from trivy_tpu_torch.db.store import AdvisoryDB, Metadata
from trivy_tpu_torch.detector.engine import MatchEngine
from trivy_tpu_torch.fleet.endpoints import EndpointSet
from trivy_tpu_torch.ops import match as m
from trivy_tpu_torch.resilience import faults
from trivy_tpu_torch.rpc import wire
from trivy_tpu_torch.rpc.server import SCAN_PATH, Server
from trivy_tpu_torch.types.scan import ScanOptions

db = AdvisoryDB()
for i in range(64):
    db.put_advisory("npm::GitHub Security Advisory Npm", f"pkg{i}",
                    Advisory(vulnerability_id=f"CVE-2024-{i:04d}",
                             fixed_version="2.0.0",
                             vulnerable_versions=["<2.0.0"]))
db.meta = Metadata(updated_at="2026-01-01")
blob = {"schema_version": 2, "applications": [{
    "type": "npm", "file_path": "package-lock.json",
    "packages": [{"id": f"pkg{i}@1.0.0", "name": f"pkg{i}",
                  "version": "1.0.0"} for i in range(0, 64, 3)]}]}
cpu = MatchEngine(db, device="cpu")
servers = []
for dev in ("cpu", "cuda:0", "cuda:0"):
    cache = MemoryCache()
    cache.put_blob("sha256:b1", blob)
    eng = cpu if dev == "cpu" else MatchEngine(db, device=dev)
    s = Server(eng, cache, host="localhost", port=0)
    s.start()
    servers.append(s)
body = wire.scan_request("img", "", ["sha256:b1"], ScanOptions())
ref = EndpointSet([servers[0].address], health_interval_s=0)
want = ref.post(SCAN_PATH, body)
ref.close()
es = EndpointSet([s.address for s in servers[1:]], hedge_s=0,
                 health_interval_s=0)
rr = [es.post(SCAN_PATH, body) for _ in range(4)]
faults.install_spec("fleet.endpoint.0:drop")
fo = [es.post(SCAN_PATH, body) for _ in range(3)]
faults.reset()
es.close()
served = [s.service.metrics.scans_total for s in servers[1:]]
for s in servers:
    s.shutdown()
print(json.dumps({"equal": all(x == want for x in rr + fo),
                  "served": served, "launches": m.match_words.launches}))
"""


@pytest.mark.cuda
def test_cuda_replica_set_and_failover_on_the_card():
    """On a card, in a fresh process: a two-replica set whose replicas
    match on cuda:0 answers round robin and through a failover with the
    bytes of a CPU server, and the replicas launched the match kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", _CARD_FLEET], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["equal"] is True
    assert got["served"][0] >= 2 and got["served"][1] >= 5
    assert got["launches"] >= 7
