"""Port parity, the observability spine: trivy_tpu_torch's metrics
registry and catalog, its context tracer, log correlation, the CLI's
`--trace` / `--trace-export` / `--log-format`, the server's `/metrics`,
trace stitching across the wire, the torch.profiler capture, the
`analysis.*` and `db.*` fault sites, and the port's lock-order witness,
each against the JAX package's (trivy_tpu/obs, trivy_tpu/log.py,
trivy_tpu/analysis/witness.py).

The tolerance is exact equality: of exposition bytes for registries
fed the same samples, of `# HELP` / `# TYPE` lines for the catalogs, of
series, label sets and counts (never durations) for `/metrics` after the
same scans, of span names and parentage for traced scans, of report
bytes between a traced and an untraced run. Random ids (trace, span)
and wall times are the only values left out.

Both packages' tracing state is process-wide: every test here leaves
both tracers disabled and empty, both attribution sinks released and
both usage registries empty (`obs_state`), and fails on a lock-order
cycle in the port's witness (`port_witness`; tests/conftest.py checks
the JAX package's). test_torch_attrib.py and test_torch_usage.py use
the same two fixtures.
"""

from __future__ import annotations

import ast
import collections
import contextlib
import hashlib
import io
import json
import os
import re
import threading
import time
import urllib.request
from pathlib import Path

import pytest
import test_sbom_e2e
import torch
from test_torch_cli import fixture_db

import trivy_tpu.db.oci as jax_oci
import trivy_tpu.obs.metrics as jax_metrics
from trivy_tpu import log as jax_log
from trivy_tpu.cache.cache import MemoryCache as JaxMemoryCache
from trivy_tpu.cli import main as jax_main
from trivy_tpu.cli import run as jax_run
from trivy_tpu.db import AdvisoryDB as JaxAdvisoryDB
from trivy_tpu.db import generations as jax_generations
from trivy_tpu.detector.engine import MatchEngine as JaxEngine
from trivy_tpu.fanal import pipeline as jax_pipeline
from trivy_tpu.obs import attrib as jax_attrib
from trivy_tpu.obs import tracing as jax_tracing
from trivy_tpu.obs import usage as jax_usage
from trivy_tpu.resilience import faults as jax_faults
from trivy_tpu.rpc import client as jax_client
from trivy_tpu.rpc.server import Server as JaxServer
from trivy_tpu.types.scan import ScanOptions as JaxScanOptions
from trivy_tpu_torch import log as port_log
from trivy_tpu_torch.analysis import witness as port_witness_mod
from trivy_tpu_torch.cache.cache import MemoryCache
from trivy_tpu_torch.cli import run
from trivy_tpu_torch.cli.main import main
from trivy_tpu_torch.db import Advisory, AdvisoryDB, generations
from trivy_tpu_torch.db import oci as port_oci
from trivy_tpu_torch.db.model import VulnerabilityMeta
from trivy_tpu_torch.detector.engine import MatchEngine
from trivy_tpu_torch.fanal import pipeline as port_pipeline
from trivy_tpu_torch.obs import attrib as port_attrib
from trivy_tpu_torch.obs import metrics as port_metrics
from trivy_tpu_torch.obs import tracing as port_tracing
from trivy_tpu_torch.obs import usage as port_usage
from trivy_tpu_torch.resilience import faults as port_faults
from trivy_tpu_torch.rpc import client as port_client
from trivy_tpu_torch.rpc.server import Server
from trivy_tpu_torch.types.scan import ScanOptions

pytestmark = pytest.mark.obs

ROOT = Path(__file__).resolve().parents[1]
FAKE_TIME = "2024-01-01T00:00:00+00:00"
TOKEN = "obs-token"

# one entry per package: its metrics module, tracer, attribution,
# usage registry and fault injector
PKGS = {
    "ref": dict(metrics=jax_metrics, tracing=jax_tracing,
                attrib=jax_attrib, usage=jax_usage, faults=jax_faults,
                pipeline=jax_pipeline, oci=jax_oci,
                generations=jax_generations, AdvisoryDB=JaxAdvisoryDB),
    "port": dict(metrics=port_metrics, tracing=port_tracing,
                 attrib=port_attrib, usage=port_usage, faults=port_faults,
                 pipeline=port_pipeline, oci=port_oci,
                 generations=generations, AdvisoryDB=AdvisoryDB),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and idle OpenMP workers spin on cores their neighbours' timing
    tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reset_spines() -> None:
    """Both packages' tracing, attribution and usage back to their
    import-time state: tracing off and empty, no span sink, no
    attribution reference held, empty aggregates, usage tables and
    per-tenant counters."""
    for p in PKGS.values():
        tr, at, us = p["tracing"], p["attrib"], p["usage"]
        tr.enable(False)
        tr.reset()
        tr.set_slow_span_ms(None)
        with at._refs_lock:
            at._refs = 0
        tr.set_sink(None)
        at.AGG.reset()
        us.USAGE.journal_close()
        us.USAGE.reset()
        # usage's conservation check compares the (reset) registry with
        # the attribution spine's counter: both start cold
        m = p["metrics"]
        for metric in (m.ATTRIB_LANE_SECONDS, m.TENANT_SCANS,
                       m.TENANT_SHEDS, m.TENANT_QUERIES,
                       m.TENANT_ROWS_MATCHED, m.TENANT_WIRE_BYTES,
                       m.TENANT_LANE_SECONDS):
            metric.clear()


@pytest.fixture(autouse=True)
def obs_state():
    reset_spines()
    yield
    reset_spines()


@pytest.fixture(autouse=True)
def port_witness():
    """The port's lock-order witness (its locks read the same
    TRIVY_TPU_LOCK_WITNESS that tests/conftest.py sets for the `obs`
    marker): a cycle in its graph fails the test."""
    port_witness_mod.WITNESS.reset()
    yield
    cycle = port_witness_mod.WITNESS.find_cycle()
    if cycle:
        pytest.fail("lock-order cycle witnessed in the port: "
                    + " -> ".join(cycle) + "\n"
                    + port_witness_mod.WITNESS.report())


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return PKGS[request.param]


# ------------------------------------------------------------ registry

def test_concurrent_increments(pkg):
    c = pkg["metrics"].Registry().counter("t_total", "h", labels=("k",))

    def work():
        for _ in range(2500):
            c.inc(k="x")

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert c.value(k="x") == 8 * 2500


def test_cardinality_guard(pkg):
    m = pkg["metrics"]
    c = m.Registry().counter("t_total", "h", labels=("k",), max_series=4)
    for i in range(4):
        c.inc(k=f"v{i}")
    with pytest.raises(m.CardinalityError):
        c.inc(k="v-one-too-many")
    c.inc(k="v0")
    assert c.value(k="v0") == 2


def test_label_set_and_reregistration(pkg):
    m = pkg["metrics"]
    reg = m.Registry()
    c = reg.counter("t_total", "h", labels=("k",))
    with pytest.raises(m.MetricError):
        c.inc(wrong="x")
    with pytest.raises(m.MetricError):
        c.inc()
    with pytest.raises(m.MetricError):
        c.inc(-1, k="x")
    assert reg.counter("t_total", "h", labels=("k",)) is c
    with pytest.raises(m.MetricError):
        reg.gauge("t_total", "h")
    with pytest.raises(m.MetricError):
        reg.counter("t_total", "h")


def test_histogram_bucket_boundaries(pkg):
    h = pkg["metrics"].Registry().histogram("t_seconds", "h",
                                            buckets=(1.0, 2.0))
    for v in (1.0, 2.0, 2.0001, 0.0):
        h.observe(v)
    cum, total, count = h.snapshot()
    assert cum == [2, 3, 4] and count == 4
    assert abs(total - 5.0001) < 1e-9


def _fed_registry(m):
    reg = m.Registry()
    c = reg.counter("app_requests_total", "Requests served",
                    labels=("code",))
    c.inc(code="200")
    c.inc(2, code="503")
    g = reg.gauge("app_temperature", "Ambient")
    g.set(3.5)
    g2 = reg.gauge("app_age_seconds", "Age")
    g2.set_function(lambda: 42.0)
    h = reg.histogram("app_latency_seconds", "Latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.75, exemplar="ab" * 16)
    return reg


def test_exposition_equals_the_reference():
    """The same samples render the same bytes, in the 0.0.4 text and
    the OpenMetrics exposition (exemplars and `# EOF`)."""
    ref, port = _fed_registry(jax_metrics), _fed_registry(port_metrics)
    assert port.render() == ref.render()
    assert port.render().decode().startswith(
        "# HELP app_requests_total Requests served\n")

    def strip_ts(b):  # exemplar timestamps are wall clock
        return re.sub(rb"(# \{[^}]*\} \S+) \S+", rb"\1 T", b)

    assert strip_ts(port.render_openmetrics()) == \
        strip_ts(ref.render_openmetrics())


def _meta_lines(text: bytes) -> list[str]:
    return [ln for ln in text.decode().splitlines() if ln.startswith("# ")]


def test_catalog_help_and_type_lines_equal_the_reference():
    """Every metric the reference registers at import, the fleet ones
    included, is registered by the port with the same name, HELP text
    and type, in the same order."""
    want = _meta_lines(jax_metrics.REGISTRY.render())
    got = _meta_lines(port_metrics.REGISTRY.render())
    assert got == want
    assert len([ln for ln in got if ln.startswith("# TYPE")]) >= 70


def test_server_metrics_catalog_equals_the_reference():
    """The server's private registry: a fresh one renders the same
    bytes, and /metrics appends the process-wide catalog."""
    from trivy_tpu.rpc.server import Metrics as JaxMetrics
    from trivy_tpu_torch.rpc.server import Metrics

    assert Metrics().registry.render() == JaxMetrics().registry.render()
    text = Metrics().render().decode()
    for name in ("trivy_tpu_scans_total", "trivy_tpu_cache_corrupt_total",
                 "trivy_tpu_scan_phase_seconds",
                 "trivy_tpu_sched_batch_rows",
                 "trivy_tpu_db_generation_age_seconds"):
        assert f"# TYPE {name} " in text, name
    assert _meta_lines(Metrics().render()) == \
        _meta_lines(JaxMetrics().render())


# -------------------------------------------------------------- tracer

def test_ids_and_parentage(pkg):
    tr = pkg["tracing"]
    tr.enable(True)
    with tr.span("outer") as outer:
        with tr.span("inner") as inner:
            pass
    assert len(outer.trace_id) == 32 and len(outer.span_id) == 16
    assert inner.trace_id == outer.trace_id
    assert inner.parent_id == outer.span_id and outer.parent_id == ""
    assert [s.name for s in tr.spans()] == ["outer", "inner"]


def test_worker_spans_attach_to_the_submitting_scan(pkg):
    """A capture() taken on the submitting thread and adopt()ed on a
    worker keeps the worker's spans under the submitting span."""
    tr = pkg["tracing"]
    tr.enable(True)
    with tr.span("scan") as root:
        ctx = tr.capture()

        def work(i):
            with tr.adopt(ctx), tr.span("item", i=i):
                pass

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
    assert len(tr.spans()) == 7
    assert [s for s in tr.spans() if not s.parent_id] == [root]
    assert {s.trace_id for s in tr.spans()} == {root.trace_id}


def test_reset_is_cross_thread_and_idempotent(pkg):
    tr = pkg["tracing"]
    tr.enable(True)
    release, opened = threading.Event(), threading.Event()

    def straggler():
        with tr.span("straggler"):
            opened.set()
            release.wait(5)

    t = threading.Thread(target=straggler)
    t.start()
    assert opened.wait(5)
    tr.reset()
    release.set()
    t.join(5)
    assert not t.is_alive() and tr.render() == ""
    tr.enable(False)
    tr.reset()
    tr.reset()


def test_scan_scope_and_log_fields(pkg):
    tr = pkg["tracing"]
    tr.enable(True)
    assert tr.log_fields() is None
    with tr.scan_scope() as sid:
        with tr.span("s") as s:
            assert tr.log_fields() == {"trace_id": s.trace_id,
                                       "span_id": s.span_id,
                                       "scan_id": sid}
        with tr.scan_scope() as again:
            assert again == sid
        with tr.scan_scope(force=True) as fresh:
            assert fresh != sid
    assert tr.log_fields() is None


@pytest.mark.parametrize("name", ["ref", "port"])
def test_slow_span_logged_when_tracing_is_off(name, capsys):
    tr = PKGS[name]["tracing"]
    log = jax_log if name == "ref" else port_log
    tr.set_slow_span_ms(0.0)
    try:
        log.init()
        with tr.span("sluggish"):
            time.sleep(0.002)
        err = capsys.readouterr().err
        assert "slow span: sluggish" in err and "ms=" in err
    finally:
        tr.set_slow_span_ms(None)
        log.init()
    assert tr.render() == ""


def test_trace_header_round_trip(pkg):
    tr = pkg["tracing"]
    tr.enable(True)
    with tr.span("client") as s:
        headers: dict = {}
        tr.inject_headers(headers)
        assert tr.parse_trace_header(headers[tr.TRACE_HEADER]) == \
            (s.trace_id, s.span_id)
    assert tr.parse_trace_header(None) is None
    assert tr.parse_trace_header("garbage") is None
    assert tr.parse_trace_header("zz-yy") is None
    assert tr.parse_attempt_tag("a-b-1.2.f") == (1, 2, "failover")


def test_disabled_span_is_the_shared_no_op():
    """The disabled fast path allocates no Span: with tracing off, no
    slow-span threshold and no sink, span() hands back one shared no-op
    (the reference guards this with a wall-clock test; this checks the
    mechanism itself)."""
    assert not port_tracing.enabled()
    created = []
    real = port_tracing.Span
    port_tracing.Span = lambda *a, **k: created.append(1) or real(*a, **k)
    try:
        first = port_tracing.span("a", k=1)
        assert first is port_tracing.span("b") is port_tracing._NOOP
        with first as s:
            assert s is None
    finally:
        port_tracing.Span = real
    assert created == [] and port_tracing.spans() == []


def test_make_lock_is_the_raw_primitive_when_the_witness_is_off(
        monkeypatch):
    monkeypatch.delenv(port_witness_mod.ENV, raising=False)
    lock = threading.Lock()
    assert port_witness_mod.make_lock("x", lock) is lock
    monkeypatch.setenv(port_witness_mod.ENV, "1")
    wrapped = port_witness_mod.make_lock("x", lock)
    assert wrapped is not lock
    cond = port_witness_mod.make_lock("y", threading.Condition())
    with wrapped:
        with cond:
            pass
    assert port_witness_mod.WITNESS.edges() == {"x": {"y"}}
    assert port_witness_mod.find_cycle({"a": {"b"}, "b": {"a"}}) == \
        ["a", "b", "a"]


# ------------------------------------------------------------- the CLI

@pytest.fixture()
def golden_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", FAKE_TIME)
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()
    fixture_db().save(str(tmp_path / "db"))
    (tmp_path / "bom.json").write_text(json.dumps(test_sbom_e2e.CDX_DOC))
    yield {"sbom": str(tmp_path / "bom.json"), "db": str(tmp_path / "db"),
           "tmp": tmp_path}
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()


def _tree(export: str) -> collections.Counter:
    """(span name, parent span name) pairs of a Chrome trace export."""
    events = json.load(open(export))["traceEvents"]
    names = {e["args"]["span_id"]: e["name"] for e in events}
    assert len({e["args"]["trace_id"] for e in events}) == 1
    return collections.Counter(
        (e["name"], names.get(e["args"].get("parent_id"), ""))
        for e in events)


def _cli(entry, argv, capsys):
    rc = entry(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("fmt", ["json", "table"])
def test_sbom_trace_export_equals_the_reference(golden_env, capsys, fmt):
    """`sbom --trace --trace-export`: the port exports the reference's
    span names under the same parents, one trace id, and its report
    equals the untraced run's byte for byte."""
    env = golden_env
    base = ["sbom", env["sbom"], "--db-path", env["db"], "--format", fmt,
            "--quiet", "--cache-dir", str(env["tmp"] / "c")]
    rc, plain, _ = _cli(main, base + ["--device", "cpu"], capsys)
    assert rc == 0
    export = {k: str(env["tmp"] / f"{k}.json") for k in ("port", "ref")}
    rc, traced, err = _cli(main, base + ["--device", "cpu", "--trace",
                                         "--trace-export",
                                         export["port"]], capsys)
    assert rc == 0 and traced == plain
    assert err.startswith("-- trace ") and "engine.dispatch" in err
    rc, want, _ = _cli(jax_main.main, base + ["--trace-export",
                                              export["ref"]], capsys)
    assert rc == 0 and want == plain
    assert _tree(export["port"]) == _tree(export["ref"])
    tree = _tree(export["port"])
    for child, parent in (("scan_artifact", "scan"),
                          ("driver.scan", "scan_artifact"),
                          ("detect", "driver.scan"),
                          ("engine.dispatch", "detect"),
                          ("report", "scan")):
        assert tree[(child, parent)] >= 1, (child, parent)
    assert not port_tracing.enabled()


def test_fs_trace_export_equals_the_reference(tmp_path, capsys,
                                              monkeypatch):
    """`fs --trace-export` on a seeded tree with an OS root, lockfiles
    and secrets: the reference's spans and parentage, the report of the
    untraced run (uuids pinned in both packages)."""
    from test_torch_fanal import seeded_db, seeded_tree

    from trivy_tpu.utils import uuid as jax_uuid
    from trivy_tpu_torch.utils import uuid as port_uuid

    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", FAKE_TIME)
    monkeypatch.setenv("TRIVY_TPU_DETERMINISTIC_UUID", "1")
    tree_dir = seeded_tree(tmp_path / "tree")
    db = str(tmp_path / "db")
    seeded_db().save(db)
    base = ["fs", str(tree_dir), "--db-path", db, "--format", "json",
            "--quiet"]
    outs, trees = {}, {}
    for name, entry, extra in (("plain", main, ["--device", "cpu"]),
                               ("port", main, ["--device", "cpu"]),
                               ("ref", jax_main.main, [])):
        port_uuid.reset()
        jax_uuid.reset()
        run._ENGINE_CACHE.clear()
        jax_run._ENGINE_CACHE.clear()
        export = str(tmp_path / f"{name}.json")
        argv = base + extra + ["--cache-dir", str(tmp_path / name)]
        if name != "plain":
            argv += ["--trace-export", export]
        rc, outs[name], _ = _cli(entry, argv, capsys)
        assert rc == 0
        if name != "plain":
            trees[name] = _tree(export)
    assert outs["port"] == outs["plain"] == outs["ref"]
    assert trees["port"] == trees["ref"]
    assert trees["port"][("secret_results", "detect")] == 1
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()


def test_json_log_lines_join_the_exported_trace(golden_env, capsys):
    """`--log-format json`: every line logged inside the run carries the
    trace id and a span id of the export, and a scan id; so does the
    reference's."""
    env = golden_env
    for name, entry, extra in (("port", main, ["--device", "cpu"]),
                               ("ref", jax_main.main, [])):
        export = str(env["tmp"] / f"{name}.json")
        rc, _out, err = _cli(entry, [
            "sbom", env["sbom"], "--db-path", env["db"], "--format",
            "json", "--log-format", "json", "--trace-export", export,
            "--cache-dir", str(env["tmp"] / name), *extra], capsys)
        assert rc == 0
        events = json.load(open(export))["traceEvents"]
        trace_ids = {e["args"]["trace_id"] for e in events}
        span_ids = {e["args"]["span_id"] for e in events}
        lines = [json.loads(ln) for ln in err.splitlines()]
        inside = [d for d in lines if d["msg"] != "trace exported"]
        assert inside, name
        for d in inside:
            assert d["trace_id"] in trace_ids, (name, d)
            assert d["span_id"] in span_ids, (name, d)
        # lines of the scan proper carry its scan id too
        assert any(d.get("scan_id") for d in inside), name
        assert lines[-1]["msg"] == "trace exported"
        assert lines[-1]["spans"] == len(events)


def test_trace_export_to_a_bad_path_keeps_the_exit_code(golden_env,
                                                        capsys):
    env = golden_env
    rc, out, err = _cli(main, [
        "sbom", env["sbom"], "--db-path", env["db"], "--format", "json",
        "--device", "cpu", "--trace-export",
        str(env["tmp"] / "missing" / "t.json"),
        "--cache-dir", str(env["tmp"] / "c")], capsys)
    assert rc == 0 and json.loads(out)["Results"]
    assert "trace export failed" in err
    assert not port_tracing.enabled()


# --------------------------------------------------- servers and wires

def _db(n: int = 12) -> AdvisoryDB:
    db = AdvisoryDB()
    for i in range(n):
        db.put_advisory("npm::ghsa", f"pkg{i}", Advisory(
            vulnerability_id=f"CVE-2026-{1000 + i}",
            vulnerable_versions=[f"<{(i % 4) + 2}.0.0"],
            fixed_version=f"{(i % 4) + 2}.0.0"))
        db.put_meta(VulnerabilityMeta.from_json(
            f"CVE-2026-{1000 + i}", {"Title": f"bug {i}",
                                     "Severity": "HIGH"}))
    return db


def _blob(n: int = 12) -> dict:
    pkgs = [{"id": f"pkg{i}@1.0.0", "name": f"pkg{i}", "version": "1.0.0",
             "identifier": {"purl": f"pkg:npm/pkg{i}@1.0.0"}}
            for i in range(n)]
    return {"schema_version": 2, "applications": [{
        "type": "npm", "file_path": "package-lock.json",
        "packages": pkgs}]}


@pytest.fixture()
def servers(tmp_path, monkeypatch):
    """A port and a reference server on the same saved DB, both behind
    TOKEN, engines on the CPU."""
    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", FAKE_TIME)
    root = str(tmp_path / "db")
    _db().save(root)
    port = Server(MatchEngine(AdvisoryDB.load(root), device="cpu"),
                  MemoryCache(), host="127.0.0.1", port=0, token=TOKEN)
    ref = JaxServer(JaxEngine(JaxAdvisoryDB.load(root), use_device=False),
                    JaxMemoryCache(), host="127.0.0.1", port=0,
                    token=TOKEN)
    for s in (port, ref):
        s.start()
    try:
        yield {"port": port, "ref": ref}
    finally:
        port_client.close_pool()
        with jax_client._CONN_POOL_LOCK:
            pooled = list(jax_client._CONN_POOL.values())
        for c in pooled:
            c.close()
        for s in (port, ref):
            s.shutdown()


def _get(url: str, path: str, token: str | None = TOKEN,
         accept: str | None = None):
    req = urllib.request.Request(url + path)
    if token:
        req.add_header("Trivy-Token", token)
    if accept:
        req.add_header("Accept", accept)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.headers, e.read()


def _scan_with(name: str, address: str, n_scans: int = 2) -> None:
    """Each package's own client: one PutBlob, `n_scans` scans."""
    if name == "port":
        cache = port_client.RemoteCache(address, token=TOKEN)
        driver = port_client.RemoteDriver(address, token=TOKEN)
        opts = ScanOptions()
    else:
        cache = jax_client.RemoteCache(address, token=TOKEN)
        driver = jax_client.RemoteDriver(address, token=TOKEN)
        opts = JaxScanOptions()
    cache.put_blob("sha256:b", _blob())
    for _ in range(n_scans):
        results, _os = driver.scan("img", "", ["sha256:b"], opts)
        assert sum(len(r.vulnerabilities) for r in results) == 12


_SAMPLE = re.compile(r"^([a-zA-Z_:][\w:]*)(\{[^}]*\})? (\S+)$")


def _samples(text: bytes) -> tuple[dict, dict]:
    """-> ({series: value}, {metric: type}) of a 0.0.4 exposition."""
    values, types = {}, {}
    for ln in text.decode().splitlines():
        if ln.startswith("# TYPE "):
            _h, _t, name, kind = ln.split()
            types[name] = kind
        elif ln and not ln.startswith("#"):
            m = _SAMPLE.match(ln)
            values[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return values, types


def _counted(before: bytes, after: bytes) -> dict:
    """Series whose count moved between two scrapes, with the move:
    counters (not ones that add up seconds) and histograms' `_count`.
    Gauges, durations and bucket spreads are wall-time data."""
    b, _ = _samples(before)
    a, types = _samples(after)
    out = {}
    for (name, labels), v in a.items():
        base = name[:-len("_count")] if name.endswith("_count") else None
        if base is not None and types.get(base) == "histogram":
            pass
        elif types.get(name) == "counter" and "seconds" not in name:
            pass
        else:
            continue
        d = v - b.get((name, labels), 0.0)
        if d:
            out[(name, labels)] = d
    return out


def test_metrics_after_the_same_scans_equal_the_reference(servers):
    """Two scans through each package's client against its own server
    move the same series, label sets and counts in `/metrics`
    (durations aside), and both scrape with the same content types."""
    moved, ctypes = {}, {}
    for name in ("port", "ref"):
        addr = servers[name].address
        s0, h, before = _get(addr, "/metrics")
        assert s0 == 200
        _scan_with(name, addr)
        _s, _h, after = _get(addr, "/metrics")
        om = _get(addr, "/metrics",
                  accept="application/openmetrics-text")
        assert om[2].endswith(b"# EOF\n")
        ctypes[name] = (h["Content-Type"], om[1]["Content-Type"])
        moved[name] = _counted(before, after)
    assert moved["port"] == moved["ref"]
    assert ctypes["port"] == ctypes["ref"]
    got = moved["port"]
    assert got[("trivy_tpu_scans_total", "")] == 2
    assert got[("trivy_tpu_findings_total", "")] == 24
    assert got[("trivy_tpu_scan_phase_seconds_count",
                '{phase="detect"}')] == 2
    assert got[("trivy_tpu_sched_batch_rows_count", "")] == \
        servers["port"].service.scheduler.stats["batches"]


@pytest.mark.parametrize("client,server", [("port", "ref"),
                                           ("ref", "port")])
def test_trace_stitches_across_the_wire(servers, client, server):
    """A client span's identity rides X-Trivy-Trace: the other
    package's `server.scan` span joins the client's trace as the child
    of its `rpc.Scan` span, and the server's phases nest under it."""
    ctr, str_ = PKGS[client]["tracing"], PKGS[server]["tracing"]
    ctr.enable(True)
    str_.enable(True)
    with ctr.span("client") as root:
        _scan_with(client, servers[server].address, n_scans=1)
    rpc = [s for s in ctr.spans() if s.name == "rpc.Scan"]
    assert len(rpc) == 1 and rpc[0].trace_id == root.trace_id
    srv = [s for s in str_.spans() if s.name == "server.scan"]
    assert len(srv) == 1
    assert (srv[0].trace_id, srv[0].parent_id) == \
        (root.trace_id, rpc[0].span_id)
    under = {c.name for c in srv[0].children}
    assert {"apply_layers", "detect"} <= under


def test_fault_injections_are_counted():
    port_faults.install_spec("analysis.fetch:drop@1")
    try:
        before = port_metrics.FAULT_FIRES.value(site="analysis.fetch",
                                                action="drop")
        port_pipeline.fetch_with_retry(lambda: b"x")
        assert port_metrics.FAULT_FIRES.value(
            site="analysis.fetch", action="drop") == before + 1
    finally:
        port_faults.reset()


# ----------------------------------------------------- device profile

def test_torch_profile_writes_one_chrome_trace_per_call(tmp_path,
                                                        monkeypatch):
    from trivy_tpu_torch.tensorize.synth import synth_queries, synth_trivy_db

    db = synth_trivy_db(n_advisories=2000, seed=5)
    engine = MatchEngine(db, device="cpu")
    qs = synth_queries(db, 64, seed=6)
    with port_tracing.torch_profile():  # variable unset: no capture
        engine.detect(qs)
    monkeypatch.setenv(port_tracing.PROFILE_DIR_ENV, str(tmp_path / "p"))
    assert port_tracing.PROFILE_DIR_ENV == "TRIVY_TPU_JAX_TRACE_DIR"
    with port_tracing.torch_profile():
        engine.detect(qs)
    files = os.listdir(tmp_path / "p")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    doc = json.load(open(tmp_path / "p" / files[0]))
    assert doc["traceEvents"]


def test_torch_profile_flags_every_capture_after_the_first(
        tmp_path, monkeypatch, caplog):
    """Captures after a process's first warn once each (a later
    torch.profiler session may lose kernel events on a card), and every
    trace records its session number."""
    monkeypatch.setattr(port_tracing, "_profile_sessions", 0)
    monkeypatch.setenv(port_tracing.PROFILE_DIR_ENV, str(tmp_path / "p"))
    sessions, warned = [], []
    for _ in range(3):
        caplog.clear()
        before = set(os.listdir(tmp_path / "p")) \
            if os.path.exists(tmp_path / "p") else set()
        with caplog.at_level("WARNING", logger="trivy_tpu_torch"):
            with port_tracing.torch_profile():
                torch.ones(4).sum()
        (path,) = set(os.listdir(tmp_path / "p")) - before
        doc = json.load(open(tmp_path / "p" / path))
        sessions.append(doc["trivy_tpu_profile_session"])
        warned.append([r.kvs for r in caplog.records
                       if "may lose kernel events" in r.getMessage()])
    assert sessions == ["1", "2", "3"]
    assert warned == [[], [{"session": 2}], [{"session": 3}]]


def test_torch_profile_refuses_to_nest(tmp_path, monkeypatch):
    monkeypatch.setenv(port_tracing.PROFILE_DIR_ENV, str(tmp_path / "p"))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(port_tracing.ProfilerActive,
                           match="already active"):
            with port_tracing.torch_profile():
                pass
    assert not os.path.exists(tmp_path / "p")


_CARD_CAPTURE = """
import json
from trivy_tpu_torch.detector.engine import MatchEngine
from trivy_tpu_torch.obs import tracing
from trivy_tpu_torch.ops import match as m
from trivy_tpu_torch.tensorize.synth import synth_queries, synth_trivy_db

db = synth_trivy_db(n_advisories=20_000, seed=5)
engine = MatchEngine(db, device="cuda:0")
qs = synth_queries(db, 512, seed=6)
engine.detect(qs)  # kernel build, warm
tracing.enable(True)
before = m.match_words.launches
with tracing.span("scan"), tracing.torch_profile():
    engine.detect(qs)
print(json.dumps({"launches": m.match_words.launches - before,
                  "spans": [s.name for s in tracing.spans()]}))
"""


@pytest.mark.cuda
def test_traced_detect_on_the_card_names_the_match_kernel(tmp_path):
    """On a card: a detect under the spine's spans and the profiler
    capture, in a fresh process (its only profiler session: on an H100
    a process's later sessions lose kernel events, PERF.md);
    the Chrome trace names the match kernel once per launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    import subprocess
    import sys

    env = {**os.environ, port_tracing.PROFILE_DIR_ENV: str(tmp_path / "p"),
           "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", _CARD_CAPTURE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "engine.dispatch" in got["spans"]
    (path,) = os.listdir(tmp_path / "p")
    events = json.load(open(tmp_path / "p" / path))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "match_kernel" in e.get("name", "")]
    assert got["launches"] and len(kernels) == got["launches"]


# ------------------------------------------------------- fault sites

_FETCH_SPECS = ["", "analysis.fetch:drop@1", "analysis.fetch:error@1",
                "analysis.fetch:error@1-2", "analysis.fetch:delay=0.001@1",
                "analysis.fetch:kill@1"]
_LANE_SPECS = ["", "analysis.lane:drop@1", "analysis.lane:error@1",
               "analysis.lane:error@1-2", "analysis.lane:delay=0.001@1",
               "analysis.lane:kill@1"]


def _run_site(p, fn_name: str, spec: str):
    """One guarded call under `spec` -> (outcome, calls of the work)."""
    faults = p["faults"]
    faults.reset()
    faults.set_kill_mode("raise")
    if spec:
        faults.install_spec(spec)
    calls = []

    def work():
        calls.append(1)
        return io.BytesIO(b"layer") if fn_name == "fetch_with_retry" \
            else {"doc": len(calls)}

    try:
        out = getattr(p["pipeline"], fn_name)(work)
        outcome = out.getvalue() if hasattr(out, "getvalue") else out
    except (Exception, faults.InjectedKill) as exc:  # the outcome
        outcome = type(exc).__name__
    finally:
        faults.reset()
        faults.set_kill_mode("sigkill")
    return outcome, len(calls)


@pytest.mark.parametrize("spec", _FETCH_SPECS)
def test_analysis_fetch_fault_matrix_equals_the_reference(spec):
    got = _run_site(PKGS["port"], "fetch_with_retry", spec)
    assert got == _run_site(PKGS["ref"], "fetch_with_retry", spec)


@pytest.mark.parametrize("spec", _LANE_SPECS)
def test_analysis_lane_fault_matrix_equals_the_reference(spec):
    got = _run_site(PKGS["port"], "lane_with_retry", spec)
    assert got == _run_site(PKGS["ref"], "lane_with_retry", spec)


@pytest.mark.parametrize("spec", ["analysis.fetch:drop@2",
                                  "analysis.fetch:error@1",
                                  "analysis.lane:drop@1",
                                  "analysis.lane:error@2"])
@pytest.mark.parametrize("workers", [1, 3])
def test_layer_lanes_under_faults_equal_the_fault_free_run(spec, workers):
    """run_layer_lanes with a healed fault applies the same documents
    in layer order as without it, in both packages."""
    def go(p, spec):
        faults = p["faults"]
        faults.reset()
        if spec:
            faults.install_spec(spec)
        applied = []
        try:
            p["pipeline"].run_layer_lanes(
                list(range(5)), lambda i: io.BytesIO(b"%d" % i),
                lambda i, payload: p["pipeline"].lane_with_retry(
                    lambda: (i, payload.getvalue())),
                lambda i, doc: applied.append(doc), workers=workers)
        finally:
            faults.reset()
        return applied

    want = [(i, b"%d" % i) for i in range(5)]
    for p in PKGS.values():
        assert go(p, "") == go(p, spec) == want


def _db_layer_tgz(updated_at: str) -> bytes:
    import gzip
    import tarfile
    import tempfile

    db = _db(2)
    db.meta.updated_at = updated_at
    with tempfile.TemporaryDirectory() as d:
        db.save(d)
        payload = io.BytesIO()
        with tarfile.open(fileobj=payload, mode="w") as tf:
            for name in sorted(os.listdir(d)):
                tf.add(os.path.join(d, name), arcname=name)
    return gzip.compress(payload.getvalue())


def _install_under(p, root: str, spec: str, monkeypatch, data: bytes):
    """install_artifact under `spec` -> what a next start sees."""
    digest = "sha256:" + hashlib.sha256(data).hexdigest()
    monkeypatch.setattr(p["oci"], "_fetch_layer",
                        lambda *a, **k: (data, digest))
    faults, gens = p["faults"], p["generations"]
    faults.set_kill_mode("raise")
    faults.install_spec(spec)
    try:
        p["oci"].install_artifact("reg.io/db:2", root)
        outcome = "installed"
    except faults.InjectedKill:
        outcome = "killed"
    finally:
        faults.reset()
        faults.set_kill_mode("sigkill")
    try:
        served = p["AdvisoryDB"].load(root).meta.updated_at
    except FileNotFoundError:
        served = None
    cur = os.path.basename(os.path.realpath(gens.resolve(root)))
    left = sorted(".tmp-" in n for n in os.listdir(gens.generations_root(
        root)))
    return outcome, cur, served, left


@pytest.mark.parametrize("spec", ["db.install.extract:kill@1",
                                  "db.install.promote:kill@1"])
def test_db_install_crash_points_equal_the_reference(tmp_path, monkeypatch,
                                                     spec):
    """A kill at each crash point of `db download`'s install leaves what
    the reference leaves: the old generation served, the new one staged
    or swept, and a re-install completes."""
    got = {}
    old = _db_layer_tgz("2024-01-01T00:00:00Z")
    new = _db_layer_tgz("2024-02-02T00:00:00Z")
    for name, p in PKGS.items():
        root = str(tmp_path / name)
        got[name] = tuple(_install_under(p, root, s, monkeypatch, data)
                          for s, data in (("", old), (spec, new),
                                          ("", new)))
    assert got["port"] == got["ref"]
    assert got["port"][1][0] == "killed"
    assert got["port"][1][2] == "2024-01-01T00:00:00Z"
    assert got["port"][2][2] == "2024-02-02T00:00:00Z"


@pytest.mark.parametrize("spec", ["db.download:torn-write@1",
                                  "db.download:bitflip@1"])
def test_a_mangled_download_never_lands(tmp_path, spec):
    """A torn or flipped blob at the `db.download` site fails the
    digest check before extraction, with the reference's error."""
    data = b"x" * 100
    errors = {}
    for name, p in PKGS.items():
        oci = p["oci"]

        class FakeClient:
            def __init__(self, *a, **k):
                pass

            def manifest(self, repo, ref):
                return {"layers": [{
                    "mediaType": oci.DB_MEDIA_TYPE,
                    "digest": "sha256:" + hashlib.sha256(data).hexdigest(),
                    "size": len(data)}]}, "sha256:m"

            def blob(self, repo, digest):
                return data

        p["faults"].install_spec(spec)
        real = oci.RegistryClient
        oci.RegistryClient = FakeClient
        try:
            with pytest.raises(oci.OCIError) as exc:
                oci.download_artifact("reg.io/db:2",
                                      str(tmp_path / name),
                                      media_type=oci.DB_MEDIA_TYPE)
        finally:
            oci.RegistryClient = real
            p["faults"].reset()
        errors[name] = str(exc.value)
        assert not os.path.exists(tmp_path / name)
    assert errors["port"] == errors["ref"]


# ------------------------------------------------------------- taxonomy

_SPAN_FNS = {"span", "phase", "server_span"}


def _emitted(pkg_dir: Path) -> tuple[set, set]:
    """The span-taxonomy lint rule's scan (trivy_tpu/analysis/rules.py
    SpanTaxonomyRule): literal first arguments of span/phase/server_span
    calls, module constants resolved, f-string names as prefixes."""
    names, prefixes = set(), set()
    for path in pkg_dir.rglob("*.py"):
        tree = ast.parse(path.read_text())
        consts = {t.id: n.value.value for n in tree.body
                  if isinstance(n, ast.Assign)
                  and isinstance(n.value, ast.Constant)
                  and isinstance(n.value.value, str)
                  for t in n.targets if isinstance(t, ast.Name)}
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            f = node.func
            tail = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", None)
            if tail not in _SPAN_FNS:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value)
            elif isinstance(arg, ast.Name) and arg.id in consts:
                names.add(consts[arg.id])
            elif isinstance(arg, ast.JoinedStr) and arg.values and \
                    isinstance(arg.values[0], ast.Constant):
                prefixes.add(arg.values[0].value)
    return names, prefixes


# classified names only the fleet scan mode (cli/fleet.py) emits
FLEET_ONLY = {"fleet", "fleet.artifact"}


def test_span_taxonomy_holds_over_the_port():
    """Every span name the port emits is classified by obs/attrib.py,
    and every classified name is emitted by the port, the fleet scan
    mode's too; the taxonomy is the reference's byte for byte."""
    assert port_attrib.SPAN_LANES == jax_attrib.SPAN_LANES
    assert port_attrib.SPAN_STRUCTURAL == jax_attrib.SPAN_STRUCTURAL
    assert port_attrib.SPAN_PREFIX_LANES == jax_attrib.SPAN_PREFIX_LANES
    assert port_attrib.LANES == jax_attrib.LANES
    assert port_attrib.PRIORITY == jax_attrib.PRIORITY
    names, prefixes = _emitted(ROOT / "trivy_tpu_torch")
    declared = set(port_attrib.SPAN_LANES) | port_attrib.SPAN_STRUCTURAL
    known = tuple(p for p, _lane in port_attrib.SPAN_PREFIX_LANES)
    assert [n for n in names if n not in declared
            and not n.startswith(known)] == []
    assert all(p.startswith(known) for p in prefixes), prefixes
    assert declared - names == set()
    assert FLEET_ONLY <= names
    ref_names, _ = _emitted(ROOT / "trivy_tpu")
    assert FLEET_ONLY <= ref_names
