"""Port parity, the scan server and client mode: trivy_tpu_torch's
Server, RemoteDriver / RemoteCache and `--server` CLI clients (engines
on device="cpu", so the match kernel's plain version answers) against
the JAX package's on one saved DB and the same blobs.

Covers the tests/test_rpc.py shapes (health, version, readiness, a
client-server scan, token auth, the advisory-DB hot swap with last-good
and quarantine, the options round trip), the wire codecs (JSON, gzip,
the columnar frames, Twirp protobuf and proto3-JSON) byte for byte
against the reference's, the capability ladder and the kill switches,
the rpc.wire fault ladder, sheds, cross-compatibility (each package's
client against the other's server), the CLI clients (`sbom --server`
and `fs --server` equal to the standalone scan and to the reference's
`--server` report), the MissingBlobs layer gate, and the refusals
(`--report`, `--journal`, `--resume`, `--mesh`, unported fault
sites and routes, `server` without a card), and a replica set or a
server that cannot be reached failing with one line.

The tolerance is exact equality of bytes. Every server is shut down and
every client connection closed in a finalizer; live servers listen on
port 0; every wait has its own timeout.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path
from urllib.parse import urlsplit

import pytest
import test_fanal
import test_sbom_e2e
import torch
from test_torch_cli import fixture_db
from test_torch_fanal import seeded_db, seeded_tree

import trivy_tpu.rpc.client as jax_client
from trivy_tpu.cache.cache import MemoryCache as JaxMemoryCache
from trivy_tpu.cli import main as jax_main
from trivy_tpu.cli import run as jax_run
from trivy_tpu.db import AdvisoryDB as JaxAdvisoryDB
from trivy_tpu.detector.engine import MatchEngine as JaxEngine
from trivy_tpu.detector.engine import PkgQuery as JaxQuery
from trivy_tpu.fanal import analyzer as jax_analyzer
from trivy_tpu.resilience import faults as jax_faults
from trivy_tpu.rpc import columnar as jax_colwire
from trivy_tpu.rpc import twirp as jax_twirp
from trivy_tpu.rpc import wire as jax_wire
from trivy_tpu.rpc.server import Server as JaxServer
from trivy_tpu.types.scan import ScanOptions as JaxScanOptions
from trivy_tpu.utils import uuid as jax_uuid
from trivy_tpu_torch.cache.cache import MemoryCache
from trivy_tpu_torch.cli import run
from trivy_tpu_torch.cli.main import main
from trivy_tpu_torch.db import Advisory, AdvisoryDB, generations
from trivy_tpu_torch.db.model import VulnerabilityMeta
from trivy_tpu_torch.detector.engine import MatchEngine, PkgQuery
from trivy_tpu_torch.fanal import analyzer as port_analyzer
from trivy_tpu_torch.fanal.analyzers import secret_analyzer
from trivy_tpu_torch.resilience import faults
from trivy_tpu_torch.resilience.retry import RetryPolicy
from trivy_tpu_torch.rpc import client as port_client
from trivy_tpu_torch.rpc import columnar as colwire
from trivy_tpu_torch.rpc import twirp, wire
from trivy_tpu_torch.rpc.client import (
    RemoteCache,
    RemoteDriver,
    RPCError,
    _Conn,
)
from trivy_tpu_torch.rpc.server import CACHE_PREFIX, SCAN_PATH, Server
from trivy_tpu_torch.secret import scanner as sc
from trivy_tpu_torch.types.scan import ScanOptions
from trivy_tpu_torch.utils import uuid as port_uuid

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "sbom_cdx.json.golden"
FAKE_TIME = "2024-01-01T00:00:00+00:00"
N_PKGS = 16
FAST_RETRY = RetryPolicy(attempts=3, base_s=0.005, cap_s=0.01)
TIMEOUT_S = 30.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and idle OpenMP workers spin on cores their neighbours' timing
    tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close_analyzers() -> None:
    """Stop the process-wide secret analyzers' lane threads (the CLI
    clients' analysis ran in this process), in both packages."""
    for a in port_analyzer._POST_ANALYZERS:
        if a.type == "secret":
            a.close()
    for a in jax_analyzer._POST_ANALYZERS:
        scanner = getattr(a, "_scanner", None)
        if a.type == "secret" and scanner is not None:
            scanner.close()


def threads_left(before: set) -> list[threading.Thread]:
    """Threads started since `before` that are still alive after up to
    10 s (scheduler threads join on close; a server handler thread ends
    when its client's socket closes)."""
    for _ in range(200):
        left = [t for t in threading.enumerate()
                if t not in before and t.is_alive()]
        if not left:
            return []
        threading.Event().wait(0.05)
    return left


@pytest.fixture(scope="module", autouse=True)
def _no_threads_left():
    before = set(threading.enumerate())
    yield
    close_clients()
    close_analyzers()
    assert threads_left(before) == []


def close_clients() -> None:
    """Close both packages' pooled client sockets, so no server handler
    thread stays parked on an idle keep-alive connection."""
    port_client.close_pool()
    with jax_client._CONN_POOL_LOCK:
        pooled = list(jax_client._CONN_POOL.values())
    for c in pooled:
        c.close()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    faults.reset()
    jax_faults.reset()
    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", FAKE_TIME)
    monkeypatch.setenv("TRIVY_TPU_DETERMINISTIC_UUID", "1")
    monkeypatch.delenv("TRIVY_TPU_SECRET_PACK_MB", raising=False)
    monkeypatch.delenv("TRIVY_TPU_SECRET_STREAM_CHUNK_MB", raising=False)
    monkeypatch.setattr(secret_analyzer, "USE_DEVICE", "hybrid")
    monkeypatch.setattr(secret_analyzer, "DEVICE", None)
    monkeypatch.setattr(sc, "_CACHE_DIR_OVERRIDE", None)
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()
    yield
    faults.reset()
    jax_faults.reset()
    close_clients()
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()


def _db(updated_at: str = "") -> AdvisoryDB:
    db = AdvisoryDB()
    for i in range(N_PKGS):
        db.put_advisory("npm::ghsa", f"pkg{i}", Advisory(
            vulnerability_id=f"CVE-2026-{1000 + i}",
            vulnerable_versions=[f"<{(i % 4) + 2}.0.0"],
            fixed_version=f"{(i % 4) + 2}.0.0",
        ))
        db.put_meta(VulnerabilityMeta.from_json(f"CVE-2026-{1000 + i}", {
            "Title": f"bug {i}", "Severity": "HIGH",
            "CweIDs": ["CWE-79", "CWE-89"],
            "References": [f"https://example.com/{i}"],
        }))
    db.put_advisory("npm::ghsa", "lodash", Advisory(
        vulnerability_id="CVE-2019-10744",
        vulnerable_versions=["<4.17.12"],
    ))
    db.put_meta(VulnerabilityMeta.from_json("CVE-2019-10744", {
        "Title": "prototype pollution", "Severity": "CRITICAL",
    }))
    db.meta.updated_at = updated_at
    return db


def _blob(n: int = N_PKGS) -> dict:
    pkgs = [{"id": f"pkg{i}@1.0.0", "name": f"pkg{i}", "version": "1.0.0",
             "identifier": {"purl": f"pkg:npm/pkg{i}@1.0.0"}}
            for i in range(n)]
    pkgs.append({"id": "lodash@4.17.4", "name": "lodash",
                 "version": "4.17.4",
                 "identifier": {"purl": "pkg:npm/lodash@4.17.4"}})
    return {"schema_version": 2, "applications": [{
        "type": "npm", "file_path": "package-lock.json",
        "packages": pkgs}]}


@pytest.fixture(scope="module")
def db_dir(tmp_path_factory):
    """The DB saved once by the port; both packages load it."""
    path = tmp_path_factory.mktemp("server-db") / "db"
    _db().save(str(path))
    return str(path)


@contextlib.contextmanager
def live(server_cls, engine, cache, **kw):
    srv = server_cls(engine, cache, host="127.0.0.1", port=0, **kw)
    srv.start()
    try:
        yield srv
    finally:
        close_clients()
        srv.shutdown()


@pytest.fixture()
def servers(db_dir):
    """A live port server and a live reference server on the same DB,
    each with blob sha256:b1 and artifact sha256:a in its cache."""
    port_cache, ref_cache = MemoryCache(), JaxMemoryCache()
    for cache in (port_cache, ref_cache):
        cache.put_blob("sha256:b1", _blob())
        cache.put_artifact("sha256:a", {"schema_version": 2})
    with live(Server, MatchEngine(AdvisoryDB.load(db_dir), device="cpu"),
              port_cache) as port, \
            live(JaxServer, JaxEngine(JaxAdvisoryDB.load(db_dir),
                                      use_device=False), ref_cache) as ref:
        yield {"port": port, "ref": ref}


def _raw(addr: str, method: str, path: str, body: bytes | None = None,
         headers: dict | None = None):
    c = http.client.HTTPConnection(urlsplit(addr).netloc, timeout=TIMEOUT_S)
    try:
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        return r.status, r.headers, r.read()
    finally:
        c.close()


def _port_scan(srv, **opts):
    return srv.service.scan("img1", "sha256:a", ["sha256:b1"],
                            ScanOptions(**opts))


def _ref_scan(srv, **opts):
    return srv.service.scan("img1", "sha256:a", ["sha256:b1"],
                            JaxScanOptions(**opts))


# ------------------------------------------------------ health, readiness


@pytest.mark.parametrize("path,accept", [
    ("/healthz", ""), ("/version", ""), ("/readyz", ""),
    ("/readyz", "application/json")], ids=["healthz", "version", "readyz",
                                           "readyz-json"])
def test_health_routes_equal_reference(servers, path, accept):
    got, want = (_raw(servers[k].address, "GET", path,
                      headers={"Accept": accept} if accept else {})
                 for k in ("port", "ref"))
    assert got[0] == want[0] == 200
    assert got[2] == want[2]
    assert got[1].get("Content-Type") == want[1].get("Content-Type")


def test_readyz_not_ready_while_draining_equals_reference(servers):
    for k in ("port", "ref"):
        servers[k].service.start_drain()
    for accept in ("", "application/json"):
        got, want = (_raw(servers[k].address, "GET", "/readyz",
                          headers={"Accept": accept})
                     for k in ("port", "ref"))
        assert got[0] == want[0] == 503
        assert got[2] == want[2]
        assert got[1].get("Retry-After") == want[1].get("Retry-After")


@pytest.mark.parametrize("method,path", [
    ("POST", "/fleet/scale"), ("POST", "/fleet/"),
    ("POST", "/dedupe/claim"), ("GET", "/fleet/reload")])
def test_unported_routes_answer_404(servers, method, path):
    """Routes neither package serves (the fleet surface knows reload,
    rescore, drain and reresolve only) answer the reference's 404."""
    got, want = (_raw(servers[k].address, method, path,
                      body=b"{}" if method == "POST" else None)
                 for k in ("port", "ref"))
    assert got[0] == want[0] == 404
    assert json.loads(got[2]) == json.loads(want[2])


def test_monitor_events_without_a_monitor_index_answer_like_the_reference(
        servers):
    """/monitor/events exists; a server started without --monitor-index
    answers the reference's 404 body."""
    got, want = (_raw(servers[k].address, "GET", "/monitor/events?since=0")
                 for k in ("port", "ref"))
    assert got[0] == want[0] == 404
    assert got[2] == want[2]
    assert json.loads(got[2]) == {
        "error": "monitor not enabled (--monitor-index)"}


# ------------------------------------------------------ client <-> server


def test_client_server_scan(servers):
    srv = servers["port"]
    cache = RemoteCache(srv.address)
    assert cache.missing_blobs("sha256:x", ["sha256:y"]) == \
        (True, ["sha256:y"])
    cache.put_blob("sha256:y", _blob(2))
    cache.put_artifact("sha256:x", {"schema_version": 2})
    assert cache.missing_blobs("sha256:x", ["sha256:y"]) == (False, [])
    driver = RemoteDriver(srv.address)
    assert driver.conn is cache.conn  # one pooled connection
    results, os_found = driver.scan("myapp", "sha256:x", ["sha256:y"],
                                    ScanOptions())
    assert not os_found.detected
    vulns = results[0].vulnerabilities
    assert [v.vulnerability_id for v in vulns] == [
        "CVE-2019-10744", "CVE-2026-1000", "CVE-2026-1001"]
    lodash = vulns[0]
    assert lodash.installed_version == "4.17.4"
    assert lodash.fixed_version == "4.17.12"
    assert lodash.info and lodash.info.severity == "CRITICAL"
    assert srv.service.metrics.scans_total == 1
    assert srv.service.metrics.findings_total == 3


def test_token_auth(db_dir):
    engine = MatchEngine(AdvisoryDB.load(db_dir), device="cpu")
    with live(Server, engine, MemoryCache(), token="sekrit") as srv:
        bad = RemoteCache(srv.address, token="wrong")
        with pytest.raises(RPCError, match="401"):
            bad.missing_blobs("sha256:a", [])
        good = RemoteCache(srv.address, token="sekrit")
        assert good.missing_blobs("sha256:a", [])[0] is True
        # health is not token-gated (reference listen.go:112)
        assert _raw(srv.address, "GET", "/healthz")[2] == b"ok"


@pytest.mark.parametrize("list_all", [False, True])
def test_scan_options_roundtrip(servers, list_all):
    """list_all_pkgs travels over the wire; the response equals the
    reference server's, byte for byte, both ways of the wire."""
    got = RemoteDriver(servers["port"].address).scan(
        "img1", "sha256:a", ["sha256:b1"], ScanOptions(list_all_pkgs=list_all))
    want = jax_client.RemoteDriver(servers["ref"].address).scan(
        "img1", "sha256:a", ["sha256:b1"],
        JaxScanOptions(list_all_pkgs=list_all))
    assert wire.scan_response(*got) == jax_wire.scan_response(*want)
    # packages travel with the result either way (the CLI strips them
    # at render time unless --list-all-pkgs)
    assert got[0][0].packages[0].identifier.purl == "pkg:npm/pkg0@1.0.0"


# ------------------------------------------------------------- hot swap


def _generation(root: str, name: str, db: AdvisoryDB | None) -> str:
    gen = os.path.join(generations.generations_root(root), name)
    os.makedirs(gen)
    if db is not None:
        db.save(gen)
    else:  # a torn download: not gzip, new metadata
        with open(os.path.join(gen, "trivy_tpu.db.json.gz"), "wb") as f:
            f.write(b"\x1f\x8bthis is not gzip data")
        with open(os.path.join(gen, "metadata.json"), "w") as f:
            json.dump({"Version": 2, "UpdatedAt": "2024-03-03T00:00:00Z"},
                      f)
    generations.promote(root, gen)
    return gen


@pytest.mark.parametrize("use_device", [True, False],
                         ids=["device-cpu", "host-oracle"])
def test_db_hot_swap_keeps_port_engine_and_device(tmp_path, use_device):
    """A promoted generation hot-swaps in as the port's MatchEngine on
    the device the served engine was on; a rescan equals a fresh port
    engine on the new DB; a corrupt third generation is quarantined
    while the server keeps serving last-good."""
    root = str(tmp_path / "db")
    _generation(root, "sha256-aaa", _db("2024-01-01T00:00:00Z"))
    engine = MatchEngine(AdvisoryDB.load(root), use_device=use_device,
                         device="cpu", db_path=root)
    grown = _db("2024-02-02T00:00:00Z")
    grown.put_advisory("npm::ghsa", "lodash", Advisory(
        vulnerability_id="CVE-2020-8203", vulnerable_versions=["<4.17.19"]))
    with live(Server, engine, MemoryCache(), db_path=root) as srv:
        svc = srv.service
        svc.cache.put_blob("sha256:b1", _blob())
        before = wire.scan_response(*svc.scan(
            "a", "", ["sha256:b1"], ScanOptions()))
        assert svc.maybe_reload_db() is False  # nothing changed
        good = _generation(root, "sha256-bbb", grown)
        assert svc.maybe_reload_db() is True
        new = svc.engine
        assert type(new) is MatchEngine and new is not engine
        assert new.use_device is use_device
        assert new.device == engine.device
        assert svc.generation_name() == "sha256-bbb"
        after = wire.scan_response(*svc.scan(
            "a", "", ["sha256:b1"], ScanOptions()))
        assert after != before and b"CVE-2020-8203" in after
        fresh = MatchEngine(AdvisoryDB.load(root), use_device=use_device,
                            device="cpu")
        with live(Server, fresh, MemoryCache()) as ref:
            ref.service.cache.put_blob("sha256:b1", _blob())
            assert wire.scan_response(*ref.service.scan(
                "a", "", ["sha256:b1"], ScanOptions())) == after

        bad = _generation(root, "sha256-ccc", None)
        assert svc.maybe_reload_db() is False
        assert svc.engine is new  # still serving last-good
        assert svc.metrics.db_reload_failures_total == 1
        assert svc.metrics.db_reloads_total == 1
        assert not os.path.isdir(bad)
        assert any(n.startswith("sha256-ccc" + generations.QUARANTINE_SUFFIX)
                   for n in os.listdir(generations.generations_root(root)))
        assert os.path.realpath(generations.resolve(root)) == \
            os.path.realpath(good)
        status, _h, body = _raw(srv.address, "GET", "/readyz")
        assert status == 200 and b"serving last-good" in body
        assert wire.scan_response(*svc.scan(
            "a", "", ["sha256:b1"], ScanOptions())) == after


# ------------------------------------------------------------ wire codecs


def _results(servers, **opts):
    return _port_scan(servers["port"], **opts), \
        _ref_scan(servers["ref"], **opts)


@pytest.mark.parametrize("list_all", [False, True])
def test_json_scan_response_bytes_equal_reference(servers, list_all):
    got, want = _results(servers, list_all_pkgs=list_all)
    body = wire.scan_response(*got)
    assert body == jax_wire.scan_response(*want)
    # each package decodes the other's bytes to the same bytes
    assert wire.scan_response(*wire.decode_scan_response(body)) == body
    assert jax_wire.scan_response(*jax_wire.decode_scan_response(body)) \
        == body
    assert wire.gzip_bytes(body) == jax_wire.gzip_bytes(body)


def test_scan_request_and_cache_bodies_equal_reference():
    opts = ScanOptions(list_all_pkgs=True, include_dev_deps=True,
                       pkg_types=["library"])
    ref_opts = JaxScanOptions(list_all_pkgs=True, include_dev_deps=True,
                              pkg_types=["library"])
    body = wire.scan_request("img", "sha256:a", ["sha256:b"], opts)
    assert body == jax_wire.scan_request("img", "sha256:a", ["sha256:b"],
                                         ref_opts)
    target, akey, blobs, decoded = wire.decode_scan_request(body)
    assert (target, akey, blobs) == ("img", "sha256:a", ["sha256:b"])
    assert decoded == opts
    blob = _blob(3)
    assert wire.encode({"diff_id": "sha256:b", "blob_info": blob}) == \
        jax_wire.encode({"diff_id": "sha256:b", "blob_info": blob})


def test_gzip_deterministic_and_torn_frames_fail():
    payload = b'{"k": "v"}' * 1000
    z = wire.gzip_bytes(payload)
    assert z == wire.gzip_bytes(payload) == jax_wire.gzip_bytes(payload)
    assert wire.gunzip_bytes(z) == payload
    with pytest.raises(OSError):
        wire.gunzip_bytes(z[:10])


@pytest.mark.parametrize("list_all", [False, True])
def test_columnar_scan_response_frames_equal_reference(servers, list_all):
    got, want = _results(servers, list_all_pkgs=list_all)
    frames = b"".join(colwire.scan_response_frames(*got))
    assert frames == b"".join(jax_colwire.scan_response_frames(*want))
    # decoding the frames rebuilds the JSON wire's exact bytes
    assert wire.scan_response(*colwire.decode_scan_response(frames)) == \
        jax_wire.scan_response(*want)


def test_columnar_request_frames_equal_reference():
    opts, ref_opts = ScanOptions(list_all_pkgs=True), \
        JaxScanOptions(list_all_pkgs=True)
    pairs = [
        (colwire.encode_scan_request("img", "sha256:a", ["b1", "b2"], opts),
         jax_colwire.encode_scan_request("img", "sha256:a", ["b1", "b2"],
                                         ref_opts)),
        (colwire.encode_put_blob("sha256:b", _blob()),
         jax_colwire.encode_put_blob("sha256:b", _blob())),
        (colwire.encode_missing_blobs("sha256:a", ["x", "y"]),
         jax_colwire.encode_missing_blobs("sha256:a", ["x", "y"])),
        (colwire.encode_missing_response(True, ["y"]),
         jax_colwire.encode_missing_response(True, ["y"])),
    ]
    for got, want in pairs:
        assert got == want
    target, akey, blobs, decoded = colwire.decode_scan_request(pairs[0][0])
    assert (target, akey, blobs, decoded) == \
        ("img", "sha256:a", ["b1", "b2"], opts)
    assert colwire.decode_put_blob(pairs[1][0]) == ("sha256:b", _blob())
    assert colwire.decode_missing_blobs(pairs[2][0]) == \
        ("sha256:a", ["x", "y"])
    assert colwire.decode_missing_response(pairs[3][0]) == (True, ["y"])


def test_columnar_queries_feed_the_port_engine(db_dir):
    qs = [PkgQuery("npm::", f"pkg{i}", f"{i % 5}.1.0", "npm")
          for i in range(N_PKGS)]
    body = colwire.encode_queries(qs)
    assert body == jax_colwire.encode_queries(
        [JaxQuery(*q.key) for q in qs])
    decoded = colwire.decode_queries(body)
    assert [q.key for q in decoded] == [q.key for q in qs]
    engine = MatchEngine(AdvisoryDB.load(db_dir), device="cpu")
    assert [r.adv_indices for r in engine.detect(decoded)] == \
        [r.adv_indices for r in engine.detect(qs)]


@pytest.mark.parametrize("mangle", ["crc", "truncate", "magic"])
def test_columnar_bad_frames_rejected(mangle):
    body = colwire.encode_missing_blobs("sha256:a", ["x" * 50] * 40)
    if mangle == "crc":
        body = body[:-20] + bytes([body[-20] ^ 1]) + body[-19:]
    elif mangle == "truncate":
        body = body[: len(body) // 2]
    else:
        body = b"XXXXX\n" + body[6:]
    with pytest.raises(colwire.WireFormatError):
        colwire.decode_missing_blobs(body)


@pytest.mark.parametrize("ctype", ["proto", "json"])
def test_twirp_scan_response_encodes_equal_reference(servers, ctype):
    got, want = _results(servers, list_all_pkgs=True)
    doc = twirp.scan_response_proto(*got)
    ref_doc = jax_twirp.scan_response_proto(*want)
    assert doc == ref_doc
    if ctype == "proto":
        body = twirp.encode_message("ScanResponse", doc)
        assert body == jax_twirp.encode_message("ScanResponse", ref_doc)
        assert twirp.decode_message("ScanResponse", body) == \
            jax_twirp.decode_message("ScanResponse", body)
    else:
        body = json.dumps(twirp.to_json_obj("ScanResponse", doc))
        assert body == json.dumps(jax_twirp.to_json_obj("ScanResponse",
                                                        ref_doc))
        assert twirp.from_json_obj("ScanResponse", json.loads(body)) == \
            jax_twirp.from_json_obj("ScanResponse", json.loads(body))


def _twirp_post(addr, path, body, ctype):
    status, hdrs, out = _raw(addr, "POST", path, body,
                             {"Content-Type": ctype})
    return status, hdrs.get("Content-Type"), out


@pytest.mark.parametrize("ctype", [twirp.PROTO_CT, twirp.JSON_CT])
def test_twirp_live_scan_equals_reference(servers, ctype):
    """A reference-style Twirp client (binary protobuf or proto3-JSON,
    no internal-wire header) gets the same bytes from both servers, for
    the cache routes and Scan."""
    def enc(name, doc):
        if ctype == twirp.PROTO_CT:
            return twirp.encode_message(name, doc)
        return json.dumps(twirp.to_json_obj(name, doc)).encode()

    blob = {"schema_version": 2, "applications": [{
        "type": "npm", "file_path": "package-lock.json",
        "packages": [{"id": "lodash@4.17.4", "name": "lodash",
                      "version": "4.17.4",
                      "identifier": {"purl": "pkg:npm/lodash@4.17.4"}}]}]}
    calls = [
        ("/twirp/trivy.cache.v1.Cache/PutBlob",
         enc("PutBlobRequest", {"diff_id": "sha256:t", "blob_info": blob})),
        ("/twirp/trivy.cache.v1.Cache/MissingBlobs",
         enc("MissingBlobsRequest", {"artifact_id": "sha256:a",
                                     "blob_ids": ["sha256:t", "sha256:u"]})),
        ("/twirp/trivy.scanner.v1.Scanner/Scan",
         enc("ScanRequest", {"target": "myapp", "artifact_id": "sha256:a",
                             "blob_ids": ["sha256:t"],
                             "options": {"scanners": ["vuln"]}})),
        ("/twirp/trivy.scanner.v1.Scanner/Nope", b""),
    ]
    for path, body in calls:
        got = _twirp_post(servers["port"].address, path, body, ctype)
        want = _twirp_post(servers["ref"].address, path, body, ctype)
        assert got == want, path
    assert got[0] == 404 and json.loads(got[2])["code"] == "bad_route"


# ------------------------------------------ negotiation and kill switches


_MISSING = iter(range(1 << 30))


def _missing_call(conn) -> tuple[bytes, str]:
    """One MissingBlobs call for a present blob and a fresh absent one
    (a fresh name: an absent blob asked for again would wait on this
    client's own layer-gate claim) -> (raw response, the absent id)."""
    absent = f"sha256:nope{next(_MISSING)}"
    body = wire.encode({"artifact_id": "sha256:a",
                        "blob_ids": ["sha256:b1", absent]})
    return conn.post(CACHE_PREFIX + "MissingBlobs", body,
                     columnar=lambda: colwire.encode_missing_blobs(
                         "sha256:a", ["sha256:b1", absent])), absent


def test_old_client_json_byte_identical(servers):
    """A header-less pre-columnar client gets the plain JSON bytes from
    both servers."""
    body = wire.scan_request("img1", "sha256:a", ["sha256:b1"],
                             ScanOptions(list_all_pkgs=True))
    hdrs = {"Content-Type": "application/json",
            "X-Trivy-Tpu-Wire": "internal"}
    got = _raw(servers["port"].address, "POST", SCAN_PATH, body, hdrs)
    want = _raw(servers["ref"].address, "POST", SCAN_PATH, body, hdrs)
    assert got[0] == want[0] == 200
    assert got[1].get("Content-Encoding") is None
    assert got[2] == want[2]
    assert got[2] == wire.scan_response(
        *_port_scan(servers["port"], list_all_pkgs=True))


def test_capability_ladder_learns_then_sends_columnar(servers):
    conn = _Conn(servers["port"].address, retry=FAST_RETRY)
    assert conn._server_columnar is False
    raw, absent = _missing_call(conn)
    # request #1 went out JSON but the RESPONSE is columnar (the Accept
    # offer), and the X-Trivy-Columnar advertisement taught the conn
    assert colwire.is_columnar(raw)
    assert colwire.decode_missing_response(raw) == (False, [absent])
    assert conn._server_columnar and conn._server_gzip
    # request #2 ships a columnar body
    raw, absent = _missing_call(conn)
    assert colwire.decode_missing_response(raw) == (False, [absent])
    conn.close()


def test_streamed_scan_response_and_gzip_equal(servers, monkeypatch):
    monkeypatch.setattr(wire, "GZIP_MIN_BYTES", 16)
    monkeypatch.setattr(jax_wire, "GZIP_MIN_BYTES", 16)
    want = jax_wire.scan_response(*_ref_scan(servers["ref"],
                                             list_all_pkgs=True))
    driver = RemoteDriver(servers["port"].address, retry=FAST_RETRY)
    for _ in range(3):  # JSON, then columnar frames, gzip learned
        got = driver.scan("img1", "sha256:a", ["sha256:b1"],
                          ScanOptions(list_all_pkgs=True))
        assert wire.scan_response(*got) == want
    assert driver.conn._server_columnar and driver.conn._server_gzip
    driver.close()


@pytest.mark.parametrize("side", ["client", "server"])
def test_kill_switch(servers, monkeypatch, side):
    if side == "client":
        monkeypatch.setattr(colwire, "enabled", lambda: False)
        conn = _Conn(servers["port"].address, retry=FAST_RETRY)
        raw, absent = _missing_call(conn)
        assert not colwire.is_columnar(raw)
        assert json.loads(raw)["missing_blob_ids"] == [absent]
        conn.close()
        return
    monkeypatch.setenv(colwire.ENV_KILL, "0")
    monkeypatch.setenv(jax_colwire.ENV_KILL, "0")
    body = colwire.encode_missing_blobs("sha256:a", [])
    hdrs = {"Content-Type": colwire.CONTENT_TYPE,
            "X-Trivy-Tpu-Wire": "internal"}
    got = _raw(servers["port"].address, "POST",
               CACHE_PREFIX + "MissingBlobs", body, hdrs)
    want = _raw(servers["ref"].address, "POST",
                CACHE_PREFIX + "MissingBlobs", body, hdrs)
    # the 400 goes out WITHOUT the capability header
    assert got[0] == want[0] == 400
    assert got[1].get(colwire.CAPABLE_HEADER) is None
    assert got[2] == want[2]


def _json_only(srv) -> None:
    """Turn `srv` into a pre-columnar server in place (a rolled-back
    binary): no capability header, no columnar Accept, 400 on columnar
    request bodies."""
    H = srv.httpd.RequestHandlerClass
    orig_send = H.send_header

    def send_header(self, name, value):
        if name == colwire.CAPABLE_HEADER:
            return
        orig_send(self, name, value)

    H.send_header = send_header
    H._accepts_columnar = lambda self: False
    orig_post = H.do_POST

    def do_POST(self):
        ctype = self.headers.get("Content-Type") or ""
        if ctype.startswith(colwire.CONTENT_TYPE):
            self.rfile.read(int(self.headers.get("Content-Length") or 0))
            self._error(400, "unsupported content type")
            return
        orig_post(self)

    H.do_POST = do_POST


def test_capability_unlearn_after_rollback(servers):
    conn = _Conn(servers["port"].address, retry=FAST_RETRY)
    _missing_call(conn)
    assert conn._server_columnar is True
    _json_only(servers["port"])
    raw, absent = _missing_call(conn)
    # the 400-without-header unlearned the capability and the granted
    # retry resent JSON — the call still succeeds
    assert not colwire.is_columnar(raw)
    assert json.loads(raw)["missing_blob_ids"] == [absent]
    assert conn._server_columnar is False
    conn.close()


@pytest.mark.fault
@pytest.mark.parametrize("spec", ["rpc.wire:drop@1", "rpc.wire:error@1-2",
                                  "rpc.wire:corrupt@1",
                                  "rpc.wire:delay=0.01@1",
                                  "rpc.cache:error=503@1",
                                  "rpc:drop@1"])
def test_wire_fault_ladder_still_answers(servers, spec):
    conn = _Conn(servers["port"].address, retry=FAST_RETRY)
    _missing_call(conn)
    assert conn._server_columnar is True
    plan = faults.install_spec(spec)
    raw, absent = _missing_call(conn)
    assert colwire.decode_missing_response(raw) == (False, [absent])
    assert plan.rules[0].fired >= 1
    conn.close()


@pytest.mark.fault
def test_rpc_error_exhausts_retries():
    faults.install_spec("rpc.scan:error=503")
    conn = _Conn("http://127.0.0.1:9", retry=FAST_RETRY)
    with pytest.raises(port_client.RPCUnavailable, match="503"):
        conn.post(SCAN_PATH, b"{}")
    faults.install_spec("rpc.scan:error=400")
    with pytest.raises(RPCError, match="400"):
        conn.post(SCAN_PATH, b"{}")


@pytest.mark.parametrize("route", ["internal", "twirp"])
def test_shed_equals_reference(servers, route):
    """A draining server sheds with the reference's status, Retry-After
    and body, on the internal wire and the Twirp one."""
    for k in ("port", "ref"):
        servers[k].service.start_drain()
    if route == "internal":
        body = wire.scan_request("img1", "sha256:a", ["sha256:b1"],
                                 ScanOptions())
        hdrs = {"Content-Type": "application/json",
                "X-Trivy-Tpu-Wire": "internal"}
    else:
        body = json.dumps({"target": "a", "artifact_id": "",
                           "blob_ids": []}).encode()
        hdrs = {"Content-Type": "application/json"}
    got = _raw(servers["port"].address, "POST", SCAN_PATH, body, hdrs)
    want = _raw(servers["ref"].address, "POST", SCAN_PATH, body, hdrs)
    assert got[0] == want[0] == 503
    assert got[1].get("Retry-After") == want[1].get("Retry-After") == "2"
    assert got[2] == want[2]
    # the port client backs off and reports the shed
    with pytest.raises(port_client.RPCBackpressure):
        RemoteDriver(servers["port"].address,
                     retry=RetryPolicy(attempts=2, base_s=0.001,
                                       cap_s=0.001,
                                       respect_retry_after=False)).scan(
            "img1", "sha256:a", ["sha256:b1"], ScanOptions())
    assert servers["port"].service.metrics.scans_shed_total >= 2


# ------------------------------------------------------ cross-compatibility


@pytest.mark.parametrize("pair", ["ref-client-port-server",
                                  "port-client-ref-server"])
def test_cross_compatibility(servers, pair):
    """Each package's client against the other's server gives the
    bytes of the same-package pair, on the JSON wire and then on the
    columnar wire it learns."""
    want = jax_wire.scan_response(*_ref_scan(servers["ref"],
                                             list_all_pkgs=True))
    if pair == "ref-client-port-server":
        driver = jax_client.RemoteDriver(servers["port"].address)
        cache = jax_client.RemoteCache(servers["port"].address)
        opts, enc = JaxScanOptions(list_all_pkgs=True), jax_wire
    else:
        driver = RemoteDriver(servers["ref"].address)
        cache = RemoteCache(servers["ref"].address)
        opts, enc = ScanOptions(list_all_pkgs=True), wire
    for _ in range(2):
        got = driver.scan("img1", "sha256:a", ["sha256:b1"], opts)
        assert enc.scan_response(*got) == want
    cache.put_blob("sha256:c9", _blob(4))
    assert cache.missing_blobs("sha256:a", ["sha256:c9", "sha256:zz"]) \
        == (False, ["sha256:zz"])


# ------------------------------------------------------------ layer gate


def test_layer_gate_two_clients_analyze_a_shared_layer_once(servers):
    """Two clients whose images share a layer: the first MissingBlobs
    claims it; the second, arriving while the first analyzes, waits on
    the claim instead of analyzing it too, and sees it present once the
    first client's PutBlob lands."""
    addr = servers["port"].address
    first = RemoteCache(addr, retry=FAST_RETRY)
    second = RemoteCache(addr, retry=FAST_RETRY)
    assert first.missing_blobs("sha256:img1", ["sha256:base",
                                               "sha256:top1"]) == \
        (True, ["sha256:base", "sha256:top1"])
    box: dict = {}
    started = threading.Event()

    def second_client():
        started.set()
        box["missing"] = second.missing_blobs(
            "sha256:img2", ["sha256:base", "sha256:top2"])

    t = threading.Thread(target=second_client)
    t.start()
    assert started.wait(TIMEOUT_S)
    gate = servers["port"].service.layer_gate
    deadline = threading.Event()
    for _ in range(500):  # the second request reaches the gate
        if gate.inflight() >= 3:
            break
        deadline.wait(0.01)
    first.put_blob("sha256:base", _blob(1))
    first.put_blob("sha256:top1", _blob(1))
    t.join(TIMEOUT_S)
    assert not t.is_alive()
    # the shared base layer is not analyzed again
    assert box["missing"] == (True, ["sha256:top2"])
    first.close()
    second.close()


# ------------------------------------------------------------ CLI clients


@pytest.fixture()
def golden_dbs(tmp_path):
    fixture_db().save(str(tmp_path / "db"))
    (tmp_path / "bom.json").write_text(json.dumps(test_sbom_e2e.CDX_DOC))
    return {"sbom": str(tmp_path / "bom.json"), "db": str(tmp_path / "db")}


@contextlib.contextmanager
def cli_servers(db: str):
    """A live port server and reference server on DB directory `db`."""
    with live(Server, MatchEngine(AdvisoryDB.load(db), device="cpu"),
              MemoryCache()) as port, \
            live(JaxServer, JaxEngine(JaxAdvisoryDB.load(db),
                                      use_device=False),
                 JaxMemoryCache()) as ref:
        yield port, ref


def _cli(entry, uuid_mod, argv, capsys) -> tuple[int, str]:
    uuid_mod.reset()
    rc = entry(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("fmt", ["json", "table"])
def test_sbom_server_cli_equals_standalone_and_reference(golden_dbs, tmp_path,
                                                        capsys, fmt):
    common = ["sbom", golden_dbs["sbom"], "--format", fmt, "--quiet"]
    with cli_servers(golden_dbs["db"]) as (port, ref):
        client = _cli(main, port_uuid, common + [
            "--server", port.address, "--device", "cpu", "--cache-dir",
            str(tmp_path / "pc")], capsys)
        ref_client = _cli(jax_main.main, jax_uuid, common + [
            "--server", ref.address, "--cache-dir", str(tmp_path / "jc")],
            capsys)
        assert port.service.metrics.scans_total == 1
    standalone = _cli(main, port_uuid, common + [
        "--db-path", golden_dbs["db"], "--device", "cpu", "--cache-dir",
        str(tmp_path / "ps")], capsys)
    assert client == standalone == ref_client
    assert client[0] == 0
    if fmt == "json":
        assert client[1] == GOLDEN.read_text()


@pytest.fixture(scope="module")
def fs_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fs-server")
    test_fanal._fixture_db().save(str(tmp / "fixture"))
    seeded_db().save(str(tmp / "seeded"))
    rootfs = tmp / "rootfs"
    test_fanal._mk_rootfs(rootfs)
    seeded = tmp / "seeded-tree"
    seeded_tree(seeded)
    return {"rootfs": (str(rootfs), str(tmp / "fixture")),
            "seeded": (str(seeded), str(tmp / "seeded"))}


@pytest.mark.parametrize("tree", ["rootfs", "seeded"])
@pytest.mark.parametrize("cmd", ["fs", "rootfs"])
def test_fs_server_cli_equals_standalone_and_reference(fs_env, tmp_path,
                                                      capsys, tree, cmd):
    root, db = fs_env[tree]
    common = [cmd, root, "--format", "json", "--list-all-pkgs", "--quiet"]
    with cli_servers(db) as (port, ref):
        client = _cli(main, port_uuid, common + [
            "--server", port.address, "--device", "cpu", "--cache-dir",
            str(tmp_path / "pc")], capsys)
        ref_client = _cli(jax_main.main, jax_uuid, common + [
            "--server", ref.address, "--cache-dir", str(tmp_path / "jc")],
            capsys)
    standalone = _cli(main, port_uuid, common + [
        "--db-path", db, "--device", "cpu", "--cache-dir",
        str(tmp_path / "ps")], capsys)
    assert client == standalone == ref_client
    doc = json.loads(client[1])
    assert client[0] == 0 and doc["Results"]
    if tree == "seeded" and cmd == "fs":
        assert any(r.get("Secrets") for r in doc["Results"])


def test_sbom_server_cli_through_python_m(golden_dbs, tmp_path):
    """`python -m trivy_tpu_torch sbom --server` in a fresh process
    against a live port server prints the golden report."""
    with cli_servers(golden_dbs["db"]) as (port, _ref):
        out = subprocess.run(
            [sys.executable, "-m", "trivy_tpu_torch", "sbom",
             golden_dbs["sbom"], "--server", port.address, "--format",
             "json", "--quiet", "--device", "cpu", "--cache-dir",
             str(tmp_path / "c")],
            cwd=ROOT, capture_output=True, text=True, timeout=120,
            env={**os.environ, "TRIVY_TPU_FAKE_TIME": FAKE_TIME,
                 "OMP_NUM_THREADS": "1"})
        assert out.returncode == 0, out.stderr
        assert out.stdout == GOLDEN.read_text()
        assert port.service.metrics.scans_total == 1


def test_scan_timeout_budget_rides_to_the_server(golden_dbs, tmp_path,
                                                 capsys):
    """--scan-timeout arms the deadline budget: the server receives it
    (X-Trivy-Deadline) and a scan within budget answers as usual."""
    seen: list = []
    with cli_servers(golden_dbs["db"]) as (port, _ref):
        orig = port.service.scan

        def spy(*a, deadline=None, **kw):
            seen.append(deadline)
            return orig(*a, deadline=deadline, **kw)

        port.service.scan = spy
        rc, out = _cli(main, port_uuid, [
            "sbom", golden_dbs["sbom"], "--format", "json", "--quiet",
            "--server", port.address, "--scan-timeout", "60s",
            "--device", "cpu", "--cache-dir", str(tmp_path / "c")], capsys)
    assert rc == 0 and out == GOLDEN.read_text()
    assert seen and seen[0] is not None and 0 < seen[0].budget_s <= 60.0


# --------------------------------------------------------------- refusals


def _error_lines(err: str) -> list[str]:
    return [ln for ln in err.splitlines() if "ERROR" in ln]


def test_replica_set_url_is_refused(golden_dbs, tmp_path, capsys,
                                    monkeypatch):
    """A replica set none of whose replicas answers fails the scan with
    one error line, the reference's, after failing over across both."""
    from trivy_tpu.cli.main import main as jax_main

    monkeypatch.setenv("TRIVY_TPU_FLEET_HEDGE_MS", "0")
    argv = ["sbom", golden_dbs["sbom"], "--server",
            "http://127.0.0.1:9,http://127.0.0.1:10",
            "--scan-timeout", "3s", "--cache-dir", str(tmp_path / "c")]
    rc = main(argv + ["--device", "cpu"])
    captured = capsys.readouterr()
    errors = _error_lines(captured.err)
    assert rc == 1 and captured.out == ""
    assert len(errors) == 1
    assert jax_main(argv) == 1
    want = _error_lines(capsys.readouterr().err)
    assert len(want) == 1
    assert errors[0].split("\t")[-1].split(":")[0] == \
        want[0].split("\t")[-1].split(":")[0]


@pytest.mark.parametrize("argv", [
    ["sbom", "bom.json", "--server", "http://h:1", "--license-full"],
    ["sbom", "bom.json", "--server", "http://h:1", "--report", "all"],
    ["sbom", "bom.json", "--module-dir", "modules"]],
    ids=["license-full", "report", "module-dir"])
def test_unported_flags_are_refused_on_argv(argv):
    """`--license-full`, `--report` and `--module-dir` are ported: each
    parses as the reference's parser parses it."""
    from trivy_tpu_torch.cli.main import build_parser

    got = vars(build_parser().parse_args(argv))
    want = vars(jax_main.build_parser().parse_args(argv))
    assert set(want) <= set(got)
    assert {k: got[k] for k in want} == want
    assert (got["license_full"], got["report"], got["module_dir"]) in (
        (True, "summary", None), (False, "all", None),
        (False, "summary", "modules"))


@pytest.mark.parametrize("dest,value", [("mesh", "2x1x4")])
def test_cross_host_server_spec_without_workers_is_one_line(
        golden_dbs, tmp_path, monkeypatch, capsys, dest, value):
    """A cross-host spec from the environment without TRIVY_TPU_DCN
    workers fails the server with rc 1 and the reference's one line."""
    from trivy_tpu.cli.main import main as jax_main

    monkeypatch.delenv("TRIVY_TPU_DCN", raising=False)
    monkeypatch.setenv("TRIVY_TPU_" + dest.upper(), value)
    argv = ["server", "--db-path", golden_dbs["db"], "--listen",
            "127.0.0.1:0", "--cache-dir", str(tmp_path / "c")]
    rc = main(argv + ["--device", "cpu"])
    lines = _error_lines(capsys.readouterr().err)
    assert rc == 1 and len(lines) == 1
    assert jax_main(argv) == 1
    want = _error_lines(capsys.readouterr().err)
    assert len(want) == 1
    message = want[0].split("\t")[-1]
    assert message.startswith("--mesh/TRIVY_TPU_MESH: mesh spec '2x1x4' "
                              "spans 2 hosts but TRIVY_TPU_DCN is unset")
    assert lines[0].endswith(message)


@pytest.mark.parametrize("spec", ["fleet.scan:error",
                                  "db.save:drop",
                                  "cache.read:kill",
                                  "report.write:delay",
                                  "sched.submit:kill",
                                  "rpc.wire:timeout"])
def test_unported_fault_spec_is_refused(spec):
    """A site no call site fires, or an action its call site does not
    handle, is refused where the reference accepts it and then leaves
    it to do nothing."""
    with pytest.raises(faults.FaultSpecError) as exc:
        faults.FaultPlan.from_spec(spec)
    assert "fired nowhere" in str(exc.value) or \
        "not handled" in str(exc.value)
    # the reference accepts each of them
    jax_faults.FaultPlan.from_spec(spec)


@pytest.mark.parametrize("command", ["sbom", "server"])
def test_unported_fault_site_in_env_fails_the_command(golden_dbs, tmp_path,
                                                      monkeypatch, capsys,
                                                      command):
    monkeypatch.setenv("TRIVY_TPU_FAULTS", "fleet.scan:error@1")
    if command == "sbom":
        argv = ["sbom", golden_dbs["sbom"], "--db-path", golden_dbs["db"]]
    else:
        argv = ["server", "--db-path", golden_dbs["db"], "--listen",
                "127.0.0.1:0"]
    rc = main(argv + ["--device", "cpu", "--cache-dir",
                      str(tmp_path / "c")])
    errors = _error_lines(capsys.readouterr().err)
    assert rc == 1 and len(errors) == 1
    assert "TRIVY_TPU_FAULTS" in errors[0] and "fleet.scan" in errors[0]


def test_server_without_a_card_refuses(golden_dbs, tmp_path, monkeypatch,
                                       capsys):
    """Without a card and without --device cpu / --no-tpu the server
    exits 1 with one line naming CUDA: no silent CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main(["server", "--db-path", golden_dbs["db"], "--listen",
               "127.0.0.1:0", "--cache-dir", str(tmp_path / "c")])
    captured = capsys.readouterr()
    errors = _error_lines(captured.err)
    assert rc == 1 and captured.out == ""
    assert len(errors) == 1 and "CUDA" in errors[0]


def test_server_command_serves_and_drains_on_sigterm(golden_dbs, tmp_path):
    """`python -m trivy_tpu_torch server --device cpu` answers /readyz,
    serves a client scan, and exits 0 on SIGTERM within its drain
    budget."""
    import signal
    import socket
    import time

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "trivy_tpu_torch", "server", "--listen",
         f"127.0.0.1:{free}", "--db-path", golden_dbs["db"], "--cache-dir",
         str(tmp_path / "c"), "--device", "cpu", "--drain-timeout", "5s",
         "--quiet"],
        cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    addr = f"http://127.0.0.1:{free}"
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                with urllib.request.urlopen(addr + "/readyz",
                                            timeout=2) as r:
                    assert r.read() == b"ok"
                    break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, proc.stderr.read()
                assert time.monotonic() < deadline, "server never ready"
                time.sleep(0.2)
        cache = RemoteCache(addr, retry=FAST_RETRY)
        cache.put_blob("sha256:b1", _blob())
        got = RemoteDriver(addr, retry=FAST_RETRY).scan(
            "img1", "", ["sha256:b1"], ScanOptions())
        assert [v.vulnerability_id for v in got[0][0].vulnerabilities] == \
            ["CVE-2019-10744"]
        cache.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
