"""Port parity, the redis cache tier: trivy_tpu_torch's `cache/redis.py`
(`RespClient`, `parse_redis_url`, `RedisCache`) and the cross-server
layer gate of `fleet/dedupe.py` wired into `ScanService`, against the
JAX package's on the `fake_redis` fixture of tests/conftest.py.

Every shape of tests/test_redis_cache.py runs in both packages, and
what each observes (the parsed URL, the fake server's keys, the values
read back, the TLS context, a CLI scan's report) must be equal. Across
packages: a redis tier written by one package's scan serves the
other's. The gate: tests/test_fleet.py's three shapes in both packages,
and two live port servers on one fake redis that analyze each unique
layer once, with the clients ordered through the claim keys (no sleep
decides the outcome). The device rule: a DeviceError in the anchor
screen of an image scan on redis ends the run with rc 1 and one line,
and no blob lands in redis.

The tolerance is exact equality.
"""

from __future__ import annotations

import importlib
import json
import os
import ssl
import threading
import time
from types import SimpleNamespace

import pytest
import test_fanal
import torch
from test_analysis_pipeline import _mk_registry
from test_image_tar_golden import _fixture_tar
from test_redis_cache import _FakeRedisHandler

FAKE_TIME = "2024-01-01T00:00:00+00:00"

_MODULES = {
    "redis": "cache.redis", "cache": "cache.cache", "dedupe": "fleet.dedupe",
    "server": "rpc.server", "client": "rpc.client",
    "pipeline": "fanal.pipeline", "image": "artifact.image",
    "metrics": "obs.metrics", "cli": "cli.main", "run": "cli.run",
    "uuid": "utils.uuid",
}


def _namespace(root: str) -> SimpleNamespace:
    ns = SimpleNamespace(root=root)
    for attr, mod in _MODULES.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    ns.port = root == "trivy_tpu_torch"
    ns.name = "port" if ns.port else "ref"
    ns.device = ["--device", "cpu"] if ns.port else []
    return ns


REF = _namespace("trivy_tpu")
PORT = _namespace("trivy_tpu_torch")
PKGS = (REF, PORT)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and idle OpenMP workers spin on cores their neighbours' timing
    tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", FAKE_TIME)
    monkeypatch.setenv("TRIVY_TPU_DETERMINISTIC_UUID", "1")
    for var in ("TRIVY_TPU_FLEET", "TRIVY_TPU_SCHED", "TRIVY_TPU_FAULTS",
                "TRIVY_TPU_ANALYSIS_PIPELINE"):
        monkeypatch.delenv(var, raising=False)
    for P in PKGS:
        P.run._ENGINE_CACHE.clear()
    yield
    for P in PKGS:
        P.run._ENGINE_CACHE.clear()


def store_keys(prefix: bytes = b"") -> list[bytes]:
    return sorted(k for k in _FakeRedisHandler.store if k.startswith(prefix))


# ------------------------------------------------------------- the URL


@pytest.mark.parametrize("url", [
    "redis://h:6380/2", "rediss://user:pw@h:7000", "redis://:sekret@h",
    "redis://h", "rediss://h:1/0", "http://h", "redis://h/x"])
def test_parse_redis_url_equals_reference(url):
    got = {}
    for P in PKGS:
        try:
            got[P.name] = P.redis.parse_redis_url(url)
        except P.redis.RedisError as e:
            got[P.name] = ("error", str(e))
    assert got["port"] == got["ref"]


# ---------------------------------------------------------- the backend


def _round_trip(P, url):
    cache = P.redis.RedisCache(url)
    try:
        cache.put_artifact("sha256:a1", {"architecture": "amd64"})
        cache.put_blob("sha256:b1", {"os": {"family": "alpine"}})
        out = [cache.missing_blobs("sha256:a1", ["sha256:b1", "sha256:b2"]),
               cache.get_artifact("sha256:a1"), cache.get_blob("sha256:b1"),
               cache.get_blob("sha256:nope"), store_keys()]
        cache.delete_blobs(["sha256:b1"])
        out.append(cache.missing_blobs("sha256:a1", ["sha256:b1"]))
        return out
    finally:
        cache.close()


def _prefix(P, url):
    cache = P.redis.RedisCache(url)
    try:
        cache.put_blob("sha256:xyz", {"k": 1})
        return store_keys(b"fanal::")
    finally:
        cache.close()


def _clear(P, url):
    cache = P.redis.RedisCache(url)
    try:
        cache.put_blob("sha256:b", {"k": 1})
        _FakeRedisHandler.store[b"other::key"] = b"keep"
        cache.clear()
        return store_keys()
    finally:
        cache.close()


def _auth(P, url):
    _FakeRedisHandler.auth = "sekret"
    host = url[len("redis://"):]
    out = []
    try:
        P.redis.RedisCache(f"redis://{host}")
    except P.redis.RedisError as e:
        out.append(str(e))
    cache = P.redis.RedisCache(f"redis://:sekret@{host}")
    try:
        cache.put_blob("sha256:b", {"k": 1})
        out.append(cache.get_blob("sha256:b"))
    finally:
        cache.close()
        _FakeRedisHandler.auth = ""
    return out


@pytest.mark.parametrize("shape", [_round_trip, _prefix, _clear, _auth],
                         ids=["round_trip", "fanal_prefix", "clear",
                              "auth"])
def test_cache_shapes_equal_reference(fake_redis, shape):
    """Each backend shape of tests/test_redis_cache.py, on an emptied
    fake redis per package: the same replies and the same keys."""
    got = {}
    for P in PKGS:
        _FakeRedisHandler.store.clear()
        _FakeRedisHandler.expiry.clear()
        got[P.name] = shape(P, fake_redis)
    assert got["port"] == got["ref"]


def _tls_context(P, monkeypatch, **kw):
    """The TLS context RespClient builds (its socket is a fake, so the
    wrap fails after the context is configured)."""
    captured = []
    real = ssl.create_default_context

    def fake_create(cafile=None):
        ctx = real(cafile=cafile)
        captured.append(ctx)
        return ctx

    class _FakeSock:
        def sendall(self, *_):
            raise OSError("fake")

        def recv(self, *_):
            return b""

        def close(self):
            pass

    monkeypatch.setattr(P.redis.ssl, "create_default_context", fake_create)
    monkeypatch.setattr(P.redis.socket, "create_connection",
                        lambda *a, **k: _FakeSock())
    with pytest.raises(Exception):
        P.redis.RespClient("localhost", 1, tls=True, **kw)
    ctx = captured[0]
    return ctx.verify_mode, ctx.check_hostname


@pytest.mark.parametrize("insecure", [False, True],
                         ids=["verifies", "insecure"])
def test_tls_verifies_unless_insecure(monkeypatch, insecure):
    """rediss:// without --redis-ca verifies against the system roots;
    only --redis-insecure turns verification off, in both packages."""
    got = {P.name: _tls_context(P, monkeypatch, insecure=insecure)
           for P in PKGS}
    assert got["port"] == got["ref"]
    assert got["port"] == ((ssl.CERT_NONE, False) if insecure
                           else (ssl.CERT_REQUIRED, True))


# ----------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("redis-image")
    test_fanal._fixture_db().save(str(tmp / "db"))
    return {"tar": _fixture_tar(tmp), "db": str(tmp / "db"), "tmp": tmp}


def cli(P, argv, capsys) -> tuple[int, str]:
    P.uuid.reset()
    rc = P.cli.main(argv + P.device)
    return rc, capsys.readouterr().out


def image_argv(image, url, cache_dir, fmt="json", scanners="vuln,secret"):
    return ["image", "--input", image["tar"], "--format", fmt, "--quiet",
            "--db-path", image["db"], "--cache-dir", cache_dir,
            "--cache-backend", url, "--scanners", scanners]


@pytest.mark.parametrize("fmt", ["json", "table"])
def test_image_scan_on_redis_equals_reference(fake_redis, image, tmp_path,
                                              capsys, fmt):
    """`image --cache-backend redis://` cold and then warm, in each
    package on its own emptied tier: the same report bytes, the same
    keys, and the warm run writes no blob."""
    got = {}
    for P in PKGS:
        _FakeRedisHandler.store.clear()
        _FakeRedisHandler.set_log.clear()
        argv = image_argv(image, fake_redis, str(tmp_path / P.name), fmt)
        cold = cli(P, argv, capsys)
        keys = store_keys()
        n_set = len(_FakeRedisHandler.set_log)
        warm = cli(P, argv, capsys)
        got[P.name] = (cold, warm, keys,
                       len(_FakeRedisHandler.set_log) - n_set)
    assert got["port"] == got["ref"]
    (cold, warm, keys, warm_sets) = got["port"]
    assert cold[0] == 0 and cold == warm and warm_sets == 0
    assert keys and all(k.startswith(b"fanal::") for k in keys)


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref_to_port", "port_to_ref"])
def test_a_tier_written_by_one_package_serves_the_other(
        fake_redis, image, tmp_path, capsys, writer, reader):
    """The keys and blob documents are the reference's: a scan of one
    package fills the tier, and the other package's scan of the same
    image reads every blob from it (it writes none) and prints the same
    report."""
    _FakeRedisHandler.store.clear()
    _FakeRedisHandler.set_log.clear()
    want = cli(writer, image_argv(image, fake_redis,
                                  str(tmp_path / "w")), capsys)
    keys = store_keys()
    n_set = len(_FakeRedisHandler.set_log)
    got = cli(reader, image_argv(image, fake_redis,
                                 str(tmp_path / "r")), capsys)
    assert want[0] == 0 and got == want
    assert store_keys() == keys
    assert _FakeRedisHandler.set_log[n_set:] == []
    blob = next(k for k in keys if k.startswith(b"fanal::blob::"))
    bid = blob.decode()[len("fanal::blob::"):]
    docs = []
    for P in PKGS:
        c = P.redis.RedisCache(fake_redis)
        docs.append(c.get_blob(bid))
        c.close()
    assert docs[0] == docs[1] and docs[0]


def test_fs_scan_uses_redis_cache(fake_redis, tmp_path, capsys):
    """The reference test's shape: `filesystem --cache-backend redis://`
    writes its blob through redis (fs artifacts clean their random-keyed
    blob after the scan), with equal reports."""
    (tmp_path / "app").mkdir()
    (tmp_path / "app" / "requirements.txt").write_text("flask==1.0\n")
    got = {}
    for P in PKGS:
        _FakeRedisHandler.store.clear()
        _FakeRedisHandler.set_log.clear()
        rc, out = cli(P, ["filesystem", str(tmp_path / "app"), "--format",
                          "json", "--cache-backend", fake_redis,
                          "--scanners", "vuln", "--cache-dir",
                          str(tmp_path / P.name), "--quiet"], capsys)
        got[P.name] = (rc, out, sorted(
            k.split(b"::")[1] for k in _FakeRedisHandler.set_log))
    assert got["port"] == got["ref"]
    assert got["port"][0] == 0 and b"blob" in got["port"][2]


@pytest.mark.parametrize("extra,message", [
    (["--cache-backend", "redis://127.0.0.1:1"], "redis cache backend"),
    (["--cache-backend", "redis://h/x"], "invalid redis db in URL"),
    (["--cache-backend", "memcached://h"], "unknown cache backend"),
])
def test_backend_errors_are_the_references(image, tmp_path, capsys,
                                           extra, message):
    """An unreachable or malformed redis URL ends the scan with rc 1 and
    the reference's one error line (port 1 on localhost refuses)."""
    errs = {}
    for P in PKGS:
        argv = ["image", "--input", image["tar"], "--db-path", image["db"],
                "--cache-dir", str(tmp_path / P.name), *extra]
        assert P.cli.main(argv + P.device) == 1
        captured = capsys.readouterr()
        assert captured.out == ""
        lines = [ln for ln in captured.err.splitlines() if "ERROR" in ln]
        assert len(lines) == 1 and message in lines[0]
        errs[P.name] = lines[0].split("ERROR", 1)[1]
    assert errs["port"] == errs["ref"]


def test_redis_options_from_env_and_config_equal_reference(
        fake_redis, image, tmp_path, capsys, monkeypatch):
    """`--cache-backend` from a config file and the redis options from
    the environment apply as the reference applies them."""
    cfg = tmp_path / "trivy-tpu.yaml"
    cfg.write_text(f"cache-backend: {fake_redis}\nredis-ca: ''\n")
    monkeypatch.setenv("TRIVY_TPU_REDIS_INSECURE", "true")
    got = {}
    for P in PKGS:
        _FakeRedisHandler.store.clear()
        got[P.name] = (cli(P, ["image", "--input", image["tar"], "--format",
                               "json", "--quiet", "--db-path", image["db"],
                               "--config", str(cfg), "--cache-dir",
                               str(tmp_path / P.name)], capsys),
                       store_keys())
    assert got["port"] == got["ref"] and got["port"][1]


def test_device_error_on_redis_writes_no_blob(fake_redis, image, tmp_path,
                                              capsys, monkeypatch):
    """A DeviceError in the anchor screen during an image scan on redis:
    rc 1, one error line, no report, and no blob in redis (a blob
    without its secrets must not serve a later scan)."""
    from trivy_tpu_torch.device import DeviceError
    from trivy_tpu_torch.fanal.analyzers import secret_analyzer
    from trivy_tpu_torch.ops import secret_nfa

    orig = secret_analyzer.SecretAnalyzer.post_analyze

    def forced(self, files):
        secret_analyzer.USE_DEVICE = True
        return orig(self, files)

    def fail(self, *a, **kw):
        raise DeviceError("anchor kernel launch failed: CUDA error 700")

    monkeypatch.setattr(secret_analyzer.SecretAnalyzer, "post_analyze",
                        forced)
    monkeypatch.setattr(secret_nfa.AnchorMatcher, "dispatch_chunks", fail)
    monkeypatch.setattr(secret_analyzer, "USE_DEVICE", "hybrid")
    _FakeRedisHandler.store.clear()
    _FakeRedisHandler.set_log.clear()
    argv = image_argv(image, fake_redis, str(tmp_path)) + [
        "--device", "cpu", "--output", str(tmp_path / "out.json")]
    argv.remove("--quiet")
    assert PORT.cli.main(argv) == 1
    out, err = capsys.readouterr()
    assert out == "" and not os.path.exists(tmp_path / "out.json")
    assert len([ln for ln in err.splitlines()
                if "CUDA error 700" in ln and "\tWARNING\t" not in ln]) == 1
    assert not [k for k in _FakeRedisHandler.set_log
                if k.startswith(b"fanal::blob::")]


# ------------------------------------------------------------ the gate


def _redis_service(P, url, monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_SCHED", "0")
    return P.server.ScanService(None, P.redis.RedisCache(url))


def _gate_selected(P, url, monkeypatch):
    svc = _redis_service(P, url, monkeypatch)
    monkeypatch.setenv("TRIVY_TPU_FLEET", "0")
    svc2 = _redis_service(P, url, monkeypatch)
    monkeypatch.delenv("TRIVY_TPU_FLEET")
    svc3 = P.server.ScanService(None, P.cache.MemoryCache())
    return [type(s.layer_gate).__name__ for s in (svc, svc2, svc3)]


def _waits_and_dedupes(P, url, monkeypatch):
    """Server B's client parks on server A's client's in-flight layer,
    then drops it from its missing set once the PutBlob lands. The
    order is fixed by the follower metric, not by a sleep."""
    m = P.metrics
    svc_a = _redis_service(P, url, monkeypatch)
    svc_b = _redis_service(P, url, monkeypatch)
    hits0 = m.LAYER_DEDUPE_HITS.value()
    waits0 = m.LAYER_DEDUPE_INFLIGHT_WAITS.value()
    followers0 = m.FLEET_DEDUPE_CLAIMS.value(outcome="follower")
    first = svc_a.filter_inflight_blobs(["b1"])
    got: dict = {}

    def client_b():
        got["missing"] = svc_b.filter_inflight_blobs(["b1", "b2"])

    t = threading.Thread(target=client_b)
    t.start()
    deadline = time.monotonic() + 30
    while m.FLEET_DEDUPE_CLAIMS.value(outcome="follower") == followers0:
        assert time.monotonic() < deadline, "server B never parked"
        time.sleep(0.005)
    svc_a.cache.put_blob("b1", {"schema_version": 2})
    svc_a.layer_gate.complete("b1")
    t.join(timeout=30)
    assert not t.is_alive()
    svc_b.layer_gate.complete("b2")
    return [first, got["missing"], m.LAYER_DEDUPE_HITS.value() - hits0,
            m.LAYER_DEDUPE_INFLIGHT_WAITS.value() - waits0,
            m.FLEET_DEDUPE_CLAIMS.value(outcome="follower") - followers0]


def _dead_leader(P, url, monkeypatch):
    svc_a = _redis_service(P, url, monkeypatch)
    svc_b = _redis_service(P, url, monkeypatch)
    monkeypatch.setattr(P.pipeline, "SERVER_WAIT_BUDGET_S", 0.2)
    out = [svc_a.filter_inflight_blobs(["b1"])]
    # the leader dies (never completes): B times out, reclaims, analyzes
    t0 = time.monotonic()
    out.append(svc_b.filter_inflight_blobs(["b1"]))
    assert time.monotonic() - t0 < 5.0
    # the reclaim is in redis: a third server parks on B's claim now
    gate_c = P.dedupe.RedisLayerGate(svc_a.cache, ttl_s=60.0)
    out.append(gate_c.claim("b1", holder="other-scan")[1])
    # a retried request (same holder) re-leads its own claim at once
    out.append(svc_a.filter_inflight_blobs(["b9"], holder="t1"))
    t0 = time.monotonic()
    out.append(svc_b.filter_inflight_blobs(["b9"], holder="t1"))
    assert time.monotonic() - t0 < 0.15
    svc_b.layer_gate.complete("b1")
    svc_b.layer_gate.complete("b9")
    return out


@pytest.mark.parametrize("shape", [_gate_selected, _waits_and_dedupes,
                                   _dead_leader],
                         ids=["selected_and_kill_switch",
                              "waits_and_dedupes", "dead_leader"])
def test_gate_shapes_equal_reference(fake_redis, monkeypatch, shape):
    """tests/test_fleet.py's three gate shapes, each package on an
    emptied fake redis: the same observations."""
    got = {}
    for P in PKGS:
        _FakeRedisHandler.store.clear()
        _FakeRedisHandler.expiry.clear()
        with monkeypatch.context() as mp:
            got[P.name] = shape(P, fake_redis, mp)
    assert got["port"] == got["ref"]
    if shape is _gate_selected:
        assert got["port"] == ["RedisLayerGate", "LayerSingleflight",
                               "LayerSingleflight"]
    if shape is _waits_and_dedupes:
        assert got["port"][:4] == [["b1"], ["b2"], 1, 1]
        assert got["port"][4] > 0


E2E_LIMIT_S = 60.0


def test_two_live_servers_exactly_once_e2e(fake_redis, monkeypatch,
                                           tmp_path):
    """Two live port Servers on one fake redis, two clients scanning
    images that share a base layer through DIFFERENT servers: the base
    is analyzed once over both, and the tier holds the blob documents
    of a serial scan (equal in both packages). The order is fixed: client B
    starts once client A's claim on the base is in redis, and A's
    PutBlob of the base waits until B has parked on that claim. The
    in-process singleflight always leads, so exactly-once can only come
    from the redis claims. Every wait is bounded; the test has a limit
    of its own (E2E_LIMIT_S)."""
    t_start = time.monotonic()
    monkeypatch.setenv("TRIVY_TPU_SCHED", "0")
    # the follower's wait must outlast the leader's analysis on a busy
    # host; only the ordering below decides who analyzes
    monkeypatch.setattr(PORT.pipeline, "SERVER_WAIT_BUDGET_S", E2E_LIMIT_S)
    imgs = _mk_registry(tmp_path, 2)
    pipeline = PORT.pipeline

    class _AlwaysLead:
        def claim(self, blob_id, src_cache=None, holder=None):
            return pipeline._Slot(src_cache), True

        def finish(self, blob_id, slot, doc=None, ok=False):
            slot.done, slot.ok, slot.doc = True, ok, doc
            slot.event.set()

    monkeypatch.setattr(pipeline, "SINGLEFLIGHT", _AlwaysLead())

    # serial oracle: each image into a private cache of each package.
    # The documents are the reference's; the port's keys fold in its
    # secret kernel's version, so the tier holds the port's keys.
    def serial(P):
        out = []
        for p in imgs:
            c = P.cache.MemoryCache()
            art = P.image.ImageArtifact(p, c, from_tar=True).inspect()
            out.append([(bid, json.dumps(c.get_blob(bid), sort_keys=True))
                        for bid in art.blob_ids])
        return out

    oracle = serial(PORT)
    assert [[d for _b, d in img] for img in oracle] == \
        [[d for _b, d in img] for img in serial(REF)]
    shared = sorted({b for b, _d in oracle[0]} & {b for b, _d in oracle[1]})
    assert len(shared) == 1 and len({b for img in oracle
                                     for b, _d in img}) == 3
    claim_key = f"fanal::claim::{shared[0]}".encode()

    m = PORT.metrics
    followers0 = m.FLEET_DEDUPE_CLAIMS.value(outcome="follower")
    servers = [PORT.server.Server(None, PORT.redis.RedisCache(fake_redis),
                                  host="localhost", port=0)
               for _ in range(2)]
    for s in servers:
        s.start()
    errs: list = []
    b_parked = threading.Event()

    puts: list = []  # each analysis ends in one PutBlob

    class _CountedCache(PORT.client.RemoteCache):
        def put_blob(self, blob_id, blob):
            puts.append(blob_id)
            return super().put_blob(blob_id, blob)

    class _HeldCache(_CountedCache):
        """Client A's cache: its PutBlob of the shared base waits until
        server B's client has parked on A's claim."""

        def put_blob(self, blob_id, blob):
            if blob_id == shared[0]:
                b_parked.wait(E2E_LIMIT_S)
            return super().put_blob(blob_id, blob)

    def scan(img_path, cache):
        try:
            PORT.image.ImageArtifact(img_path, cache,
                                     from_tar=True).inspect()
        except Exception as exc:  # noqa: BLE001 — surfaced below
            errs.append(exc)

    def until(cond, what):
        while not cond():
            if time.monotonic() - t_start > E2E_LIMIT_S:
                raise AssertionError(f"timed out waiting for {what}")
            time.sleep(0.005)

    try:
        ta = threading.Thread(target=scan, args=(
            imgs[0], _HeldCache(servers[0].address)))
        ta.start()
        until(lambda: claim_key in _FakeRedisHandler.store or errs,
              "client A's claim")
        tb = threading.Thread(target=scan, args=(
            imgs[1], _CountedCache(servers[1].address)))
        tb.start()
        until(lambda: m.FLEET_DEDUPE_CLAIMS.value(outcome="follower")
              > followers0 or errs, "client B to park")
        b_parked.set()
        for t in (ta, tb):
            t.join(timeout=max(0.0, E2E_LIMIT_S
                               - (time.monotonic() - t_start)))
            assert not t.is_alive(), "a client did not finish in time"
        assert not errs, errs
        # 2 images x (shared base + own app layer): 3 analyses, each
        # blob written to the tier once (process-wide counters are not
        # read: another test's threads may still run in this process)
        assert sorted(puts) == sorted({b for img in oracle
                                       for b, _d in img})
        assert sorted(k for k in _FakeRedisHandler.set_log
                      if k.startswith(b"fanal::blob::")) == sorted(
            f"fanal::blob::{b}".encode() for b in set(puts))
        reader = PORT.redis.RedisCache(fake_redis)
        for img in oracle:
            for bid, want in img:
                assert json.dumps(reader.get_blob(bid),
                                  sort_keys=True) == want
        reader.close()
    finally:
        b_parked.set()
        PORT.client.close_pool()
        for s in servers:
            s.shutdown()
    assert time.monotonic() - t_start < E2E_LIMIT_S


# ------------------------------------------------------------ on a card


@pytest.mark.cuda
def test_cuda_image_on_redis_equals_device_cpu(fake_redis, image, tmp_path,
                                               capsys):
    """On a card: `image --cache-backend redis://` cold and warm on
    cuda:0 print the report of `--device cpu` on a tier of its own,
    and the warm run launches no anchor screen."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    from trivy_tpu_torch.ops import secret_nfa

    outs = {}
    for dev in ("cpu", "cuda:0"):
        _FakeRedisHandler.store.clear()
        argv = image_argv(image, fake_redis, str(tmp_path / dev))
        runs = []
        for _ in ("cold", "warm"):
            PORT.uuid.reset()
            n0 = secret_nfa.anchor_words.launches
            rc = PORT.cli.main(argv + ["--device", dev])
            runs.append((rc, capsys.readouterr().out,
                         secret_nfa.anchor_words.launches - n0))
        outs[dev] = runs
    assert [r[:2] for r in outs["cuda:0"]] == [r[:2] for r in outs["cpu"]]
    assert outs["cuda:0"][0][0] == 0 and outs["cuda:0"][1][2] == 0
