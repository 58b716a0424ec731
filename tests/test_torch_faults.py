"""Port parity, the device-loss ladders: the match engine's ``engine``
and ``engine.device`` sites and the secret scanner's ``secret.device``
site on trivy_tpu_torch, against the JAX package under the same fault
plan on the same seeded inputs.

The shapes are the reference's: the ``engine.device`` drop / delay /
device-lost cases of tests/test_pipeline_cache.py (serial and
pipelined), the engine device loss of tests/test_resilience.py, the
mid-burst ``engine:device-lost`` of tests/test_sched.py's concurrent
scans, and the ``secret.device`` matrix of tests/test_secret_engine.py
(batch, hybrid, a 16 MiB stream). Each rung gives the fault-free hits
or findings. And the port's own rule: an error that is neither
DeviceLost nor ScreenUnavailable (a kernel that cannot launch, a CUDA
error) raises instead of degrading. Engines run on device="cpu" (the
match kernel's plain version), the secret scanner on device="cpu" (the
screens' plain versions); the `cuda`-marked tests run the kernels.
Hits, findings and response bytes compare by exact equality.
"""

from __future__ import annotations

import pytest
import torch
from test_pipeline_cache import _many_queries, _rich_db
from test_secret_engine import _big_file
from test_torch_match import port_db
from test_torch_secret_scanner import norm, secret_corpus
from test_torch_sched import (
    _artifacts,
    _caches,
    _custom_sched,
    _db,
    _ref_bytes,
    _run_threads,
    _scan_bytes,
)

import trivy_tpu.secret.scanner as jsc
import trivy_tpu_torch.ops.secret_nfa as tn
import trivy_tpu_torch.secret.scanner as tsc
from trivy_tpu.detector.engine import MatchEngine as JaxEngine
from trivy_tpu.resilience import faults as jax_faults
from trivy_tpu.rpc.server import ScanService as JaxScanService
from trivy_tpu_torch.detector.engine import MatchEngine, PkgQuery
from trivy_tpu_torch.ops import match as tm
from trivy_tpu_torch.resilience import faults
from trivy_tpu_torch.rpc.server import ScanService

pytestmark = pytest.mark.fault


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
def _clean_faults():
    faults.reset()
    jax_faults.reset()
    tsc.reset_hybrid_probe()
    yield
    faults.reset()
    jax_faults.reset()
    tsc.reset_hybrid_probe()


def _both(spec: str) -> None:
    faults.install_spec(spec)
    jax_faults.install_spec(spec)


def _hits(results):
    return [r.adv_indices for r in results]


@pytest.fixture(scope="module")
def rich():
    """tests/test_pipeline_cache.py's DB and crawl in both packages."""
    jdb = _rich_db()
    jqs = _many_queries(seed=7)
    return {"jdb": jdb, "db": port_db(jdb), "jqs": jqs,
            "qs": [PkgQuery(*q.key) for q in jqs],
            "want": _hits(JaxEngine(jdb, window=16, use_device=False)
                          .detect_many(jqs, batch_size=1024))}


# ------------------------------------------------------- engine.device


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["serial", "pipelined"])
@pytest.mark.parametrize("spec", [
    "engine.device:drop@2",        # one in-flight result lost, recomputed
    "engine.device:drop",          # every result lost
    "engine.device:delay=0.01@1-3",
    "engine.device:device-lost@2",  # the crawl degrades to the oracle
])
def test_crawl_under_device_faults(rich, monkeypatch, spec, pipelined):
    """Each rung gives the oracle's hits, as the reference's crawl does;
    a loss in the pipelined crawl degrades the port to the oracle, where
    the reference mostly lets a CancelledError out (its crunch lanes'
    cancelled futures are read on the error path; ROADMAP.md queue 3):
    there the reference's own host path is the comparison."""
    monkeypatch.setenv("TRIVY_TPU_PIPELINE", "1" if pipelined else "0")
    monkeypatch.setenv("TRIVY_TPU_PIPELINE_WORKERS", "2")
    _both(spec)
    e = MatchEngine(rich["db"], window=16, device="cpu")
    got = _hits(e.detect_many(rich["qs"], batch_size=1024, depth=3))
    assert got == rich["want"]
    lost = "device-lost" in spec
    if not (lost and pipelined):
        j = JaxEngine(rich["jdb"], window=16)
        assert got == _hits(j.detect_many(rich["jqs"], batch_size=1024,
                                          depth=3))
        assert j.device_lost == lost
    if pipelined:
        assert e.last_pipeline_stats is not None or e.device_lost
    assert e.device_lost == lost
    assert e.use_device == (not lost) and e.degraded == int(lost)
    if not lost:  # a loss races the other crunch lane's fire
        assert [r.fired for r in faults.active().rules] == \
            [r.fired for r in jax_faults.active().rules]


@pytest.mark.parametrize("spec", ["engine.device:drop@1",
                                  "engine.device:delay=0.005@1",
                                  "engine.device:device-lost@1"])
def test_detect_under_device_faults(rich, spec):
    """detect() passes the same stage hook as the crawl."""
    _both(spec)
    qs, jqs = rich["qs"][:300], rich["jqs"][:300]
    e = MatchEngine(rich["db"], window=16, device="cpu")
    j = JaxEngine(rich["jdb"], window=16)
    assert _hits(e.detect(qs)) == _hits(j.detect(jqs)) \
        == rich["want"][:300]
    assert e.device_lost == j.device_lost == ("device-lost" in spec)


def test_pipelined_device_lost_degrades_to_oracle(rich, monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_PIPELINE", "1")
    monkeypatch.setenv("TRIVY_TPU_PIPELINE_WORKERS", "1")
    # the loss fires mid-crawl (the 3rd chunk's dispatch), after results
    # have been collected: the whole crawl must still be exact
    _both("engine:device-lost@4")
    e = MatchEngine(rich["db"], window=16, device="cpu")
    j = JaxEngine(rich["jdb"], window=16)
    got = _hits(e.detect_many(rich["qs"], batch_size=1024, depth=2))
    assert got == _hits(j.detect_many(rich["jqs"], batch_size=1024,
                                      depth=2)) == rich["want"]
    assert e.device_lost and not e.use_device and e.degraded == 1
    assert j.device_lost and not j.use_device


# --------------------------------------------------------------- engine


def test_engine_device_lost_degrades_to_oracle():
    _both("engine:device-lost@1")
    db = _db()
    e = MatchEngine(db, device="cpu")
    oracle = MatchEngine(db, use_device=False)
    qs = [PkgQuery("npm::", f"pkg{i}", "1.1.0", "npm") for i in range(6)]
    want = _hits(oracle.detect(qs))
    assert _hits(e.detect(qs)) == want
    assert e.device_lost and not e.use_device and e.degraded == 1
    # later batches stay on the (degraded) host path and still match
    assert _hits(e.detect(qs)) == want and e.degraded == 1
    assert e.device is not None  # where it ran; it stays off the card


def test_engine_device_lost_in_detect_many():
    _both("engine:device-lost@1")
    e = MatchEngine(_db(), device="cpu")
    qs = [PkgQuery("npm::", "pkg3", v, "npm")
          for v in ("0.1.0", "3.1.0", "5.1.0")]
    got = _hits(e.detect_many(qs, batch_size=2))
    assert got == _hits(MatchEngine(_db(), use_device=False)
                        .detect_many(qs, batch_size=2))
    assert e.device_lost


@pytest.mark.sched
def test_concurrent_scans_zero_diff_under_device_loss(monkeypatch,
                                                      tmp_path):
    """tests/test_sched.py's concurrent scans under sched.submit drop
    and delay faults and a mid-burst device loss: every response equals
    the TRIVY_TPU_SCHED=0 reference service's bytes."""
    from trivy_tpu.db import AdvisoryDB as JaxAdvisoryDB

    arts, blobs = _artifacts([6, 80, 20, 150, 3, 40], seed=11, prefix="f")
    cache, ref_cache = _caches(blobs)
    _db().save(str(tmp_path / "db"))
    jdb = JaxAdvisoryDB.load(str(tmp_path / "db"))
    monkeypatch.setenv("TRIVY_TPU_SCHED", "0")
    ref = JaxScanService(JaxEngine(jdb, use_device=False), ref_cache)
    want = {t: _ref_bytes(ref, t, k) for t, k in arts}
    monkeypatch.delenv("TRIVY_TPU_SCHED")

    faults.install_spec("sched.submit:delay=0.001@2;sched.submit:drop@3;"
                        "engine:device-lost@2")
    engine = MatchEngine(_db(), device="cpu")
    service = ScanService(engine, cache)
    try:
        _custom_sched(service, window_ms=4.0, max_rows=48, chunk_rows=16)
        got: dict[str, bytes] = {}

        def worker(tid: int):
            for target, key in arts:
                got[f"{tid}:{target}"] = _scan_bytes(service, target, key)

        assert not _run_threads(worker, 4)
    finally:
        service.close()
    assert engine.device_lost and engine.degraded == 1
    assert len(got) == 4 * len(arts)
    for k, b in got.items():
        assert b == want[k.split(":", 1)[1]], k


# ----------------------------------------------------------- no fallback


class KernelFault(RuntimeError):
    """Stands in for a kernel that fails to build or launch."""


def _kernel_fault(*_a, **_k):
    raise KernelFault("kernel failed to launch")


@pytest.mark.parametrize("mesh", [False, True], ids=["single", "mesh"])
def test_engine_error_that_is_no_device_loss_raises(rich, monkeypatch,
                                                    mesh):
    """A failing kernel is not a lost card: detect and detect_many raise
    it, the engine stays on the device, no shard degrades."""
    kw = {"mesh_spec": "2x2"} if mesh else {}
    e = MatchEngine(rich["db"], window=16, device="cpu", **kw)
    monkeypatch.setattr(tm, "match_words", _kernel_fault)
    with pytest.raises(KernelFault):
        e.detect(rich["qs"][:50])
    with pytest.raises(KernelFault):
        e.detect_many(rich["qs"], batch_size=1024)
    assert e.use_device and not e.device_lost and e.degraded == 0
    if mesh:
        assert e.shard_health()["degraded"] == []


# --------------------------------------------------------- secret.device


@pytest.fixture(scope="module", autouse=True)
def _small_batches(tmp_path_factory):
    """Screen batches of eight chunks in both packages, and their
    compiled-NFA caches out of the home directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRIVY_TPU_SECRET_PACK_MB", "0.125")
        mp.setenv("TRIVY_TPU_CACHE_DIR",
                  str(tmp_path_factory.mktemp("nfa-cache")))
        yield


@pytest.fixture(scope="module")
def port():
    s = tsc.SecretScanner(device="cpu")
    yield s
    s.close()


@pytest.fixture(scope="module")
def js():
    s = jsc.SecretScanner()
    yield s
    s.close()


@pytest.fixture(scope="module")
def corpus():
    return secret_corpus(seed=4, n_files=25)


@pytest.fixture(scope="module")
def host(corpus, js):
    out = norm(js.scan_files(corpus, use_device=False))
    assert out
    return out


@pytest.mark.secret
@pytest.mark.parametrize("spec", ["secret.device:drop",
                                  "secret.device:error",
                                  "secret.device:device-lost",
                                  "secret.device:delay=0.001"])
def test_secret_batch_degrades_to_host_zero_diff(corpus, port, js, host,
                                                 spec):
    before = port.device_stats["degraded"]
    _both(spec)
    assert norm(port.scan_files(corpus, use_device=True)) == host
    assert norm(js.scan_files(corpus, use_device=True)) == host
    faults.reset()
    # one degradation a faulted scan, none for a delay
    assert port.device_stats["degraded"] == before + (
        0 if "delay" in spec else 1)


@pytest.mark.secret
@pytest.mark.parametrize("spec", ["secret.device:drop",
                                  "secret.device:device-lost@1",
                                  "secret.device:delay=0.001"])
def test_secret_hybrid_fault_keeps_findings(corpus, port, host, monkeypatch,
                                            spec):
    monkeypatch.setenv("TRIVY_TPU_SECRET_PROBE", "0")
    monkeypatch.setattr(tsc.SecretScanner, "_accel_backend",
                        lambda self: True)
    before = port.device_stats["degraded"]
    faults.install_spec(spec)
    assert norm(port.scan_files(corpus, use_device="hybrid")) == host
    assert port.device_stats["degraded"] == before + (
        0 if "delay" in spec else 1)


@pytest.mark.secret
def test_secret_probe_unavailable_keeps_host(corpus, port, host,
                                             monkeypatch):
    """A screen the ladder reports unavailable during the hybrid probe
    keeps the host alone (the reference's verdict), with the same
    findings."""
    monkeypatch.setattr(tsc.SecretScanner, "_accel_backend",
                        lambda self: True)
    faults.install_spec("secret.device:error@1")
    assert norm(port.scan_files(corpus, use_device="hybrid")) == host
    state = tsc.hybrid_probe_state()
    assert state["device"] is False
    assert state["reason"].startswith("unavailable")


@pytest.mark.secret
def test_secret_16mib_stream_fault_falls_back(port):
    """A file over 16 MiB streams; under secret.device device-lost it
    restarts on the host with the whole-file findings of both
    packages."""
    content = _big_file(4 << 20)
    assert len(content) >= 16 << 20
    want = port.scan_file("lib/blob.txt", content)
    ref = jsc.SecretScanner().scan_file("lib/blob.txt", content)
    before = port.device_stats["degraded"]
    faults.install_spec("secret.device:device-lost")
    got = port.scan_stream("lib/blob.txt", content, use_device=True)
    assert norm([got]) == norm([want]) == norm([ref])
    assert port.device_stats["degraded"] == before + 1


@pytest.mark.secret
def test_secret_error_that_is_no_screen_fault_raises(corpus, port,
                                                     monkeypatch):
    """A screen that fails to launch raises out of the batch, hybrid and
    stream paths: only ScreenUnavailable and DeviceLost degrade."""
    before = port.device_stats["degraded"]
    monkeypatch.setattr(tn.AnchorMatcher, "dispatch_chunks", _kernel_fault)
    monkeypatch.setenv("TRIVY_TPU_SCHED", "0")
    with pytest.raises(KernelFault):
        port.scan_files(corpus, use_device=True)
    monkeypatch.setenv("TRIVY_TPU_SECRET_PROBE", "0")
    monkeypatch.setattr(tsc.SecretScanner, "_accel_backend",
                        lambda self: True)
    with pytest.raises(KernelFault):
        port.scan_files(corpus, use_device="hybrid")
    with pytest.raises(KernelFault):
        port.scan_stream("lib/blob.txt", _big_file(64 * 1024),
                         use_device=True)
    assert port.device_stats["degraded"] == before


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_cuda_ladders_on_the_card(rich, corpus, host):
    """On a card: each rung of the engine and secret ladders gives the
    fault-free hits and findings with the kernels launching."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    for spec in ("engine.device:drop@2", "engine.device:delay=0.01@1-3",
                 "engine.device:device-lost@2", "engine:device-lost@3"):
        faults.install_spec(spec)
        e = MatchEngine(rich["db"], window=16, device=dev)
        launches = tm.match_words.launches
        got = _hits(e.detect_many(rich["qs"], batch_size=1024, depth=3))
        assert got == rich["want"], spec
        assert tm.match_words.launches > launches, spec
    s = tsc.SecretScanner(device=dev)
    try:
        for spec in ("secret.device:drop", "secret.device:error",
                     "secret.device:device-lost",
                     "secret.device:delay=0.001"):
            faults.install_spec(spec)
            assert norm(s.scan_files(corpus, use_device=True)) == host
        faults.reset()
        assert s.device_stats["degraded"] == 3
    finally:
        s.close()
