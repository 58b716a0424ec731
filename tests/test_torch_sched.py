"""Port parity, the cross-request match scheduler and the secret-lane
scheduler: trivy_tpu_torch's MatchScheduler and ScanService (engines on
device="cpu", so the match kernel's plain version answers) against the
JAX package's, on one saved DB and the same blobs. The shapes are
tests/test_sched.py's: fan-out, concurrent zero-diff (against the
TRIVY_TPU_SCHED=0 path and against the reference), queued-deadline
sheds, admission control, the sched.submit faults, fairness, per-slice
failure isolation, the lone-scan window skip, drain and per-tenant QoS.
The secret lane: concurrent SecretScanner.scan_files calls coalesce into
shared screen dispatches with findings equal to the direct path's and
the reference's.

Scan responses are compared as `wire.scan_response` bytes, match sets
as advisory-index lists, findings as tuples: the tolerance is exact
equality. Every scheduler, service and scanner is closed in a
finalizer, and every wait has its own timeout.
"""

from __future__ import annotations

import random
import threading
import time

import pytest
import torch
from test_torch_secret_scanner import norm, secret_corpus

import trivy_tpu.secret.scanner as jsc
import trivy_tpu_torch.secret.scanner as tsc
from trivy_tpu.cache.cache import MemoryCache as JaxMemoryCache
from trivy_tpu.db import AdvisoryDB as JaxAdvisoryDB
from trivy_tpu.detector.engine import MatchEngine as JaxEngine
from trivy_tpu.detector.engine import PkgQuery as JaxQuery
from trivy_tpu.resilience import faults as jax_faults
from trivy_tpu.rpc import wire as jax_wire
from trivy_tpu.rpc.server import ScanService as JaxScanService
from trivy_tpu.sched.scheduler import MatchScheduler as JaxScheduler
from trivy_tpu.sched.scheduler import _Pending as JaxPending
from trivy_tpu.types.scan import ScanOptions as JaxScanOptions
from trivy_tpu_torch.cache.cache import MemoryCache
from trivy_tpu_torch.db import Advisory, AdvisoryDB
from trivy_tpu_torch.detector.engine import MatchEngine, PkgQuery
from trivy_tpu_torch.obs import usage
from trivy_tpu_torch.resilience import faults
from trivy_tpu_torch.resilience.retry import Deadline, deadline_scope
from trivy_tpu_torch.rpc import wire
from trivy_tpu_torch.rpc.server import Overloaded, ScanService
from trivy_tpu_torch.sched.scheduler import MatchScheduler, _Pending
from trivy_tpu_torch.types.scan import ScanOptions

pytestmark = pytest.mark.sched

N_PKGS = 24
JOIN_S = 30.0  # every thread join and event wait is bounded


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and idle OpenMP workers spin on cores their neighbours' timing
    tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _no_threads_left():
    """No scheduler or scanner thread outlives the module."""
    before = set(threading.enumerate())
    yield
    for _ in range(200):
        left = [t for t in threading.enumerate()
                if t not in before and t.is_alive()]
        if not left:
            break
        time.sleep(0.05)
    assert left == []


@pytest.fixture(autouse=True)
def _reset_faults():
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


@pytest.fixture()
def closer():
    """Finalizer list: every scheduler, service and scanner a test
    builds is closed after it, passed or failed (None: nothing to
    close, e.g. a service built with TRIVY_TPU_SCHED=0)."""
    items: list = []
    yield items.append
    for obj in reversed(items):
        if obj is not None:
            obj.close()


def _db() -> AdvisoryDB:
    db = AdvisoryDB()
    for i in range(N_PKGS):
        db.put_advisory("npm::ghsa", f"pkg{i}", Advisory(
            vulnerability_id=f"CVE-2024-{1000 + i}",
            vulnerable_versions=[f"<{(i % 5) + 1}.0.0"],
        ))
    for i in range(8):
        db.put_advisory("pip::ghsa", f"mod{i}", Advisory(
            vulnerability_id=f"CVE-2024-{2000 + i}",
            vulnerable_versions=[f"<{(i % 3) + 1}.2.0"],
        ))
    return db


@pytest.fixture(scope="module")
def db_dir(tmp_path_factory):
    """The DB saved once by the port; both packages load it."""
    path = tmp_path_factory.mktemp("sched-db") / "db"
    _db().save(str(path))
    return str(path)


@pytest.fixture(scope="module")
def engines(db_dir):
    return {"port": MatchEngine(AdvisoryDB.load(db_dir), device="cpu"),
            "ref": JaxEngine(JaxAdvisoryDB.load(db_dir), use_device=False)}


def _queries(n: int, seed: int = 0) -> list[PkgQuery]:
    rng = random.Random(seed)
    return [PkgQuery("npm::", f"pkg{rng.randrange(N_PKGS)}",
                     f"{rng.randrange(7)}.1.0", "npm") for _ in range(n)]


def _blob(rng: random.Random, n_pkgs: int) -> dict:
    apps = []
    for app_type, eco_prefix, pool in (("npm", "pkg", N_PKGS),
                                       ("pip", "mod", 8)):
        pkgs = []
        for _j in range(max(n_pkgs // 2, 1)):
            k = rng.randrange(pool)
            v = f"{rng.randrange(6)}.1.0"
            name = f"{eco_prefix}{k}"
            pkgs.append({"id": f"{name}@{v}", "name": name, "version": v})
        apps.append({"type": app_type,
                     "file_path": f"{app_type}/lock.json",
                     "packages": pkgs})
    return {"schema_version": 2, "applications": apps}


def _artifacts(sizes, seed: int, prefix: str):
    """-> ([(target, key)], blobs by key) from one seeded rng."""
    rng = random.Random(seed)
    blobs = {}
    arts = []
    for i, size in enumerate(sizes):
        key = f"sha256:{prefix}{i}"
        blobs[key] = _blob(rng, size)
        arts.append((f"img{i}", key))
    return arts, blobs


def _caches(blobs: dict):
    port, ref = MemoryCache(), JaxMemoryCache()
    for key, blob in blobs.items():
        port.put_blob(key, blob)
        ref.put_blob(key, blob)
    return port, ref


def _scan_bytes(service: ScanService, target: str, key: str) -> bytes:
    results, os_found = service.scan(target, "", [key], ScanOptions())
    return wire.scan_response(results, os_found)


def _ref_bytes(service, target: str, key: str) -> bytes:
    results, os_found = service.scan(target, "", [key], JaxScanOptions())
    return jax_wire.scan_response(results, os_found)


def _custom_sched(svc: ScanService, **kw) -> MatchScheduler:
    """Swap the service's default scheduler for one with test knobs."""
    if svc.scheduler is not None:
        svc.scheduler.close()
    svc.scheduler = MatchScheduler(lambda: svc.engine,
                                   on_shed=svc.metrics.scans_shed.inc,
                                   **kw)
    return svc.scheduler


def _run_threads(target, n: int) -> list[Exception]:
    errs: list[Exception] = []

    def guarded(tid):
        try:
            target(tid)
        except Exception as exc:  # noqa: BLE001 — reported below
            errs.append(exc)

    threads = [threading.Thread(target=guarded, args=(tid,))
               for tid in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive(), "worker thread hung"
    return errs


def _same_hits(a, b) -> bool:
    return [r.adv_indices for r in a] == [r.adv_indices for r in b]


# ------------------------------------------------------------- tentpole


def test_engine_submit_fans_out_per_request(engines):
    engine, ref = engines["port"], engines["ref"]
    lists = [_queries(7, seed=1), _queries(0, seed=2), _queries(13, seed=3)]
    fanned = engine.submit(lists)
    ref_fanned = ref.submit([[JaxQuery(*q.key) for q in qs]
                             for qs in lists])
    assert [len(part) for part in fanned] == [7, 0, 13]
    for qs, part, ref_part in zip(lists, fanned, ref_fanned):
        assert _same_hits(part, engine.detect(qs))
        assert _same_hits(part, ref_part)
        assert [r.query for r in part] == qs


def test_concurrent_server_zero_diff(engines, monkeypatch, closer):
    """4 threads x 6 artifacts through a ScanService with the scheduler
    on == byte-identical to the per-request path (TRIVY_TPU_SCHED=0) and
    to the reference's service on the same DB and blobs."""
    arts, blobs = _artifacts([4, 30, 120, 7, 300, 18], seed=3, prefix="a")
    cache, ref_cache = _caches(blobs)

    monkeypatch.setenv("TRIVY_TPU_SCHED", "0")
    seq_service = ScanService(engines["port"], cache)
    assert seq_service.scheduler is None  # kill switch honored
    want = {t: _scan_bytes(seq_service, t, k) for t, k in arts}
    ref_service = JaxScanService(engines["ref"], ref_cache)
    closer(ref_service.scheduler)
    ref = {t: _ref_bytes(ref_service, t, k) for t, k in arts}
    assert want == ref

    monkeypatch.delenv("TRIVY_TPU_SCHED")
    service = ScanService(engines["port"], cache)
    closer(service)
    assert service.scheduler is not None
    # small batches + wide window force coalescing AND chunk
    # interleaving across the concurrent scans
    _custom_sched(service, window_ms=5.0, max_rows=64, chunk_rows=16)
    got: dict[str, bytes] = {}

    def worker(tid: int):
        for target, key in arts[tid:] + arts[:tid]:
            got[f"{tid}:{target}"] = _scan_bytes(service, target, key)

    assert not _run_threads(worker, 4)
    for tid in range(4):
        for target, _k in arts:
            assert got[f"{tid}:{target}"] == want[target]
    assert service.scheduler.stats["batches"] >= 1
    assert service.scheduler.stats["coalesced"] >= 2
    assert service.scheduler.stats["sheds"] == 0


@pytest.mark.fault
def test_concurrent_zero_diff_under_faults(engines, monkeypatch, closer):
    """Zero diff holds under sched.submit drop and delay faults: a
    dropped submission takes the private detect path, a delayed one
    joins a later batch."""
    arts, blobs = _artifacts([6, 80, 20, 150, 3, 40], seed=11, prefix="f")
    cache, ref_cache = _caches(blobs)
    ref_service = JaxScanService(engines["ref"], ref_cache)
    closer(ref_service.scheduler)
    want = {t: _ref_bytes(ref_service, t, k) for t, k in arts}

    faults.install_spec("sched.submit:delay=0.001@2;sched.submit:drop@3")
    service = ScanService(engines["port"], cache)
    closer(service)
    _custom_sched(service, window_ms=4.0, max_rows=48, chunk_rows=16)
    got: dict[str, bytes] = {}

    def worker(tid: int):
        for target, key in arts:
            got[f"{tid}:{target}"] = _scan_bytes(service, target, key)

    assert not _run_threads(worker, 4)
    for k, b in got.items():
        assert b == want[k.split(":", 1)[1]], k
    rules = faults.active().rules
    assert [r.fired for r in rules] == [1, 1]


def test_queued_deadline_expiry_sheds(engines, closer):
    """A request whose budget expires while queued is shed with
    Retry-After (503 upstream), never silently dropped — as in the
    reference."""
    for sched_cls, overloaded in ((MatchScheduler, Overloaded),
                                  (JaxScheduler, None)):
        shed: list = []
        sched = sched_cls(lambda: engines["port"], window_ms=2000.0,
                          on_shed=lambda: shed.append(1))
        closer(sched)
        if sched_cls is MatchScheduler:
            with deadline_scope(Deadline(0.05)):
                with pytest.raises(overloaded) as ei:
                    sched.submit(_queries(8))
        else:
            from trivy_tpu.resilience.retry import Deadline as JD
            from trivy_tpu.resilience.retry import deadline_scope as jds
            from trivy_tpu.sched.scheduler import Overloaded as JO

            with jds(JD(0.05)):
                with pytest.raises(JO) as ei:
                    sched.submit([JaxQuery(*q.key) for q in _queries(8)])
        assert ei.value.retry_after == 1.0
        assert "expired while queued" in str(ei.value)
        assert shed == [1]


def test_service_counts_queued_shed_once(engines, closer):
    cache = MemoryCache()
    cache.put_blob("sha256:s", _blob(random.Random(1), 10))
    service = ScanService(engines["port"], cache)
    closer(service)
    _custom_sched(service, window_ms=2000.0)
    with pytest.raises(Overloaded):
        service.scan("img", "", ["sha256:s"], ScanOptions(),
                     deadline=Deadline(0.15))
    assert service.metrics.scans_shed_total == 1
    assert service.metrics.scan_errors_total == 0
    assert service.metrics.scans_total == 0


def test_queue_admission_control(engines, closer):
    sched = MatchScheduler(lambda: engines["port"], window_ms=1000.0,
                           max_queue=1)
    closer(sched)
    out: list = []
    t = threading.Thread(
        target=lambda: out.append(sched.submit(_queries(4))))
    t.start()
    try:
        deadline = time.monotonic() + 5.0
        while not sched._waiting and time.monotonic() < deadline:
            time.sleep(0.002)
        assert sched._waiting, "first submission never queued"
        with pytest.raises(Overloaded) as ei:
            sched.submit(_queries(4))
        assert "overloaded" in str(ei.value)
        assert sched.stats["sheds"] == 1
    finally:
        # close() drains the queued-and-admitted request first
        sched.close()
        t.join(JOIN_S)
    assert out and len(out[0]) == 4


@pytest.mark.fault
def test_sched_submit_error_fault_sheds(engines, closer):
    faults.install_spec("sched.submit:error@1")
    sched = MatchScheduler(lambda: engines["port"], window_ms=1.0)
    closer(sched)
    with pytest.raises(Overloaded) as ei:
        sched.submit(_queries(3))
    assert ei.value.retry_after == 1.0
    assert sched.stats["sheds"] == 1
    # next submission is clean
    assert len(sched.submit(_queries(3))) == 3


@pytest.mark.fault
def test_sched_submit_drop_bypasses_scheduler(engines, closer):
    faults.install_spec("sched.submit:drop")
    sched = MatchScheduler(lambda: engines["port"], window_ms=1.0)
    closer(sched)
    qs = _queries(9)
    got = sched.submit(qs)
    assert _same_hits(got, engines["port"].detect(qs))
    assert _same_hits(got, engines["ref"].detect(
        [JaxQuery(*q.key) for q in qs]))
    assert sched.stats["batches"] == 0  # never entered the queue


class _ManualSched(MatchScheduler):
    """Scheduler whose background thread idles: tests drive
    _compose/_dispatch by hand for deterministic batch composition."""

    def _run(self):
        while not self._stopping:
            time.sleep(0.02)


class _ManualJaxSched(JaxScheduler):
    def _run(self):
        while not self._stopping:
            time.sleep(0.02)


def _batches(sched, pendings) -> list[list[tuple]]:
    """Drive `pendings` through _compose/_dispatch until all are done
    -> per batch [(pending index, lo, hi)]."""
    index = {id(p): i for i, p in enumerate(pendings)}
    out = []
    for _ in range(1000):
        if all(p.done.is_set() for p in pendings):
            return out
        parts, rows = sched._compose()
        out.append([(index[id(p)], lo, hi) for p, lo, hi in parts])
        sched._dispatch(parts, rows)
    raise AssertionError("pendings never completed")


def test_fairness_small_request_not_starved(engines, closer):
    """Chunk interleaving: a small request queued behind a huge one is
    fully dispatched in the huge request's FIRST batch; the batch
    sequence equals the reference scheduler's."""
    sched = _ManualSched(lambda: engines["port"], window_ms=30.0,
                         max_rows=32, chunk_rows=8)
    closer(sched)
    p_big = sched._enqueue(_queries(400, seed=1))
    p_small = sched._enqueue(_queries(6, seed=2))
    batches = _batches(sched, [p_big, p_small])
    # queued rows >= max_rows: the window closes immediately and the
    # first batch interleaves chunks of BOTH requests
    assert {i for i, _lo, _hi in batches[0]} == {0, 1}
    assert sum(hi - lo for _i, lo, hi in batches[0]) == 32
    assert [hi for i, _lo, hi in batches[0] if i == 1][-1] == 6
    assert len(batches) >= 400 // 32
    assert p_small.error is None and p_big.error is None
    assert _same_hits(p_small.results, engines["port"].detect(
        p_small.queries))
    assert _same_hits(p_big.results, engines["port"].detect(
        p_big.queries))

    ref = _ManualJaxSched(lambda: engines["ref"], window_ms=30.0,
                          max_rows=32, chunk_rows=8)
    closer(ref)
    r_big = ref._enqueue([JaxQuery(*q.key) for q in p_big.queries])
    r_small = ref._enqueue([JaxQuery(*q.key) for q in p_small.queries])
    assert _batches(ref, [r_big, r_small]) == batches
    assert _same_hits(r_big.results, p_big.results)


def test_batch_failure_isolated_per_request(engines, closer):
    """One request's poison queries must fail only that request: a
    failed shared batch re-dispatches each coalesced slice privately
    (per-request-path error parity)."""
    engine = engines["port"]
    poison = _queries(5, seed=9)
    good = _queries(6, seed=4)

    class FlakyEngine:
        def submit(self, lists):
            raise RuntimeError("batch boom")

        def detect(self, qs):
            if qs and qs[0] is poison[0]:
                raise RuntimeError("poison slice")
            return engine.detect(qs)

    sched = MatchScheduler(lambda: FlakyEngine(), window_ms=100.0)
    closer(sched)
    results: dict = {}
    errs: dict = {}

    def run(name, qs):
        try:
            results[name] = sched.submit(qs)
        except Exception as exc:  # noqa: BLE001
            errs[name] = exc

    threads = [threading.Thread(target=run, args=("good", good)),
               threading.Thread(target=run, args=("poison", poison))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive()
    assert "poison" in errs and "poison slice" in str(errs["poison"])
    assert "good" not in errs
    assert _same_hits(results["good"], engine.detect(good))


def test_lone_scan_skips_coalesce_window(engines, closer):
    """With one in-flight scan (busy_fn <= 1) the coalesce window is
    skipped: a huge window must not delay a lone submission."""
    sched = MatchScheduler(lambda: engines["port"], window_ms=5000.0,
                           busy_fn=lambda: 1)
    closer(sched)
    t0 = time.monotonic()
    out = sched.submit(_queries(5))
    assert len(out) == 5
    assert time.monotonic() - t0 < 2.0


def test_drain_finishes_admitted_work_and_refuses_new(engines, closer):
    """Drain semantics: a scan admitted (and queued in the scheduler)
    before drain completes; a scan arriving after drain sheds."""
    cache = MemoryCache()
    cache.put_blob("sha256:d", _blob(random.Random(2), 12))
    service = ScanService(engines["port"], cache)
    closer(service)
    _custom_sched(service, window_ms=150.0)
    out: list = []
    errs: list = []

    def admitted():
        try:
            out.append(_scan_bytes(service, "img", "sha256:d"))
        except Exception as exc:  # noqa: BLE001
            errs.append(exc)

    t = threading.Thread(target=admitted)
    t.start()
    try:
        deadline = time.monotonic() + 5.0
        while not service._inflight and time.monotonic() < deadline:
            time.sleep(0.002)
        service.start_drain()
        with pytest.raises(Overloaded) as ei:
            service.scan("img2", "", ["sha256:d"], ScanOptions())
        assert ei.value.retry_after == 2.0
    finally:
        t.join(JOIN_S)
    assert out and not errs
    assert service.await_drained(5.0) == 0
    assert service.metrics.drained_scans_total == 1
    assert service.metrics.scans_shed_total == 1


def test_concurrent_dispatch_keeps_the_bucket_floor(engines):
    """The scheduler dispatches from more than one thread: concurrent
    match_dispatch calls (a shortened switch interval, more threads
    than cores) leave DeviceDB.bucket_floor at the largest bucket any
    of them asked for, and every dispatch's words equal a lone one's."""
    import sys

    from trivy_tpu_torch.ops import match as m

    engine = engines["port"]
    ddb = engine._ddb
    sizes = [1 + 37 * i for i in range(24)]
    batches = [engine.cdb.encode_packages([q.key for q in _queries(n, i)])
               for i, n in enumerate(sizes)]
    want = [m.match_dispatch(ddb, b).collect_words() for b in batches]
    ddb.bucket_floor = 0
    got: dict = {}
    start = threading.Barrier(len(batches), timeout=JOIN_S)

    def worker(i):
        start.wait()
        got[i] = m.match_dispatch(ddb, batches[i]).collect_words()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        assert not _run_threads(worker, len(batches))
    finally:
        sys.setswitchinterval(interval)
    assert ddb.bucket_floor == max(m._bucket(n) for n in sizes)
    for i, w in enumerate(want):
        assert (got[i] == w).all()


# ------------------------------------------------- per-tenant QoS (DRR)


def _drained_sched(cls, **kw):
    """A scheduler whose thread has exited: ``_compose`` can then be
    driven synchronously against hand-built pendings, making the DRR
    interleave a deterministic unit under test."""
    s = cls(lambda: None, window_ms=0, **kw)
    with s._cond:
        s._stopping = True
        s._cond.notify_all()
    s._thread.join(5)
    assert not s._thread.is_alive()
    s._stopping = False
    return s


def _pend(cls, rows: int, seq: int, tenant: str):
    p = cls(list(range(rows)), None, seq)
    p.tenant = tenant
    return p


def _compose_all(s, pendings) -> list[tuple]:
    """Drain every pending through repeated _compose calls ->
    [(seq, lo, hi)] in emission order."""
    with s._cond:
        s._waiting = list(pendings)
    out = []
    for _ in range(10_000):
        with s._cond:
            if not s._waiting:
                return out
        parts, _rows = s._compose()
        out.extend((p.seq, lo, hi) for p, lo, hi in parts)
    raise AssertionError("compose never drained")


def _both_compose(mk, **kw) -> list[tuple]:
    """The port's and the reference's emission for the same pendings
    (`mk(pending_cls)` builds them); they must be equal."""
    out = []
    for sched_cls, pend_cls in ((MatchScheduler, _Pending),
                                (JaxScheduler, JaxPending)):
        s = _drained_sched(sched_cls, **kw)
        try:
            out.append(_compose_all(s, mk(pend_cls)))
        finally:
            s._stopping = True
    assert out[0] == out[1]
    return out[0]


def test_qos_single_tenant_zero_diff(monkeypatch):
    """With one tenant at weight 1 the DRR compose emits the exact
    chunk sequence of the request-level round-robin."""
    sizes = [200, 50, 130, 470, 64]

    def mk(cls):
        return [_pend(cls, n, i + 1, "tA") for i, n in enumerate(sizes)]

    kw = {"chunk_rows": 64, "max_rows": 256, "max_queue": 64}
    with_qos = _both_compose(mk, **kw)
    monkeypatch.setenv("TRIVY_TPU_QOS", "0")
    without_qos = _both_compose(mk, **kw)
    assert with_qos == without_qos
    assert sum(hi - lo for _seq, lo, hi in with_qos) == sum(sizes)


def test_qos_starvation_bound():
    """A greedy tenant with 3 large queued requests cannot starve a
    small interactive tenant: its two chunks land in the first four
    emissions."""
    def mk(cls):
        return ([_pend(cls, 640, i + 1, "tGreedy") for i in range(3)]
                + [_pend(cls, 128, 4, "tSmall")])

    parts = _both_compose(mk, chunk_rows=64, max_rows=1 << 20,
                          max_queue=64)
    small_last = max(i for i, (seq, _lo, _hi) in enumerate(parts)
                     if seq == 4)
    assert small_last <= 3
    greedy_before = sum(hi - lo for seq, lo, hi
                        in parts[:small_last] if seq != 4)
    assert greedy_before <= 2 * 64


def test_qos_weights_shift_share(monkeypatch):
    """TRIVY_TPU_QOS_WEIGHTS=<tenant>=2 banks two quanta per round."""
    monkeypatch.setenv("TRIVY_TPU_QOS_WEIGHTS", "tHeavy=2")

    def mk(cls):
        return [_pend(cls, 640, 1, "tHeavy"), _pend(cls, 640, 2, "tHeavy"),
                _pend(cls, 128, 3, "tLight")]

    parts = _both_compose(mk, chunk_rows=64, max_rows=1 << 20,
                          max_queue=64)
    tenants = ["H" if seq in (1, 2) else "L" for seq, _lo, _hi in parts]
    assert tenants[:6] == ["H", "H", "L", "H", "H", "L"]


def test_qos_tenant_queue_cap_sheds(monkeypatch):
    """TRIVY_TPU_QOS_TENANT_QUEUE caps one tenant's waiting requests:
    the over-cap submission sheds while other tenants keep their slots.
    The tenant is the request scope's (obs/usage.py)."""
    monkeypatch.setenv("TRIVY_TPU_QOS_TENANT_QUEUE", "2")
    # a huge window + busy_fn > 1 holds the coalesce open so the queue
    # stays populated while we probe the admission path
    s = MatchScheduler(lambda: None, window_ms=60000, max_rows=1 << 30,
                       max_queue=16, busy_fn=lambda: 2)
    greedy = usage.tenant_id("greedy-token")
    assert greedy.startswith("t-") and "greedy-token" not in greedy
    try:
        with usage.scope(greedy):
            s.submit_async([0] * 8)
            s.submit_async([0] * 8)
            with pytest.raises(Overloaded) as ei:
                s.submit_async([0] * 8)
        assert greedy in str(ei.value)
        with usage.scope(usage.tenant_id("other-token")):
            s.submit_async([0] * 8)  # other tenants are unaffected
        assert s.stats["sheds"] == 1
        assert [p.tenant for p in s._waiting] == [greedy] * 2 + [
            usage.tenant_id("other-token")]
    finally:
        with s._cond:
            for p in s._waiting:
                p.done.set()
            s._waiting.clear()
            s._stopping = True
            s._cond.notify_all()
        s._thread.join(5)
    assert not s._thread.is_alive()


# ------------------------------------------------------------ secret lane


@pytest.fixture(scope="module")
def lane_corpus():
    return secret_corpus(seed=21, n_files=24)


@pytest.fixture()
def small_pack(monkeypatch, tmp_path):
    """Screen super-buffers of eight chunks in both packages (the lane's
    rows: 16 KiB chunks), and the compiled-NFA caches in the test's own
    directory."""
    monkeypatch.setenv("TRIVY_TPU_SECRET_PACK_MB", "0.125")
    monkeypatch.setenv("TRIVY_TPU_CACHE_DIR", str(tmp_path / "nfa"))
    tsc.reset_hybrid_probe()
    jsc.reset_hybrid_probe()
    yield
    tsc.reset_hybrid_probe()
    jsc.reset_hybrid_probe()


def test_secret_lane_coalesces_concurrent_scans(lane_corpus, small_pack,
                                                monkeypatch, closer):
    """Concurrent SecretScanner.scan_files calls coalesce their anchor
    screens in the scanner's secret lane (more than one scan in one
    dispatch), with findings equal to the direct per-scan dispatch
    (TRIVY_TPU_SCHED=0) and to the reference scanner."""
    # one super-buffer holds all of a scan's chunks, so each scan makes
    # one lane submission and four of them fit one batch
    monkeypatch.setenv("TRIVY_TPU_SECRET_PACK_MB", "4")
    parts = [lane_corpus[i::4] for i in range(4)]
    monkeypatch.setenv("TRIVY_TPU_SCHED", "0")
    direct = tsc.SecretScanner(device="cpu")
    closer(direct)
    want = [norm(direct.scan_files(p, use_device=True)) for p in parts]
    assert direct._sched is None
    monkeypatch.delenv("TRIVY_TPU_SCHED")

    ref = jsc.SecretScanner()
    closer(ref)
    assert [norm(ref.scan_files(p, use_device=True))
            for p in parts] == want
    assert sum(len(w) for w in want) > 0

    lane = tsc.SecretScanner(device="cpu")
    closer(lane)
    lane.scan_files(parts[0][:1], use_device=True)  # builds the program
    sched = lane._screen_scheduler()
    assert sched is not None and sched.lane == "secret"
    assert sched.max_rows == 256
    # a wide window so the four scans meet in it
    sched.window_s = 1.0
    got: dict = {}
    start = threading.Barrier(4, timeout=JOIN_S)

    def worker(tid: int):
        start.wait()
        with lane.stats_scope() as st:
            got[tid] = norm(lane.scan_files(parts[tid], use_device=True))
        assert st["chunks"] > 0

    assert not _run_threads(worker, 4)
    assert [got[t] for t in range(4)] == want
    assert sched.stats["coalesced"] > 1
    assert sched.stats["sheds"] == 0
    lane.close()
    assert lane._sched is None and not sched._thread.is_alive()


def test_secret_lane_hybrid_and_stream_equal_direct(small_pack, monkeypatch,
                                                   closer):
    """The dispatch-first callers of the lane (the hybrid split, the
    stream path's steps) give the direct path's findings."""
    big = secret_corpus(seed=7, n_files=6, sizes=(3 * 16384, 40000))
    monkeypatch.setenv("TRIVY_TPU_SECRET_PROBE", "0")
    monkeypatch.setattr(tsc.SecretScanner, "_accel_backend",
                        lambda self: True)
    lane = tsc.SecretScanner(device="cpu")
    closer(lane)
    got_hybrid = norm(lane.scan_files(big, use_device="hybrid"))
    path, content = big[0]
    got_stream = norm([lane.scan_stream(path, content * 8,
                                        use_device=True)])
    assert lane._sched is not None and lane._sched.stats["batches"] > 0
    monkeypatch.setenv("TRIVY_TPU_SCHED", "0")
    direct = tsc.SecretScanner(device="cpu")
    closer(direct)
    assert norm(direct.scan_files(big, use_device="hybrid")) == got_hybrid
    assert norm([direct.scan_stream(path, content * 8,
                                    use_device=True)]) == got_stream
    assert direct._sched is None
