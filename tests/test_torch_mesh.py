"""Port parity, the serving mesh: trivy_tpu_torch.ops.mesh and the
engine's mesh path against the JAX package's trivy_tpu.ops.mesh and its
MatchEngine(mesh=...), on one seeded DB and the same queries.

The shapes are tests/test_mesh.py's: topology parsing and sizing, every
dp x db shape (1x1, 2x4, 4x2, 1x8, a DB smaller than the shard count),
the engine.shard fault ladder at each rung, the whole-engine device
loss, the shard-slice cache (warm, keyed by the shard count, a corrupt
entry quarantined, no entry for 1x1), the scheduler's mesh fill, the
hot reload that keeps the mesh and /readyz's shard health. The port's
cells are repeated CPU devices (the reference's are the 8 host devices
tests/conftest.py forces), so the match kernel's plain version answers
in every cell; the `cuda`-marked test runs the kernel in every cell on
a card. Hit lists, shard masks and slices compare by exact equality.
"""

from __future__ import annotations

import os
import random
import time

import numpy as np
import pytest
import torch
from test_match import _random_db, _random_queries
from test_torch_match import port_db

from trivy_tpu.db import Advisory as JaxAdvisory
from trivy_tpu.db import AdvisoryDB as JaxAdvisoryDB
from trivy_tpu.detector.engine import MatchEngine as JaxEngine
from trivy_tpu.detector.engine import PkgQuery as JaxQuery
from trivy_tpu.obs import metrics as jax_metrics
from trivy_tpu.ops import match as jm
from trivy_tpu.ops import mesh as jax_mesh
from trivy_tpu.resilience import faults as jax_faults
from trivy_tpu_torch.db import Advisory, AdvisoryDB
from trivy_tpu_torch.detector.engine import MatchEngine, PkgQuery
from trivy_tpu_torch.ops import match as tm
from trivy_tpu_torch.ops import mesh as mesh_ops
from trivy_tpu_torch.resilience import faults
from trivy_tpu_torch.tensorize import cache as compile_cache

pytestmark = pytest.mark.mesh

CPU = torch.device("cpu")
SHAPES = [(1, 1), (2, 4), (4, 2), (1, 8)]


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
    yield
    faults.reset()
    jax_faults.reset()


@pytest.fixture(scope="module")
def jdb():
    return _random_db(random.Random(42))


@pytest.fixture(scope="module")
def db(jdb):
    return port_db(jdb)


@pytest.fixture(scope="module")
def jqueries():
    return _random_queries(random.Random(13), n=500)


@pytest.fixture(scope="module")
def queries(jqueries):
    return [PkgQuery(*q.key) for q in jqueries]


@pytest.fixture(scope="module")
def oracle(jdb, jqueries):
    e = JaxEngine(jdb, window=32, use_device=False)
    return [r.adv_indices for r in e.oracle_detect(jqueries)]


def cpu_mesh(dp: int, n_db: int):
    return mesh_ops.build_mesh(dp, n_db, devices=[CPU] * (dp * n_db))


def _mesh_engine(db, dp, n_db, **kw):
    return MatchEngine(db, window=32, device="cpu", mesh=cpu_mesh(dp, n_db),
                       **kw)


def _jax_mesh_engine(jdb, dp, n_db, **kw):
    return JaxEngine(jdb, window=32, mesh=jax_mesh.build_mesh(dp, n_db),
                     **kw)


def _hits(engine, queries):
    return [r.adv_indices for r in engine.detect(queries)]


def _both(spec: str) -> None:
    """The same fault plan in both packages."""
    faults.install_spec(spec)
    jax_faults.install_spec(spec)


# ------------------------------------------------------------- topology


def test_parse_spec():
    for spec in ("", "off", "0", "none", "auto", "2x4", " 8 X 1 ",
                 "1x2x4", "1x1"):
        assert mesh_ops.parse_spec(spec) == jax_mesh.parse_spec(spec), spec
    assert mesh_ops.parse_spec("2x4") == (2, 4)
    for bad, msg in (("banana", "bad mesh spec"), ("0x4", ">= 1")):
        with pytest.raises(ValueError, match=msg):
            mesh_ops.parse_spec(bad)
        with pytest.raises(ValueError, match=msg):
            jax_mesh.parse_spec(bad)
    # the cross-host form is the distributed MeshDB (ops/dcn.py)
    assert mesh_ops.parse_spec("2x1x4") == jax_mesh.parse_spec("2x1x4") \
        == (2, 1, 4)


def test_choose_topology(monkeypatch):
    # a DB that fits one device: all devices go to the data axis
    assert mesh_ops.choose_topology(8, 10_000) == (8, 1)
    monkeypatch.setenv(mesh_ops.ENV_HBM, "0.001")  # 1 MB
    assert mesh_ops.choose_topology(8, 1_000_000) == (1, 8)
    monkeypatch.setenv(mesh_ops.ENV_HBM, "0.01")  # 10 MB ~ 277k rows
    assert mesh_ops.choose_topology(8, 500_000) == (4, 2)
    # the same sizing rule as the reference at every budget
    for gb in ("0.001", "0.01", "0.1", "8"):
        monkeypatch.setenv(mesh_ops.ENV_HBM, gb)
        for n_dev in (1, 2, 4, 6, 8):
            for rows in (1, 10_000, 500_000, 3_000_000):
                assert mesh_ops.choose_topology(n_dev, rows) == \
                    jax_mesh.choose_topology(n_dev, rows)


def test_build_mesh_too_big_rejected(monkeypatch):
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError,
                       match=f"needs 16 devices, have {have}$"):
        mesh_ops.build_mesh(4, 4)
    with pytest.raises(ValueError, match="needs 16 devices"):
        jax_mesh.build_mesh(4, 4)
    with pytest.raises(ValueError, match="needs 8 devices, have 3"):
        mesh_ops.build_mesh(2, 4, devices=[CPU] * 3)
    grid = cpu_mesh(2, 4)
    assert grid.shape == {"data": 2, "db": 4}
    assert grid.shape == dict(jax_mesh.build_mesh(2, 4).shape)


def test_engine_mesh_spec(db, jdb, queries, jqueries, oracle, monkeypatch):
    e = MatchEngine(db, window=32, device="cpu", mesh_spec="2x4")
    j = JaxEngine(jdb, window=32, mesh_spec="2x4")
    assert e.shard_health() == j.shard_health() == {
        "shape": "2x4", "data": 2, "db": 4, "degraded": []}
    assert e.mesh_data_axis == j.mesh_data_axis == 2
    assert _hits(e, queries) == _hits(j, jqueries) == oracle
    # off: the single-device path
    e1 = MatchEngine(db, window=32, device="cpu", mesh_spec="off")
    assert e1.shard_health() is None and e1.mesh_data_axis == 1
    with pytest.raises(ValueError, match="bad mesh spec"):
        MatchEngine(db, window=32, device="cpu", mesh_spec="nope")
    # without device="cpu" the cells are CUDA devices, or it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MatchEngine(db, window=32, mesh_spec="2x4")


def test_engine_mesh_spec_auto(db, jdb, queries, oracle, monkeypatch):
    # auto stays single-device on one device, as in the reference
    assert MatchEngine(db, window=32, device="cpu",
                       mesh_spec="auto").shard_health() is None
    # and reaches every device of an 8-device count
    monkeypatch.setattr(mesh_ops, "local_device_count", lambda device: 8)
    e = MatchEngine(db, window=32, device="cpu", mesh_spec="auto")
    h = e.shard_health()
    assert h is not None and h["data"] * h["db"] == 8
    assert h == JaxEngine(jdb, window=32, mesh_spec="auto").shard_health()
    assert _hits(e, queries) == oracle


# --------------------------------------------------------------- parity


def test_host_shards_equal_reference_pads_last_unsigned(db, jdb):
    """The shard slices equal the reference's; the pad rows (h1 =
    0xFFFFFFFF) stay last under the kernel's unsigned order and each
    cell's search index is built from the uint32 column."""
    cdb = MatchEngine(db, window=32, use_device=False).cdb
    jcdb = JaxEngine(jdb, window=32, use_device=False).cdb
    for n_db in (1, 3, 4, 8):
        h1s, tables, shard_len, base = tm.host_shards(cdb, n_db)
        jh1s, jtables, jlen, jbase = jm.host_shards(jcdb, n_db)
        assert (shard_len, base) == (jlen, jbase)
        np.testing.assert_array_equal(h1s, jh1s)
        np.testing.assert_array_equal(tables, jtables)
        assert h1s.dtype == np.uint32
        for d in range(n_db):
            h1 = h1s[d]
            assert np.all(h1[1:] >= h1[:-1])  # sorted as uint32
            pads = h1 == 0xFFFFFFFF
            if d == n_db - 1:
                assert pads.any()  # the last shard's halo is all pads
            assert not pads.any() or pads[np.argmax(pads):].all()
            ddb = tm.shard_device_db(h1, tables[d], cdb.window, CPU)
            np.testing.assert_array_equal(
                ddb.h1.numpy().view(np.uint32), h1)
            np.testing.assert_array_equal(
                ddb.h1_index.numpy().view(np.uint32), tm.search_index(h1))
            # read as int32 (-1) the pads would sort before every real
            # row below 2**31, not last
            if pads.any() and (h1[~pads] < 1 << 31).any():
                assert not pads[np.argsort(h1.view(np.int32),
                                           kind="stable")[-1]]


def test_host_shard_mask_equals_cell_kernel(db, jdb, queries, jqueries):
    """The degraded shard's host mask equals the cell's kernel (its
    plain version) and the reference's host mask, bit for bit."""
    e = _mesh_engine(db, 1, 4)
    j = _jax_mesh_engine(jdb, 1, 4)
    batch = e.cdb.encode_packages([q.key for q in queries])
    jbatch = j.cdb.encode_packages([q.key for q in jqueries])
    got = e._mdb.dispatch(batch).collect()
    np.testing.assert_array_equal(got, j._mdb.dispatch(jbatch).collect())
    for d in range(4):
        np.testing.assert_array_equal(e._mdb._host_mask(d, batch), got[d])
        np.testing.assert_array_equal(e._mdb._host_mask(d, batch),
                                      j._mdb._host_mask(d, jbatch))


@pytest.mark.parametrize("dp,n_db", SHAPES)
def test_mesh_zero_diff_all_shapes(db, jdb, queries, jqueries, oracle, dp,
                                   n_db):
    e = _mesh_engine(db, dp, n_db)
    j = _jax_mesh_engine(jdb, dp, n_db)
    if n_db > 1:
        # every shard is halo-padded, so pad rows sit in every shard's
        # table and must never match
        assert e._mdb.shard_len > e._mdb.shard_base
    if n_db == 8:
        # the uneven remainder: 2100 rows over 8 shards leaves the last
        # shard short
        assert e.cdb.n_rows % e._mdb.shard_base != 0
    assert (e._mdb.shard_len, e._mdb.shard_base) == \
        (j._mdb.shard_len, j._mdb.shard_base)
    assert _hits(e, queries) == _hits(j, jqueries) == oracle


def test_mesh_vs_single_device_parity(db, jdb, queries, jqueries):
    single = MatchEngine(db, window=32, device="cpu")
    meshed = _mesh_engine(db, 2, 4)
    assert _hits(meshed, queries) == _hits(single, queries) \
        == _hits(_jax_mesh_engine(jdb, 2, 4), jqueries)


def test_mesh_with_hot_and_tall_tiers():
    """A DB with all three tiers: the main tier on the mesh, the hot and
    tall tiers on the engine's device; hits equal the reference's
    mesh engine and the oracle."""
    from trivy_tpu.tensorize.synth import synth_trivy_db as jax_synth
    from trivy_tpu_torch.tensorize.synth import synth_queries, synth_trivy_db

    sdb = synth_trivy_db(n_advisories=20_000, seed=5)
    qs = synth_queries(sdb, 1_500, seed=6)
    e = MatchEngine(sdb, device="cpu", mesh=cpu_mesh(2, 2))
    assert e._ddb is None and e._ddb_hot is not None \
        and e._ddb_tall is not None
    routes = e.cdb.encode_packages([q.key for q in qs]).route
    assert {0, 1, 2} <= set(routes.tolist())
    j = JaxEngine(jax_synth(n_advisories=20_000, seed=5),
                  mesh=jax_mesh.build_mesh(2, 2))
    want = [r.adv_indices for r in e.oracle_detect(qs)]
    assert _hits(e, qs) == want
    assert _hits(j, [JaxQuery(*q.key) for q in qs]) == want


def test_db_smaller_than_shard_count():
    advs = [("npm::ghsa", "left-pad", "CVE-1", ["<2.0.0"]),
            ("npm::ghsa", "lodash", "CVE-2", [">=1.0.0, <3.0.0"]),
            ("pip::ghsa", "requests", "CVE-3", ["<1.5.0"])]
    tiny, jtiny = AdvisoryDB(), JaxAdvisoryDB()
    for bucket, name, vid, vv in advs:
        tiny.put_advisory(bucket, name, Advisory(
            vulnerability_id=vid, vulnerable_versions=vv))
        jtiny.put_advisory(bucket, name, JaxAdvisory(
            vulnerability_id=vid, vulnerable_versions=vv))
    e = _mesh_engine(tiny, 1, 8)  # more shards than advisory rows
    keys = [("npm::", "left-pad", "1.0.0", "npm"),
            ("npm::", "lodash", "2.5.0", "npm"),
            ("pip::", "requests", "1.0", "pep440"),
            ("pip::", "requests", "9.9", "pep440"),
            ("go::", "not-in-db", "1.0.0", "generic")]
    got = _hits(e, [PkgQuery(*k) for k in keys])
    want = [r.adv_indices
            for r in e.oracle_detect([PkgQuery(*k) for k in keys])]
    assert got == want == _hits(_jax_mesh_engine(jtiny, 1, 8),
                                [JaxQuery(*k) for k in keys])
    assert got[0] and got[1] and got[2]  # real matches happened
    assert got[3] == [] and got[4] == []  # padding shards match nothing


def test_detect_many_and_submit_on_mesh(db, queries, oracle):
    e = _mesh_engine(db, 2, 4)
    crawl = e.detect_many(queries, batch_size=128, depth=2)
    assert [r.adv_indices for r in crawl] == oracle
    lists = [queries[:200], queries[200:201], queries[201:]]
    flat = [r.adv_indices for rs in e.submit(lists) for r in rs]
    assert flat == oracle


# ------------------------------------------------------ fault isolation


@pytest.mark.fault
def test_shard_error_retried_then_healthy(db, jdb, queries, jqueries,
                                          oracle):
    _both("engine.shard:error@1")
    before = jax_metrics.MESH_SHARD_RETRIES.value(shard="0")
    e = _mesh_engine(db, 2, 4)
    j = _jax_mesh_engine(jdb, 2, 4)
    assert _hits(e, queries) == _hits(j, jqueries) == oracle
    assert e.shard_health()["degraded"] == [] == \
        j.shard_health()["degraded"]  # the retry succeeded
    assert e._mdb.shard_retry_count == {0: 1}
    assert jax_metrics.MESH_SHARD_RETRIES.value(shard="0") == before + 1


@pytest.mark.fault
def test_shard_error_exhausts_retries_degrades(db, jdb, queries, jqueries,
                                               oracle, monkeypatch):
    # shard 0's first collect and its retry fail: that shard degrades
    # to the host mask, the other shards stay on their devices
    _both("engine.shard:error@1-2")
    e = _mesh_engine(db, 1, 4)
    j = _jax_mesh_engine(jdb, 1, 4)
    assert _hits(e, queries) == _hits(j, jqueries) == oracle
    assert e.shard_health()["degraded"] == [0] == \
        j.shard_health()["degraded"]
    assert e._mdb.degradations == {0: 1}
    faults.reset()
    # a later batch on the degraded engine: the same hits, shard 0 on
    # the host, the other cells still launched
    launched = []
    orig = tm.match_dispatch
    monkeypatch.setattr(tm, "match_dispatch",
                        lambda ddb, b: launched.append(ddb) or orig(ddb, b))
    assert _hits(e, queries) == oracle
    ids = {id(ddb) for ddb in launched}
    assert id(e._mdb.grid[0][0]) not in ids
    assert all(id(e._mdb.grid[0][d]) in ids for d in (1, 2, 3))
    assert e.shard_health()["degraded"] == [0]


@pytest.mark.fault
def test_shard_device_lost_degrades_immediately(db, jdb, queries, jqueries,
                                                oracle):
    _both("engine.shard:device-lost@1")
    before = jax_metrics.MESH_SHARD_DEGRADATIONS.value(shard="0")
    e = _mesh_engine(db, 2, 4)
    j = _jax_mesh_engine(jdb, 2, 4)
    assert _hits(e, queries) == _hits(j, jqueries) == oracle
    assert e.shard_health()["degraded"] == [0] == \
        j.shard_health()["degraded"]  # only the lost shard left
    assert e._mdb.degradations == {0: 1}
    assert e._mdb.shard_retry_count == {}  # no retry before degrading
    assert jax_metrics.MESH_SHARD_DEGRADATIONS.value(shard="0") \
        == before + 1
    # reresolve uploads the slice again; the shard serves on its device
    assert e.reresolve_mesh() is True and j.reresolve_mesh() is True
    assert e.shard_health()["degraded"] == [] == \
        j.shard_health()["degraded"]
    assert e._mdb.reresolves == 1
    assert _hits(e, queries) == oracle
    assert e.reresolve_mesh() is False  # a healthy mesh: a no-op


@pytest.mark.fault
def test_shard_drop_redispatches(db, jdb, queries, jqueries, oracle):
    _both("engine.shard:drop@2;engine.shard:delay=0.001@3")
    e = _mesh_engine(db, 2, 4)
    j = _jax_mesh_engine(jdb, 2, 4)
    assert _hits(e, queries) == _hits(j, jqueries) == oracle
    assert e.shard_health()["degraded"] == []
    assert [r.fired for r in faults.active().rules] == \
        [r.fired for r in jax_faults.active().rules] == [1, 1]


@pytest.mark.fault
@pytest.mark.parametrize("retries,degraded,retried", [
    (0, [0, 1], {}),  # no retry: shards 0 and 1 each take one error
    (2, [], {0: 2}),  # shard 0's two errors are both retried
])
def test_shard_retries_knob(db, jdb, queries, jqueries, oracle,
                            monkeypatch, retries, degraded, retried):
    """TRIVY_TPU_MESH_SHARD_RETRIES sets how many times a failing cell
    is dispatched again before its shard degrades, as in the
    reference."""
    monkeypatch.setenv(mesh_ops.ENV_RETRIES, str(retries))
    _both("engine.shard:error@1-2")
    e = _mesh_engine(db, 1, 4)
    j = _jax_mesh_engine(jdb, 1, 4)
    assert e._mdb.retries == j._mdb.retries == retries
    assert _hits(e, queries) == _hits(j, jqueries) == oracle
    assert e.shard_health()["degraded"] == degraded == \
        j.shard_health()["degraded"]
    assert e._mdb.shard_retry_count == retried


@pytest.mark.fault
def test_reresolve_upload_error_raises(db, queries, oracle, monkeypatch):
    """A slice that fails to upload again (a CUDA error is a
    RuntimeError) raises out of reresolve_mesh, from the engine and
    from the server; the shard stays degraded and serves on."""
    from trivy_tpu_torch.cache.cache import MemoryCache
    from trivy_tpu_torch.rpc.server import ScanService

    faults.install_spec("engine.shard:device-lost@1")
    e = _mesh_engine(db, 2, 4)
    assert _hits(e, queries) == oracle
    faults.reset()
    assert e.shard_health()["degraded"] == [0]

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(tm, "shard_device_db", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        e.reresolve_mesh()
    assert e.shard_health()["degraded"] == [0]
    assert e._mdb.reresolves == 0
    svc = ScanService(e, MemoryCache())
    try:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            svc.reresolve_mesh()
        # the write lock was released: the service still answers
        assert "shard(s) 0 degraded to host" in svc.ready()[1]
        assert _hits(e, queries) == oracle
        monkeypatch.undo()
        assert svc.reresolve_mesh() == {"reresolved": True,
                                        "mesh": e.shard_health()}
        assert e.shard_health()["degraded"] == []
    finally:
        svc.close()


@pytest.mark.fault
def test_whole_device_lost_still_degrades_engine(db, jdb, queries,
                                                 jqueries, oracle):
    # site "engine" device-lost flips the whole engine to the host
    # oracle, mesh or not
    _both("engine:device-lost@1")
    e = _mesh_engine(db, 2, 4)
    j = _jax_mesh_engine(jdb, 2, 4)
    assert _hits(e, queries) == _hits(j, jqueries) == oracle
    assert e.device_lost and not e.use_device
    assert j.device_lost and not j.use_device
    assert e.degraded == 1


# ------------------------------------------------------ mesh-aware cache


def _saved_db_dir(db, tmp_path):
    root = str(tmp_path / "db")
    db.save(root, compress=False)
    return root


def test_shard_cache_warm_start(db, queries, oracle, tmp_path):
    root = _saved_db_dir(db, tmp_path)
    e1 = _mesh_engine(db, 2, 4, db_path=root)
    assert e1.build_stats["mesh_shard_cache"] == "miss"
    assert _hits(e1, queries) == oracle
    digest = compile_cache.db_digest(root)
    shard_path = compile_cache.shard_entry_path(root, digest, 32, 4)
    assert os.path.exists(shard_path)
    assert shard_path.endswith(".mesh4.npz")
    assert os.path.dirname(shard_path).endswith("compiled-torch")
    # the base entry's key has no mesh part
    assert os.path.exists(compile_cache.entry_path(root, digest, 32))
    hits0 = compile_cache.COUNTS["hits"]
    e2 = _mesh_engine(db, 2, 4, db_path=root)
    # warm: the base tensors and the shard slices load from the cache
    assert compile_cache.COUNTS["hits"] >= hits0 + 2
    assert e2.build_stats["mesh_shard_cache"] == "hit"
    assert _hits(e2, queries) == oracle


def test_shard_cache_keyed_by_shard_count(db, queries, oracle, tmp_path):
    root = _saved_db_dir(db, tmp_path)
    _mesh_engine(db, 1, 4, db_path=root)
    misses0 = compile_cache.COUNTS["misses"]
    e = _mesh_engine(db, 1, 8, db_path=root)  # another db axis
    assert compile_cache.COUNTS["misses"] > misses0
    assert e.build_stats["mesh_shard_cache"] == "miss"
    assert _hits(e, queries) == oracle


def test_shard_cache_corrupt_entry_quarantined(db, queries, oracle,
                                               tmp_path):
    root = _saved_db_dir(db, tmp_path)
    _mesh_engine(db, 2, 4, db_path=root)
    digest = compile_cache.db_digest(root)
    path = compile_cache.shard_entry_path(root, digest, 32, 4)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x01  # silent bit rot
    with open(path, "wb") as f:
        f.write(bytes(raw))
    e = _mesh_engine(db, 2, 4, db_path=root)  # slices again, zero diff
    assert e.build_stats["mesh_shard_cache"] == "miss"
    assert _hits(e, queries) == oracle
    assert os.path.exists(path + compile_cache.QUARANTINE_SUFFIX)


def test_one_by_one_mesh_creates_no_mesh_entries(db, tmp_path):
    root = _saved_db_dir(db, tmp_path)
    e = _mesh_engine(db, 1, 1, db_path=root)
    assert e.build_stats["mesh_shard_cache"] == "off"
    names = os.listdir(compile_cache.cache_root(root))
    assert names and not [n for n in names if ".mesh" in n]


# ------------------------------------------- scheduler + server surface


def _manual_sched(engine, **kw):
    from trivy_tpu_torch.sched.scheduler import MatchScheduler

    class _ManualSched(MatchScheduler):
        def _run(self):
            while not self._stopping:
                time.sleep(0.02)

    return _ManualSched(lambda: engine, window_ms=30.0, max_rows=64,
                        chunk_rows=16, **kw)


def test_sched_mesh_fill_tops_up_to_data_axis(db, jdb):
    engine = MatchEngine(db, window=32, use_device=False)
    jqs = _random_queries(random.Random(3), n=700)
    qs = [PkgQuery(*q.key) for q in jqs]
    sched = _manual_sched(engine, data_axis_fn=lambda: 4)
    try:
        p1 = sched._enqueue(qs[:350])
        p2 = sched._enqueue(qs[350:])
        parts, rows = sched._compose()
        # the interleave cut 64 rows; the mesh fill tops the batch up to
        # a multiple of 128 * dp so every data group carries queries
        assert rows == 512 and rows % (128 * 4) == 0
        assert sum(hi - lo for _p, lo, hi in parts) == rows
        sched._dispatch(parts, rows)
        while not (p1.done.is_set() and p2.done.is_set()):
            parts, rows = sched._compose()
            sched._dispatch(parts, rows)
        got = [r.adv_indices for r in p1.results + p2.results]
        assert got == [r.adv_indices for r in
                       JaxEngine(jdb, window=32,
                                 use_device=False).detect(jqs)]
    finally:
        sched.close()


def test_sched_mesh_fill_honors_bucket_floor(db):
    engine = MatchEngine(db, window=32, use_device=False)
    qs = [PkgQuery(*q.key) for q in _random_queries(random.Random(7),
                                                     n=700)]
    # a big crawl ratcheted every cell's bucket to 256: the fill targets
    # 2 * 256
    sched = _manual_sched(engine, data_axis_fn=lambda: 2,
                          row_floor_fn=lambda: 256)
    try:
        sched._enqueue(qs)
        _parts, rows = sched._compose()
        assert rows == 512
    finally:
        sched.close()


def test_sched_mesh_fill_noop_single_device(db):
    engine = MatchEngine(db, window=32, use_device=False)
    qs = [PkgQuery(*q.key) for q in _random_queries(random.Random(5),
                                                     n=300)]
    sched = _manual_sched(engine, data_axis_fn=lambda: 1)
    try:
        sched._enqueue(qs)
        _parts, rows = sched._compose()
        assert rows == 64  # dp = 1: the plain cut, no top-up
    finally:
        sched.close()


def test_db_hot_reload_keeps_mesh(db, queries, oracle, tmp_path):
    from trivy_tpu_torch.cache.cache import MemoryCache
    from trivy_tpu_torch.db import generations
    from trivy_tpu_torch.rpc.server import ScanService

    root = str(tmp_path / "db")

    def promote(name: str, updated: str) -> None:
        gen = os.path.join(generations.generations_root(root), name)
        os.makedirs(gen)
        db.meta.updated_at = updated
        db.save(gen)
        generations.promote(root, gen)

    promote("sha256-aaa", "2024-01-01T00:00:00Z")
    e = MatchEngine(AdvisoryDB.load(root), window=32, device="cpu",
                    mesh_spec="2x4", db_path=root)
    grid = cpu_mesh(2, 2)
    e2 = MatchEngine(AdvisoryDB.load(root), window=32, device="cpu",
                     mesh=grid)
    svc = ScanService(e, MemoryCache(), db_path=root)
    svc2 = ScanService(e2, MemoryCache(), db_path=root)
    try:
        # a new generation lands: the swap keeps serving the 2x4 mesh
        # (spec-built: resolved again) and the 2x2 grid (carried over)
        promote("sha256-bbb", "2024-02-02T00:00:00Z")
        assert svc.maybe_reload_db() is True
        assert svc2.maybe_reload_db() is True
        assert svc.engine is not e and svc2.engine is not e2
        assert svc.engine.shard_health()["shape"] == "2x4"
        assert svc2.engine.shard_health()["shape"] == "2x2"
        assert svc2.engine.mesh is grid
        assert svc.engine.build_stats["mesh_shard_cache"] == "miss"
        for s in (svc, svc2):
            assert [r.adv_indices
                    for r in s.engine.detect(queries)] == oracle
    finally:
        svc.close()
        svc2.close()


def test_readyz_reports_shard_health(db, queries, oracle):
    from trivy_tpu_torch.cache.cache import MemoryCache
    from trivy_tpu_torch.rpc.server import ScanService

    e = _mesh_engine(db, 2, 4)
    svc = ScanService(e, MemoryCache())
    try:
        ok, why = svc.ready()
        assert ok and "mesh 2x4" in why and "degraded" not in why
        assert svc.ready_doc()["mesh"] == {"shape": "2x4", "degraded": []}
        # the scheduler composes against the engine's data axis
        if svc.scheduler is not None:
            assert svc.scheduler._data_axis_fn() == 2
        faults.install_spec("engine.shard:device-lost@1")
        assert _hits(e, queries) == oracle
        faults.reset()
        ok, why = svc.ready()
        assert ok, why  # a degraded shard serves on, like last-good
        assert "shard(s) 0 degraded to host" in why
        assert svc.ready_doc()["mesh"]["degraded"] == [0]
        out = svc.reresolve_mesh()
        assert out == {"reresolved": True, "mesh": e.shard_health()}
        assert "degraded" not in svc.ready()[1]
        assert _hits(e, queries) == oracle
    finally:
        svc.close()
    single = ScanService(MatchEngine(db, window=32, device="cpu"),
                         MemoryCache())
    try:
        assert "mesh" not in single.ready()[1]
        assert "mesh" not in single.ready_doc()
        assert single.reresolve_mesh() == {"reresolved": False,
                                           "mesh": None}
    finally:
        single.close()


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_cuda_mesh_cells_launch_the_kernel(db, queries, oracle):
    """On a card: a 2x4 mesh with every cell on cuda:0 launches the match
    kernel once per cell, and its hits equal the single-device engine's
    and the oracle, healthy and at each engine.shard rung."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    grid = mesh_ops.build_mesh(2, 4, devices=[dev] * 8)
    single = MatchEngine(db, window=32, device=dev)
    assert _hits(single, queries) == oracle
    for spec in ("", "engine.shard:error@1", "engine.shard:error@1-2",
                 "engine.shard:device-lost@1", "engine.shard:drop@1"):
        faults.install_spec(spec) if spec else faults.reset()
        e = MatchEngine(db, window=32, device=dev, mesh=grid)
        for row in e._mdb.grid:
            for ddb in row:
                ddb.launches = 0
        assert _hits(e, queries) == oracle, spec
        launches = [ddb.launches for row in e._mdb.grid for ddb in row]
        degraded = e.shard_health()["degraded"]
        assert all(n >= 1 for i, n in enumerate(launches)
                   if i % 4 not in degraded), (spec, launches)


# ------------------------------------------------------------------- CLI


@pytest.fixture()
def cli_env(db, tmp_path, monkeypatch):
    import test_sbom_e2e

    from trivy_tpu_torch.cli import run

    root = str(tmp_path / "db")
    db.save(root)
    bom = tmp_path / "bom.json"
    bom.write_text(__import__("json").dumps(test_sbom_e2e.CDX_DOC))
    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", "2024-01-01T00:00:00+00:00")
    run._ENGINE_CACHE.clear()
    yield {"db": root, "bom": str(bom), "cache": str(tmp_path / "c")}
    run._ENGINE_CACHE.clear()


def _cli(argv, capsys):
    from trivy_tpu_torch.cli.main import main

    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, [ln for ln in out.err.splitlines() if "ERROR" in ln]


def test_cli_mesh_report_equals_single_device(cli_env, capsys, monkeypatch):
    """`sbom --mesh 2x4 --device cpu` (and TRIVY_TPU_MESH) writes the
    report of the run without a mesh, and the reference's."""
    from trivy_tpu.cli.main import main as jax_main

    base = ["sbom", cli_env["bom"], "--format", "json", "--db-path",
            cli_env["db"], "--cache-dir", cli_env["cache"], "--quiet"]
    plain = _cli(base + ["--device", "cpu"], capsys)
    meshed = _cli(base + ["--device", "cpu", "--mesh", "2x4"], capsys)
    monkeypatch.setenv("TRIVY_TPU_MESH", "1x2")
    env = _cli(base + ["--device", "cpu"], capsys)
    monkeypatch.delenv("TRIVY_TPU_MESH")
    assert plain[0] == meshed[0] == env[0] == 0
    assert meshed[1] == plain[1] == env[1]
    assert jax_main(base + ["--mesh", "2x4"]) == 0
    assert capsys.readouterr().out == plain[1]
    from trivy_tpu_torch.cli import run

    shapes = sorted(e.shard_health()["shape"]
                    for e in run._ENGINE_CACHE.values()
                    if e.shard_health() is not None)
    assert shapes == ["1x2", "2x4"]


@pytest.mark.parametrize("spec,message", [
    ("2x4", "--mesh/TRIVY_TPU_MESH: mesh 2x4 needs 8 devices, have 1"),
    ("banana", "--mesh/TRIVY_TPU_MESH: bad mesh spec 'banana'"),
    ("2x1x4", "--mesh/TRIVY_TPU_MESH: mesh spec '2x1x4' spans 2 hosts "
              "but TRIVY_TPU_DCN is unset")])
def test_cli_mesh_errors_are_one_line(cli_env, capsys, monkeypatch, spec,
                                      message):
    """On one card a 2x4 mesh fails as the reference fails on one chip:
    rc 1 and one error line; so do a malformed spec and a cross-host
    spec without TRIVY_TPU_DCN workers, for a scan and for the
    server."""
    import jax

    monkeypatch.delenv("TRIVY_TPU_DCN", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    # the reference's wording on one device
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)
    with pytest.raises(ValueError) as ref:
        jax_mesh.build_mesh(2, 4)
    assert str(ref.value) == "mesh 2x4 needs 8 devices, have 1"
    rc, out, errors = _cli(["sbom", cli_env["bom"], "--db-path",
                            cli_env["db"], "--cache-dir", cli_env["cache"],
                            "--mesh", spec], capsys)
    assert rc == 1 and out == ""
    assert len(errors) == 1 and message in errors[0], errors
    monkeypatch.setenv("TRIVY_TPU_MESH", spec)
    rc, out, errors = _cli(["server", "--db-path", cli_env["db"],
                            "--cache-dir", cli_env["cache"], "--listen",
                            "127.0.0.1:0"], capsys)
    assert rc == 1 and len(errors) == 1 and message in errors[0], errors
