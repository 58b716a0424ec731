"""Port parity, advisory-DB persistence and the compiled-DB cache:
trivy_tpu_torch's AdvisoryDB.save / load against the JAX package's (a
DB saved by either loads in the other), and the port's compiled-DB cache
(tensorize/cache.py) through MatchEngine(db_path=...), in the shapes of
tests/test_pipeline_cache.py's cache tests. The two packages keep their
compiled entries apart.

Advisories, payloads and match sets are compared exactly.
"""

import gzip
import os
import random

import numpy as np
import pytest
import torch
from test_pipeline_cache import _many_queries, _rich_db

from trivy_tpu.db import AdvisoryDB as JaxDB
from trivy_tpu.db.model import Advisory as JaxAdvisory
from trivy_tpu.db.model import VulnerabilityMeta as JaxMeta
from trivy_tpu.detector.engine import MatchEngine as JaxEngine
from trivy_tpu.obs import metrics as obs_metrics
from trivy_tpu.tensorize import cache as jax_cache
from trivy_tpu_torch.db import Advisory, AdvisoryDB, VulnerabilityMeta
from trivy_tpu_torch.db.model import DataSourceInfo
from trivy_tpu_torch.db.store import validate_db
from trivy_tpu_torch.detector.engine import MatchEngine, PkgQuery
from trivy_tpu_torch.durability import atomic
from trivy_tpu_torch.tensorize import cache as ccache

DB_FILE = "trivy_tpu.db.json.gz"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and idle OpenMP workers spin on cores their neighbours' timing
    tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hits(results) -> list[list[int]]:
    return [r.adv_indices for r in results]


def queries(seed: int, n: int) -> list[PkgQuery]:
    return [PkgQuery(*q.key) for q in _many_queries(seed=seed)[:n]]


def port_rich_db() -> AdvisoryDB:
    """tests/test_pipeline_cache.py's _rich_db in the port's types, plus
    vulnerability metadata and Red Hat CPE entries (expanded on load)."""
    jdb = _rich_db()
    db = AdvisoryDB()
    for bucket, pkgs in jdb.buckets.items():
        for name, advs in pkgs.items():
            for a in advs:
                db.put_advisory(bucket, name, Advisory.from_json(a.to_json()))
    db.meta.updated_at = jdb.meta.updated_at
    db.put_meta(VulnerabilityMeta(
        id="CVE-25-0010", title="t", severity="HIGH",
        vendor_severity={"nvd": 3}, cwe_ids=["CWE-79"],
        references=["https://example.com/a"]))
    db.put_advisory("debian 12", "openssl", Advisory(
        vulnerability_id="CVE-24-9999", fixed_version="3.0.11-1~deb12u2",
        data_source=DataSourceInfo(id="debian", name="Debian Security "
                                   "Tracker", url="https://deb.debian.org"),
        severity=3))
    db.redhat_cpe = {"repository": {"rhel-8-for-x86_64-baseos-rpms": [0]},
                     "nvr": {}, "cpe": {"0": "cpe:/o:redhat:enterprise_"
                                             "linux:8::baseos"}}
    db.put_redhat_entry("bash", "RHSA-2024:0001", [{
        "Affected": [0], "FixedVersion": "0:4.4.20-5.el8",
        "Status": 3, "Arches": ["x86_64"],
        "Cves": [{"ID": "CVE-24-0042", "Severity": 2}]}])
    return db


def payload(root: str) -> bytes:
    with open(os.path.join(root, DB_FILE), "rb") as f:
        return gzip.decompress(f.read())


def advisories_json(db) -> dict:
    return {bucket: {name: [a.to_json() for a in advs]
                     for name, advs in sorted(pkgs.items())}
            for bucket, pkgs in sorted(db.buckets.items())}


def jax_copy(db: AdvisoryDB) -> JaxDB:
    """The same DB built in the JAX package's types."""
    jdb = JaxDB()
    for bucket, pkgs in db.buckets.items():
        for name, advs in pkgs.items():
            for a in advs:
                jdb.put_advisory(bucket, name,
                                 JaxAdvisory.from_json(a.to_json()))
    for vid, m in db.metadata_bucket.items():
        jdb.put_meta(JaxMeta.from_json(vid, m.to_json()))
    jdb.redhat_entries = db.redhat_entries
    jdb.redhat_cpe = db.redhat_cpe
    jdb.meta.updated_at = db.meta.updated_at
    return jdb


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_db_saved_by_one_package_loads_in_the_other(tmp_path, writer):
    db = port_rich_db()
    root = str(tmp_path / "db")
    (db if writer == "port" else jax_copy(db)).save(root)
    # both packages write the same payload for the same DB (gzip stamps
    # an mtime, so the decompressed payloads are compared)
    other = str(tmp_path / "other")
    (jax_copy(db) if writer == "port" else db).save(other)
    assert payload(root) == payload(other)

    port, jax = AdvisoryDB.load(root), JaxDB.load(root)
    assert port.stats() == jax.stats()
    # the Red Hat entries expand into a "redhat 8" bucket on load
    assert port.stats()["buckets"] == len(db.buckets) + 1
    assert "redhat 8" in port.buckets
    assert advisories_json(port) == advisories_json(jax)
    assert {k: m.to_json() for k, m in port.metadata_bucket.items()} == \
        {k: m.to_json() for k, m in jax.metadata_bucket.items()}
    assert port.meta.to_json() == jax.meta.to_json()
    assert validate_db(port) is None

    # each package's save of what it loaded: the same payload again
    port.save(str(tmp_path / "p"))
    jax.save(str(tmp_path / "j"))
    assert payload(str(tmp_path / "p")) == payload(str(tmp_path / "j"))


def test_db_load_missing_empty_and_boltdb(tmp_path):
    with pytest.raises(FileNotFoundError):
        AdvisoryDB.load(str(tmp_path / "nothing"))
    (tmp_path / "bolt").mkdir()
    (tmp_path / "bolt" / "trivy.db").write_bytes(b"\0" * 16)
    # a BoltDB trivy.db directory is read now: one that is not a BoltDB
    # file raises the reader's error, as in the reference
    from trivy_tpu.db.bolt import BoltError as JaxBoltError
    from trivy_tpu_torch.db.bolt import BoltError

    with pytest.raises(BoltError, match="not a boltdb file"):
        AdvisoryDB.load(str(tmp_path / "bolt"))
    with pytest.raises(JaxBoltError, match="not a boltdb file"):
        JaxDB.load(str(tmp_path / "bolt"))
    assert validate_db(AdvisoryDB()) == "candidate DB is empty"
    db = port_rich_db()
    db.meta.version = 3
    assert "unsupported schema" in validate_db(db)


def test_db_load_reads_through_last_good(tmp_path):
    """A generation-managed root loads its last-good generation."""
    root = tmp_path / "db"
    gen = root / "generations" / "sha256-abc"
    port_rich_db().save(str(gen))
    os.symlink(os.path.join("generations", "sha256-abc"),
               root / "last-good")
    assert AdvisoryDB.load(str(root)).stats() == \
        AdvisoryDB.load(str(gen)).stats()
    assert ccache.db_digest(str(root)) == "sha256-abc"


# --------------------------------------------------- compiled-DB cache


def saved_db(tmp_path) -> str:
    root = str(tmp_path / "db")
    port_rich_db().save(root)
    return root


def test_compile_cache_hit_and_zero_diff(tmp_path):
    root = saved_db(tmp_path)
    misses0, hits0 = ccache.COUNTS["misses"], ccache.COUNTS["hits"]

    e1 = MatchEngine(AdvisoryDB.load(root), window=16, device="cpu",
                     db_path=root)
    assert ccache.COUNTS["misses"] == misses0 + 1
    assert e1.build_stats["compile_cache"] == "miss"
    entry = ccache.entry_path(root, ccache.db_digest(root), 16)
    assert os.path.exists(entry)
    assert os.path.dirname(entry) == os.path.join(root, "compiled-torch")

    e2 = MatchEngine(AdvisoryDB.load(root), window=16, device="cpu",
                     db_path=root)
    assert ccache.COUNTS["hits"] == hits0 + 1
    assert e2.cdb.stats.get("compile_cache") == "hit"
    assert e2.build_stats["compile_cache"] == "hit"

    qs = queries(23, 600)
    want = hits(e1.oracle_detect(qs))
    assert hits(e1.detect(qs)) == want
    assert hits(e2.detect(qs)) == want
    assert hits(e2.detect_many(qs, batch_size=256)) == want
    for f in ("row_h1", "row_lo", "row_hi", "row_adv", "hot_h1", "tall_h1"):
        a, b = getattr(e1.cdb, f), getattr(e2.cdb, f)
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)
    assert e1.cdb.window == e2.cdb.window
    assert e1.cdb.host_fallback == e2.cdb.host_fallback


def test_compile_cache_params_and_digest_key(tmp_path):
    root = saved_db(tmp_path)
    db = AdvisoryDB.load(root)
    MatchEngine(db, window=16, device="cpu", db_path=root)
    hits0 = ccache.COUNTS["hits"]
    # a different window is a different entry: no cross-param hit
    MatchEngine(db, window=32, device="cpu", db_path=root)
    assert ccache.COUNTS["hits"] == hits0
    # changing the DB bytes changes the digest: the old entry is not
    # served for the new DB
    db.put_advisory("npm::ghsa", "npm-pkg-0", Advisory(
        vulnerability_id="CVE-25-NEW", vulnerable_versions=["<9.9.9"]))
    db.save(root)
    e3 = MatchEngine(AdvisoryDB.load(root), window=16, device="cpu",
                     db_path=root)
    assert ccache.COUNTS["hits"] == hits0
    q = PkgQuery("npm::", "npm-pkg-0", "1.0.0", "npm")
    assert hits(e3.detect([q])) == hits(e3.oracle_detect([q]))
    assert any(e3.cdb.advisories[i][2].vulnerability_id == "CVE-25-NEW"
               for i in e3.detect([q])[0].adv_indices)


def test_compile_cache_corrupt_entry_quarantined(tmp_path):
    root = saved_db(tmp_path)
    MatchEngine(AdvisoryDB.load(root), window=16, device="cpu",
                db_path=root)
    entry = ccache.entry_path(root, ccache.db_digest(root), 16)
    with open(entry, "rb") as f:
        raw = f.read()
    # bitflip in the tensor payload: the sha256 frame must catch it
    mid = len(raw) // 2
    with open(entry, "wb") as f:
        f.write(raw[:mid] + bytes([raw[mid] ^ 0x01]) + raw[mid + 1:])

    e2 = MatchEngine(AdvisoryDB.load(root), window=16, device="cpu",
                     db_path=root)
    assert e2.build_stats["compile_cache"] == "miss"
    names = os.listdir(os.path.dirname(entry))
    assert any(ccache.QUARANTINE_SUFFIX in n for n in names), names
    # the corrupt bytes were replaced by a clean recompile + re-save
    assert os.path.exists(entry)
    qs = queries(29, 400)
    assert hits(e2.detect(qs)) == hits(e2.oracle_detect(qs))

    # truncation (torn tail) is caught the same way
    with open(entry, "rb") as f:
        raw = f.read()
    with open(entry, "wb") as f:
        f.write(raw[: len(raw) // 3])
    e3 = MatchEngine(AdvisoryDB.load(root), window=16, device="cpu",
                     db_path=root)
    assert e3.build_stats["compile_cache"] == "miss"
    assert hits(e3.detect(qs)) == hits(e3.oracle_detect(qs))


def test_compile_cache_torn_write_self_heals(tmp_path, monkeypatch):
    """A torn cache WRITE (the entry's bytes cut short on their way to
    disk) must never poison later runs: the reader rejects the entry
    and recompiles."""
    root = saved_db(tmp_path)
    real_write = atomic.atomic_write

    def torn(path, data, fault_site=""):
        if fault_site == "compile_cache.save":
            data = data[: len(data) // 2]
        real_write(path, data, fault_site=fault_site)

    monkeypatch.setattr(atomic, "atomic_write", torn)
    MatchEngine(AdvisoryDB.load(root), window=16, device="cpu",
                db_path=root)
    monkeypatch.setattr(atomic, "atomic_write", real_write)
    e2 = MatchEngine(AdvisoryDB.load(root), window=16, device="cpu",
                     db_path=root)
    assert e2.build_stats["compile_cache"] == "miss"
    qs = queries(31, 400)
    assert hits(e2.detect(qs)) == hits(e2.oracle_detect(qs))
    e3 = MatchEngine(AdvisoryDB.load(root), window=16, device="cpu",
                     db_path=root)
    assert e3.build_stats["compile_cache"] == "hit"


def test_compile_cache_disabled_by_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_COMPILE_CACHE", "0")
    root = saved_db(tmp_path)
    e = MatchEngine(AdvisoryDB.load(root), window=16, device="cpu",
                    db_path=root)
    assert e.build_stats["compile_cache"] == "off"
    assert not os.path.exists(ccache.cache_root(root))


def test_compile_cache_auto_window_entry(tmp_path):
    """window=None (auto) entries round-trip the RESOLVED window and
    hot/tall partitions."""
    root = saved_db(tmp_path)
    e1 = MatchEngine(AdvisoryDB.load(root), device="cpu", db_path=root)
    e2 = MatchEngine(AdvisoryDB.load(root), device="cpu", db_path=root)
    assert e2.cdb.stats.get("compile_cache") == "hit"
    assert e1.cdb.window == e2.cdb.window
    assert e1.cdb.hot_window == e2.cdb.hot_window
    assert e1.cdb.tall_window == e2.cdb.tall_window
    qs = queries(37, 600)
    assert hits(e2.detect(qs)) == hits(e1.detect(qs))


def test_packages_never_load_each_others_entries(tmp_path):
    """Under one DB root the JAX package's entries (compiled/) and the
    port's (compiled-torch/) stay apart: each package misses on the
    other's entry, compiles its own, and leaves the other's bytes as
    they were."""
    root = saved_db(tmp_path)
    jax_entry = jax_cache.entry_path(root, jax_cache.db_digest(root), 16)
    port_entry = ccache.entry_path(root, ccache.db_digest(root), 16)
    assert jax_cache.db_digest(root) == ccache.db_digest(root)
    assert os.path.dirname(jax_entry) != os.path.dirname(port_entry)

    JaxEngine(JaxDB.load(root), window=16, db_path=root)
    with open(jax_entry, "rb") as f:
        jax_bytes = f.read()
    misses0 = ccache.COUNTS["misses"]
    e = MatchEngine(AdvisoryDB.load(root), window=16, device="cpu",
                    db_path=root)
    assert ccache.COUNTS["misses"] == misses0 + 1
    assert e.build_stats["compile_cache"] == "miss"
    assert os.path.exists(port_entry)
    with open(jax_entry, "rb") as f:
        assert f.read() == jax_bytes

    # the other way round: with only the port's entry present, the JAX
    # package misses
    os.unlink(jax_entry)
    jmiss0 = obs_metrics.COMPILE_CACHE_MISSES.value()
    JaxEngine(JaxDB.load(root), window=16, db_path=root)
    assert obs_metrics.COMPILE_CACHE_MISSES.value() == jmiss0 + 1
    e2 = MatchEngine(AdvisoryDB.load(root), window=16, device="cpu",
                     db_path=root)
    assert e2.build_stats["compile_cache"] == "hit"
    qs = queries(41, 500)
    assert hits(e2.detect(qs)) == hits(e.oracle_detect(qs))


def test_cache_entry_random_db_roundtrip(tmp_path):
    """A seeded random DB: the entry's tensors and answers equal a fresh
    compile's."""
    rng = random.Random(20261017)
    db = AdvisoryDB()
    for i in range(300):
        db.put_advisory("debian 12", f"pkg-{rng.randrange(120)}", Advisory(
            vulnerability_id=f"CVE-26-{i}",
            fixed_version=f"{rng.randint(0, 5)}.{rng.randint(0, 9)}-1"))
    root = str(tmp_path / "db")
    db.save(root)
    e1 = MatchEngine(AdvisoryDB.load(root), window=8, device="cpu",
                     db_path=root)
    e2 = MatchEngine(AdvisoryDB.load(root), window=8, device="cpu",
                     db_path=root)
    assert e2.build_stats["compile_cache"] == "hit"
    qs = [PkgQuery("debian 12", f"pkg-{rng.randrange(130)}",
                   f"{rng.randint(0, 6)}.{rng.randint(0, 9)}-1", "deb")
          for _ in range(500)]
    assert hits(e2.detect(qs)) == hits(e1.detect(qs)) == \
        hits(e1.oracle_detect(qs))
