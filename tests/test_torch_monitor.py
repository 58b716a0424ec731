"""Port parity, continuous monitoring: trivy_tpu_torch.monitor (the
advisory-key fingerprints, the delta plan, the durable monitor index,
the re-score through `MatchEngine.submit`, the scan tap, `watch` and the
server's /monitor/events) against the JAX package's trivy_tpu.monitor,
on the same seeded DBs and index files.

The DBs are built by the reference's types from a seeded spec (numpy
and `random`), saved once and loaded by both packages; the port's
engines run with device="cpu" (the match kernel's plain version) and
the reference's with use_device=False. The shapes are
tests/test_monitor.py's: fingerprints, delta, index, re-score, the
fault matrices, capture and scheduler, watch. Events, `RescoreReport`
fields (all but `duration_s`), keymap entry bytes, index file bytes and
replayed index states are compared for exact equality; after every
re-score the index's state equals `full_findings`. Every server and
scheduler is closed in a finalizer, and every wait has a timeout.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import test_sbom_e2e
import torch
from test_fanal import PACKAGE_LOCK, _fixture_db, _mk_rootfs

import trivy_tpu.monitor as jmon
from trivy_tpu.cache.cache import MemoryCache as JaxMemoryCache
from trivy_tpu.cli import main as jax_main
from trivy_tpu.cli import run as jax_run
from trivy_tpu.db import generations as jgens
from trivy_tpu.db.model import Advisory as JaxAdvisory
from trivy_tpu.db.store import AdvisoryDB as JaxAdvisoryDB
from trivy_tpu.db.store import Metadata as JaxMetadata
from trivy_tpu.detector.engine import MatchEngine as JaxEngine
from trivy_tpu.detector.engine import PkgQuery as JaxQuery
from trivy_tpu.durability import ScanJournal as JaxJournal
from trivy_tpu.monitor import watch as jwatch
from trivy_tpu.resilience import faults as jfaults
from trivy_tpu.rpc.server import ScanService as JaxScanService
from trivy_tpu.rpc.server import Server as JaxServer
from trivy_tpu.tensorize import cache as jcache
from trivy_tpu.types.scan import ScanOptions as JaxScanOptions
from trivy_tpu.utils import uuid as jax_uuid
from trivy_tpu_torch import monitor as tmon
from trivy_tpu_torch.cache.cache import MemoryCache
from trivy_tpu_torch.cli import run
from trivy_tpu_torch.cli.main import main
from trivy_tpu_torch.db.store import AdvisoryDB
from trivy_tpu_torch.detector.engine import MatchEngine, PkgQuery
from trivy_tpu_torch.monitor import rematch as trematch
from trivy_tpu_torch.monitor import watch as twatch
from trivy_tpu_torch.obs import tracing as ttracing
from trivy_tpu_torch.resilience import faults
from trivy_tpu_torch.rpc.client import close_pool
from trivy_tpu_torch.rpc.server import ScanService, Server
from trivy_tpu_torch.sched.scheduler import MatchScheduler, SchedEngine
from trivy_tpu_torch.tensorize import cache as tcache
from trivy_tpu_torch.types.scan import ScanOptions
from trivy_tpu_torch.utils import uuid as port_uuid

pytestmark = pytest.mark.monitor

ROOT = Path(__file__).resolve().parents[1]
SEED = 20261020
WAIT_S = 30.0  # every event wait and thread join is bounded
NPM = "npm::GitHub Security Advisory Npm"
PIP = "pip::GitHub Security Advisory pip"
DEB = "debian 11"
DEAD = "no-such-eco::x"  # no scheme: invisible to matching


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread (the suite runs several test processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _no_threads_left():
    """No server, scheduler or monitor thread outlives the module."""
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
def _reset(monkeypatch):
    for f in (faults, jfaults):
        f.reset()
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()
    yield
    for f in (faults, jfaults):
        f.reset()
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()


# ------------------------------------------------------------ seeded DBs


def _versions(eco: str, rng: random.Random) -> tuple[str, str]:
    """(a vulnerable version, the fix above it) in the name's scheme."""
    major = rng.randint(1, 8)
    if eco == DEB:
        return f"{major}.0-1", f"{major}.{rng.randint(1, 9)}-1"
    return f"{major}.0.0", f"{major}.{rng.randint(1, 9)}.0"


def seeded_spec(seed: int = SEED) -> dict:
    """{(bucket, name): [(vuln id, fixed)]}: 40 npm names (a second npm
    source on some), 20 pip, 30 debian 11 and 4 on a bucket no scheme
    resolves, each with 1-3 advisories."""
    rng = random.Random(seed)
    np_rng = np.random.default_rng(seed)
    spec: dict = {}
    n = 0
    for bucket, prefix, count in ((NPM, "n", 40), (PIP, "p", 20),
                                  (DEB, "d", 30), (DEAD, "x", 4)):
        for i in range(count):
            advs = []
            for _ in range(int(np_rng.integers(1, 4))):
                n += 1
                advs.append((f"CVE-2024-{n:05d}",
                             _versions(bucket, rng)[1]))
            spec[(bucket, f"{prefix}{i}")] = advs
    for i in range(0, 40, 7):  # a second data source folds into "npm::"
        n += 1
        spec[("npm::npm-audit", f"n{i}")] = [(f"CVE-2023-{n:05d}", "9.0.0")]
    return spec


def mutate(spec: dict, seed: int = SEED + 1) -> dict:
    """Generation B: advisories added on held names, fixes moved, names
    removed, new names, and churn on the schemeless bucket."""
    rng = random.Random(seed)
    out = {k: list(v) for k, v in spec.items()}
    keys = sorted(k for k in out if k[0] != DEAD)
    picks = rng.sample(keys, 14)
    for k in picks[:5]:  # an advisory added: introduced findings
        out[k].append((f"CVE-2026-{rng.randint(1, 99999):05d}", "99.0.0"
                       if k[0] != DEB else "99.0-1"))
    for k in picks[5:10]:  # a fix moved below every held version
        vid, _fixed = out[k][0]
        out[k][0] = (vid, "0.1.0" if k[0] != DEB else "0.1-1")
    for k in picks[10:]:  # removed: resolved findings
        del out[k]
    for i in range(3):  # names nobody holds
        out[(NPM, f"fresh{i}")] = [(f"CVE-2026-9{i:04d}", "5.0.0")]
    out[(DEAD, "x0")] = [("CVE-2026-77777", "1.0.0")]
    return out


def build_db(spec: dict, updated: str) -> JaxAdvisoryDB:
    db = JaxAdvisoryDB()
    for (bucket, name), advs in sorted(spec.items()):
        for vid, fixed in advs:
            if bucket == DEB:
                adv = JaxAdvisory(vulnerability_id=vid, fixed_version=fixed)
            else:
                adv = JaxAdvisory(vulnerability_id=vid,
                                  vulnerable_versions=[f"<{fixed}"])
            db.put_advisory(bucket, name, adv)
    db.meta = JaxMetadata(updated_at=updated)
    return db


def seeded_artifacts(spec: dict, n: int = 24, seed: int = SEED + 2):
    """[(artifact id, [(space, name, version, scheme)])]: 3-12 packages
    each, at vulnerable and at safe versions."""
    rng = random.Random(seed)
    keys = sorted(k for k in spec if k[0] not in (DEAD, "npm::npm-audit"))
    arts = []
    for a in range(n):
        pkgs = set()
        for bucket, name in rng.sample(keys, rng.randint(3, 12)):
            ver = rng.choice(["1.0.0", "3.0.0", "12.0.0"])
            if bucket == DEB:
                pkgs.add((DEB, name, ver.replace(".0.0", ".0-1"), "deb"))
            elif bucket == PIP:
                pkgs.add(("pip::", name, ver, "pep440"))
            else:
                pkgs.add(("npm::", name, ver, "npm"))
        arts.append((f"img{a:02d}", sorted(pkgs)))
    return arts


def save_generation(root: str, name: str, db) -> str:
    gen = os.path.join(jgens.generations_root(root), name)
    db.save(gen)
    jgens.promote(root, gen)
    return gen


def index_state(idx) -> dict:
    return {"artifacts": {
        a: (idx.packages_of(a),
            None if idx.findings_of(a) is None
            else sorted(idx.findings_of(a)))
        for a in idx.artifacts()},
        "db": idx.db_digest, "window": idx.window,
        "degraded": bool(idx.degraded)}


def fields(report) -> dict:
    d = dataclasses.asdict(report)
    d.pop("duration_s")
    return d


def lines_without_duration(text: str) -> list[dict]:
    """JSON lines without `duration_s` (a wall time) and `trace_id`: a
    live server of either package collects traces (its attribution
    holds the span sink) and stamps the span's random id on its
    events."""
    out = []
    for ln in text.splitlines():
        doc = json.loads(ln)
        doc.pop("duration_s", None)
        doc.pop("trace_id", None)
        out.append(doc)
    return out


class Pair:
    """Generation A indexed by both packages (each its own index file,
    the same artifacts and baselines), generation B saved on top: flat
    (content digests) or generation-managed (sha256-<name> digests)."""

    def __init__(self, tmp_path, layout="flat", n_artifacts=24,
                 spec_b=None):
        self.tmp = tmp_path
        self.root = str(tmp_path / "db")
        self.layout = layout
        self.spec_a = seeded_spec()
        self.spec_b = spec_b if spec_b is not None else mutate(self.spec_a)
        self._save(build_db(self.spec_a, "2026-01-01"), "sha256-" + "a" * 8)
        self.d1 = jcache.db_digest(self.root)
        assert tcache.db_digest(self.root) == self.d1
        jeng = JaxEngine(JaxAdvisoryDB.load(self.root), use_device=False,
                         db_path=self.root)
        teng = MatchEngine(AdvisoryDB.load(self.root), device="cpu",
                           db_path=self.root)
        self.arts = seeded_artifacts(self.spec_a, n_artifacts)
        self.jidx = jmon.MonitorIndex.open(str(tmp_path / "j.jsonl"))
        self.tidx = tmon.MonitorIndex.open(str(tmp_path / "t.jsonl"))
        for aid, pkgs in self.arts:
            self.jidx.update(aid, pkgs, jeng.match_keys(
                [[JaxQuery(*p) for p in pkgs]])[0], db_digest=self.d1)
            self.tidx.update(aid, pkgs, teng.match_keys(
                [[PkgQuery(*p) for p in pkgs]])[0], db_digest=self.d1)
        self.jidx.set_state(self.d1)
        self.tidx.set_state(self.d1)
        self._save(build_db(self.spec_b, "2026-01-02"), "sha256-" + "b" * 8)
        self.d2 = jcache.db_digest(self.root)
        self.jeng = JaxEngine(JaxAdvisoryDB.load(self.root),
                              use_device=False, db_path=self.root)
        self.teng = MatchEngine(AdvisoryDB.load(self.root), device="cpu",
                                db_path=self.root)

    def _save(self, db, gen_name):
        if self.layout == "flat":
            db.save(self.root)
        else:
            save_generation(self.root, gen_name, db)

    def plans(self, **kw):
        return (jmon.compute_delta(self.root, self.jidx.db_digest,
                                   self.jeng.db, new_digest=self.d2, **kw),
                tmon.compute_delta(self.root, self.tidx.db_digest,
                                   self.teng.db, new_digest=self.d2, **kw))

    def close(self):
        self.jidx.close()
        self.tidx.close()


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def assert_zero_diff(idx, engine, full_findings=trematch.full_findings):
    oracle = full_findings(engine, idx)
    for aid, keys in oracle.items():
        assert (idx.findings_of(aid) or set()) == keys, aid


def plan_fields(plan) -> dict:
    return dataclasses.asdict(plan)


# ====================================================== fingerprints


@pytest.mark.parametrize("layout", ["flat", "generations"])
def test_keymap_entry_bytes_equal_reference(tmp_path, layout):
    p = Pair(tmp_path, layout=layout, n_artifacts=2)
    try:
        for digest in (p.d1, p.d2):
            ref = jcache.keymap_path(p.root, digest)
            port = tcache.keymap_path(p.root, digest)
            assert "compiled-torch" in port and port != ref
            with open(ref, "rb") as f, open(port, "rb") as g:
                assert f.read() == g.read()
    finally:
        p.close()


def test_fingerprints_equal_reference_and_skip_schemeless():
    db = build_db(seeded_spec(), "2026-01-01")
    ref = jcache.advisory_fingerprints(db)
    port = tcache.advisory_fingerprints(db)
    assert port == ref
    assert not any("no-such-eco" in s for s, _n in port)
    # the second npm source folds into the "npm::" space's key
    assert ("npm::", "n0") in port and not any(
        s.startswith("npm::npm-audit") for s, _n in port)


def test_keymap_roundtrip_and_space_collapse(tmp_path):
    db = build_db(seeded_spec(), "2026-01-01")
    db.save(str(tmp_path))
    tdb = AdvisoryDB.load(str(tmp_path))
    digest = tcache.db_digest(str(tmp_path))
    assert tcache.save_keymap(str(tmp_path), tdb, digest=digest)
    loaded = tcache.load_keymap(str(tmp_path), digest)
    assert loaded is not None and loaded["schema"] == tdb.meta.version
    assert loaded["keys"] == tcache.advisory_fingerprints(tdb)
    # a second source changes the folded key's digest, not another's
    solo = build_db({k: v for k, v in seeded_spec().items()
                     if k[0] != "npm::npm-audit"}, "2026-01-01")
    fp = tcache.advisory_fingerprints(solo)
    assert fp[("npm::", "n1")] == loaded["keys"][("npm::", "n1")]
    assert fp[("npm::", "n0")] != loaded["keys"][("npm::", "n0")]


def test_keymap_save_skips_a_moved_root(tmp_path):
    """A DB whose metadata disagrees with the root's is never saved
    under the root's digest (the load-then-promote race)."""
    root = str(tmp_path / "db")
    build_db(seeded_spec(), "2026-01-01").save(root)
    other = AdvisoryDB.load(root)
    other.meta.updated_at = "2030-01-01"
    assert tcache.save_keymap(root, other) is None
    assert jcache.save_keymap(root, JaxAdvisoryDB.load(root)) is not None


def test_corrupt_keymap_quarantined(tmp_path):
    build_db(seeded_spec(), "2026-01-01").save(str(tmp_path))
    db = AdvisoryDB.load(str(tmp_path))
    digest = tcache.db_digest(str(tmp_path))
    path = tcache.save_keymap(str(tmp_path), db, digest=digest)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    with open(path, "wb") as f:
        f.write(raw)
    assert tcache.load_keymap(str(tmp_path), digest) is None
    assert not os.path.exists(path)
    assert os.path.exists(path + tcache.QUARANTINE_SUFFIX)


def test_prune_superseded_spares_keymaps(tmp_path):
    build_db(seeded_spec(), "2026-01-01").save(str(tmp_path))
    db = AdvisoryDB.load(str(tmp_path))
    e = MatchEngine(db, device="cpu", db_path=str(tmp_path))
    assert e.build_stats["keymap_s"] >= 0.0
    path = tcache.keymap_path(str(tmp_path),
                              tcache.db_digest(str(tmp_path)))
    assert os.path.exists(path)
    root = tcache.cache_root(str(tmp_path))
    for name in os.listdir(root):
        os.utime(os.path.join(root, name), (1, 1))  # ancient
    tcache._prune_superseded(root, "sha256-something-else")
    assert os.listdir(root) == [os.path.basename(path)]


def test_every_engine_build_with_a_db_path_times_its_keymap(tmp_path):
    build_db(seeded_spec(), "2026-01-01").save(str(tmp_path))
    db = AdvisoryDB.load(str(tmp_path))
    cold = MatchEngine(db, device="cpu", db_path=str(tmp_path))
    warm = MatchEngine(db, device="cpu", db_path=str(tmp_path))
    assert cold.build_stats["compile_cache"] == "miss"
    assert warm.build_stats["compile_cache"] == "hit"
    assert "keymap_s" in cold.build_stats and "keymap_s" in warm.build_stats
    assert "keymap_s" not in MatchEngine(db, device="cpu").build_stats


# ============================================================ delta


DELTA_CASES = {
    "noop": dict(new=None),
    "touched": dict(),
    "schema": dict(schema=1),
    "params": dict(params="window-params-changed"),
    "no_old_keymap_flat": dict(drop_old_keymap=True),
    "no_old_keymap_generation": dict(drop_old_keymap=True,
                                     layout="generations"),
    "threshold": dict(threshold="0.05"),
    "no_baseline": dict(no_baseline=True),
}


@pytest.mark.parametrize("case", sorted(DELTA_CASES))
def test_delta_plan_equals_reference(tmp_path, monkeypatch, case):
    c = DELTA_CASES[case]
    root = str(tmp_path / "db")
    layout = c.get("layout", "flat")
    spec_a = seeded_spec()
    db1 = build_db(spec_a, "2026-01-01")
    if layout == "flat":
        db1.save(root)
    else:
        save_generation(root, "sha256-aaaa", db1)
    d1 = jcache.db_digest(root)
    if not c.get("drop_old_keymap"):
        jcache.save_keymap(root, JaxAdvisoryDB.load(root), digest=d1)
        tcache.save_keymap(root, AdvisoryDB.load(root), digest=d1)
    if "new" in c:
        db2 = db1
    else:
        db2 = build_db(mutate(spec_a), "2026-01-02")
        if "schema" in c:
            db2.meta.version = c["schema"]
        if layout == "flat":
            db2.save(root)
        else:
            save_generation(root, "sha256-bbbb", db2)
    d2 = jcache.db_digest(root)
    if "threshold" in c:
        monkeypatch.setenv("TRIVY_TPU_DELTA_FULL_THRESHOLD", c["threshold"])
    old = None if c.get("no_baseline") else d1
    kw = {"params_changed": c["params"]} if "params" in c else {}
    ref = jmon.compute_delta(root, old, JaxAdvisoryDB.load(root),
                             new_digest=d2, **kw)
    port = tmon.compute_delta(root, old, AdvisoryDB.load(root),
                              new_digest=d2, **kw)
    assert plan_fields(port) == plan_fields(ref)
    if case == "touched":
        assert not port.full and port.touched
    if case == "no_old_keymap_generation":
        assert not port.full  # fingerprinted the installed generation


def test_delta_threshold_env_malformed_uses_default(monkeypatch):
    from trivy_tpu_torch.monitor import delta

    monkeypatch.setenv("TRIVY_TPU_DELTA_FULL_THRESHOLD", "lots")
    assert delta.full_threshold() == delta.DEFAULT_FULL_THRESHOLD


# ============================================================ index


def _fill(idx):
    idx.update("a", [("npm::", "p", "1", "npm")],
               [("npm::", "p", "1", "npm", "CVE-1")], db_digest="sha256-x")
    idx.update("b", [("npm::", "q", "2", "npm")], None)
    idx.update("a", [("npm::", "r", "3", "npm")],
               [("npm::", "r", "3", "npm", "CVE-2")], db_digest="sha256-x")
    idx.set_state("sha256-x", window=None, prev=None,
                  touched=[("npm::", "r")])
    idx.update("c", [("pip::", "s", "4", "pep440")],
               [("pip::", "s", "4", "pep440", "CVE-3")],
               db_digest="sha256-w")
    idx.remove("b")


def test_index_update_replay_roundtrip_equals_reference_bytes(tmp_path):
    t = tmon.MonitorIndex.open(str(tmp_path / "t.jsonl"))
    j = jmon.MonitorIndex.open(str(tmp_path / "j.jsonl"))
    _fill(t)
    _fill(j)
    t.close()
    j.close()
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
    t2 = tmon.MonitorIndex.open(str(tmp_path / "t.jsonl"))
    j2 = jmon.MonitorIndex.open(str(tmp_path / "j.jsonl"))
    try:
        assert index_state(t2) == index_state(j2)
        assert t2.artifacts() == ["a", "c"]
        assert t2.packages_of("a") == [("npm::", "r", "3", "npm")]
        # "c" was stamped with a generation no chain reaches: nulled
        assert t2.findings_of("c") is None
        assert t2.affected({("npm::", "r")}) == j2.affected(
            {("npm::", "r")}) == ["a", "c"]
        assert t2.affected(set()) == ["c"]
    finally:
        t2.close()
        j2.close()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_index_written_by_either_package_replays_in_the_other(pair, writer):
    rescore_src = jmon.rescore if writer == "reference" else tmon.rescore
    idx, eng = (pair.jidx, pair.jeng) if writer == "reference" else \
        (pair.tidx, pair.teng)
    plan = pair.plans()[0 if writer == "reference" else 1]
    rescore_src(eng, idx, plan)
    idx.update("extra", [("npm::", "n1", "1.0.0", "npm")], None)
    idx.close()
    j = jmon.MonitorIndex.open(idx.path)
    t = tmon.MonitorIndex.open(idx.path)
    try:
        assert index_state(t) == index_state(j)
        assert index_state(t)["db"] == pair.d2
    finally:
        j.close()
        t.close()


def test_index_torn_tail_tolerated(tmp_path):
    path = str(tmp_path / "idx.jsonl")
    idx = tmon.MonitorIndex.open(path)
    idx.update("a", [("npm::", "p", "1", "npm")], [])
    idx.close()
    with open(path, "ab") as f:
        f.write(b'{"kind": "artifact", "id": "b", "packa')  # torn
    idx2 = tmon.MonitorIndex.open(path)
    assert idx2.artifacts() == ["a"]
    idx2.update("c", [("npm::", "c", "1", "npm")], [])
    idx2.close()
    idx3 = tmon.MonitorIndex.open(path)
    ref = jmon.MonitorIndex.open(path)
    try:
        assert idx3.artifacts() == ["a", "c"]
        assert index_state(idx3) == index_state(ref)
    finally:
        idx3.close()
        ref.close()


def test_index_bitflipped_record_dropped_at_replay(tmp_path):
    path = str(tmp_path / "idx.jsonl")
    idx = tmon.MonitorIndex.open(path)
    idx.update("a", [("npm::", "p", "1", "npm")],
               [("npm::", "p", "1", "npm", "CVE-1")])
    faults.install_spec("monitor.index:bitflip@1")
    idx.update("a", [("npm::", "z", "9", "npm")], [])
    idx.close()
    faults.reset()
    idx2 = tmon.MonitorIndex.open(path)
    ref = jmon.MonitorIndex.open(path)
    try:
        assert idx2.findings_of("a") == {("npm::", "p", "1", "npm",
                                          "CVE-1")}
        assert index_state(idx2) == index_state(ref)
    finally:
        idx2.close()
        ref.close()


def test_index_open_or_reset_moves_corrupt_aside(tmp_path):
    path = str(tmp_path / "idx.jsonl")
    with open(path, "w", encoding="utf-8") as f:
        f.write("this is not a monitor index\n")
    with pytest.raises(tmon.MonitorIndexError):
        tmon.MonitorIndex.open(path)
    idx = tmon.MonitorIndex.open_or_reset(path)
    assert idx.artifacts() == []
    idx.close()
    assert os.path.exists(path + ".corrupt")


def test_index_of_another_version_is_refused(tmp_path):
    path = str(tmp_path / "idx.jsonl")
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps({"v": 99, "kind": "header"}) + "\n")
    with pytest.raises(tmon.MonitorIndexError, match="version 99"):
        tmon.MonitorIndex.open(path)


def test_reference_journal_rebuilds_the_port_index(tmp_path):
    jpath = str(tmp_path / "fleet.jsonl")
    j = JaxJournal.create(jpath, "image", ["img0", "img1"], "sha256:fp")
    docs = {
        "img0": {"Results": [{"Class": "lang-pkgs", "Type": "npm",
                              "Packages": [{"Name": "pkg1",
                                            "Version": "1.0.0"}]}],
                 "Metadata": {"OS": {"Family": "alpine",
                                     "Name": "3.19.1"}}},
        "img1": {"Results": [{"Class": "os-pkgs", "Type": "debian",
                              "Packages": [
                                  {"Name": "libc6", "Version": "2.31",
                                   "Release": "13", "SrcName": "glibc",
                                   "SrcVersion": "2.31",
                                   "SrcRelease": "13"},
                                  {"Name": "tzdata", "Version": "2021a",
                                   "Epoch": 1}]}],
                 "Metadata": {"OS": {"Family": "debian",
                                     "Name": "11.5"}}},
    }
    for t, doc in docs.items():
        j.mark_done(t, doc)
    j.close()
    for pkg, opener in (("port", tmon.MonitorIndex), ("ref", jmon.MonitorIndex)):
        path = str(tmp_path / f"{pkg}.jsonl")
        with open(path, "w", encoding="utf-8") as f:
            f.write("garbage\n")
        idx = opener.rebuild_from_journal(path, jpath)
        if pkg == "port":
            port_state = index_state(idx)
            assert idx.packages_of("img0") == [("npm::", "pkg1", "1.0.0",
                                                "npm")]
            assert idx.findings_of("img0") is None
            assert idx.affected(set()) == ["img0", "img1"]
        else:
            ref_state = index_state(idx)
        idx.close()
    assert port_state == ref_state
    assert os.path.exists(str(tmp_path / "port.jsonl.corrupt"))


def test_packages_from_report_equals_reference():
    from trivy_tpu.monitor.index import packages_from_report as jpfr
    from trivy_tpu_torch.monitor.index import packages_from_report

    doc = {"Metadata": {"OS": {"Family": "alpine", "Name": "3.18.4"}},
           "Results": [
               {"Class": "os-pkgs", "Packages": [
                   {"Name": "musl", "Version": "1.2.4", "Release": "r0"},
                   {"Name": "busybox", "Version": "1.36.1",
                    "SrcName": "busybox", "SrcVersion": "1.36.1",
                    "SrcRelease": "r2", "SrcEpoch": 1}]},
               {"Class": "lang-pkgs", "Type": "pip", "Packages": [
                   {"Name": "requests", "Version": "2.19.0"},
                   {"Name": "", "Version": "1"}]},
               {"Class": "lang-pkgs", "Type": "nosuch", "Packages": [
                   {"Name": "x", "Version": "1"}]}]}
    assert packages_from_report(doc) == jpfr(doc)
    assert ("pip::", "requests", "2.19.0", "pep440") in \
        packages_from_report(doc)


def test_index_compact_preserves_state_and_equals_reference(tmp_path):
    out = {}
    for name, mod in (("t", tmon), ("j", jmon)):
        path = str(tmp_path / f"{name}.jsonl")
        idx = mod.MonitorIndex.open(path)
        for i in range(30):  # 30 appends, 1 live artifact
            idx.update("a", [("npm::", f"p{i}", "1", "npm")], [])
        idx.set_state("sha256-x")
        size_before = os.path.getsize(path)
        idx.compact()
        assert os.path.getsize(path) < size_before
        idx.close()
        out[name] = Path(path).read_bytes()
        idx2 = mod.MonitorIndex.open(path)
        assert idx2.packages_of("a") == [("npm::", "p29", "1", "npm")]
        assert idx2.db_digest == "sha256-x"
        idx2.close()
    assert out["t"] == out["j"]


def test_oversized_touched_set_persists_as_everything(tmp_path):
    from trivy_tpu_torch.monitor.index import MAX_TOUCHED_PERSIST

    idx = tmon.MonitorIndex.open(str(tmp_path / "i.jsonl"))
    idx.update("a", [("npm::", "p", "1", "npm")], [], db_digest="d0")
    idx.set_state("d1", prev="d0", touched=[
        ("npm::", f"k{i}") for i in range(MAX_TOUCHED_PERSIST + 1)])
    idx.close()
    idx2 = tmon.MonitorIndex.open(str(tmp_path / "i.jsonl"))
    try:
        # a "touched everything" transition re-baselines "a"
        assert idx2.findings_of("a") is None
    finally:
        idx2.close()


# ====================================================== re-scoring


def _both_rescore(pair, verify=True, **kw):
    jplan, tplan = pair.plans()
    ref = jmon.rescore(pair.jeng, pair.jidx, jplan, verify=verify, **kw)
    port = tmon.rescore(pair.teng, pair.tidx, tplan, verify=verify, **kw)
    return ref, port


@pytest.mark.parametrize("layout", ["flat", "generations"])
def test_rescore_equals_reference_and_full_rematch(tmp_path, layout):
    p = Pair(tmp_path, layout=layout)
    try:
        jplan, tplan = p.plans()
        assert plan_fields(tplan) == plan_fields(jplan)
        assert not tplan.full and tplan.touched
        ref = jmon.rescore(p.jeng, p.jidx, jplan, verify=True)
        port = tmon.rescore(p.teng, p.tidx, tplan, verify=True)
        assert fields(port) == fields(ref)
        assert port.verified is True
        assert port.introduced and port.resolved
        assert 0 < port.rematched < port.total_indexed
        assert index_state(p.tidx) == index_state(p.jidx)
        assert p.tidx.db_digest == p.d2
        assert_zero_diff(p.tidx, p.teng)
        assert Path(p.tidx.path).read_bytes() == \
            Path(p.jidx.path).read_bytes()
    finally:
        p.close()


def test_rescore_event_shape_and_order(pair):
    ref, port = _both_rescore(pair)
    assert port.events == ref.events
    assert [list(e) for e in port.events[:1]] == [[
        "event", "artifact", "space", "name", "version", "scheme",
        "vuln_id", "db_digest"]]
    keys = [(e["artifact"], e["event"] == "resolved", e["space"], e["name"],
             e["version"], e["scheme"], e["vuln_id"]) for e in port.events]
    assert keys == sorted(keys)  # artifact order, introduced first
    assert {e["db_digest"] for e in port.events} == {pair.d2}


def test_rescore_stamps_the_given_scan_id(pair):
    _jplan, tplan = pair.plans()
    with ttracing.scan_scope(force=True) as sid:
        port = tmon.rescore(pair.teng, pair.tidx, tplan)
    assert port.events and all(e["scan_id"] == sid for e in port.events)


def test_rescore_through_match_keys_equals_submit(pair):
    lists = [[PkgQuery(*p) for p in pkgs] for _a, pkgs in pair.arts]
    advs = pair.teng.cdb.advisories
    via_submit = [sorted(trematch.finding_keys(advs, rl))
                  for rl in pair.teng.submit(lists)]
    assert pair.teng.match_keys(lists) == via_submit


def test_full_plan_rebaselines_everything(pair):
    jplan, tplan = pair.plans(params_changed="window-params-changed")
    ref = jmon.rescore(pair.jeng, pair.jidx, jplan, verify=True)
    port = tmon.rescore(pair.teng, pair.tidx, tplan, verify=True)
    assert port.full and port.rematched == len(pair.arts)
    assert fields(port) == fields(ref)
    assert_zero_diff(pair.tidx, pair.teng)


def test_noop_promote_rematches_nothing(pair):
    _both_rescore(pair)
    ref, port = _both_rescore(pair)
    assert fields(port) == fields(ref)
    assert port.rematched == 0 and not port.events


@pytest.mark.fault
@pytest.mark.parametrize("spec", ["monitor.rematch:drop",
                                  "monitor.rematch:error",
                                  "monitor.rematch:delay=0.001",
                                  "monitor:drop"])
def test_rematch_fault_matrix_equals_reference(pair, spec):
    faults.install_spec(spec)
    jfaults.install_spec(spec)
    ref, port = _both_rescore(pair)
    faults.reset()
    jfaults.reset()
    if spec.split(":")[1].split("=")[0] in ("drop", "error"):
        assert port.full and port.reason.startswith("fault-")
    assert fields(port) == fields(ref)
    assert port.verified is True and pair.tidx.db_digest == pair.d2
    assert index_state(pair.tidx) == index_state(pair.jidx)
    assert_zero_diff(pair.tidx, pair.teng)


@pytest.mark.fault
@pytest.mark.parametrize("action", ["drop", "error"])
def test_index_fault_matrix_equals_reference(pair, action):
    spec = f"monitor.index:{action}@p0.5;seed=11"
    faults.install_spec(spec)
    jfaults.install_spec(spec)
    ref, port = _both_rescore(pair, verify=False)
    faults.reset()
    jfaults.reset()
    assert fields(port) == fields(ref)
    assert index_state(pair.tidx) == index_state(pair.jidx)
    assert_zero_diff(pair.tidx, pair.teng)
    if action == "error":
        assert pair.tidx.degraded
        r2, p2 = _both_rescore(pair)
        assert p2.full and p2.reason == "index-degraded"
        assert fields(p2) == fields(r2)
        assert not pair.tidx.degraded and p2.verified is True
    # the replayed durable state re-scores to the same answer
    pair.tidx.close()
    pair.jidx.close()
    t2 = tmon.MonitorIndex.open(pair.tidx.path)
    j2 = jmon.MonitorIndex.open(pair.jidx.path)
    try:
        assert index_state(t2) == index_state(j2)
        tp = tmon.compute_delta(pair.root, t2.db_digest, pair.teng.db,
                                new_digest=pair.d2)
        jp = jmon.compute_delta(pair.root, j2.db_digest, pair.jeng.db,
                                new_digest=pair.d2)
        assert fields(tmon.rescore(pair.teng, t2, tp)) == \
            fields(jmon.rescore(pair.jeng, j2, jp))
        assert_zero_diff(t2, pair.teng)
    finally:
        t2.close()
        j2.close()


@pytest.mark.fault
@pytest.mark.parametrize("action", ["torn-write", "bitflip"])
def test_index_write_rot_is_caught_at_replay(pair, action):
    faults.install_spec(f"monitor.index:{action}@2")
    jfaults.install_spec(f"monitor.index:{action}@2")
    _both_rescore(pair, verify=False)
    faults.reset()
    jfaults.reset()
    for idx in (pair.tidx, pair.jidx):
        idx.close()
    t2 = tmon.MonitorIndex.open(pair.tidx.path)
    j2 = jmon.MonitorIndex.open(pair.jidx.path)
    try:
        assert index_state(t2) == index_state(j2)
        tp = tmon.compute_delta(pair.root, t2.db_digest, pair.teng.db,
                                new_digest=pair.d2)
        tmon.rescore(pair.teng, t2, tp)
        assert_zero_diff(t2, pair.teng)
    finally:
        t2.close()
        j2.close()


@pytest.mark.fault
def test_kill_mid_rescore_replays(pair):
    faults.set_kill_mode("raise")
    faults.install_spec("monitor.rematch:kill@1")
    _jplan, tplan = pair.plans()
    with pytest.raises(faults.InjectedKill):
        tmon.rescore(pair.teng, pair.tidx, tplan)
    faults.reset()
    assert pair.tidx.db_digest == pair.d1
    _jplan, tplan = pair.plans()
    report = tmon.rescore(pair.teng, pair.tidx, tplan, verify=True)
    assert report.verified is True and pair.tidx.db_digest == pair.d2
    assert_zero_diff(pair.tidx, pair.teng)


@pytest.mark.fault
def test_kill_mid_index_update_keeps_the_durable_prefix(pair):
    """A raise-mode kill at the 3rd index append of a re-score: the two
    earlier appends are durable, the state did not advance, the replay
    re-scores to a full re-match's answer."""
    faults.set_kill_mode("raise")
    faults.install_spec("monitor.index:kill@3")
    _jplan, tplan = pair.plans()
    with pytest.raises(faults.InjectedKill):
        tmon.rescore(pair.teng, pair.tidx, tplan)
    faults.reset()
    pair.tidx.close()
    t2 = tmon.MonitorIndex.open(pair.tidx.path)
    try:
        assert t2.db_digest == pair.d1
        tp = tmon.compute_delta(pair.root, t2.db_digest, pair.teng.db,
                                new_digest=pair.d2)
        r = tmon.rescore(pair.teng, t2, tp, verify=True)
        assert r.verified is True
        assert_zero_diff(t2, pair.teng)
    finally:
        t2.close()


def test_baselines_carry_across_restart(pair):
    _both_rescore(pair, verify=False)
    pair.tidx.close()
    idx2 = tmon.MonitorIndex.open(pair.tidx.path)
    try:
        assert all(idx2.findings_of(a) is not None for a in idx2.artifacts())
        plan2 = tmon.compute_delta(pair.root, idx2.db_digest, pair.teng.db,
                                   new_digest=pair.d2)
        r2 = tmon.rescore(pair.teng, idx2, plan2)
        assert r2.rematched == 0 and not r2.events
        assert_zero_diff(idx2, pair.teng)
        idx2.compact(slack=0)
    finally:
        idx2.close()
    idx3 = tmon.MonitorIndex.open(pair.tidx.path)
    try:
        assert all(idx3.findings_of(a) is not None for a in idx3.artifacts())
    finally:
        idx3.close()


def test_budget_shed_does_not_advance_state(pair):
    jplan, tplan = pair.plans()
    ref = jmon.rescore(pair.jeng, pair.jidx, jplan, budget_s=0.0)
    port = tmon.rescore(pair.teng, pair.tidx, tplan, budget_s=0.0)
    assert port.shed and fields(port) == fields(ref)
    assert pair.tidx.db_digest == pair.d1
    ref, port = _both_rescore(pair, verify=False)
    assert not port.shed and pair.tidx.db_digest == pair.d2
    assert fields(port) == fields(ref)
    assert_zero_diff(pair.tidx, pair.teng)


def test_live_rescan_mid_sweep_wins(pair):
    """update_if refuses a write when a live scan re-recorded the
    artifact after the sweep's snapshot: no event, the fresh record
    stays."""
    _jplan, tplan = pair.plans()
    victim = pair.tidx.affected(tplan.touched)[0]
    fresh = [("npm::", "n1", "12.0.0", "npm")]
    real_submit = pair.teng.submit

    def racing_submit(lists):
        pair.tidx.update(victim, fresh, [], db_digest=pair.d2)
        return real_submit(lists)

    pair.teng.submit = racing_submit
    try:
        report = tmon.rescore(pair.teng, pair.tidx, tplan)
    finally:
        del pair.teng.submit
    assert all(e["artifact"] != victim for e in report.events)
    assert pair.tidx.packages_of(victim) == fresh


def test_rescore_raises_a_device_error(pair):
    """A device error during the re-match raises out of the re-score
    (no host fallback); the state is not advanced."""
    _jplan, tplan = pair.plans()

    def broken(_lists):
        raise RuntimeError("CUDA error: an illegal memory access")

    pair.teng.submit = broken
    try:
        with pytest.raises(RuntimeError, match="CUDA error"):
            tmon.rescore(pair.teng, pair.tidx, tplan)
    finally:
        del pair.teng.submit
    assert pair.tidx.db_digest == pair.d1


def test_verify_mismatch_rebaselines(pair):
    _jplan, tplan = pair.plans()
    real = pair.teng.submit
    calls = {"n": 0}

    def first_batch_lies(lists):
        calls["n"] += 1
        out = real(lists)
        if calls["n"] == 1:
            return [[] for _ in out]
        return out

    pair.teng.submit = first_batch_lies
    try:
        report = tmon.rescore(pair.teng, pair.tidx, tplan, verify=True)
    finally:
        del pair.teng.submit
    assert report.verified is False
    assert_zero_diff(pair.tidx, pair.teng)


def test_sigkill_replay_in_a_subprocess(tmp_path):
    """A child process dies (SIGKILL) at the 5th index append; the
    surviving log replays in both packages to the same state and
    re-scores to a full re-match's answer."""
    script = (
        "from trivy_tpu_torch.monitor.index import MonitorIndex\n"
        f"idx = MonitorIndex.open({str(tmp_path / 'idx.jsonl')!r})\n"
        "for i in range(10):\n"
        "    idx.update('img%d' % i,\n"
        "               [('npm::', 'n%d' % i, '1.0.0', 'npm')], [])\n"
        "print('UNREACHABLE')\n")
    env = {**os.environ, "TRIVY_TPU_FAULTS": "monitor.index:kill@5",
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert "UNREACHABLE" not in proc.stdout
    idx = tmon.MonitorIndex.open(str(tmp_path / "idx.jsonl"))
    ref = jmon.MonitorIndex.open(str(tmp_path / "idx.jsonl"))
    try:
        assert idx.artifacts() == ["img0", "img1", "img2"]
        assert index_state(idx) == index_state(ref)
        db = build_db(seeded_spec(), "2026-01-01")
        db.save(str(tmp_path / "db"))
        eng = MatchEngine(AdvisoryDB.load(str(tmp_path / "db")),
                          device="cpu")
        plan = tmon.compute_delta(str(tmp_path / "nodb"), None, eng.db,
                                  new_digest="content-x")
        assert plan.full
        tmon.rescore(eng, idx, plan, verify=True)
        assert_zero_diff(idx, eng)
    finally:
        idx.close()
        ref.close()


# ============================================== capture / scheduler


def test_tap_records_packages_and_findings_equal_reference(pair):
    pkgs = pair.arts[0][1] + pair.arts[1][1]
    with jmon.capture_scan() as jcap:
        h = jmon.tap(pair.jeng)
        h.detect([JaxQuery(*p) for p in pkgs])
    with tmon.capture_scan() as tcap:
        h = tmon.tap(pair.teng)
        assert h is not pair.teng
        h.detect([PkgQuery(*p) for p in pkgs])
    assert tcap.packages == jcap.packages == set(pkgs)
    assert tcap.findings == jcap.findings and tcap.findings


def test_tap_is_noop_outside_scope(pair):
    assert tmon.tap(pair.teng) is pair.teng


def test_capture_does_not_follow_a_thread_unless_adopted(pair):
    from trivy_tpu_torch.monitor import capture

    q = [PkgQuery(*pair.arts[0][1][0])]
    seen = {}
    with tmon.capture_scan() as cap:
        snap = capture.current()

        def bare():
            seen["bare"] = tmon.tap(pair.teng) is pair.teng

        def adopted():
            with capture.adopt(snap):
                tmon.tap(pair.teng).detect(q)

        for fn in (bare, adopted):
            t = threading.Thread(target=fn)
            t.start()
            t.join(WAIT_S)
    assert seen["bare"] is True
    assert cap.packages == {q[0].key}


@pytest.mark.sched
def test_sched_engine_submit_matches_direct(pair):
    sched = MatchScheduler(lambda: pair.teng, window_ms=1.0)
    try:
        lists = [[PkgQuery(*p) for p in pkgs] for _a, pkgs in pair.arts]
        direct = pair.teng.submit(lists)
        via = SchedEngine(pair.teng, sched).submit(lists)
        assert [[r.adv_indices for r in rl] for rl in via] == \
            [[r.adv_indices for r in rl] for rl in direct]
        assert sched.stats["batches"] >= 1
    finally:
        sched.close()


@pytest.mark.sched
def test_rescore_through_the_scheduler_equals_reference(pair):
    sched = MatchScheduler(lambda: pair.teng, window_ms=1.0,
                           max_rows=16)  # many micro-batches
    try:
        jplan, tplan = pair.plans()
        ref = jmon.rescore(pair.jeng, pair.jidx, jplan, verify=True)
        port = tmon.rescore(SchedEngine(pair.teng, sched), pair.tidx,
                            tplan, verify=True)
        assert fields(port) == fields(ref)
        assert sched.stats["batches"] > 1
    finally:
        sched.close()


# ============================================================ watch


def _watch_out(fn, *a, **kw) -> str:
    out = io.StringIO()
    assert fn(*a, out, **kw) == 0
    return out.getvalue()


def test_watch_local_once_equals_reference(pair, monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_DETERMINISTIC_UUID", "1")
    port_uuid.reset()
    jax_uuid.reset()
    ref = _watch_out(jwatch.watch_local, pair.root, pair.jidx,
                     lambda: pair.jeng, once=True, verify=True)
    port = _watch_out(twatch.watch_local, pair.root, pair.tidx,
                      lambda: pair.teng, once=True, verify=True)
    assert lines_without_duration(port) == lines_without_duration(ref)
    lines = lines_without_duration(port)
    assert lines[-1]["event"] == "rescore" and not lines[-1]["full"]
    assert all(ln.get("scan_id") for ln in lines[:-1])
    # a second pass is a no-op
    assert _watch_out(twatch.watch_local, pair.root, pair.tidx,
                      lambda: pair.teng, once=True) == ""


def test_watch_local_stop_event_ends_the_loop(pair):
    stop = threading.Event()
    stop.set()
    out = io.StringIO()
    assert twatch.watch_local(pair.root, pair.tidx, lambda: pair.teng, out,
                              interval_s=60.0, stop_event=stop) == 0
    assert '"event": "rescore"' in out.getvalue()


def test_monitor_service_promote_and_ring_equal_reference(pair,
                                                          monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_DETERMINISTIC_UUID", "1")
    pair.tidx.close()
    pair.jidx.close()
    tsvc = twatch.MonitorService(pair.tidx.path, lambda: pair.teng,
                                 pair.root)
    jsvc = jwatch.MonitorService(pair.jidx.path, lambda: pair.jeng,
                                 pair.root)
    try:
        port_uuid.reset()
        jax_uuid.reset()
        tr = tsvc.rescore_now(pair.d1, pair.teng.db, pair.d2)
        jr = jsvc.rescore_now(pair.d1, pair.jeng.db, pair.d2)
        assert fields(tr) == fields(jr)
        tn, tev = tsvc.events_since(0)
        jn, jev = jsvc.events_since(0)
        assert (tn, tev) == (jn, jev) and tn == len(tr.events) > 0
        assert tsvc.events_since(tn) == (tn, [])
        assert tsvc.events_since(tn - 1)[1] == tev[-1:]
    finally:
        tsvc.close()
        jsvc.close()


def test_monitor_service_queues_a_promote_landing_mid_rescore(pair):
    pair.tidx.close()
    gate = threading.Event()
    release = threading.Event()

    def slow_engine():
        gate.set()
        release.wait(WAIT_S)
        return pair.teng

    svc = twatch.MonitorService(pair.tidx.path, slow_engine, pair.root)
    try:
        assert svc.on_promote(pair.d1, pair.teng.db, pair.d2) is True
        assert gate.wait(WAIT_S)
        # lands while the first runs: queued, not stacked
        assert svc.on_promote(pair.d1, pair.teng.db, pair.d2) is False
        release.set()
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and svc._running:
            time.sleep(0.02)
        assert not svc._running and svc.last_error == ""
        assert svc.index.db_digest == pair.d2
    finally:
        release.set()
        svc.close()


def test_monitor_service_background_device_error_is_not_absorbed(pair):
    """A device error on the background re-score is recorded and raised
    on its thread; the index keeps its state and the next promote runs."""
    pair.tidx.close()

    class Broken:
        cdb = pair.teng.cdb

        def submit(self, _lists):
            raise RuntimeError("CUDA error: device-side assert triggered")

    seen = []
    old_hook = threading.excepthook
    threading.excepthook = lambda a: seen.append(a.exc_type)
    svc = twatch.MonitorService(pair.tidx.path, Broken, pair.root)
    try:
        svc.on_promote(pair.d1, pair.teng.db, pair.d2)
        for t in list(svc._threads):
            t.join(WAIT_S)
        assert seen == [RuntimeError]
        assert "CUDA error" in svc.last_error and not svc._running
        assert svc.index.db_digest == pair.d1
        svc._engine_fn = lambda: pair.teng
        svc.on_promote(pair.d1, pair.teng.db, pair.d2)
        for t in list(svc._threads):
            t.join(WAIT_S)
        assert svc.index.db_digest == pair.d2 and svc.last_error == ""
    finally:
        threading.excepthook = old_hook
        svc.close()


def test_open_index_rebuilds_from_a_journal(tmp_path):
    jpath = str(tmp_path / "j.jsonl")
    j = JaxJournal.create(jpath, "fs", ["t"], "fp")
    j.mark_done("t", {"Results": [{"Class": "lang-pkgs", "Type": "npm",
                                   "Packages": [{"Name": "a",
                                                 "Version": "1.0.0"}]}]})
    j.close()
    bad = tmp_path / "idx.jsonl"
    bad.write_text("garbage\n")
    idx = twatch.open_index(str(bad), journal_path=jpath)
    try:
        assert idx.artifacts() == ["t"]
    finally:
        idx.close()
    bad.write_text("garbage\n")
    idx = twatch.open_index(str(bad))  # no journal: moved aside, fresh
    try:
        assert idx.artifacts() == []
    finally:
        idx.close()


def test_budget_env(monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_DELTA_BUDGET_S", "2.5")
    assert twatch.budget_s() == 2.5
    monkeypatch.setenv("TRIVY_TPU_DELTA_BUDGET_S", "soon")
    assert twatch.budget_s() is None


# ===================================================== CLI and server


def _cli(entry, argv, capsys) -> tuple[int, str, str]:
    rc = entry(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.fixture()
def fixture_dbs(tmp_path, monkeypatch):
    """test_fanal's fixture DB saved once, a project with a lockfile, an
    alpine rootfs and the golden SBOM; pinned clock and uuids."""
    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", "2024-01-01T00:00:00+00:00")
    monkeypatch.setenv("TRIVY_TPU_DETERMINISTIC_UUID", "1")
    _fixture_db().save(str(tmp_path / "db"))
    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "package-lock.json").write_text(PACKAGE_LOCK)
    rootfs = tmp_path / "rootfs"
    _mk_rootfs(rootfs)
    (tmp_path / "bom.json").write_text(json.dumps(test_sbom_e2e.CDX_DOC))
    return tmp_path


def _scan_both(kind, target, d, capsys, extra=()):
    """One --monitor-index scan in each package -> (port index, ref
    index) paths."""
    out = {}
    for name, entry, dev in (("port", main, ["--device", "cpu"]),
                             ("ref", jax_main.main, ["--no-tpu"])):
        port_uuid.reset()
        jax_uuid.reset()
        idx = str(d / f"{name}-mon.jsonl")
        rc, _o, err = _cli(entry, [kind, *([target] if target else []),
                                   "--format", "json",
                                   "--output", str(d / f"{name}.json"),
                                   "--db-path", str(d / "db"),
                                   "--cache-dir", str(d / f"{name}-c"),
                                   "--quiet", "--scanners", "vuln",
                                   "--monitor-index", idx, *dev, *extra],
                           capsys)
        assert rc == 0, err
        out[name] = idx
    return out


@pytest.mark.parametrize("kind", ["sbom", "fs", "rootfs", "image"])
def test_scan_monitor_index_equals_reference(fixture_dbs, capsys, kind):
    """The capture follows the scan onto its worker thread: the port's
    CLI records the reference's packages and findings."""
    d = fixture_dbs
    if kind == "image":
        from test_image_tar_golden import _fixture_tar

        paths = _scan_both(kind, None, d, capsys,
                           extra=("--input", _fixture_tar(d)))
    else:
        target = {"sbom": str(d / "bom.json"), "fs": str(d / "proj"),
                  "rootfs": str(d / "rootfs")}[kind]
        paths = _scan_both(kind, target, d, capsys)
    t = tmon.MonitorIndex.open(paths["port"])
    j = jmon.MonitorIndex.open(paths["ref"])
    try:
        assert index_state(t) == index_state(j)
        (aid,) = t.artifacts()
        assert t.packages_of(aid) and t.findings_of(aid)
        assert t.db_digest == tcache.db_digest(str(d / "db"))
    finally:
        t.close()
        j.close()
    assert Path(paths["port"]).read_bytes() == Path(paths["ref"]).read_bytes()


def test_scan_then_watch_once_equals_reference(fixture_dbs, capsys):
    d = fixture_dbs
    paths = _scan_both("fs", str(d / "proj"), d, capsys)
    db2 = _fixture_db()
    db2.put_advisory("npm::g", "lodash", JaxAdvisory(
        vulnerability_id="CVE-2099-0001", vulnerable_versions=["<5.0.0"]))
    db2.save(str(d / "db"))
    outs = {}
    for name, entry, dev in (("port", main, ["--device", "cpu"]),
                             ("port-host", main, ["--no-tpu"]),
                             ("ref", jax_main.main, ["--no-tpu"])):
        idx = paths["ref" if name == "ref" else "port"]
        if name == "port-host":
            idx = str(d / "host-mon.jsonl")
            shutil.copy(paths["port"] + ".orig", idx)
        else:
            shutil.copy(idx, idx + ".orig")
        port_uuid.reset()
        jax_uuid.reset()
        rc, out, err = _cli(entry, ["watch", "--db-path", str(d / "db"),
                                    "--index", idx, "--once", "--verify",
                                    "--cache-dir", str(d / f"{name}-w"),
                                    "--quiet", *dev], capsys)
        assert rc == 0, err
        outs[name] = lines_without_duration(out)
    assert outs["port"] == outs["ref"] == outs["port-host"]
    events = [ln for ln in outs["port"] if ln["event"] != "rescore"]
    assert [(e["event"], e["name"], e["vuln_id"]) for e in events] == \
        [("introduced", "lodash", "CVE-2099-0001")]
    assert outs["port"][-1]["rematched"] == 1


def test_watch_with_a_mesh_gives_the_same_events(pair, capsys, monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_DETERMINISTIC_UUID", "1")
    pair.tidx.close()
    base = pair.tidx.path
    outs = {}
    for name, mesh in (("plain", []), ("mesh", ["--mesh", "2x2"])):
        idx = str(pair.tmp / f"{name}.jsonl")
        shutil.copy(base, idx)
        port_uuid.reset()
        rc, out, err = _cli(main, ["watch", "--db-path", pair.root,
                                   "--index", idx, "--once", "--device",
                                   "cpu", "--quiet", "--cache-dir",
                                   str(pair.tmp / "wc"), *mesh], capsys)
        assert rc == 0, err
        outs[name] = lines_without_duration(out)
    assert outs["mesh"] == outs["plain"]
    assert len(outs["plain"]) > 1


def test_watch_output_file_appends(pair, capsys):
    pair.tidx.close()
    out_file = pair.tmp / "events.jsonl"
    out_file.write_text('{"event": "earlier"}\n')
    rc, out, err = _cli(main, ["watch", "--db-path", pair.root, "--index",
                               pair.tidx.path, "--once", "--device", "cpu",
                               "--quiet", "--output", str(out_file),
                               "--cache-dir", str(pair.tmp / "wc")], capsys)
    assert rc == 0 and out == "", err
    lines = out_file.read_text().splitlines()
    assert json.loads(lines[0]) == {"event": "earlier"}
    assert json.loads(lines[-1])["event"] == "rescore"


def test_watch_without_a_card_fails_with_one_line(pair, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pair.tidx.close()
    rc, out, err = _cli(main, ["watch", "--db-path", pair.root, "--index",
                               pair.tidx.path, "--once", "--cache-dir",
                               str(pair.tmp / "wc")], capsys)
    lines = [ln for ln in err.splitlines() if ln.strip()]
    assert rc == 1 and out == "" and len(lines) == 1
    assert "CUDA" in lines[0] and "--no-tpu" in lines[0]
    # nothing was re-scored
    idx = tmon.MonitorIndex.open(pair.tidx.path)
    try:
        assert idx.db_digest == pair.d1
    finally:
        idx.close()


def test_monitor_kill_switch(fixture_dbs, capsys, monkeypatch):
    d = fixture_dbs
    monkeypatch.setenv("TRIVY_TPU_MONITOR", "0")
    assert not tmon.enabled()
    idx = str(d / "mon.jsonl")
    rc, _o, err = _cli(main, ["fs", str(d / "proj"), "--db-path",
                              str(d / "db"), "--cache-dir", str(d / "c"),
                              "--device", "cpu", "--quiet", "--scanners",
                              "vuln", "--monitor-index", idx], capsys)
    assert rc == 0 and not os.path.exists(idx), err
    rc, out, err = _cli(main, ["watch", "--db-path", str(d / "db"),
                               "--index", idx, "--once", "--device", "cpu",
                               "--cache-dir", str(d / "c")], capsys)
    assert rc == 1 and out == "" and "TRIVY_TPU_MONITOR=0" in err
    svc = ScanService(MatchEngine(AdvisoryDB.load(str(d / "db")),
                                  device="cpu"), MemoryCache(),
                      db_path=str(d / "db"), monitor_index=idx)
    try:
        assert svc.monitor is None and svc.ready_doc()["monitor"] is False
    finally:
        svc.close()


def test_client_mode_ignores_monitor_index(fixture_dbs, capsys):
    d = fixture_dbs
    eng = MatchEngine(AdvisoryDB.load(str(d / "db")), device="cpu")
    srv = Server(eng, MemoryCache(), host="127.0.0.1", port=0)
    srv.start()
    try:
        idx = str(d / "mon.jsonl")
        rc, _o, err = _cli(main, ["sbom", str(d / "bom.json"), "--server",
                                  srv.address, "--device", "cpu",
                                  "--cache-dir", str(d / "c"),
                                  "--monitor-index", idx], capsys)
        assert rc == 0 and not os.path.exists(idx)
        assert "ignored in client mode" in err
    finally:
        close_pool()
        srv.shutdown()


# ------------------------------------------------------------- server


def _blob(pkgs) -> dict:
    apps = {}
    for space, name, version, _scheme in pkgs:
        eco = space.rstrip(":")
        apps.setdefault(eco, []).append(
            {"id": f"{name}@{version}", "name": name, "version": version,
             "identifier": {"purl": f"pkg:{eco}/{name}@{version}"}})
    return {"schema_version": 2, "applications": [
        {"type": eco, "file_path": f"{eco}.lock", "packages": ps}
        for eco, ps in sorted(apps.items())]}


def _lang_pkgs(pkgs):
    return [p for p in pkgs if p[0] in ("npm::", "pip::")]


@contextlib.contextmanager
def services(root: str, tmp: Path, **kw):
    """A port and a reference ScanService with a monitor index on `root`
    (flat layout), both at its current DB."""
    teng = MatchEngine(AdvisoryDB.load(root), device="cpu", db_path=root)
    jeng = JaxEngine(JaxAdvisoryDB.load(root), use_device=False,
                     db_path=root)
    tsvc = ScanService(teng, MemoryCache(), db_path=root,
                       monitor_index=str(tmp / "srv-t.jsonl"), **kw)
    jsvc = JaxScanService(jeng, JaxMemoryCache(), db_path=root,
                          monitor_index=str(tmp / "srv-j.jsonl"), **kw)
    try:
        yield tsvc, jsvc
    finally:
        tsvc.close()
        if jsvc.scheduler is not None:
            jsvc.scheduler.close()
        jsvc.monitor.close()


def _record_scans(tsvc, jsvc, arts):
    for aid, pkgs in arts:
        blob = _blob(_lang_pkgs(pkgs))
        tsvc.cache.put_blob(f"sha256:{aid}", blob)
        jsvc.cache.put_blob(f"sha256:{aid}", blob)
        tsvc.scan(aid, "", [f"sha256:{aid}"], ScanOptions())
        jsvc.scan(aid, "", [f"sha256:{aid}"], JaxScanOptions())


def _wait_events(svc, n_min: int = 1):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if not svc.monitor._running:
            nxt, ev = svc.monitor.events_since(0)
            if len(ev) >= n_min:
                return nxt, ev
        time.sleep(0.02)
    return svc.monitor.events_since(0)


@pytest.mark.parametrize("sched", ["on", "off"])
def test_server_hot_swap_fills_events_equal_to_reference(tmp_path,
                                                         monkeypatch,
                                                         sched):
    monkeypatch.setenv("TRIVY_TPU_DETERMINISTIC_UUID", "1")
    if sched == "off":
        monkeypatch.setenv("TRIVY_TPU_SCHED", "0")
    root = str(tmp_path / "db")
    spec_a = seeded_spec()
    build_db(spec_a, "2026-01-01").save(root)
    arts = seeded_artifacts(spec_a, 12)
    with services(root, tmp_path) as (tsvc, jsvc):
        assert (tsvc.scheduler is None) == (sched == "off")
        assert tsvc.ready_doc()["monitor"] is True
        _record_scans(tsvc, jsvc, arts)
        assert index_state(tsvc.monitor.index) == \
            index_state(jsvc.monitor.index)
        build_db(mutate(spec_a), "2026-01-02").save(root)
        port_uuid.reset()
        jax_uuid.reset()
        assert tsvc.maybe_reload_db() is True
        assert jsvc.maybe_reload_db() is True
        tn, tev = _wait_events(tsvc)
        jn, jev = _wait_events(jsvc)
        assert tev and (tn, tev) == (jn, jev)
        assert tsvc.monitor.index.db_digest == tcache.db_digest(root)
        assert index_state(tsvc.monitor.index) == \
            index_state(jsvc.monitor.index)
        assert_zero_diff(tsvc.monitor.index, tsvc.engine)


def test_server_scan_stamp_is_read_before_the_scan(tmp_path):
    root = str(tmp_path / "db")
    build_db(seeded_spec(), "2026-01-01").save(root)
    with services(root, tmp_path) as (tsvc, _jsvc):
        stamp = tsvc._db_digest
        real = tsvc._scan_admitted

        def swap_mid_scan(*a, **kw):
            out = real(*a, **kw)
            tsvc._db_digest = "sha256-newer"
            return out

        tsvc._scan_admitted = swap_mid_scan
        pkgs = [("npm::", "n1", "1.0.0", "npm")]
        tsvc.cache.put_blob("sha256:x", _blob(pkgs))
        tsvc.scan("x", "", ["sha256:x"], ScanOptions())
        tsvc.monitor.index.close()
        idx = tmon.MonitorIndex.open(tsvc.monitor.index.path)
        try:
            assert idx._artifacts["x"]["db"] == stamp
        finally:
            idx.close()


def test_events_endpoint_answers_as_the_reference(tmp_path):
    root = str(tmp_path / "db")
    build_db(seeded_spec(), "2026-01-01").save(root)
    teng = MatchEngine(AdvisoryDB.load(root), device="cpu")
    jeng = JaxEngine(JaxAdvisoryDB.load(root), use_device=False)
    kw = dict(host="127.0.0.1", port=0, token="tok", db_path=root)
    t = Server(teng, MemoryCache(), monitor_index=str(tmp_path / "t.jsonl"),
               **kw)
    j = JaxServer(jeng, JaxMemoryCache(),
                  monitor_index=str(tmp_path / "j.jsonl"), **kw)
    plain = Server(teng, MemoryCache(), host="127.0.0.1", port=0)
    jplain = JaxServer(jeng, JaxMemoryCache(), host="127.0.0.1", port=0)
    for s in (t, j, plain, jplain):
        s.start()
    try:
        def get(srv, path, token="tok"):
            req = urllib.request.Request(srv.address + path)
            if token:
                req.add_header("Trivy-Token", token)
            try:
                with urllib.request.urlopen(req, timeout=10) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()

        for path, token in (("/monitor/events?since=0", "tok"),
                            ("/monitor/events", "tok"),
                            ("/monitor/events?since=x", "tok"),
                            ("/monitor/events?since=0", "bad"),
                            ("/monitor/events?since=0", None)):
            assert get(t, path, token) == get(j, path, token), path
        assert get(t, "/monitor/events?since=0") == \
            (200, b'{"next": 0, "events": []}')
        # without --monitor-index: the reference's 404 body
        got = get(plain, "/monitor/events?since=0", None)
        assert got == get(jplain, "/monitor/events?since=0", None)
        assert got[0] == 404 and json.loads(got[1]) == {
            "error": "monitor not enabled (--monitor-index)"}
    finally:
        close_pool()
        for s in (t, j, plain, jplain):
            s.shutdown()


def test_watch_server_once_prints_the_reference_lines(tmp_path, capsys,
                                                      monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_DETERMINISTIC_UUID", "1")
    root = str(tmp_path / "db")
    spec_a = seeded_spec()
    build_db(spec_a, "2026-01-01").save(root)
    arts = seeded_artifacts(spec_a, 8)
    teng = MatchEngine(AdvisoryDB.load(root), device="cpu", db_path=root)
    jeng = JaxEngine(JaxAdvisoryDB.load(root), use_device=False,
                     db_path=root)
    kw = dict(host="127.0.0.1", port=0, db_path=root)
    t = Server(teng, MemoryCache(), monitor_index=str(tmp_path / "t.jsonl"),
               **kw)
    j = JaxServer(jeng, JaxMemoryCache(),
                  monitor_index=str(tmp_path / "j.jsonl"), **kw)
    for s in (t, j):
        s.start()
    try:
        _record_scans(t.service, j.service, arts)
        build_db(mutate(spec_a), "2026-01-02").save(root)
        port_uuid.reset()
        jax_uuid.reset()
        assert t.service.maybe_reload_db() and j.service.maybe_reload_db()
        _wait_events(t.service)
        _wait_events(j.service)
        outs = {}
        for name, entry, srv in (("port", main, t),
                                 ("ref", jax_main.main, j),
                                 ("port-on-ref", main, j)):
            rc, out, err = _cli(entry, ["watch", "--server", srv.address,
                                        "--once", "--quiet"], capsys)
            assert rc == 0, err
            outs[name] = out
        # equal but the trace ids, which each server draws at random
        assert lines_without_duration(outs["port"]) == \
            lines_without_duration(outs["ref"])
        assert outs["port-on-ref"] == outs["ref"]
        assert all("trace_id" in d for out in (outs["port"], outs["ref"])
                   for d in map(json.loads, out.splitlines()))
        assert outs["port"].count("\n") == \
            len(t.service.monitor.events_since(0)[1]) > 0
    finally:
        close_pool()
        for s in (t, j):
            s.shutdown()


def test_watch_remote_survives_an_unreachable_server(capsys):
    out = io.StringIO()
    assert twatch.watch_remote("http://127.0.0.1:9", out, once=True) == 0
    assert out.getvalue() == ""


def test_server_command_accepts_monitor_index(fixture_dbs, monkeypatch):
    """`server --monitor-index` passes the path through run_server."""
    d = fixture_dbs
    seen = {}
    import trivy_tpu_torch.rpc.server as server_mod

    monkeypatch.setattr(server_mod, "serve",
                        lambda engine, **kw: seen.update(kw))
    rc = main(["server", "--db-path", str(d / "db"), "--device", "cpu",
               "--listen", "127.0.0.1:0", "--monitor-index",
               str(d / "m.jsonl"), "--cache-dir", str(d / "c")])
    assert rc == 0 and seen["monitor_index"] == str(d / "m.jsonl")


def test_monitor_index_from_env_reaches_the_scan(fixture_dbs, capsys,
                                                 monkeypatch):
    d = fixture_dbs
    monkeypatch.setenv("TRIVY_TPU_MONITOR_INDEX", str(d / "env.jsonl"))
    rc, _o, err = _cli(main, ["fs", str(d / "proj"), "--db-path",
                              str(d / "db"), "--cache-dir", str(d / "c"),
                              "--device", "cpu", "--quiet", "--scanners",
                              "vuln"], capsys)
    assert rc == 0, err
    idx = tmon.MonitorIndex.open(str(d / "env.jsonl"))
    try:
        assert idx.artifacts() == [str(d / "proj")]
    finally:
        idx.close()


# --------------------------------------------------------------- card


@pytest.mark.cuda
def test_cuda_rescore_equals_the_cpu(tmp_path):
    """On a card: a two-generation re-score through the match kernel,
    on the engine and on a 2x2 mesh with every cell on cuda:0 (what
    `watch --mesh` re-matches on), equals the CPU's events and state,
    with the kernel launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the match kernel has no CPU mode")
    from trivy_tpu_torch.device import build_mesh
    from trivy_tpu_torch.ops import match as tm

    p = Pair(tmp_path)
    try:
        _jplan, tplan = p.plans()
        cpu_idx = str(tmp_path / "cpu.jsonl")
        shutil.copy(p.tidx.path, cpu_idx)
        cpu = tmon.rescore(p.teng, p.tidx, tplan, verify=True)
        card = torch.device("cuda", 0)
        for name, kw in (("engine", {}),
                         ("mesh", {"mesh": build_mesh(2, 2,
                                                      devices=[card] * 4)})):
            eng = MatchEngine(AdvisoryDB.load(p.root), device=card,
                              db_path=p.root, **kw)
            path = str(tmp_path / f"{name}.jsonl")
            shutil.copy(cpu_idx, path)
            gidx = tmon.MonitorIndex.open(path)
            try:
                launches = tm.match_words.launches
                got = tmon.rescore(eng, gidx, tplan, verify=True)
                assert tm.match_words.launches > launches, name
                assert fields(got) == fields(cpu), name
                assert got.verified is True
                assert index_state(gidx) == index_state(p.tidx), name
            finally:
                gidx.close()
    finally:
        p.close()
