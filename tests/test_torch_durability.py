"""Port parity, the durability layer the monitor rides on:
trivy_tpu_torch.durability (the append log, the scan journal, the
atomic write's fault injector) and the durability fault kinds of
resilience.faults, against the JAX package's trivy_tpu.durability.

The shapes are tests/test_durability.py's journal tests plus the append
log's torn tail, bit flip, salvage, drop / error / kill actions and
atomic compaction. Files written by one package are replayed by the
other; the tolerance is exact equality of the replayed records, the
journal's done / failed / layer sets and the bytes on disk.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

from trivy_tpu.durability import AppendLog as JaxAppendLog
from trivy_tpu.durability import ScanJournal as JaxJournal
from trivy_tpu.durability import journal as jjournal
from trivy_tpu.resilience import faults as jfaults
from trivy_tpu_torch.durability import (
    AppendLog,
    AppendLogError,
    JournalError,
    ScanJournal,
    atomic,
    journal,
)
from trivy_tpu_torch.resilience import faults

pytestmark = pytest.mark.durability

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _reset():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


# ------------------------------------------------------------ journal


def test_journal_create_resume_roundtrip(tmp_path):
    p = str(tmp_path / "j.jsonl")
    j = ScanJournal.create(p, "image", ["t1", "t2"], "sha256:fp")
    j.mark_running("t1")
    j.mark_done("t1", {"ArtifactName": "t1", "Results": []})
    j.mark_running("t2")
    j.mark_failed("t2", "boom")
    j.mark_layer("sha256:l1")
    j.mark_layer("sha256:l1")  # once per fleet
    j.close()
    r = ScanJournal.resume(p)
    assert r.targets == ["t1", "t2"]
    assert r.command == "image" and r.fingerprint == "sha256:fp"
    assert list(r.done) == ["t1"]
    assert r.done["t1"]["ArtifactName"] == "t1"
    assert r.failed == {"t2": "boom"}
    assert r.layers == {"sha256:l1"}
    r.mark_done("t2", {"ArtifactName": "t2", "Results": []})
    r.close()
    r2 = ScanJournal.resume(p)
    assert sorted(r2.done) == ["t1", "t2"] and not r2.failed
    r2.close()


def test_journal_torn_tail_tolerated_and_truncated(tmp_path):
    p = str(tmp_path / "j.jsonl")
    j = ScanJournal.create(p, "fs", ["t1", "t2"], "fp")
    j.mark_done("t1", {"Results": []})
    j.close()
    with open(p, "ab") as f:
        f.write(b'{"kind":"done","target":"t2","dig')
    r = ScanJournal.resume(p)
    assert list(r.done) == ["t1"]
    r.mark_done("t2", {"Results": []})
    r.close()
    r2 = ScanJournal.resume(p)
    assert sorted(r2.done) == ["t1", "t2"]
    r2.close()


@pytest.mark.parametrize("action", ["torn-write", "bitflip"])
def test_journal_rotted_done_record_reruns_artifact(tmp_path, action):
    # the 4th append: header, pending, running, DONE
    faults.install_spec(f"journal.append:{action}@4")
    p = str(tmp_path / "j.jsonl")
    j = ScanJournal.create(p, "fs", ["t1"], "fp")
    j.mark_running("t1")
    j.mark_done("t1", {"Results": [], "ArtifactName": "t1"})
    j.close()
    faults.reset()
    r = ScanJournal.resume(p)
    assert r.done == {}
    r.close()
    ref = JaxJournal.resume(p)
    assert ref.done == {}
    ref.close()


def test_journal_refuses_duplicate_create_and_missing(tmp_path):
    p = str(tmp_path / "j.jsonl")
    ScanJournal.create(p, "fs", ["t"], "fp").close()
    with pytest.raises(JournalError, match="already exists"):
        ScanJournal.create(p, "fs", ["t"], "fp")
    with pytest.raises(JournalError):
        ScanJournal.resume(str(tmp_path / "nope.jsonl"))


def test_journal_of_another_version_is_refused(tmp_path):
    p = tmp_path / "j.jsonl"
    p.write_text('{"kind":"header","v":7}\n')
    with pytest.raises(JournalError, match="version 7"):
        ScanJournal.resume(str(p))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journal_bytes_equal_and_cross_replay(tmp_path, writer):
    """Both packages write the same bytes, and each resumes the other's
    journal to the same done / failed / layer sets."""
    paths = {}
    for name, cls in (("port", ScanJournal), ("reference", JaxJournal)):
        p = str(tmp_path / f"{name}.jsonl")
        j = cls.create(p, "image", ["a", "b", "c"], "sha256:fp")
        j.mark_running("a")
        j.mark_layer("sha256:x")
        j.mark_done("a", {"Results": [{"Target": "a", "Z": 1, "A": [2]}]})
        j.mark_failed("b", "boom")
        j.close()
        paths[name] = p
    assert Path(paths["port"]).read_bytes() == \
        Path(paths["reference"]).read_bytes()
    src = paths[writer]
    t, r = ScanJournal.resume(src), JaxJournal.resume(src)
    try:
        assert (t.done, t.failed, t.layers, t.header) == \
            (r.done, r.failed, r.layers, r.header)
    finally:
        t.close()
        r.close()


def test_journal_helpers_equal_reference():
    import argparse

    doc = {"b": [1, {"y": 2, "x": 1}], "a": "é"}
    assert journal.canonical_json(doc) == jjournal.canonical_json(doc)
    assert journal.report_digest(doc) == jjournal.report_digest(doc)
    args = argparse.Namespace(scanners="vuln", severity="HIGH",
                              vex=["a.json"], skip_dirs=["x"])
    assert journal.options_fingerprint("fs", args) == \
        jjournal.options_fingerprint("fs", args)
    assert journal.options_fingerprint("fs", args) != \
        journal.options_fingerprint("image", args)


@pytest.mark.fault
def test_journal_kill_before_the_write(tmp_path):
    faults.set_kill_mode("raise")
    faults.install_spec("journal.append:kill@3")
    p = str(tmp_path / "j.jsonl")
    j = ScanJournal.create(p, "fs", ["t1"], "fp")
    with pytest.raises(faults.InjectedKill):
        j.mark_running("t1")
    j.close()
    faults.reset()
    assert Path(p).read_text().count("\n") == 2  # header, pending


# ---------------------------------------------------------- append log


def _log(path, header=None):
    return AppendLog.create(path, header or {"v": 1, "purpose": "test"},
                            fault_site="monitor.index")


def test_appendlog_create_replay_roundtrip_and_bytes(tmp_path):
    for name, cls in (("port", AppendLog), ("ref", JaxAppendLog)):
        log = cls.create(str(tmp_path / f"{name}.jsonl"), {"v": 1},
                         fault_site="monitor.index")
        for i in range(3):
            log.append({"kind": "r", "i": i})
        assert log.records_written == 4
        log.close()
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()
    log, recs = AppendLog.replay(str(tmp_path / "ref.jsonl"))
    try:
        assert log.header == {"v": 1, "kind": "header"}
        assert recs == [{"kind": "r", "i": i} for i in range(3)]
        assert log.records_written == 4
    finally:
        log.close()


def test_appendlog_refuses_to_clobber(tmp_path):
    _log(str(tmp_path / "l.jsonl")).close()
    with pytest.raises(AppendLogError, match="already exists"):
        _log(str(tmp_path / "l.jsonl"))


def test_appendlog_torn_tail_truncated(tmp_path):
    p = str(tmp_path / "l.jsonl")
    log = _log(p)
    log.append({"kind": "r", "i": 1})
    log.close()
    with open(p, "ab") as f:
        f.write(b'{"kind":"r","i":2')  # torn
    log, recs = AppendLog.replay(p)
    assert recs == [{"kind": "r", "i": 1}]
    log.append({"kind": "r", "i": 3})  # starts a clean line
    log.close()
    jlog, jrecs = JaxAppendLog.replay(p)
    jlog.close()
    assert jrecs == [{"kind": "r", "i": 1}, {"kind": "r", "i": 3}]


@pytest.mark.fault
@pytest.mark.parametrize("action", ["torn-write", "bitflip"])
def test_appendlog_rotted_record_skipped_at_replay(tmp_path, action):
    p = str(tmp_path / "l.jsonl")
    log = _log(p)
    faults.install_spec(f"monitor.index:{action}@1")
    log.append({"kind": "r", "payload": "x" * 64})
    faults.reset()
    log.append({"kind": "r", "i": 2})
    log.close()
    _log2, recs = AppendLog.replay(p)
    _log2.close()
    jl, jrecs = JaxAppendLog.replay(p)
    jl.close()
    # a torn record merges with the next line: both unparsable, or the
    # flip landed where JSON still parses with different bytes
    assert recs == jrecs
    assert {"kind": "r", "payload": "x" * 64} not in recs


@pytest.mark.fault
def test_appendlog_error_and_drop_actions(tmp_path):
    p = str(tmp_path / "l.jsonl")
    log = _log(p)
    faults.install_spec("monitor.index:error@1;monitor.index:drop@2")
    with pytest.raises(AppendLogError, match="injected append failure"):
        log.append({"kind": "r", "i": 1})
    log.append({"kind": "r", "i": 2})  # silently lost
    log.append({"kind": "r", "i": 3})
    log.close()
    faults.reset()
    _l, recs = AppendLog.replay(p)
    _l.close()
    assert recs == [{"kind": "r", "i": 3}]


@pytest.mark.fault
def test_appendlog_kill_dies_before_the_write(tmp_path):
    p = str(tmp_path / "l.jsonl")
    log = _log(p)
    faults.set_kill_mode("raise")
    faults.install_spec("monitor.index:kill@1")
    with pytest.raises(faults.InjectedKill):
        log.append({"kind": "r", "i": 1})
    log.close()
    faults.reset()
    _l, recs = AppendLog.replay(p)
    _l.close()
    assert recs == []


def test_appendlog_salvages_a_torn_header(tmp_path):
    p = str(tmp_path / "l.jsonl")
    faults.install_spec("monitor.index:torn-write@1")
    log = _log(p)  # the header append tears
    faults.reset()
    log.append({"kind": "r", "i": 1})  # merges with the torn fragment
    log.append({"kind": "r", "i": 2})
    log.close()
    with pytest.raises(AppendLogError, match="no header"):
        AppendLog.replay(p)
    log, recs = AppendLog.salvage(p, {"v": 1, "purpose": "test"},
                                  fault_site="monitor.index")
    log.close()
    assert recs == [{"kind": "r", "i": 2}]
    jl, jrecs = JaxAppendLog.replay(p)
    jl.close()
    assert jrecs == recs


def test_appendlog_rewrite_is_atomic(tmp_path):
    p = str(tmp_path / "l.jsonl")
    log = _log(p)
    for i in range(5):
        log.append({"kind": "r", "i": i})
    log.rewrite([{"kind": "r", "i": 9}])
    assert log.records_written == 2
    log.append({"kind": "r", "i": 10})
    log.close()
    _l, recs = AppendLog.replay(p)
    _l.close()
    assert recs == [{"kind": "r", "i": 9}, {"kind": "r", "i": 10}]


@pytest.mark.fault
def test_appendlog_kill_at_commit_keeps_the_previous_log(tmp_path):
    p = str(tmp_path / "l.jsonl")
    log = _log(p)
    log.append({"kind": "r", "i": 1})
    before = Path(p).read_bytes()
    faults.set_kill_mode("raise")
    # the rewrite probes the site twice: its payload (1), then the
    # commit between the tmp write and the rename (2)
    faults.install_spec("monitor.index:kill@2")
    with pytest.raises(faults.InjectedKill):
        log.rewrite([{"kind": "r", "i": 2}])
    faults.reset()
    assert Path(p).read_bytes() == before
    assert [n for n in os.listdir(tmp_path) if ".tmp-" in n]  # stale tmp
    with pytest.raises(AppendLogError, match="closed"):
        log.append({"kind": "r", "i": 3})


def test_appendlog_closed_refuses_appends(tmp_path):
    log = _log(str(tmp_path / "l.jsonl"))
    log.close()
    with pytest.raises(AppendLogError, match="closed"):
        log.append({"kind": "r"})


def test_appendlog_sigkill_in_a_subprocess(tmp_path):
    p = str(tmp_path / "l.jsonl")
    script = (
        "from trivy_tpu_torch.durability import AppendLog\n"
        f"log = AppendLog.create({p!r}, {{'v': 1}}, "
        "fault_site='journal.append')\n"
        "for i in range(10):\n"
        "    log.append({'kind': 'r', 'i': i})\n"
        "print('UNREACHABLE')\n")
    env = {**os.environ, "TRIVY_TPU_FAULTS": "journal.append:kill@4"}
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    _l, recs = AppendLog.replay(p)
    _l.close()
    assert recs == [{"kind": "r", "i": 0}, {"kind": "r", "i": 1}]


# ---------------------------------------------------- atomic + faults


@pytest.mark.fault
@pytest.mark.parametrize("action", ["torn-write", "bitflip"])
def test_atomic_write_mangles_at_a_ported_site(tmp_path, action):
    body = atomic.frame(b"payload" * 20)
    faults.install_spec(f"monitor.index:{action}@1")
    atomic.atomic_write(str(tmp_path / "e"), body, fault_site="monitor.index")
    faults.reset()
    raw = (tmp_path / "e").read_bytes()
    if action == "torn-write":
        # the footer went with the tail: the reader's parser is the
        # integrity check then
        assert raw == body[:len(body) // 2]
    else:
        with pytest.raises(atomic.CorruptEntry):
            atomic.unframe(raw)


def test_atomic_write_fires_nothing_at_an_unported_site(tmp_path):
    """A write site no call site of the package names (here
    `compile_cache.load`) is not in the grammar: no rule can name it,
    and a rule on another site does not reach it."""
    faults.install_spec("monitor:kill;compile_cache.save:kill")
    faults.set_kill_mode("raise")
    atomic.atomic_write(str(tmp_path / "e"), b"x",
                        fault_site="compile_cache.load")
    assert (tmp_path / "e").read_bytes() == b"x"
    with pytest.raises(faults.FaultSpecError, match="fired nowhere"):
        faults.FaultPlan.from_spec("compile_cache.load:kill")


@pytest.mark.parametrize("spec", [
    "journal.append:kill@1", "journal.append:torn-write=0.3",
    "journal.append:bitflip=5", "monitor.index:drop@p0.5",
    "monitor.index:error", "monitor.index:kill@2+",
    "monitor.index:torn-write", "monitor.index:bitflip",
    "monitor.rematch:drop", "monitor.rematch:delay=0.01",
    "monitor.rematch:error@1", "monitor.rematch:kill",
    "monitor:drop", "journal:kill"])
def test_monitor_fault_specs_compile_like_the_reference(spec):
    port = faults.FaultPlan.from_spec(spec)
    ref = jfaults.FaultPlan.from_spec(spec)
    assert [(r.site, r.action, r.param, r.start, r.stop, r.prob)
            for r in port.rules] == \
        [(r.site, r.action, r.param, r.start, r.stop, r.prob)
         for r in ref.rules]


@pytest.mark.parametrize("spec", ["monitor.index:delay",
                                  "monitor.rematch:torn-write",
                                  "journal.append:drop",
                                  "db.save:drop",
                                  "cache.write:delay",
                                  "fleet.scan:torn-write"])
def test_other_durability_specs_are_refused(spec):
    with pytest.raises(faults.FaultSpecError):
        faults.FaultPlan.from_spec(spec)


def test_mangle_write_equals_reference():
    data = bytes(range(200))
    for spec in ("monitor.index:torn-write", "monitor.index:torn-write=0.2",
                 "monitor.index:bitflip", "monitor.index:bitflip=7",
                 "monitor.index:bitflip=1000"):
        faults.install_spec(spec)
        jfaults.install_spec(spec)
        assert faults.mangle_write("monitor.index", data) == \
            jfaults.mangle_write("monitor.index", data)
    faults.reset()
    assert faults.mangle_write("monitor.index", data) == data


def test_kill_mode_is_validated_and_reset():
    with pytest.raises(ValueError):
        faults.set_kill_mode("maybe")
    faults.set_kill_mode("raise")
    faults.reset()
    assert faults._kill_mode == "sigkill"


# ------------------------------------------- the durable write sites


def _saved_db_files(pkg: str, root: Path) -> dict:
    """The fixture DB of tests/test_durability.py saved uncompressed
    by `pkg`'s AdvisoryDB (no gzip mtime) -> its files' bytes, or the
    exception type the save raised."""
    if pkg == "port":
        from trivy_tpu_torch.db import Advisory, AdvisoryDB
        from trivy_tpu_torch.db.model import VulnerabilityMeta
    else:
        from trivy_tpu.db import Advisory, AdvisoryDB
        from trivy_tpu.db.model import VulnerabilityMeta
    db = AdvisoryDB()
    db.put_advisory("npm::ghsa", "lodash", Advisory(
        vulnerability_id="CVE-2019-10744",
        vulnerable_versions=["<4.17.12"]))
    db.put_meta(VulnerabilityMeta.from_json("CVE-2019-10744", {
        "Title": "prototype pollution", "Severity": "CRITICAL"}))
    db.meta.updated_at = "2024-01-01T00:00:00Z"
    try:
        db.save(str(root), compress=False)
    except faults.InjectedKill:
        return {"raised": "InjectedKill"}
    except jfaults.InjectedKill:
        return {"raised": "InjectedKill"}
    out = {n: (root / n).read_bytes() for n in sorted(os.listdir(root))
           if ".tmp-" not in n}
    try:
        AdvisoryDB.load(str(root))
        out["load"] = "ok"
    except Exception as e:  # the reader's verdict on what landed
        out["load"] = type(e).__name__
    return out


@pytest.mark.fault
@pytest.mark.parametrize("site", ["db.save", "db.save.metadata"])
@pytest.mark.parametrize("action", ["kill", "torn-write", "bitflip"])
def test_db_save_sites_fire_like_the_reference(tmp_path, site, action):
    """`AdvisoryDB.save` under a rule at its data file's site or its
    metadata's: the same bytes land on disk in both packages (a kill
    between the tmp write and the rename leaves the file out), and the
    reader gives the same verdict."""
    got = {}
    for pkg, f in (("port", faults), ("ref", jfaults)):
        f.install_spec(f"{site}:{action}")
        f.set_kill_mode("raise")
        try:
            got[pkg] = _saved_db_files(pkg, tmp_path / pkg)
            assert any(r.fired for r in f.active().rules)
        finally:
            f.reset()
    assert got["port"] == got["ref"]
    if action == "kill":
        assert got["port"] == {"raised": "InjectedKill"}


@pytest.mark.fault
@pytest.mark.parametrize("action", ["kill", "torn-write", "bitflip"])
def test_cache_write_site_fires_like_the_reference(tmp_path, action):
    """`FSCache.put_blob` under cache.write: a torn or flipped entry is
    the same bytes in both packages and reads as a miss (evicted); a
    kill keeps the previous entry."""
    from trivy_tpu.cache.cache import FSCache as JaxFSCache
    from trivy_tpu_torch.cache.cache import FSCache

    blob = {"schema_version": 2, "applications": []}
    got = {}
    for pkg, f, cls in (("port", faults, FSCache),
                        ("ref", jfaults, JaxFSCache)):
        c = cls(str(tmp_path / pkg))
        c.put_blob("sha256:b", {"v": 1})
        f.install_spec(f"cache.write:{action}")
        f.set_kill_mode("raise")
        try:
            if action == "kill":
                with pytest.raises(f.InjectedKill):
                    c.put_blob("sha256:b", blob)
            else:
                c.put_blob("sha256:b", blob)
            assert any(r.fired for r in f.active().rules)
        finally:
            f.reset()
        with open(c._path("blob", "sha256:b"), "rb") as fh:
            raw = fh.read()
        got[pkg] = (raw, c.get_blob("sha256:b"))
    assert got["port"] == got["ref"]
    if action == "kill":
        assert got["port"][1] == {"v": 1}
    else:
        assert got["port"][1] == {}  # detected, evicted: a miss


@pytest.mark.fault
@pytest.mark.parametrize("action", ["kill", "torn-write", "bitflip"])
def test_compile_cache_save_site_fires(tmp_path, action):
    """The compiled-DB cache's save under compile_cache.save: a kill
    ends the build before the entry lands, a torn or flipped entry is
    quarantined by the next build (a miss and a recompile), and the
    engine's answers stay the oracle's."""
    from trivy_tpu_torch.db import Advisory, AdvisoryDB
    from trivy_tpu_torch.detector.engine import MatchEngine, PkgQuery

    db = AdvisoryDB()
    for i in range(12):
        db.put_advisory("npm::ghsa", f"pkg{i}", Advisory(
            vulnerability_id=f"CVE-2024-{1000 + i}",
            vulnerable_versions=[f"<{(i % 4) + 1}.0.0"]))
    root = str(tmp_path / "db")
    db.save(root)
    faults.install_spec(f"compile_cache.save:{action}")
    faults.set_kill_mode("raise")
    try:
        if action == "kill":
            with pytest.raises(faults.InjectedKill):
                MatchEngine(AdvisoryDB.load(root), window=16,
                            device="cpu", db_path=root)
        else:
            MatchEngine(AdvisoryDB.load(root), window=16, device="cpu",
                        db_path=root)
        assert any(r.fired for r in faults.active().rules)
    finally:
        faults.reset()
    e = MatchEngine(AdvisoryDB.load(root), window=16, device="cpu",
                    db_path=root)
    assert e.build_stats["compile_cache"] == "miss"
    qs = [PkgQuery("npm::", f"pkg{i % 12}", f"{i % 5}.1.0", "npm")
          for i in range(40)]
    assert [sorted(int(x) for x in r.adv_indices) for r in e.detect(qs)] \
        == [sorted(int(x) for x in r.adv_indices)
            for r in e.oracle_detect(qs)]
