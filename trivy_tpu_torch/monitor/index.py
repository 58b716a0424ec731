"""Durable inverted package→artifact index.

One JSONL append log (durability.appendlog) persisted next to the scan
journal.  Records after the header:

    {"kind": "artifact", "id": t,
     "packages": [[space, name, version, scheme], ...],
     "findings": [[space, name, version, scheme, vuln_id], ...] | null,
     "db": <generation digest the findings were matched against> | null,
     "digest": "sha256:..."}          last-write-wins per artifact id
    {"kind": "remove", "id": t}       artifact dropped from monitoring
    {"kind": "state", "db_digest": d, "window": w|null,
     "prev": d_old|null,
     "touched": [[space, name], ...] | null}
                                      a completed re-score's transition:
                                      the generation the index is now
                                      baselined at, which one it came
                                      from, and which advisory keys that
                                      delta touched (null = everything)

In memory the records expand into (a) per-artifact package inventory +
finding baseline and (b) the inverted (space, name) → {artifact ids}
map a delta plan intersects.  Every artifact record is digest-sealed
(like journal `done` records): a bit-flipped record is dropped at
replay and the artifact falls back to its previous valid record — the
monitor then re-baselines it rather than diffing against garbage.

Fault site ``monitor.index`` fires per append: `kill` crashes before
the write, `torn-write`/`bitflip` mangle it (caught at replay),
`error` raises (the caller marks the index degraded → next re-score
goes full), `drop` silently loses the record (an undetected lost
write; replay simply yields the older state, against which delta and
full re-scoring still agree — never a wrong answer).

The per-record ``db`` stamp closes the lost-write coherence hole: if a
``state`` record reached the disk while some artifact's update did
not (a dropped append, a crash between the two), the replayed log
would otherwise pair the new generation's state digest with an old
generation's finding baseline — and an incremental re-score would
trust it.  At replay, an artifact stamped with an older generation
keeps its baseline only when the recorded transition chain from its
stamp to the final state digest exists and touches NONE of its
(space, name) keys — by the delta invariant (monitor/delta.py) such
a baseline is identical at both ends.  Any gap in the chain, a
full ("touched everything") transition, or an intersection nulls the
baseline, which forces the artifact into the next re-score's
re-baseline set: more work, never a stale answer.

Copy of trivy_tpu/monitor/index.py (its lock a plain `threading.Lock`).
The file format is the reference's: an index written by either package
replays in the other to the same state.
"""

from __future__ import annotations

import hashlib
import json
import os

from trivy_tpu_torch.analysis.witness import make_lock
from trivy_tpu_torch.durability.appendlog import AppendLog, AppendLogError
from trivy_tpu_torch.log import logger

_log = logger("monitor.index")

FAULT_SITE = "monitor.index"
INDEX_VERSION = 1


class MonitorIndexError(Exception):
    pass


# a touched-key set larger than this is persisted as "everything" in
# the state record (the replay chain then re-baselines conservatively
# instead of the log carrying megabytes of key lists per promote)
MAX_TOUCHED_PERSIST = 4096


def _seal(rec: dict) -> str:
    body = {k: v for k, v in rec.items() if k != "digest"}
    return "sha256:" + hashlib.sha256(
        json.dumps(body, sort_keys=True,
                   separators=(",", ":")).encode()).hexdigest()


class MonitorIndex:
    """Writer + replayer for one monitor index file."""

    def __init__(self, log: AppendLog):
        self._log = log
        self._lock = make_lock("monitor.index._lock")
        # id -> {"packages": [tuple4...], "findings": set[tuple5]|None}
        self._artifacts: dict[str, dict] = {}
        self._inverted: dict[tuple[str, str], set[str]] = {}
        self.db_digest: str | None = None
        self.window = None
        # completed re-score transitions, in record order (replay only):
        # (prev_digest, new_digest, frozenset of touched keys | None)
        self._transitions: list[tuple] = []
        # non-empty when a durable append failed: the stored state may
        # be stale in unknown ways, so the next re-score goes full and
        # re-baselines every artifact (clearing this on success)
        self.degraded: str = ""

    # ------------------------------------------------------------ open

    @property
    def path(self) -> str:
        return self._log.path

    @classmethod
    def open(cls, path: str) -> "MonitorIndex":
        """Open (creating if missing) and replay. Raises
        MonitorIndexError when the file exists but is unusable — the
        caller decides between `rebuild_from_journal` and
        `open_or_reset`."""
        if not os.path.exists(path):
            log = AppendLog.create(
                path, {"v": INDEX_VERSION, "purpose": "monitor-index"},
                fault_site=FAULT_SITE)
            return cls(log)
        try:
            log, records = AppendLog.replay(path, fault_site=FAULT_SITE)
        except AppendLogError as e:
            raise MonitorIndexError(str(e))
        if log.header.get("v") != INDEX_VERSION:
            log.close()
            raise MonitorIndexError(
                f"monitor index {path} is version {log.header.get('v')}, "
                f"this build writes v{INDEX_VERSION}")
        idx = cls(log)
        last_stamp = None
        for rec in records:
            idx._apply(rec)
            if rec.get("kind") == "artifact" and rec.get("db"):
                last_stamp = rec["db"]
        if idx.db_digest is None:
            # no re-score ever recorded a state: adopt the generation
            # the most recent scan was matched against, so a fleet
            # scanned under X and watched later still gets its X→Y
            # delta instead of a silent re-baseline
            idx.db_digest = last_stamp
        # lost-write coherence (module docstring): a baseline stamped
        # with an older generation survives only when the recorded
        # transition chain from its stamp to the final state exists and
        # touches none of its keys — anything else re-baselines
        stale = 0
        for a in idx._artifacts.values():
            if a["findings"] is None or a["db"] == idx.db_digest:
                continue
            if not idx._baseline_carries(a):
                a["findings"] = None
                stale += 1
        if stale:
            _log.info("monitor index baselines from another generation "
                      "will re-baseline on the next re-score",
                      count=stale)
        idx._rebuild_inverted()
        return idx

    @classmethod
    def open_or_reset(cls, path: str) -> "MonitorIndex":
        """Open; on corruption move the bad file aside and start fresh
        (scan-side callers: records repopulate as scans complete)."""
        try:
            return cls.open(path)
        except MonitorIndexError as e:
            dest = path + ".corrupt"
            n = 0
            while os.path.exists(dest):
                n += 1
                dest = f"{path}.corrupt.{n}"
            os.rename(path, dest)
            _log.warn("monitor index unusable; moved aside and starting "
                      "fresh", path=path, moved_to=dest, err=str(e))
            return cls.open(path)

    @classmethod
    def rebuild_from_journal(cls, path: str,
                             journal_path: str) -> "MonitorIndex":
        """Rebuild a missing/corrupt index from a fleet scan journal's
        embedded reports.  Package inventories are reconstructed from
        each report's result package lists (full only under
        ``--list-all-pkgs``); findings are NOT trusted across the
        rebuild — every rebuilt artifact carries a null baseline, so
        its first re-score re-baselines silently instead of emitting
        events diffed against a lossy reconstruction."""
        from trivy_tpu_torch.durability.journal import ScanJournal

        if os.path.exists(path):
            dest = path + ".corrupt"
            n = 0
            while os.path.exists(dest):
                n += 1
                dest = f"{path}.corrupt.{n}"
            os.rename(path, dest)
            _log.warn("rebuilding monitor index from journal; old file "
                      "moved aside", path=path, moved_to=dest)
        j = ScanJournal.resume(journal_path)
        try:
            idx = cls.open(path)
            for target, doc in j.done.items():
                pkgs = packages_from_report(doc)
                if pkgs:
                    idx.update(target, pkgs, None)
            _log.info("monitor index rebuilt from journal",
                      path=path, journal=journal_path,
                      artifacts=len(idx._artifacts))
            return idx
        finally:
            j.close()

    # ------------------------------------------------------------ state

    def _apply(self, rec: dict) -> None:
        kind = rec.get("kind")
        if kind == "artifact" and rec.get("id"):
            if _seal(rec) != rec.get("digest"):
                _log.warn("monitor index record failed digest check; "
                          "dropped", id=rec.get("id"))
                return
            f = rec.get("findings")
            self._artifacts[rec["id"]] = {
                "packages": [tuple(p) for p in rec.get("packages") or []],
                "findings": (None if f is None
                             else {tuple(x) for x in f}),
                "db": rec.get("db"),
            }
        elif kind == "remove" and rec.get("id"):
            self._artifacts.pop(rec["id"], None)
        elif kind == "state":
            t = rec.get("touched")
            self._transitions.append(
                (rec.get("prev"), rec.get("db_digest"),
                 None if t is None else frozenset(
                     (s, n) for s, n in t)))
            self.db_digest = rec.get("db_digest")
            self.window = rec.get("window")

    def _baseline_carries(self, a: dict) -> bool:
        """Is a baseline stamped at a["db"] still exact at the final
        state digest?  True iff a recorded transition chain leads from
        the stamp to the final digest and its accumulated touched keys
        avoid every one of the artifact's (space, name) keys."""
        cur = a["db"]
        acc: set = set()
        for prev, new, touched in self._transitions:
            if cur == self.db_digest:
                break
            if prev != cur:
                continue
            if touched is None:  # full re-score: everything moved
                return False
            acc |= touched
            cur = new
        if cur != self.db_digest:
            return False  # no chain (interrupted re-score, lost state)
        return not any((p[0], p[1]) in acc for p in a["packages"])

    def _rebuild_inverted(self) -> None:
        inv: dict[tuple[str, str], set[str]] = {}
        for aid, a in self._artifacts.items():
            for p in a["packages"]:
                inv.setdefault((p[0], p[1]), set()).add(aid)
        self._inverted = inv

    # ------------------------------------------------------------ write

    def _append(self, rec: dict) -> None:
        try:
            self._log.append(rec)
        except AppendLogError as e:
            # the scan (or re-score) goes on; the monitor stops trusting
            # incremental state until a full re-score rewrites it
            self.degraded = f"index append failed: {e}"
            _log.warn("monitor index append failed; delta re-scoring "
                      "degraded to full until re-baselined", err=str(e))

    def update(self, artifact_id: str, packages, findings,
               db_digest: str | None = None) -> None:
        """Record one artifact's inventory + finding baseline.
        `packages`: iterable of (space, name, version, scheme) tuples;
        `findings`: iterable of (space, name, version, scheme, vuln_id)
        tuples, or None for "no baseline yet" (first re-score
        re-baselines without emitting events); `db_digest`: the
        generation the findings were matched against — a replay drops
        baselines whose stamp disagrees with the final state record."""
        pkgs = sorted({tuple(p) for p in packages})
        fnds = None if findings is None else sorted(
            {tuple(f) for f in findings})
        with self._lock:
            self._update_locked(artifact_id, pkgs, fnds, db_digest)

    def _update_locked(self, artifact_id: str, pkgs: list[tuple],
                       fnds, db_digest: str | None) -> None:
        rec = {"kind": "artifact", "id": artifact_id,
               "packages": [list(p) for p in pkgs],
               "findings": None if fnds is None else [list(f)
                                                      for f in fnds],
               "db": db_digest}
        rec["digest"] = _seal(rec)
        prev = self._artifacts.get(artifact_id)
        self._append(rec)
        if prev:
            for p in prev["packages"]:
                s = self._inverted.get((p[0], p[1]))
                if s:
                    s.discard(artifact_id)
        self._artifacts[artifact_id] = {
            "packages": pkgs,
            "findings": None if fnds is None else set(fnds),
            "db": db_digest,
        }
        for p in pkgs:
            self._inverted.setdefault((p[0], p[1]),
                                      set()).add(artifact_id)

    def update_if(self, artifact_id: str, expected_packages,
                  expected_findings, findings,
                  db_digest: str | None = None) -> bool:
        """Compare-and-swap for the re-score sweep: write `findings`
        only if the artifact's record still matches the (packages,
        findings) snapshot the sweep computed from.  False = a live
        scan re-recorded the artifact mid-sweep — its fresher record
        wins and the sweep's stale computation is discarded."""
        exp_pkgs = sorted({tuple(p) for p in expected_packages})
        exp_fnds = None if expected_findings is None else {
            tuple(f) for f in expected_findings}
        fnds = None if findings is None else sorted(
            {tuple(f) for f in findings})
        with self._lock:  # check + write under ONE acquisition
            a = self._artifacts.get(artifact_id)
            if a is None or a["packages"] != exp_pkgs \
                    or a["findings"] != exp_fnds:
                return False
            self._update_locked(artifact_id, exp_pkgs, fnds, db_digest)
        return True

    def remove(self, artifact_id: str) -> None:
        with self._lock:
            a = self._artifacts.pop(artifact_id, None)
            if a is None:
                return
            self._append({"kind": "remove", "id": artifact_id})
            for p in a["packages"]:
                s = self._inverted.get((p[0], p[1]))
                if s:
                    s.discard(artifact_id)

    def set_state(self, db_digest: str | None, window=None,
                  prev: str | None = None, touched=None) -> None:
        """Record a completed re-score transition.  `touched` is the
        delta's touched-key iterable (None = everything / unknown);
        oversized sets persist as None — conservative, never stale."""
        if touched is not None:
            touched = sorted({(k[0], k[1]) for k in touched})
            if len(touched) > MAX_TOUCHED_PERSIST:
                touched = None
        with self._lock:
            self._append({"kind": "state", "db_digest": db_digest,
                          "window": window, "prev": prev,
                          "touched": (None if touched is None else
                                      [list(k) for k in touched])})
            # mirror the transition in memory so compact() can judge
            # baseline carry exactly the way a later replay would
            self._transitions.append(
                (prev, db_digest,
                 None if touched is None else frozenset(touched)))
            self.db_digest = db_digest
            self.window = window

    def compact(self, slack: int = 3) -> None:
        """Rewrite the log when appends outnumber live records by
        `slack`x (every re-score appends changed artifacts; without
        this the log grows with advisory churn forever). `slack=0`
        forces the rewrite."""
        with self._lock:
            live = len(self._artifacts) + 1
            if slack and self._log.records_written <= max(
                    slack * live, 16):
                return
            records: list[dict] = []
            for aid in sorted(self._artifacts):
                a = self._artifacts[aid]
                # chain collapse: a baseline that provably carries to
                # the current state digest is re-stamped onto it (the
                # carry proof IS "identical at both ends"); anything
                # else is nulled — the compacted log holds exactly one
                # state record, so old stamps could never re-verify
                stamp, fnds = a["db"], a["findings"]
                if fnds is not None and stamp != self.db_digest:
                    if self._baseline_carries(a):
                        stamp = self.db_digest
                    else:
                        fnds = None
                    a["db"], a["findings"] = stamp, fnds
                rec = {"kind": "artifact", "id": aid,
                       "packages": [list(p) for p in a["packages"]],
                       "findings": (None if fnds is None else
                                    [list(f) for f in sorted(fnds)]),
                       "db": stamp}
                rec["digest"] = _seal(rec)
                records.append(rec)
            records.append({"kind": "state", "db_digest": self.db_digest,
                            "window": self.window, "prev": None,
                            "touched": None})
            try:
                self._log.rewrite(records)
            except (AppendLogError, OSError) as e:
                # the previous log survives (atomic rewrite), but the
                # handle is closed: degrade like any append failure —
                # the next re-score goes full and re-baselines
                self.degraded = f"index compaction failed: {e}"
                _log.warn("monitor index compaction failed; degraded "
                          "to full re-score", err=str(e))
                return
            self._transitions = [(None, self.db_digest, None)]
            _log.info("monitor index compacted", path=self.path,
                      artifacts=len(self._artifacts))

    # ------------------------------------------------------------- read

    def artifacts(self) -> list[str]:
        with self._lock:
            return sorted(self._artifacts)

    def packages_of(self, artifact_id: str) -> list[tuple]:
        with self._lock:
            a = self._artifacts.get(artifact_id)
            return list(a["packages"]) if a else []

    def findings_of(self, artifact_id: str):
        """set of finding tuples, or None (no baseline)."""
        with self._lock:
            a = self._artifacts.get(artifact_id)
            if a is None or a["findings"] is None:
                return None
            return set(a["findings"])

    def affected(self, touched) -> list[str]:
        """Artifact ids whose inventory intersects the touched key set,
        plus every artifact with no finding baseline yet (those must
        re-baseline whenever a re-score runs)."""
        with self._lock:
            out: set[str] = set()
            inv = self._inverted
            if len(touched) <= len(inv):
                for key in touched:
                    out |= inv.get(key, set())
            else:
                for key, ids in inv.items():
                    if key in touched:
                        out |= ids
            for aid, a in self._artifacts.items():
                if a["findings"] is None:
                    out.add(aid)
            return sorted(out)

    def close(self) -> None:
        self._log.close()

    def __enter__(self) -> "MonitorIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------- report rebuild

def packages_from_report(doc: dict) -> list[tuple]:
    """Best-effort package inventory from an embedded fleet-journal
    report document (rebuild path). Language results map their type to
    the "eco::" query space; OS results reconstruct the space from the
    report's OS metadata. Packages whose space/scheme cannot be
    resolved are skipped — a rebuilt artifact re-baselines on first
    re-score anyway, so a lossy inventory only narrows which deltas
    re-match it, never which findings it reports."""
    from trivy_tpu_torch.detector.ospkg import DISTROS, bucket_for
    from trivy_tpu_torch.versioning import ECOSYSTEM_SCHEME

    out: set[tuple] = set()
    meta_os = ((doc.get("Metadata") or {}).get("OS") or {})
    family = meta_os.get("Family") or ""
    os_name = meta_os.get("Name") or ""
    cfg = DISTROS.get(family)
    for res in doc.get("Results") or []:
        rclass = res.get("Class")
        rtype = res.get("Type") or ""
        for p in res.get("Packages") or []:
            name = p.get("Name")
            version = p.get("Version") or ""
            if p.get("Release"):
                version = f"{version}-{p['Release']}"
            if p.get("Epoch"):
                version = f"{p['Epoch']}:{version}"
            if not name or not version:
                continue
            if rclass == "lang-pkgs":
                scheme = ECOSYSTEM_SCHEME.get(rtype)
                if scheme:
                    out.add((f"{rtype}::", name, version, scheme))
            elif rclass == "os-pkgs" and cfg is not None:
                src = p.get("SrcName") or name
                src_ver = p.get("SrcVersion") or p.get("Version") or ""
                if p.get("SrcRelease"):
                    src_ver = f"{src_ver}-{p['SrcRelease']}"
                if p.get("SrcEpoch"):
                    src_ver = f"{p['SrcEpoch']}:{src_ver}"
                out.add((bucket_for(family, os_name), src,
                         src_ver or version, cfg.scheme))
    return sorted(out)
