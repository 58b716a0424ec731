"""Append-only fleet-scan journal (docs/durability.md).

One JSONL file per fleet run. The first record is a header naming the
subcommand, the full target list, and a fingerprint of every scan-
affecting option; after it, per-artifact lifecycle records:

    {"kind": "pending", "target": t}            enqueued
    {"kind": "running", "target": t}            a worker picked it up
    {"kind": "layer", "blob": blob_id}          a layer analysis landed
                                                durably in the cache
    {"kind": "done", "target": t,
     "digest": "sha256:…", "report": {…}}       finished; report embedded
    {"kind": "failed", "target": t, "error": e} scan raised

Layer records are fleet-wide (blob ids are content-addressed, so one
record covers every image sharing that layer): a resumed crawl replays
them as dedupe hints and skips re-journaling, and the analysis pipeline
counts cache hits on them as journal-replayed layers.

Every append is flushed + fsynced before the writer proceeds, so the
journal is a write-ahead log of fleet progress: after SIGKILL, replay
yields exactly the set of artifacts whose reports are durable. The
`digest` is the sha256 of the canonical report JSON — a bit-flipped
`done` record is detected at replay and the artifact re-runs.

Replay is torn-tail tolerant: a record that did not finish hitting the
disk (the common crash artifact) simply did not happen.

Copy of trivy_tpu/durability/journal.py: the monitor index rebuilds
from a journal's embedded reports (`monitor/index.py`
`rebuild_from_journal`). The fleet mode that writes journals
(`--targets`, `--journal`, `--resume`) is not ported yet.
"""

from __future__ import annotations

import hashlib
import json
import os

from trivy_tpu_torch.analysis.witness import make_lock
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.resilience import faults

_log = logger("journal")

JOURNAL_VERSION = 1
FAULT_SITE = "journal.append"


class JournalError(Exception):
    pass


def canonical_json(doc: dict) -> str:
    """One byte-stable rendering per document: digest computation and
    resume-time re-rendering must agree."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def report_digest(doc: dict) -> str:
    return "sha256:" + hashlib.sha256(canonical_json(doc).encode()).hexdigest()


def options_fingerprint(command: str, args) -> str:
    """Hash of every option that changes scan results. A journal resumed
    under different options would merge skew into the report — refuse
    instead (the Vexed-by-VEX-tools failure mode, arXiv:2503.14388)."""
    payload = {
        "command": command,
        "scanners": getattr(args, "scanners", ""),
        "pkg_types": getattr(args, "pkg_types", ""),
        "severity": getattr(args, "severity", None),
        "ignore_unfixed": getattr(args, "ignore_unfixed", False),
        "ignore_status": getattr(args, "ignore_status", None),
        "ignorefile": getattr(args, "ignorefile", None),
        "ignore_policy": getattr(args, "ignore_policy", None),
        "list_all_pkgs": getattr(args, "list_all_pkgs", False),
        "dependency_tree": getattr(args, "dependency_tree", False),
        "include_dev_deps": getattr(args, "include_dev_deps", False),
        "show_suppressed": getattr(args, "show_suppressed", False),
        "vex": list(getattr(args, "vex", []) or []),
        "skip_files": list(getattr(args, "skip_files", []) or []),
        "skip_dirs": list(getattr(args, "skip_dirs", []) or []),
        "file_patterns": list(getattr(args, "file_patterns", []) or []),
        "secret_config": getattr(args, "secret_config", None),
        "sbom_sources": getattr(args, "sbom_sources", ""),
    }
    digest = hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()
    return f"sha256:{digest}"


class ScanJournal:
    """Writer + replayer for one fleet journal file."""

    def __init__(self, path: str, header: dict):
        self.path = path
        self.header = header
        self._lock = make_lock("durability.journal._lock")
        self._layer_lock = make_lock("durability.journal._layer_lock")
        self._fh = None
        self.done: dict[str, dict] = {}
        self.failed: dict[str, str] = {}
        self.layers: set[str] = set()

    # ------------------------------------------------------------ open

    @classmethod
    def create(cls, path: str, command: str, targets: list[str],
               fingerprint: str) -> "ScanJournal":
        if os.path.exists(path):
            raise JournalError(
                f"journal {path} already exists; pass --resume to continue "
                "it or choose a fresh path")
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        header = {"kind": "header", "v": JOURNAL_VERSION,
                  "command": command, "fingerprint": fingerprint,
                  "targets": list(targets)}
        j = cls(path, header)
        j._fh = open(path, "ab")
        j._append(header)
        for t in targets:
            j._append({"kind": "pending", "target": t})
        return j

    @classmethod
    def resume(cls, path: str) -> "ScanJournal":
        """Replay an existing journal, tolerate a torn tail, verify every
        embedded report digest, and reopen for appending.

        A tail without a trailing newline is the signature of a write
        that never finished — it is dropped from the replay AND
        truncated from the file, so the next append starts a fresh line
        instead of merging with (and thereby destroying) the fragment.
        A newline-terminated line that fails to parse is mid-file
        corruption: warned about, skipped, and left in place (it is
        line-bounded, so later records are unaffected)."""
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise JournalError(f"cannot read journal {path}: {e}")
        durable_end = len(raw)
        if raw and not raw.endswith(b"\n"):
            durable_end = raw.rfind(b"\n") + 1
            _log.debug(
                f"dropping torn journal tail ({len(raw) - durable_end} "
                "bytes past the last complete record)")
            raw = raw[:durable_end]
        records: list[dict] = []
        for i, line in enumerate(raw.split(b"\n")):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                # line-bounded but unreadable: disk rot, not a torn
                # write — surface it (the record's artifact re-runs)
                _log.warn("skipping corrupt journal record",
                          path=path, line=i + 1)
                continue
            records.append(rec)
        if not records or records[0].get("kind") != "header":
            raise JournalError(f"journal {path} has no header record")
        header = records[0]
        if header.get("v") != JOURNAL_VERSION:
            raise JournalError(
                f"journal {path} is version {header.get('v')}, "
                f"this build writes v{JOURNAL_VERSION}")
        j = cls(path, header)
        running: set[str] = set()
        for rec in records[1:]:
            kind, target = rec.get("kind"), rec.get("target")
            if kind == "running" and target:
                running.add(target)
            if kind == "done" and target:
                doc = rec.get("report")
                if not isinstance(doc, dict) or \
                        report_digest(doc) != rec.get("digest"):
                    _log.warn("journal report failed digest check; "
                              "artifact will re-run", target=target)
                    continue
                j.done[target] = doc
                j.failed.pop(target, None)
            elif kind == "failed" and target:
                if target not in j.done:
                    j.failed[target] = rec.get("error", "")
            elif kind == "layer" and rec.get("blob"):
                j.layers.add(rec["blob"])
        # artifacts that were mid-scan at the crash (running, never
        # done/failed): they re-run, but the distinction matters to an
        # operator reading the resume log
        inflight = running - set(j.done) - set(j.failed)
        if inflight:
            _log.info("journal has artifacts that were in flight at the "
                      "crash; they will re-run", count=len(inflight))
        j._fh = open(path, "r+b")
        j._fh.truncate(durable_end)  # torn fragment must not prefix the
        j._fh.seek(0, os.SEEK_END)   # next append
        return j

    # ------------------------------------------------------------ props

    @property
    def targets(self) -> list[str]:
        return list(self.header.get("targets") or [])

    @property
    def command(self) -> str:
        return self.header.get("command", "")

    @property
    def fingerprint(self) -> str:
        return self.header.get("fingerprint", "")

    # ------------------------------------------------------------ write

    def _append(self, rec: dict) -> None:
        # NOT canonical_json: the embedded report must round-trip with
        # its key order intact or a resumed merged report would not be
        # byte-identical to an uninterrupted one (digests are computed
        # over the canonical form, so verification is order-free)
        line = (json.dumps(rec, separators=(",", ":")) + "\n").encode()
        # one fault probe per append: rule ordinals count appends
        # (1=header, then pending/running/done records in write order)
        rules = faults.fire(FAULT_SITE)
        faults.check_kill(FAULT_SITE, rules=rules)
        line = faults.mangle_write(FAULT_SITE, line, rules=rules)
        with self._lock:
            if self._fh is None:
                raise JournalError("journal is closed")
            self._fh.write(line)
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def mark_running(self, target: str) -> None:
        self._append({"kind": "running", "target": target})

    def mark_layer(self, blob_id: str) -> None:
        """Record one durable layer analysis (called after put_blob
        returns, so the cache entry exists when the record does). Each
        blob id is journaled once per fleet, however many images share
        it — repeats and replayed layers are no-ops."""
        if blob_id in self.layers:
            return
        with self._layer_lock:
            if blob_id in self.layers:
                return
            self.layers.add(blob_id)
            self._append({"kind": "layer", "blob": blob_id})

    def mark_done(self, target: str, report_doc: dict) -> None:
        self._append({"kind": "done", "target": target,
                      "digest": report_digest(report_doc),
                      "report": report_doc})
        self.done[target] = report_doc
        self.failed.pop(target, None)

    def mark_failed(self, target: str, error: str) -> None:
        self._append({"kind": "failed", "target": target, "error": error})
        self.failed[target] = error

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "ScanJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
