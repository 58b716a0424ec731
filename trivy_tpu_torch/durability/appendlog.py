"""Generic fsynced JSONL append log (docs/durability.md).

The fleet ScanJournal (journal.py) proved the shape: an append-only
JSONL file whose first record is a header, every append flushed+fsynced
before the writer proceeds, and a replay that tolerates a torn tail
(the signature crash artifact) by truncating it.  The monitor's
package→artifact index needs the same write-ahead discipline with a
different record schema, so the mechanics live here once.

Contract:

- ``append`` is durable-when-returned: the record hit the disk (fsync)
  before control comes back.  An injected ``kill`` at the instrumented
  fault site dies *before* the write, an injected ``torn-write`` /
  ``bitflip`` mangles the payload — exactly the journal.append matrix.
- ``replay`` truncates an unterminated tail (the write never happened),
  skips line-bounded unparsable records with a warning (mid-file rot —
  later records are unaffected), and returns the surviving records.
- ``rewrite`` compacts the log: the full replacement content is
  published atomically (tmp + fsync + rename), so a crash mid-compact
  leaves the previous log intact.

Copy of trivy_tpu/durability/appendlog.py (the lock is a plain
`threading.Lock`: the lock-order witness is not ported).
"""

from __future__ import annotations

import json
import os

from trivy_tpu_torch.analysis.witness import make_lock
from trivy_tpu_torch.durability import atomic
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.resilience import faults

_log = logger("appendlog")


class AppendLogError(Exception):
    pass


def _encode(rec: dict) -> bytes:
    return (json.dumps(rec, separators=(",", ":")) + "\n").encode()


class AppendLog:
    """One durable JSONL file: header + appended records."""

    def __init__(self, path: str, header: dict,
                 fault_site: str = "journal.append"):
        self.path = path
        self.header = header
        self.fault_site = fault_site
        self._lock = make_lock("durability.appendlog._lock")
        self._fh = None
        self.records_written = 0

    # ------------------------------------------------------------ open

    @classmethod
    def create(cls, path: str, header: dict,
               fault_site: str = "journal.append") -> "AppendLog":
        """Start a fresh log (refuses to clobber an existing one)."""
        if os.path.exists(path):
            raise AppendLogError(f"append log {path} already exists")
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        log = cls(path, dict(header, kind="header"), fault_site)
        log._fh = open(path, "ab")
        log.append(log.header)
        return log

    @classmethod
    def replay(cls, path: str, fault_site: str = "journal.append",
               ) -> tuple["AppendLog", list[dict]]:
        """-> (reopened log, surviving records after the header).

        Torn tail truncated from the file AND absent from the replay;
        unparsable line-bounded records are skipped with a warning.
        Raises AppendLogError when the file is unreadable or has no
        header (the caller decides whether to rebuild or start fresh).
        """
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise AppendLogError(f"cannot read append log {path}: {e}")
        durable_end = len(raw)
        if raw and not raw.endswith(b"\n"):
            durable_end = raw.rfind(b"\n") + 1
            _log.debug(
                f"dropping torn append-log tail "
                f"({len(raw) - durable_end} bytes past the last complete "
                "record)")
            raw = raw[:durable_end]
        records: list[dict] = []
        for i, line in enumerate(raw.split(b"\n")):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                _log.warn("skipping corrupt append-log record",
                          path=path, line=i + 1)
                continue
            if isinstance(rec, dict):
                records.append(rec)
        if not records or records[0].get("kind") != "header":
            raise AppendLogError(f"append log {path} has no header record")
        log = cls(path, records[0], fault_site)
        log._fh = open(path, "r+b")
        log._fh.truncate(durable_end)  # the torn fragment must not
        log._fh.seek(0, os.SEEK_END)   # prefix the next append
        log.records_written = len(records)
        return log, records[1:]

    @classmethod
    def salvage(cls, path: str, header: dict,
                fault_site: str = "journal.append",
                ) -> tuple["AppendLog", list[dict]]:
        """Rebuild a log whose header record never durably landed (the
        create-time append tore, so replay sees "no header").  Appends
        made after the torn header in the original process are complete
        line-bounded records and MUST survive — for a write-ahead
        journal they carry the applied-id set exactly-once replay
        depends on.  A fresh header is stamped and the repaired file is
        published atomically, then replayed as usual."""
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise AppendLogError(f"cannot read append log {path}: {e}")
        if raw and not raw.endswith(b"\n"):
            raw = raw[:raw.rfind(b"\n") + 1]
        survivors: list[dict] = []
        for line in raw.split(b"\n"):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and rec.get("kind") != "header":
                survivors.append(rec)
        _log.warn("salvaging headerless append log", path=path,
                  survivors=len(survivors))
        body = b"".join([_encode(dict(header, kind="header"))]
                        + [_encode(r) for r in survivors])
        atomic.atomic_write(path, body, fault_site=fault_site)
        return cls.replay(path, fault_site)

    # ------------------------------------------------------------ write

    def append(self, rec: dict) -> None:
        """Durably append one record. Fault rules at ``fault_site``
        apply per append: ``kill`` dies before the write, ``torn-write``
        / ``bitflip`` mangle the payload, ``error`` raises
        AppendLogError, ``drop`` silently loses the record (an
        undetected lost write — replay simply never sees it)."""
        line = _encode(rec)
        rules = faults.fire(self.fault_site)
        faults.check_kill(self.fault_site, rules=rules)
        for r in rules:
            if r.action == "error":
                raise AppendLogError(
                    f"injected append failure at {self.fault_site}")
            if r.action == "drop":
                return
        line = faults.mangle_write(self.fault_site, line, rules=rules)
        with self._lock:
            if self._fh is None:
                raise AppendLogError("append log is closed")
            self._fh.write(line)
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self.records_written += 1

    def rewrite(self, records: list[dict]) -> None:
        """Compact: atomically replace the whole log with header +
        `records`. A crash mid-rewrite leaves the previous log. On a
        failed rewrite the handle is left None (closed), so later
        appends raise AppendLogError — the caller's degrade path —
        instead of ValueError from a closed file object."""
        body = b"".join([_encode(self.header)]
                        + [_encode(r) for r in records])
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            atomic.atomic_write(self.path, body,
                                fault_site=self.fault_site)
            self._fh = open(self.path, "ab")
            self.records_written = 1 + len(records)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "AppendLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
