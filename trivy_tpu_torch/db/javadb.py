"""trivy-java-db equivalent: JAR sha1 → Maven GAV lookup
(reference pkg/javadb/client.go + aquasecurity/trivy-java-db).

The upstream java DB is a sqlite database distributed as an OCI
artifact; here the same schema lives in stdlib sqlite3 under
<cache>/javadb/javadb.sqlite with a metadata.json next to it.  Two
queries drive jar identification (reference
dependency/parser/java/jar/parse.go:123-146):

- search_by_sha1:     digest of the jar file → exact (G, A, V)
- search_by_artifact_id: (A, V) → the single G that publishes it
  (heuristic; ambiguous artifact ids return None)

Populate with `trivy-tpu db import-java <dump.jsonl>` where each line is
{"groupId":…, "artifactId": …, "version": …, "sha1": …}.

Copy of trivy_tpu/db/javadb.py. The port reads and writes the same
file the reference does.
"""

from __future__ import annotations

import json
import os
import sqlite3
from dataclasses import dataclass

from trivy_tpu_torch.durability.atomic import atomic_write
from trivy_tpu_torch.log import logger

_log = logger("javadb")

SCHEMA_VERSION = 1


@dataclass(frozen=True)
class GAV:
    group_id: str
    artifact_id: str
    version: str

    @property
    def name(self) -> str:
        return f"{self.group_id}:{self.artifact_id}"


class JavaDB:
    """sqlite-backed sha1→GAV index.  Connections are opened read-only
    per call site; a missing DB yields a client that finds nothing, so
    jar analysis degrades to manifest/filename heuristics."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._conn: sqlite3.Connection | None = None
        self._upstream = False  # real trivy-java-db schema
        if path and os.path.exists(path):
            self._conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True,
                                         check_same_thread=False)
            tables = {r[0] for r in self._conn.execute(
                "SELECT name FROM sqlite_master WHERE type='table'")}
            # the real trivy-java-db splits artifacts(id,group,artifact)
            # from indices(artifact_id,version,sha1 BLOB,archive_type);
            # it is consumed natively, no conversion step
            self._upstream = "indices" in tables

    # ------------------------------------------------------------ build

    @classmethod
    def create(cls, path: str) -> "JavaDB":
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        conn = sqlite3.connect(path)
        conn.executescript("""
            CREATE TABLE IF NOT EXISTS artifacts (
                sha1 TEXT PRIMARY KEY,
                group_id TEXT NOT NULL,
                artifact_id TEXT NOT NULL,
                version TEXT NOT NULL
            );
            CREATE INDEX IF NOT EXISTS idx_artifact_version
                ON artifacts (artifact_id, version);
        """)
        conn.commit()
        db = cls.__new__(cls)
        db.path = path
        db._conn = conn
        db._upstream = False
        return db

    def import_entries(self, entries) -> int:
        assert self._conn is not None
        rows = [
            (e["sha1"].lower(), e["groupId"], e["artifactId"], e["version"])
            for e in entries
            if e.get("sha1") and e.get("groupId") and e.get("artifactId")
            and e.get("version")
        ]
        self._conn.executemany(
            "INSERT OR REPLACE INTO artifacts VALUES (?, ?, ?, ?)", rows)
        self._conn.commit()
        return len(rows)

    def write_metadata(self) -> None:
        if not self.path:
            return
        meta = {"Version": SCHEMA_VERSION}
        atomic_write(os.path.join(os.path.dirname(self.path),
                                  "metadata.json"),
                     json.dumps(meta).encode())

    # ----------------------------------------------------------- search

    def search_by_sha1(self, sha1: str) -> GAV | None:
        if self._conn is None:
            return None
        if self._upstream:
            row = self._conn.execute(
                "SELECT a.group_id, a.artifact_id, i.version "
                "FROM indices i JOIN artifacts a ON a.id = i.artifact_id "
                "WHERE i.sha1 = ?", (bytes.fromhex(sha1),)).fetchone()
            return GAV(*row) if row else None
        row = self._conn.execute(
            "SELECT group_id, artifact_id, version FROM artifacts "
            "WHERE sha1 = ?", (sha1.lower(),)).fetchone()
        return GAV(*row) if row else None

    def search_by_artifact_id(self, artifact_id: str,
                              version: str) -> str | None:
        """-> groupId, only when exactly one group publishes this
        (artifactId, version) — same false-positive guard as the
        reference heuristic (parse.go:138-140)."""
        if self._conn is None:
            return None
        if self._upstream:
            rows = self._conn.execute(
                "SELECT DISTINCT a.group_id FROM artifacts a "
                "JOIN indices i ON a.id = i.artifact_id "
                "WHERE a.artifact_id = ? AND i.version = ? LIMIT 2",
                (artifact_id, version)).fetchall()
        else:
            rows = self._conn.execute(
                "SELECT DISTINCT group_id FROM artifacts "
                "WHERE artifact_id = ? AND version = ? LIMIT 2",
                (artifact_id, version)).fetchall()
        if len(rows) == 1:
            return rows[0][0]
        return None

    def stats(self) -> dict:
        if self._conn is None:
            return {"artifacts": 0}
        table = "indices" if self._upstream else "artifacts"
        n = self._conn.execute(
            f"SELECT COUNT(*) FROM {table}").fetchone()[0]
        return {"artifacts": n}

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None


# Process-wide client used by the jar analyzer; configured by the CLI
# runner (same pattern as the reference's javadb.updater singleton).
_CLIENT: JavaDB | None = None


def configure(path: str | None) -> None:
    global _CLIENT
    if _CLIENT is not None:
        _CLIENT.close()
    _CLIENT = JavaDB(path) if path else None


def client() -> JavaDB | None:
    return _CLIENT


def default_path(cache_dir: str) -> str:
    return os.path.join(cache_dir, "javadb", "javadb.sqlite")
