"""Advisory DB store.

Bucket layout mirrors trivy-db's BoltDB:
- OS buckets: "<family> <release>" (e.g. "alpine 3.10", "debian 11")
- language buckets: "<ecosystem>::<source>" (e.g. "npm::GitHub Security
  Advisory Npm"); lookups use the "<ecosystem>::" *prefix* across all
  sources (reference pkg/detector/library/driver.go:115-124)
- metadata: vuln_id -> VulnerabilityMeta

Persistence is a directory of JSON files (one per bucket family) with a
metadata.json manifest — the moral equivalent of the reference's
`trivy.db` + `metadata.json` pair (reference pkg/db/db.go:97-140).

Copy of trivy_tpu/db/store.py. The on-disk format is the same, so a DB
saved by either package loads in the other, and a directory holding a
BoltDB `trivy.db` (real trivy-db) loads through `db/trivydb.py`.
"""

from __future__ import annotations

import gzip
import json
import os
from dataclasses import dataclass, field

from trivy_tpu_torch.db.model import Advisory, VulnerabilityMeta

SCHEMA_VERSION = 2


def validate_db(db: "AdvisoryDB") -> str | None:
    """Is a DB fit to serve? Returns a rejection reason or None: the DB
    must carry a schema this build understands and actually contain
    advisories — serving an empty DB silently zeroes every CVE match,
    the worst possible failure mode."""
    if db.meta.version > SCHEMA_VERSION:
        return (f"unsupported schema version {db.meta.version} "
                f"(this build reads <= {SCHEMA_VERSION})")
    try:
        s = db.stats()
    except Exception as exc:  # stats must be computable
        return f"stats unreadable: {exc}"
    if not s.get("advisories") and not s.get("metadata") \
            and not db.redhat_entries:
        return "candidate DB is empty"
    return None


@dataclass
class Metadata:
    version: int = SCHEMA_VERSION
    next_update: str = ""
    updated_at: str = ""
    downloaded_at: str = ""

    def to_json(self) -> dict:
        return {
            "Version": self.version,
            "NextUpdate": self.next_update,
            "UpdatedAt": self.updated_at,
            "DownloadedAt": self.downloaded_at,
        }


@dataclass
class AdvisoryDB:
    """In-memory advisory database with JSON(.gz) persistence."""

    buckets: dict[str, dict[str, list[Advisory]]] = field(default_factory=dict)
    metadata_bucket: dict[str, VulnerabilityMeta] = field(default_factory=dict)
    meta: Metadata = field(default_factory=Metadata)
    # Red Hat OVAL v2 CPE-indexed entries (trivy-db redhat-oval layout):
    # redhat_entries: pkg -> [{"key": CVE/RHSA id, "entries": [...]}]
    # redhat_cpe: {"repository": {name: [idx]}, "nvr": {nvr: [idx]},
    #              "cpe": {idx(str): cpe string}}
    redhat_entries: dict[str, list[dict]] = field(default_factory=dict)
    redhat_cpe: dict[str, dict] = field(default_factory=dict)

    # ------------------------------------------------------------ write

    def put_advisory(self, bucket: str, pkg_name: str, adv: Advisory) -> None:
        self.buckets.setdefault(bucket, {}).setdefault(pkg_name, []).append(adv)

    def put_meta(self, meta: VulnerabilityMeta) -> None:
        self.metadata_bucket[meta.id] = meta

    def put_redhat_entry(self, pkg_name: str, key: str,
                         entries: list[dict]) -> None:
        self.redhat_entries.setdefault(pkg_name, []).append(
            {"key": key, "entries": entries})

    def expand_redhat(self) -> None:
        """Resolve CPE-indexed Red Hat entries into plain per-major
        "redhat N" buckets (see trivy_tpu_torch.detector.redhat)."""
        from trivy_tpu_torch.detector.redhat import expand_redhat_entries

        expand_redhat_entries(self)

    # ------------------------------------------------------------ read

    def get_advisories(self, bucket: str, pkg_name: str) -> list[Advisory]:
        """Exact-bucket lookup (OS path)."""
        return self.buckets.get(bucket, {}).get(pkg_name, [])

    def get_advisories_prefix(self, prefix: str, pkg_name: str) -> list[Advisory]:
        """Prefix lookup across data sources (language path,
        reference driver.go:115-124)."""
        out: list[Advisory] = []
        for bucket, pkgs in self.buckets.items():
            if bucket.startswith(prefix):
                out.extend(pkgs.get(pkg_name, []))
        return out

    def get_meta(self, vuln_id: str) -> VulnerabilityMeta | None:
        return self.metadata_bucket.get(vuln_id)

    def bucket_names(self) -> list[str]:
        return sorted(self.buckets)

    def stats(self) -> dict:
        n_adv = sum(
            len(advs) for pkgs in self.buckets.values() for advs in pkgs.values()
        )
        n_names = sum(len(pkgs) for pkgs in self.buckets.values())
        return {
            "buckets": len(self.buckets),
            "names": n_names,
            "advisories": n_adv,
            "metadata": len(self.metadata_bucket),
        }

    # ------------------------------------------------------------ io

    def save(self, path: str, compress: bool = True) -> None:
        from trivy_tpu_torch.durability import atomic

        os.makedirs(path, exist_ok=True)
        blob = {
            "buckets": {
                bucket: {
                    name: [a.to_json() for a in advs]
                    for name, advs in pkgs.items()
                }
                for bucket, pkgs in self.buckets.items()
            },
            "vulnerability": {
                vid: m.to_json() for vid, m in self.metadata_bucket.items()
            },
        }
        if self.redhat_entries:
            blob["redhat"] = self.redhat_entries
        if self.redhat_cpe:
            blob["redhat_cpe"] = self.redhat_cpe
        data = json.dumps(blob, separators=(",", ":")).encode()
        fname = os.path.join(path, "trivy_tpu.db.json")
        # atomic + fsynced: a crash mid-save leaves the previous DB (or
        # nothing), never a torn one a reader would half-parse
        if compress:
            atomic.atomic_write(fname + ".gz", gzip.compress(data),
                                fault_site="db.save")
        else:
            atomic.atomic_write(fname, data, fault_site="db.save")
        atomic.atomic_write(os.path.join(path, "metadata.json"),
                            json.dumps(self.meta.to_json()).encode(),
                            fault_site="db.save.metadata")

    @classmethod
    def load(cls, path: str) -> "AdvisoryDB":
        from trivy_tpu_torch.db import generations

        # a generation-managed root (verified OCI downloads) is read
        # through its last-good link; flat layouts load as before
        path = generations.resolve(path)
        db = cls()
        fname = os.path.join(path, "trivy_tpu.db.json")
        if os.path.exists(fname + ".gz"):
            with gzip.open(fname + ".gz", "rb") as f:
                blob = json.loads(f.read())
        elif os.path.exists(fname):
            with open(fname, "rb") as f:
                blob = json.loads(f.read())
        elif os.path.exists(os.path.join(path, "trivy.db")):
            # a downloaded reference trivy-db artifact (BoltDB); the
            # sibling metadata.json still loads below
            from trivy_tpu_torch.db.trivydb import load_trivy_db

            db = load_trivy_db(os.path.join(path, "trivy.db"))
            blob = {}
        else:
            raise FileNotFoundError(f"no advisory DB at {path}")
        for bucket, pkgs in blob.get("buckets", {}).items():
            for name, advs in pkgs.items():
                for a in advs:
                    db.put_advisory(bucket, name, Advisory.from_json(a))
        for vid, m in blob.get("vulnerability", {}).items():
            db.put_meta(VulnerabilityMeta.from_json(vid, m))
        db.redhat_entries = blob.get("redhat", {}) or {}
        db.redhat_cpe = blob.get("redhat_cpe", {}) or {}
        if db.redhat_entries:
            db.expand_redhat()
        mpath = os.path.join(path, "metadata.json")
        if os.path.exists(mpath):
            with open(mpath) as f:
                md = json.load(f)
            db.meta = Metadata(
                version=md.get("Version", SCHEMA_VERSION),
                next_update=md.get("NextUpdate", ""),
                updated_at=md.get("UpdatedAt", ""),
                downloaded_at=md.get("DownloadedAt", ""),
            )
        return db
