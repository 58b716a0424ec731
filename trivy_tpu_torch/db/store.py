"""Advisory DB store (in memory).

Bucket layout mirrors trivy-db's BoltDB:
- OS buckets: "<family> <release>" (e.g. "alpine 3.10", "debian 11")
- language buckets: "<ecosystem>::<source>" (e.g. "npm::GitHub Security
  Advisory Npm"); lookups use the "<ecosystem>::" *prefix* across all
  sources (reference pkg/detector/library/driver.go:115-124)
- metadata: vuln_id -> VulnerabilityMeta

Copy of trivy_tpu/db/store.py without persistence (save/load) and the
Red Hat CPE expansion: those come with the DB slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch.db.model import Advisory, VulnerabilityMeta

SCHEMA_VERSION = 2


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
    """In-memory advisory database."""

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
