"""Red Hat OVAL v2 CPE-entry resolution (reference
pkg/detector/ospkg/redhat/redhat.go + trivy-db redhat-oval vulnsrc).

Red Hat advisories are not keyed by release bucket: each entry carries a
list of *affected CPE indices*, and the scanner resolves the artifact's
content sets / NVRs through the "Red Hat CPE" repository/nvr tables to a
CPE index set, keeping entries whose Affected list intersects it.

Device-first twist: instead of a per-package host lookup at scan time, the
CPE join is resolved ONCE at DB load — each supported major release's
default content sets (redhat.go:25-44) expand the entry table into plain
"redhat {major}" fixed-version buckets, which then flow through the
standard tensor compilation and the device match kernel like every other
distro. Scan-time content sets from build metadata (UBI images) resolve
through `content_set_advisories` on the host, the same entry walk with a
caller-provided repository list.

Copy of trivy_tpu/detector/redhat.py.
"""

from __future__ import annotations

from trivy_tpu_torch.db.model import Advisory, DataSourceInfo
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.types.enums import Status

_log = logger("redhat")

# reference redhat.go:25-44
DEFAULT_CONTENT_SETS: dict[str, list[str]] = {
    "6": ["rhel-6-server-rpms", "rhel-6-server-extras-rpms"],
    "7": ["rhel-7-server-rpms", "rhel-7-server-extras-rpms"],
    "8": ["rhel-8-for-x86_64-baseos-rpms", "rhel-8-for-x86_64-appstream-rpms"],
    "9": ["rhel-9-for-x86_64-baseos-rpms", "rhel-9-for-x86_64-appstream-rpms"],
}

_DS = DataSourceInfo(
    id="redhat", name="Red Hat OVAL v2",
    url="https://www.redhat.com/security/data/oval/v2/")


def _indices_for(db, repositories: list[str], nvrs: list[str]) -> set[int]:
    repo_map = db.redhat_cpe.get("repository", {})
    nvr_map = db.redhat_cpe.get("nvr", {})
    out: set[int] = set()
    for r in repositories:
        out.update(repo_map.get(r, []))
    for n in nvrs:
        out.update(nvr_map.get(n, []))
    return out


def _entry_advisories(pkg_entries: list[dict],
                      indices: set[int]) -> list[Advisory]:
    """Entries whose Affected CPEs intersect `indices` -> Advisory rows
    (one per CVE of the entry; RHSA-keyed entries carry the key as the
    vendor id, CVE-keyed unpatched entries carry none)."""
    out: list[Advisory] = []
    for rec in pkg_entries:
        key = rec.get("key", "")
        for entry in rec.get("entries") or []:
            # strict intersection (trivy-db redhat-oval HasIntersection):
            # an entry with no affected CPEs matches nothing, and an
            # unresolvable content set matches nothing
            affected = set(entry.get("Affected") or [])
            if not (affected & indices):
                continue
            fixed = entry.get("FixedVersion", "") or ""
            status_i = entry.get("Status")
            status = ""
            if isinstance(status_i, int) and 0 <= status_i < 8:
                status = Status(status_i).label
            arches = list(entry.get("Arches") or [])
            for cve in entry.get("Cves") or [{}]:
                vuln_id = cve.get("ID") or key
                severity = cve.get("Severity") or 0
                out.append(Advisory(
                    vulnerability_id=vuln_id,
                    vendor_ids=[key] if vuln_id != key else [],
                    fixed_version=fixed,
                    status=status,
                    severity=int(severity),
                    arches=arches,
                    data_source=_DS,
                ))
    return out


def content_set_advisories(db, pkg_name: str, repositories: list[str],
                           nvrs: list[str]) -> list[Advisory]:
    """Scan-time resolution for artifacts with build metadata (UBI):
    content sets / NVRs -> CPE indices -> matching entries."""
    indices = _indices_for(db, repositories, nvrs)
    return _entry_advisories(db.redhat_entries.get(pkg_name, []), indices)


def expand_redhat_entries(db) -> None:
    """Expand the CPE-entry table into plain "redhat {major}" buckets
    using each major's default content sets, so RHEL/CentOS matching runs
    on the device like every bucket-keyed distro."""
    if not db.redhat_entries:
        return
    n = 0
    for major, repos in DEFAULT_CONTENT_SETS.items():
        indices = _indices_for(db, repos, [])
        if not indices:
            continue
        bucket = f"redhat {major}"
        for pkg_name, recs in db.redhat_entries.items():
            for adv in _entry_advisories(recs, indices):
                db.put_advisory(bucket, pkg_name, adv)
                n += 1
    if n:
        _log.info("expanded Red Hat CPE entries",
                  advisories=n, majors=len(DEFAULT_CONTENT_SETS))
