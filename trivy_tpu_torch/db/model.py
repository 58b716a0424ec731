"""Advisory / metadata records (shape of trivy-db types.Advisory and
types.Vulnerability, as consumed by the reference detectors)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class DataSourceInfo:
    id: str = ""
    name: str = ""
    url: str = ""
    base_id: str = ""

    def to_json(self) -> dict:
        out = {}
        if self.id:
            out["ID"] = self.id
        if self.base_id:
            out["BaseID"] = self.base_id
        if self.name:
            out["Name"] = self.name
        if self.url:
            out["URL"] = self.url
        return out

    @classmethod
    def from_json(cls, d: dict | None) -> "DataSourceInfo":
        d = d or {}
        return cls(
            id=d.get("ID", ""),
            name=d.get("Name", ""),
            url=d.get("URL", ""),
            base_id=d.get("BaseID", ""),
        )


@dataclass
class Advisory:
    """One advisory row in a bucket (trivy-db types.Advisory shape).

    OS advisories use fixed_version/affected_version (+arches, status);
    language advisories use the three constraint lists."""

    vulnerability_id: str = ""
    vendor_ids: list[str] = field(default_factory=list)
    # OS style
    fixed_version: str = ""
    affected_version: str = ""  # version that introduced the vuln (alpine)
    arches: list[str] = field(default_factory=list)
    status: str = ""  # "affected" | "fixed" | "will_not_fix" | ...
    severity: int = 0  # vendor severity ordinal (0 = unknown)
    # language style
    vulnerable_versions: list[str] = field(default_factory=list)
    patched_versions: list[str] = field(default_factory=list)
    unaffected_versions: list[str] = field(default_factory=list)
    data_source: DataSourceInfo | None = None
    custom: object = None

    @property
    def is_range_style(self) -> bool:
        return bool(
            self.vulnerable_versions
            or self.patched_versions
            or self.unaffected_versions
        )

    def to_json(self) -> dict:
        out: dict = {"VulnerabilityID": self.vulnerability_id}
        if self.vendor_ids:
            out["VendorIDs"] = self.vendor_ids
        if self.fixed_version:
            out["FixedVersion"] = self.fixed_version
        if self.affected_version:
            out["AffectedVersion"] = self.affected_version
        if self.arches:
            out["Arches"] = self.arches
        if self.status:
            out["Status"] = self.status
        if self.severity:
            out["Severity"] = self.severity
        if self.vulnerable_versions:
            out["VulnerableVersions"] = self.vulnerable_versions
        if self.patched_versions:
            out["PatchedVersions"] = self.patched_versions
        if self.unaffected_versions:
            out["UnaffectedVersions"] = self.unaffected_versions
        if self.data_source is not None:
            out["DataSource"] = self.data_source.to_json()
        return out

    @classmethod
    def from_json(cls, d: dict) -> "Advisory":
        return cls(
            vulnerability_id=d.get("VulnerabilityID", ""),
            vendor_ids=d.get("VendorIDs", []) or [],
            fixed_version=d.get("FixedVersion", ""),
            affected_version=d.get("AffectedVersion", ""),
            arches=d.get("Arches", []) or [],
            status=d.get("Status", ""),
            severity=d.get("Severity", 0) or 0,
            vulnerable_versions=d.get("VulnerableVersions", []) or [],
            patched_versions=d.get("PatchedVersions", []) or [],
            unaffected_versions=d.get("UnaffectedVersions", []) or [],
            data_source=DataSourceInfo.from_json(d.get("DataSource"))
            if d.get("DataSource")
            else None,
        )


@dataclass
class VulnerabilityMeta:
    """vulnerability-bucket record (trivy-db types.Vulnerability), joined
    host-side after detection (reference pkg/vulnerability/vulnerability.go:70)."""

    id: str = ""
    title: str = ""
    description: str = ""
    severity: str = "UNKNOWN"
    cwe_ids: list[str] = field(default_factory=list)
    vendor_severity: dict[str, int] = field(default_factory=dict)
    cvss: dict[str, dict] = field(default_factory=dict)
    references: list[str] = field(default_factory=list)
    published_date: str = ""
    last_modified_date: str = ""

    def to_json(self) -> dict:
        out: dict = {}
        if self.title:
            out["Title"] = self.title
        if self.description:
            out["Description"] = self.description
        if self.severity and self.severity != "UNKNOWN":
            out["Severity"] = self.severity
        if self.cwe_ids:
            out["CweIDs"] = self.cwe_ids
        if self.vendor_severity:
            out["VendorSeverity"] = self.vendor_severity
        if self.cvss:
            out["CVSS"] = self.cvss
        if self.references:
            out["References"] = self.references
        if self.published_date:
            out["PublishedDate"] = self.published_date
        if self.last_modified_date:
            out["LastModifiedDate"] = self.last_modified_date
        return out

    @classmethod
    def from_json(cls, vid: str, d: dict) -> "VulnerabilityMeta":
        return cls(
            id=vid,
            title=d.get("Title", ""),
            description=d.get("Description", ""),
            severity=d.get("Severity", "UNKNOWN") or "UNKNOWN",
            cwe_ids=d.get("CweIDs", []) or [],
            vendor_severity=d.get("VendorSeverity", {}) or {},
            cvss=d.get("CVSS", {}) or {},
            references=d.get("References", []) or [],
            published_date=d.get("PublishedDate", ""),
            last_modified_date=d.get("LastModifiedDate", ""),
        )
