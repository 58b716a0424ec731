"""Report data model.

JSON shape is compatible with the reference report schema (schema v2):
- Report/Metadata/Result: reference pkg/types/report.go:14-129
- DetectedVulnerability: reference pkg/types/vulnerability.go:9-31
- Vulnerability detail (embedded): reference trivy-db types.Vulnerability

Copy of trivy_tpu/types/report.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from trivy_tpu_torch.types.artifact import (
    CustomResource,
    JSONMixin,
    Layer,
    OS,
    Package,
    PkgIdentifier,
)
from trivy_tpu_torch.types.enums import ResultClass, Severity, Status

REPORT_SCHEMA_VERSION = 2


@dataclass
class DataSource(JSONMixin):
    """Where an advisory came from (reference trivy-db types.DataSource)."""

    id: str = ""
    name: str = ""
    url: str = ""
    base_id: str = ""

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        if self.id:
            out["ID"] = self.id
        if self.base_id:
            out["BaseID"] = self.base_id
        if self.name:
            out["Name"] = self.name
        if self.url:
            out["URL"] = self.url
        return out


@dataclass
class VulnerabilityInfo(JSONMixin):
    """Vulnerability metadata (reference trivy-db types.Vulnerability),
    joined host-side by trivy_tpu_torch.vulnerability.Client.fill_info
    (reference pkg/vulnerability/vulnerability.go:70)."""

    title: str = ""
    description: str = ""
    severity: str = "UNKNOWN"
    cwe_ids: list[str] = field(default_factory=list)
    vendor_severity: dict[str, int] = field(default_factory=dict)
    cvss: dict[str, dict] = field(default_factory=dict)
    references: list[str] = field(default_factory=list)
    published_date: str = ""
    last_modified_date: str = ""

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        if self.title:
            out["Title"] = self.title
        if self.description:
            out["Description"] = self.description
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


@dataclass
class DetectedVulnerability(JSONMixin):
    vulnerability_id: str = ""
    vendor_ids: list[str] = field(default_factory=list)
    pkg_id: str = ""
    pkg_name: str = ""
    pkg_path: str = ""
    pkg_identifier: PkgIdentifier = field(default_factory=PkgIdentifier)
    installed_version: str = ""
    fixed_version: str = ""
    status: Status = Status.UNKNOWN
    layer: Layer = field(default_factory=Layer)
    severity_source: str = ""
    primary_url: str = ""
    data_source: DataSource | None = None
    info: VulnerabilityInfo | None = None

    @property
    def severity(self) -> Severity:
        return Severity.parse(self.info.severity if self.info else "UNKNOWN")

    def sort_key(self) -> tuple:
        return (
            self.vulnerability_id,
            self.pkg_name,
            self.pkg_path,
            self.installed_version,
        )

    def to_dict(self) -> dict:
        out: dict[str, Any] = {"VulnerabilityID": self.vulnerability_id}
        if self.vendor_ids:
            out["VendorIDs"] = self.vendor_ids
        if self.pkg_id:
            out["PkgID"] = self.pkg_id
        out["PkgName"] = self.pkg_name
        if self.pkg_path:
            out["PkgPath"] = self.pkg_path
        ident = self.pkg_identifier.to_dict()
        if ident:
            out["PkgIdentifier"] = ident
        out["InstalledVersion"] = self.installed_version
        out["FixedVersion"] = self.fixed_version
        if self.status != Status.UNKNOWN:
            out["Status"] = self.status.label
        layer = self.layer.to_dict()
        if layer:
            out["Layer"] = layer
        if self.severity_source:
            out["SeveritySource"] = self.severity_source
        if self.primary_url:
            out["PrimaryURL"] = self.primary_url
        if self.data_source is not None:
            out["DataSource"] = self.data_source.to_dict()
        if self.info is not None:
            out.update(self.info.to_dict())
        return out


@dataclass
class Line(JSONMixin):
    number: int = 0
    content: str = ""
    is_cause: bool = False
    annotation: str = ""
    truncated: bool = False
    highlighted: str = ""
    first_cause: bool = False
    last_cause: bool = False

    def to_dict(self) -> dict:
        return {
            "Number": self.number,
            "Content": self.content,
            "IsCause": self.is_cause,
            "Annotation": self.annotation,
            "Truncated": self.truncated,
            **({"Highlighted": self.highlighted} if self.highlighted else {}),
            "FirstCause": self.first_cause,
            "LastCause": self.last_cause,
        }


@dataclass
class Code(JSONMixin):
    lines: list[Line] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"Lines": [l.to_dict() for l in self.lines] or None}


@dataclass
class CauseMetadata(JSONMixin):
    resource: str = ""
    provider: str = ""
    service: str = ""
    start_line: int = 0
    end_line: int = 0
    code: Code = field(default_factory=Code)
    occurrences: list = field(default_factory=list)

    def to_dict(self) -> dict:
        out: dict[str, Any] = {
            "Resource": self.resource,
            "Provider": self.provider,
            "Service": self.service,
        }
        if self.start_line:
            out["StartLine"] = self.start_line
        if self.end_line:
            out["EndLine"] = self.end_line
        out["Code"] = self.code.to_dict()
        return out


@dataclass
class DetectedMisconfiguration(JSONMixin):
    type: str = ""
    id: str = ""
    avd_id: str = ""
    title: str = ""
    description: str = ""
    message: str = ""
    namespace: str = ""
    query: str = ""
    resolution: str = ""
    severity: str = "UNKNOWN"
    primary_url: str = ""
    references: list[str] = field(default_factory=list)
    status: str = ""  # "PASS" | "FAIL" | "EXCEPTION"
    layer: Layer = field(default_factory=Layer)
    cause_metadata: CauseMetadata = field(default_factory=CauseMetadata)

    def sort_key(self) -> tuple:
        return (-Severity.parse(self.severity), self.id, self.message)

    def to_dict(self) -> dict:
        out = {
            "Type": self.type,
            "ID": self.id,
            "AVDID": self.avd_id,
            "Title": self.title,
            "Description": self.description,
            "Message": self.message,
            "Namespace": self.namespace,
            "Query": self.query,
            "Resolution": self.resolution,
            "Severity": self.severity,
            "PrimaryURL": self.primary_url,
            "References": self.references,
            "Status": self.status,
            "CauseMetadata": self.cause_metadata.to_dict(),
        }
        layer = self.layer.to_dict()
        if layer:
            out["Layer"] = layer
        return out


@dataclass
class DetectedSecret(JSONMixin):
    rule_id: str = ""
    category: str = ""
    severity: str = "UNKNOWN"
    title: str = ""
    start_line: int = 0
    end_line: int = 0
    match: str = ""
    code: Code = field(default_factory=Code)
    layer: Layer = field(default_factory=Layer)

    def to_dict(self) -> dict:
        out = {
            "RuleID": self.rule_id,
            "Category": self.category,
            "Severity": self.severity,
            "Title": self.title,
            "StartLine": self.start_line,
            "EndLine": self.end_line,
            "Match": self.match,
        }
        if self.code.lines:
            out["Code"] = self.code.to_dict()
        layer = self.layer.to_dict()
        if layer:
            out["Layer"] = layer
        return out


@dataclass
class DetectedLicense(JSONMixin):
    severity: str = "UNKNOWN"
    category: str = ""
    pkg_name: str = ""
    file_path: str = ""
    name: str = ""
    text: str = ""
    confidence: float = 1.0
    link: str = ""

    def to_dict(self) -> dict:
        return {
            "Severity": self.severity,
            "Category": self.category,
            "PkgName": self.pkg_name,
            "FilePath": self.file_path,
            "Name": self.name,
            **({"Text": self.text} if self.text else {}),
            "Confidence": self.confidence,
            "Link": self.link,
        }


@dataclass
class MisconfSummary(JSONMixin):
    successes: int = 0
    failures: int = 0

    def to_dict(self) -> dict:
        return {"Successes": self.successes, "Failures": self.failures}


@dataclass
class Result(JSONMixin):
    target: str = ""
    result_class: ResultClass | str = ""
    type: str = ""
    packages: list[Package] = field(default_factory=list)
    vulnerabilities: list[DetectedVulnerability] = field(default_factory=list)
    misconf_summary: MisconfSummary | None = None
    misconfigurations: list[DetectedMisconfiguration] = field(default_factory=list)
    secrets: list[DetectedSecret] = field(default_factory=list)
    licenses: list[DetectedLicense] = field(default_factory=list)
    custom_resources: list[CustomResource] = field(default_factory=list)
    # findings suppressed by VEX/ignore policies (reference
    # types.ModifiedFinding, rendered as ExperimentalModifiedFindings)
    modified_findings: list[dict] = field(default_factory=list)

    @property
    def is_empty(self) -> bool:
        return not (
            self.packages
            or self.vulnerabilities
            or self.misconfigurations
            or self.secrets
            or self.licenses
            or self.custom_resources
        )

    def to_dict(self) -> dict:
        out: dict[str, Any] = {"Target": self.target}
        if self.result_class:
            cls = self.result_class
            out["Class"] = cls.value if isinstance(cls, ResultClass) else cls
        if self.type:
            out["Type"] = self.type
        if self.packages:
            out["Packages"] = [p.to_dict() for p in self.packages]
        if self.vulnerabilities:
            out["Vulnerabilities"] = [v.to_dict() for v in self.vulnerabilities]
        if self.misconf_summary is not None:
            out["MisconfSummary"] = self.misconf_summary.to_dict()
        if self.misconfigurations:
            out["Misconfigurations"] = [m.to_dict() for m in self.misconfigurations]
        if self.secrets:
            out["Secrets"] = [s.to_dict() for s in self.secrets]
        if self.licenses:
            out["Licenses"] = [l.to_dict() for l in self.licenses]
        if self.custom_resources:
            out["CustomResources"] = [c.to_dict() for c in self.custom_resources]
        if self.modified_findings:
            out["ExperimentalModifiedFindings"] = self.modified_findings
        return out


@dataclass
class Metadata(JSONMixin):
    size: int = 0
    os: OS | None = None
    image_id: str = ""
    diff_ids: list[str] = field(default_factory=list)
    repo_tags: list[str] = field(default_factory=list)
    repo_digests: list[str] = field(default_factory=list)
    image_config: dict = field(default_factory=dict)
    # non-empty when the scan degraded to a fallback path (circuit
    # breaker open / deadline exhausted / remote failure); the value is
    # the human-readable reason. Consumers use it to tell a fallback
    # scan from a primary one (docs/resilience.md).
    degraded: str = ""

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        if self.size:
            out["Size"] = self.size
        if self.os is not None and self.os.detected:
            out["OS"] = self.os.to_dict()
        if self.image_id:
            out["ImageID"] = self.image_id
        if self.diff_ids:
            out["DiffIDs"] = self.diff_ids
        if self.repo_tags:
            out["RepoTags"] = self.repo_tags
        if self.repo_digests:
            out["RepoDigests"] = self.repo_digests
        if self.image_config:
            out["ImageConfig"] = self.image_config
        if self.degraded:
            out["Degraded"] = self.degraded
        return out


@dataclass
class Report(JSONMixin):
    schema_version: int = REPORT_SCHEMA_VERSION
    created_at: str = ""
    artifact_name: str = ""
    artifact_type: str = ""
    metadata: Metadata = field(default_factory=Metadata)
    results: list[Result] = field(default_factory=list)

    def to_dict(self) -> dict:
        out: dict[str, Any] = {"SchemaVersion": self.schema_version}
        if self.created_at:
            out["CreatedAt"] = self.created_at
        if self.artifact_name:
            out["ArtifactName"] = self.artifact_name
        if self.artifact_type:
            out["ArtifactType"] = self.artifact_type
        md = self.metadata.to_dict()
        if md:
            out["Metadata"] = md
        if self.results:
            out["Results"] = [r.to_dict() for r in self.results]
        return out
