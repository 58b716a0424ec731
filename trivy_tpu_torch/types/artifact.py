"""Artifact analysis data model.

Same shape as the reference fanal model so cached blobs / applied details are
semantically interchangeable:
- Package: reference pkg/fanal/types/package.go:179-219
- BlobInfo/ArtifactDetail: reference pkg/fanal/types/artifact.go:122-175
- Application/PackageInfo/OS: reference pkg/fanal/types/{app,os}.go

Copy of trivy_tpu/types/artifact.py without ExternalRef, CauseMetadata
and License, which nothing of the port uses yet: blobs the two packages
write to a shared cache directory hold the same fields.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

from trivy_tpu_torch.types.enums import Severity

SCHEMA_VERSION = 2  # blob/artifact schema version (ref artifact.go SchemaVersion)


# Field names whose Go JSON rendering is not plain snake->Pascal
_JSON_NAMES = {
    "os": "OS",
    "id": "ID",
    "uid": "UID",
    "purl": "PURL",
    "url": "URL",
    "diff_id": "DiffID",
    "diff_ids": "DiffIDs",
    "avd_id": "AVDID",
    "eosl": "EOSL",
    "rule_id": "RuleID",
    "image_id": "ImageID",
    "cwe_ids": "CweIDs",
    "vendor_ids": "VendorIDs",
    "pkg_id": "PkgID",
    "vulnerability_id": "VulnerabilityID",
    "primary_url": "PrimaryURL",
    "modularity_label": "Modularitylabel",
}


def _pascal(name: str) -> str:
    return _JSON_NAMES.get(name, "".join(p.capitalize() for p in name.split("_")))


def _drop_empty(obj: Any) -> Any:
    """Recursive dataclass -> dict with the reference's Go JSON rendering:
    PascalCase names and `json:",omitempty"` semantics (zero values — 0,
    False, "", empty containers, None — are omitted unless the field is
    marked keep). Classes overriding to_dict() are dispatched to it."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        if type(obj).to_dict is not JSONMixin.to_dict:
            return obj.to_dict()
        out = {}
        for f in dataclasses.fields(obj):
            if f.metadata.get("skip_json"):
                continue
            v = _drop_empty(getattr(obj, f.name))
            if not f.metadata.get("keep") and v in (None, "", 0, False, [], {}, ()):
                continue
            out[f.metadata.get("json", _pascal(f.name))] = v
        return out
    if isinstance(obj, dict):
        return {k: _drop_empty(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_drop_empty(v) for v in obj]
    if isinstance(obj, Severity):
        return str(obj)
    if hasattr(obj, "value") and hasattr(obj, "name") and not isinstance(obj, (int, float)):
        return obj.value  # str enums
    return obj


class JSONMixin:
    def to_dict(self) -> dict:
        return _drop_empty(self)


@dataclass
class Layer(JSONMixin):
    digest: str = ""
    diff_id: str = ""
    created_by: str = ""

    def to_dict(self) -> dict:
        out = {}
        if self.digest:
            out["Digest"] = self.digest
        if self.diff_id:
            out["DiffID"] = self.diff_id
        if self.created_by:
            out["CreatedBy"] = self.created_by
        return out


@dataclass
class Location(JSONMixin):
    start_line: int = 0
    end_line: int = 0

    def to_dict(self) -> dict:
        return {"StartLine": self.start_line, "EndLine": self.end_line}




@dataclass
class PkgIdentifier(JSONMixin):
    """Reference pkg/fanal/types/package.go PkgIdentifier: PURL + UID + BOMRef."""

    purl: str = ""
    uid: str = ""
    bom_ref: str = ""

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        if self.purl:
            out["PURL"] = self.purl
        if self.uid:
            out["UID"] = self.uid
        if self.bom_ref:
            out["BOMRef"] = self.bom_ref
        return out


@dataclass
class Package(JSONMixin):
    name: str = ""
    version: str = ""
    id: str = ""
    identifier: PkgIdentifier = field(default_factory=PkgIdentifier)
    release: str = ""
    epoch: int = 0
    arch: str = ""
    dev: bool = False
    src_name: str = ""
    src_version: str = ""
    src_release: str = ""
    src_epoch: int = 0
    licenses: list[str] = field(default_factory=list)
    maintainer: str = ""
    modularity_label: str = ""
    indirect: bool = False
    relationship: str = ""  # "direct" | "indirect" | "root" | "workspace" | ""
    depends_on: list[str] = field(default_factory=list)
    # Red Hat build metadata attached by the applier (reference attaches
    # the owning layer's buildinfo per package; artifact-level here)
    build_info: "BuildInfo | None" = None
    layer: Layer = field(default_factory=Layer)
    file_path: str = ""
    digest: str = ""
    locations: list[Location] = field(default_factory=list)
    installed_files: list[str] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not self.name or not self.version

    def full_version(self) -> str:
        """epoch:version-release rendering used for OS packages
        (reference pkg/scanner/utils/util.go FormatVersion)."""
        v = self.version
        if self.release:
            v = f"{v}-{self.release}"
        if self.epoch:
            v = f"{self.epoch}:{v}"
        return v

    def full_src_version(self) -> str:
        v = self.src_version
        if self.src_release:
            v = f"{v}-{self.src_release}"
        if self.src_epoch:
            v = f"{self.src_epoch}:{v}"
        return v

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        if self.id:
            out["ID"] = self.id
        if self.name:
            out["Name"] = self.name
        ident = self.identifier.to_dict()
        if ident:
            out["Identifier"] = ident
        if self.version:
            out["Version"] = self.version
        if self.release:
            out["Release"] = self.release
        if self.epoch:
            out["Epoch"] = self.epoch
        if self.arch:
            out["Arch"] = self.arch
        if self.dev:
            out["Dev"] = True
        if self.src_name:
            out["SrcName"] = self.src_name
        if self.src_version:
            out["SrcVersion"] = self.src_version
        if self.src_release:
            out["SrcRelease"] = self.src_release
        if self.src_epoch:
            out["SrcEpoch"] = self.src_epoch
        if self.licenses:
            out["Licenses"] = self.licenses
        if self.maintainer:
            out["Maintainer"] = self.maintainer
        if self.modularity_label:
            out["Modularitylabel"] = self.modularity_label
        if self.relationship:
            out["Relationship"] = self.relationship
        if self.indirect:
            out["Indirect"] = True
        if self.depends_on:
            out["DependsOn"] = self.depends_on
        layer = self.layer.to_dict()
        if layer:
            out["Layer"] = layer
        if self.file_path:
            out["FilePath"] = self.file_path
        if self.digest:
            out["Digest"] = self.digest
        if self.locations:
            out["Locations"] = [loc.to_dict() for loc in self.locations]
        if self.installed_files:
            out["InstalledFiles"] = self.installed_files
        return out


@dataclass
class PackageInfo(JSONMixin):
    """OS packages found at one file path (e.g. lib/apk/db/installed)."""

    file_path: str = ""
    packages: list[Package] = field(default_factory=list)


@dataclass
class Application(JSONMixin):
    """Language-ecosystem app: one lockfile / binary / site-packages set.
    Reference pkg/fanal/types Application."""

    type: str = ""  # LangType value
    file_path: str = ""
    packages: list[Package] = field(default_factory=list)


@dataclass
class OS(JSONMixin):
    family: str = ""
    name: str = ""
    eosl: bool = False
    extended: bool = False  # e.g. Ubuntu ESM

    @property
    def detected(self) -> bool:
        return bool(self.family)

    def merge(self, other: "OS") -> "OS":
        """Layer-merge semantics (reference pkg/fanal/types/artifact.go:38-68):
        earlier detection wins (fill-empty only), EXCEPT a detected
        redhat/debian family is fully replaced — OLE ships
        /etc/redhat-release and Ubuntu ships Debian files, so the more
        specific later file must override. Extended (ESM) is sticky."""
        if not other.detected and not other.name:
            return self
        if self.family in ("redhat", "debian"):
            return OS(family=other.family, name=other.name,
                      eosl=other.eosl, extended=other.extended)
        return OS(
            family=self.family or other.family,
            name=self.name or other.name,
            eosl=self.eosl,
            extended=self.extended or other.extended,
        )

    def to_dict(self) -> dict:
        out: dict[str, Any] = {"Family": self.family, "Name": self.name}
        if self.eosl:
            out["EOSL"] = True
        return out


@dataclass
class Repository(JSONMixin):
    family: str = ""
    release: str = ""




@dataclass
class Misconfiguration(JSONMixin):
    file_type: str = ""
    file_path: str = ""
    successes: list = field(default_factory=list)
    failures: list = field(default_factory=list)


@dataclass
class SecretFinding(JSONMixin):
    rule_id: str = ""
    category: str = ""
    severity: str = "UNKNOWN"
    title: str = ""
    start_line: int = 0
    end_line: int = 0
    match: str = ""
    code: Any = None
    offset: int = 0
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
        if self.code is not None:
            out["Code"] = self.code
        layer = self.layer.to_dict()
        if layer:
            out["Layer"] = layer
        return out


@dataclass
class Secret(JSONMixin):
    file_path: str = ""
    findings: list[SecretFinding] = field(default_factory=list)


@dataclass
class LicenseFinding(JSONMixin):
    category: str = ""
    name: str = ""
    confidence: float = 1.0
    link: str = ""


@dataclass
class LicenseFile(JSONMixin):
    type: str = ""  # "dpkg" | "header" | "license-file"
    file_path: str = ""
    package_name: str = ""
    findings: list[LicenseFinding] = field(default_factory=list)
    layer: Layer = field(default_factory=Layer)




@dataclass
class CustomResource(JSONMixin):
    type: str = ""
    file_path: str = ""
    layer: Layer = field(default_factory=Layer)
    data: Any = None


@dataclass
class BuildInfo(JSONMixin):
    """Red Hat build metadata (reference artifact.go BuildInfo):
    content sets from root/buildinfo content manifests, NVR/arch from
    buildinfo Dockerfiles — used for Red Hat advisory matching."""

    content_sets: list[str] = field(default_factory=list)
    nvr: str = ""
    arch: str = ""


@dataclass
class BlobInfo(JSONMixin):
    """Per-layer (or per-pseudo-blob) analysis result
    (reference pkg/fanal/types/artifact.go:122-149)."""

    schema_version: int = field(default=SCHEMA_VERSION, metadata={"keep": True})
    digest: str = ""
    diff_id: str = ""
    created_by: str = ""
    opaque_dirs: list[str] = field(default_factory=list)
    whiteout_files: list[str] = field(default_factory=list)
    os: OS = field(default_factory=OS)
    repository: Repository | None = None
    package_infos: list[PackageInfo] = field(default_factory=list)
    applications: list[Application] = field(default_factory=list)
    misconfigurations: list[Misconfiguration] = field(default_factory=list)
    secrets: list[Secret] = field(default_factory=list)
    licenses: list[LicenseFile] = field(default_factory=list)
    custom_resources: list[CustomResource] = field(default_factory=list)
    build_info: BuildInfo | None = None
    # sha256 digests of unpackaged executables (rekor SBOM discovery)
    digests: dict[str, str] = field(default_factory=dict)


@dataclass
class ArtifactInfo(JSONMixin):
    """Per-artifact config analysis (image config) result."""

    schema_version: int = field(default=SCHEMA_VERSION, metadata={"keep": True})
    architecture: str = ""
    created: str = ""
    docker_version: str = ""
    os: str = ""
    misconfiguration: Misconfiguration | None = None
    secret: Secret | None = None
    history_packages: list[Package] = field(default_factory=list)


@dataclass
class ArtifactDetail(JSONMixin):
    """Squashed view of all layers (reference artifact.go:152-175 +
    applier output pkg/fanal/applier/docker.go:95)."""

    os: OS = field(default_factory=OS)
    repository: Repository | None = None
    packages: list[Package] = field(default_factory=list)
    applications: list[Application] = field(default_factory=list)
    misconfigurations: list[Misconfiguration] = field(default_factory=list)
    secrets: list[Secret] = field(default_factory=list)
    licenses: list[LicenseFile] = field(default_factory=list)
    image_config: ArtifactInfo | None = None
    custom_resources: list[CustomResource] = field(default_factory=list)
    build_info: BuildInfo | None = None
    digests: dict[str, str] = field(default_factory=dict)
