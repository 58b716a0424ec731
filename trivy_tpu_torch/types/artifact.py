"""Artifact analysis data model, trimmed to the secret findings.

Copy of trivy_tpu/types/artifact.py (same JSON rendering as the
reference fanal model: SecretFinding and Secret are
pkg/fanal/types/secret.go's shapes), keeping only what the port's
secret scanner returns: the JSON helpers, Layer, SecretFinding and
Secret.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

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
