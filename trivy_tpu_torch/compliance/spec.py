"""Compliance spec model and loading (reference
pkg/compliance/spec/compliance.go + pkg/iac/types/compliance.go).

A spec is a YAML document `spec: {id, title, version, controls: [...]}`;
each control maps to scanner check IDs (AVD-* → misconfig, CVE-*/DLA-* →
vuln) or to custom severity-filter IDs (VULN-CRITICAL, SECRET-HIGH, …).
`--compliance <name>` loads a builtin spec; `--compliance @path` loads a
user spec from disk (compliance.go:86-120).

Copy of trivy_tpu/compliance/spec.py, whole, with its imports rewritten.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import yaml

FAIL = "FAIL"
PASS = "PASS"
WARN = "WARN"


@dataclass
class SpecCheck:
    id: str


@dataclass
class Control:
    id: str
    name: str = ""
    description: str = ""
    checks: list[SpecCheck] = field(default_factory=list)
    severity: str = "UNKNOWN"
    default_status: str = ""  # control with no checks: PASS/FAIL verdict


@dataclass
class Spec:
    id: str = ""
    title: str = ""
    description: str = ""
    version: str = ""
    platform: str = ""
    type: str = ""
    related_resources: list[str] = field(default_factory=list)
    controls: list[Control] = field(default_factory=list)


class SpecError(ValueError):
    pass


def scanner_by_check_id(check_id: str) -> str:
    """check-ID prefix → scanner (reference compliance.go:59-73)."""
    low = check_id.lower()
    if low.startswith(("cve-", "dla-", "vuln-")):
        return "vuln"
    if low.startswith("avd-"):
        return "misconfig"
    if low.startswith("secret-"):
        return "secret"
    return "unknown"


@dataclass
class ComplianceSpec:
    spec: Spec

    def scanners(self) -> list[str]:
        out = []
        for control in self.spec.controls:
            for check in control.checks:
                s = scanner_by_check_id(check.id)
                if s == "unknown":
                    raise SpecError(f"unsupported check ID: {check.id}")
                if s not in out:
                    out.append(s)
        return out

    def check_ids(self) -> dict[str, list[str]]:
        out: dict[str, list[str]] = {}
        for control in self.spec.controls:
            for check in control.checks:
                out.setdefault(scanner_by_check_id(check.id), []).append(check.id)
        return out


def _parse_spec(doc: dict) -> ComplianceSpec:
    s = doc.get("spec") or {}
    controls = []
    for c in s.get("controls") or []:
        controls.append(Control(
            id=str(c.get("id", "")),
            name=c.get("name", ""),
            description=c.get("description", ""),
            checks=[SpecCheck(id=str(ch.get("id", "")))
                    for ch in (c.get("checks") or [])],
            severity=c.get("severity", "UNKNOWN"),
            default_status=c.get("defaultStatus", ""),
        ))
    return ComplianceSpec(Spec(
        id=s.get("id", ""),
        title=s.get("title", ""),
        description=s.get("description", ""),
        version=str(s.get("version", "")),
        platform=s.get("platform", ""),
        type=s.get("type", ""),
        related_resources=list(s.get("relatedResources") or []),
        controls=controls,
    ))


def get_compliance_spec(name_or_path: str) -> ComplianceSpec:
    """Builtin spec by name, or `@/path/to/spec.yaml` from disk."""
    if not name_or_path:
        raise SpecError("empty compliance spec name")
    if name_or_path.startswith("@"):
        path = name_or_path[1:]
        with open(path, "rb") as f:
            return _parse_spec(yaml.safe_load(f) or {})
    from trivy_tpu_torch.compliance.builtin import BUILTIN_SPECS

    raw = BUILTIN_SPECS.get(name_or_path)
    if raw is None:
        raise SpecError(
            f"unknown compliance spec {name_or_path!r} "
            f"(builtin: {', '.join(sorted(BUILTIN_SPECS))}; "
            f"use @path for a custom spec)")
    return _parse_spec(yaml.safe_load(raw) or {})


def exists(name_or_path: str) -> bool:
    if name_or_path.startswith("@"):
        return os.path.exists(name_or_path[1:])
    from trivy_tpu_torch.compliance.builtin import BUILTIN_SPECS
    return name_or_path in BUILTIN_SPECS
