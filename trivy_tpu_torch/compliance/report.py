"""Compliance report building and writing (reference
pkg/compliance/spec/mapper.go, pkg/compliance/report/{report,json,
table,summary}.go).

Scan results are mapped per check ID (vuln ID, misconfig AVD ID, or
custom severity filter), aggregated per spec control, and rendered as
`all` (full evidence) or `summary` (pass/fail counts per control).

Copy of trivy_tpu/compliance/report.py, whole, with its imports rewritten.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field

from trivy_tpu_torch.compliance.spec import FAIL, ComplianceSpec
from trivy_tpu_torch.types.report import Result


@dataclass
class ControlCheckResult:
    id: str
    name: str = ""
    description: str = ""
    severity: str = ""
    default_status: str = ""
    results: list[Result] = field(default_factory=list)

    @property
    def total_fail(self) -> int:
        """Failure count for the summary view (reference
        report/summary.go): every finding attached to a control is a
        failure; a check-less control fails iff DefaultStatus=FAIL."""
        if not self.results:
            return 1 if self.default_status == FAIL else 0
        n = 0
        for r in self.results:
            n += len(r.vulnerabilities) + len(r.secrets)
            n += sum(1 for m in r.misconfigurations if m.status != "PASS")
        return n


@dataclass
class ComplianceReport:
    id: str = ""
    title: str = ""
    description: str = ""
    version: str = ""
    related_resources: list[str] = field(default_factory=list)
    results: list[ControlCheckResult] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not self.results


def _map_result_to_check_ids(result: Result,
                             check_ids: dict[str, list[str]]) -> dict[str, list[Result]]:
    """One scan Result → {check_id: [filtered Results]}
    (reference spec/mapper.go:10-43 + custom.go)."""
    out: dict[str, list[Result]] = {}
    vuln_ids = set(check_ids.get("vuln", []))
    misconf_ids = set(check_ids.get("misconfig", []))
    secret_ids = set(check_ids.get("secret", []))

    for v in result.vulnerabilities:
        if v.vulnerability_id in vuln_ids:
            out.setdefault(v.vulnerability_id, []).append(Result(
                target=result.target, result_class=result.result_class,
                type=result.type, vulnerabilities=[v]))
    for m in result.misconfigurations:
        if m.avd_id in misconf_ids:
            out.setdefault(m.avd_id, []).append(Result(
                target=result.target, result_class=result.result_class,
                type=result.type, misconfigurations=[m]))

    # custom severity-filter IDs (reference spec/custom.go:12-17)
    for cid in vuln_ids:
        if cid.upper().startswith("VULN-"):
            sev = cid.split("-", 1)[1].upper()
            hits = [v for v in result.vulnerabilities
                    if str(v.severity) == sev]
            if hits:
                out.setdefault(cid, []).append(Result(
                    target=result.target, result_class=result.result_class,
                    type=result.type, vulnerabilities=hits))
    for cid in secret_ids:
        if cid.upper().startswith("SECRET-"):
            sev = cid.split("-", 1)[1].upper()
            hits = [s for s in result.secrets if s.severity == sev]
            if hits:
                out.setdefault(cid, []).append(Result(
                    target=result.target, result_class=result.result_class,
                    type=result.type, secrets=hits))
    return out


def build_compliance_report(results: list[Result],
                            cs: ComplianceSpec) -> ComplianceReport:
    check_ids = cs.check_ids()
    by_check: dict[str, list[Result]] = {}
    for result in results:
        for cid, rs in _map_result_to_check_ids(result, check_ids).items():
            by_check.setdefault(cid, []).extend(rs)

    out = ComplianceReport(
        id=cs.spec.id, title=cs.spec.title, description=cs.spec.description,
        version=cs.spec.version, related_resources=cs.spec.related_resources,
    )
    for control in cs.spec.controls:
        rs: list[Result] = []
        for check in control.checks:
            rs.extend(by_check.get(check.id, []))
        out.results.append(ControlCheckResult(
            id=control.id, name=control.name,
            description=control.description, severity=control.severity,
            default_status=control.default_status, results=rs,
        ))
    return out


# ------------------------------------------------------------- writers


def _report_dict(rep: ComplianceReport) -> dict:
    return {
        "ID": rep.id,
        "Title": rep.title,
        "Description": rep.description,
        "Version": rep.version,
        "RelatedResources": rep.related_resources,
        "Results": [
            {
                "ID": c.id,
                "Name": c.name,
                "Description": c.description,
                **({"DefaultStatus": c.default_status}
                   if c.default_status else {}),
                "Severity": c.severity,
                "Results": [r.to_dict() for r in c.results] or None,
            }
            for c in rep.results
        ],
    }


def _summary_dict(rep: ComplianceReport) -> dict:
    return {
        "SchemaVersion": 2,
        "ID": rep.id,
        "Title": rep.title,
        "SummaryControls": [
            {"ID": c.id, "Name": c.name, "Severity": c.severity,
             "TotalFail": c.total_fail}
            for c in rep.results
        ],
    }


def write_compliance_report(rep: ComplianceReport, fmt: str = "table",
                            report: str = "summary", output=None) -> None:
    """fmt: json|table; report: all|summary
    (reference compliance/report/report.go:66-92)."""
    out = output or sys.stdout
    if fmt == "json":
        doc = _report_dict(rep) if report == "all" else _summary_dict(rep)
        out.write(json.dumps(doc, indent=2, default=str) + "\n")
        return
    if rep.empty:
        return
    # table summary (reference report/table.go + summary.go)
    title = f"Summary Report for compliance: {rep.title}"
    rows = [(c.id, c.severity, c.name, str(c.total_fail))
            for c in rep.results]
    headers = ("ID", "Severity", "Control Name", "Failed")
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    sep = "─" * (sum(widths) + 3 * len(widths) + 1)
    out.write(title + "\n" + sep + "\n")
    out.write(" | ".join(h.ljust(w) for h, w in zip(headers, widths)) + "\n")
    out.write(sep + "\n")
    for r in rows:
        out.write(" | ".join(v.ljust(w) for v, w in zip(r, widths)) + "\n")
    out.write(sep + "\n")
