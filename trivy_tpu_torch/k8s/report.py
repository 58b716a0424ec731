"""Cluster report writers (reference pkg/k8s/report: summary table with
per-resource severity counts, full json, and the `all` detail view).

Copy of trivy_tpu/k8s/report.py."""

from __future__ import annotations

import json
import sys

from trivy_tpu_torch.k8s.scanner import ClusterReport

_SEVS = ["CRITICAL", "HIGH", "MEDIUM", "LOW", "UNKNOWN"]


def _count(findings, key=lambda f: f.severity) -> dict[str, int]:
    out = {s: 0 for s in _SEVS}
    for f in findings:
        out[key(f)] = out.get(key(f), 0) + 1
    return out


def _vuln_counts(rr) -> dict[str, int]:
    out = {s: 0 for s in _SEVS}
    for _img, rep in rr.image_reports:
        for res in rep.results:
            for v in res.vulnerabilities:
                out[str(v.severity)] = out.get(str(v.severity), 0) + 1
    return out


def to_dict(report: ClusterReport) -> dict:
    resources = []
    for rr in report.resources:
        entry = {
            "Namespace": rr.resource.namespace or "default",
            "Kind": rr.resource.kind,
            "Name": rr.resource.name,
            "Images": rr.images,
            "Misconfigurations": [m.to_dict()
                                  for m in rr.misconfigurations],
        }
        if rr.image_reports:
            entry["Vulnerabilities"] = [
                {"Image": img, "Report": rep.to_dict()}
                for img, rep in rr.image_reports
            ]
        resources.append(entry)
    return {
        "ClusterName": report.cluster_name,
        "Resources": resources,
        "RBACAssessment": [
            {"ID": f.id, "Title": f.title, "Severity": f.severity,
             "Message": f.message, "Resource": f.resource}
            for f in report.rbac
        ],
        "InfraAssessment": [
            {"ID": f.id, "Title": f.title, "Severity": f.severity,
             "Message": f.message, "Resource": f.resource}
            for f in report.infra
        ],
    }


def render_summary(report: ClusterReport) -> str:
    """The `--report summary` table: one row per resource with
    misconfig/vuln severity counts, then RBAC and infra sections."""
    out = [f"Summary Report for {report.cluster_name}", ""]

    def table(headers, rows):
        if not rows:
            return ["  (none)", ""]
        widths = [max(len(h), *(len(str(r[i])) for r in rows))
                  for i, h in enumerate(headers)]
        lines = ["  " + "  ".join(h.ljust(widths[i])
                                  for i, h in enumerate(headers))]
        lines.append("  " + "  ".join("-" * w for w in widths))
        for r in rows:
            lines.append("  " + "  ".join(str(r[i]).ljust(widths[i])
                                          for i in range(len(headers))))
        lines.append("")
        return lines

    rows = []
    for rr in sorted(report.resources,
                     key=lambda r: (r.resource.namespace, r.resource.kind,
                                    r.resource.name)):
        m = _count(rr.misconfigurations)
        v = _vuln_counts(rr)
        sev_cell = "/".join(str(m[s]) for s in _SEVS[:4])
        vuln_cell = "/".join(str(v[s]) for s in _SEVS[:4])
        rows.append([rr.resource.namespace or "default", rr.resource.kind,
                     rr.resource.name, vuln_cell, sev_cell])
    out.append("Workload Assessment (C/H/M/L)")
    out.extend(table(["Namespace", "Kind", "Name", "Vulns", "Misconfigs"],
                     rows))

    out.append("RBAC Assessment")
    out.extend(table(
        ["Severity", "ID", "Resource", "Title"],
        [[f.severity, f.id, f.resource, f.title] for f in report.rbac]))

    out.append("Infra Assessment")
    out.extend(table(
        ["Severity", "ID", "Resource", "Title"],
        [[f.severity, f.id, f.resource, f.title] for f in report.infra]))
    return "\n".join(out)


def render_all(report: ClusterReport) -> str:
    """`--report all`: summary plus each failing misconfiguration."""
    out = [render_summary(report), "", "Detailed Findings", "=" * 17, ""]
    for rr in report.resources:
        if not rr.misconfigurations:
            continue
        out.append(rr.resource.fullname)
        for m in rr.misconfigurations:
            out.append(f"  [{m.severity}] {m.id}: {m.message}")
        out.append("")
    return "\n".join(out)


def write_cluster_report(report: ClusterReport, fmt: str = "summary",
                         output: str | None = None) -> None:
    if fmt == "json":
        text = json.dumps(to_dict(report), indent=2)
    elif fmt == "all":
        text = render_all(report)
    else:
        text = render_summary(report)
    if output:
        # a user-requested report stream: a partial file is the user's
        # lint: allow[atomic-write] user-requested report stream, partial file is visible to the user
        with open(output, "w") as f:
            f.write(text + "\n")
    else:
        sys.stdout.write(text + "\n")
