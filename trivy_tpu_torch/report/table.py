"""Table report writer (reference pkg/report/table/): per-target summary
header + vulnerability/secret/misconfig tables with severity colors.

Copy of trivy_tpu/report/table.py.
"""

from __future__ import annotations

import os
import shutil
import sys

from trivy_tpu_torch.types.enums import Severity
from trivy_tpu_torch.types.report import Report, Result

_SEV_ORDER = ["CRITICAL", "HIGH", "MEDIUM", "LOW", "UNKNOWN"]
_SEV_COLOR = {
    "CRITICAL": "\x1b[31m",  # red
    "HIGH": "\x1b[91m",
    "MEDIUM": "\x1b[33m",
    "LOW": "\x1b[36m",
    "UNKNOWN": "\x1b[35m",
}
_RESET = "\x1b[0m"
_BOLD = "\x1b[1m"


def _color_enabled() -> bool:
    return sys.stdout.isatty() and os.environ.get("NO_COLOR") is None


def _sev(s: str, color: bool) -> str:
    return f"{_SEV_COLOR.get(s, '')}{s}{_RESET}" if color else s


def _render_grid(headers: list[str], rows: list[list[str]], color: bool) -> str:
    """Simple box-drawing table with wrapped cells."""
    if not rows:
        return ""
    width_budget = max(shutil.get_terminal_size((150, 40)).columns, 80)
    ncol = len(headers)
    raw_w = [max(len(headers[i]), *(len(_plain(r[i])) for r in rows))
             for i in range(ncol)]
    total = sum(raw_w) + 3 * ncol + 1
    if total > width_budget:
        # shrink the widest columns
        excess = total - width_budget
        order = sorted(range(ncol), key=lambda i: -raw_w[i])
        for i in order:
            cut = min(excess, max(raw_w[i] - 20, 0))
            raw_w[i] -= cut
            excess -= cut
            if excess <= 0:
                break
    sep = "+" + "+".join("-" * (w + 2) for w in raw_w) + "+"
    out = [sep]
    out.append("| " + " | ".join(headers[i].ljust(raw_w[i])
                                 for i in range(ncol)) + " |")
    out.append(sep.replace("-", "="))
    for r in rows:
        wrapped = [_wrap(r[i], raw_w[i]) for i in range(ncol)]
        height = max(len(w) for w in wrapped)
        for line_i in range(height):
            cells = []
            for i in range(ncol):
                cell = wrapped[i][line_i] if line_i < len(wrapped[i]) else ""
                pad = raw_w[i] - len(_plain(cell))
                cells.append(cell + " " * max(pad, 0))
            out.append("| " + " | ".join(cells) + " |")
        out.append(sep)
    return "\n".join(out) + "\n"


def _plain(s: str) -> str:
    import re

    return re.sub(r"\x1b\[[0-9;]*m", "", s)


def _wrap(s: str, width: int) -> list[str]:
    if len(_plain(s)) <= width:
        return [s]
    words = s.split()
    lines, cur = [], ""
    for w in words:
        if cur and len(_plain(cur)) + 1 + len(_plain(w)) > width:
            lines.append(cur)
            cur = w
        else:
            cur = f"{cur} {w}" if cur else w
    if cur:
        lines.append(cur)
    return lines or [""]


def render_table(report: Report, severities=None,
                 dependency_tree: bool = False) -> str:
    color = _color_enabled()
    out = []
    sev_names = [str(s) for s in severities] if severities else _SEV_ORDER
    for res in report.results:
        rendered = _render_result(res, color, sev_names)
        if rendered and dependency_tree and res.vulnerabilities:
            tree = _render_dependency_tree(res)
            if tree:
                rendered += tree
        out.append(rendered)
    text = "\n".join(x for x in out if x)
    return text if text else "No issues detected.\n"


def _render_dependency_tree(res: Result) -> str:
    """--dependency-tree: why is each vulnerable package present?
    Reversed origin tree from the lockfile dependency graph
    (reference pkg/report/table renderedDeps)."""
    parents: dict[str, list[str]] = {}
    by_id: dict[str, object] = {}
    for p in res.packages:
        pid = p.id or f"{p.name}@{p.version}"
        by_id[pid] = p
        for dep in p.depends_on:
            parents.setdefault(dep, []).append(pid)
    if not parents:
        return ""
    vuln_ids = []
    seen = set()
    for v in res.vulnerabilities:
        pid = v.pkg_id or f"{v.pkg_name}@{v.installed_version}"
        if pid not in seen:
            seen.add(pid)
            vuln_ids.append(pid)
    lines = ["", "Dependency Origin Tree (Reversed)", "=" * 33]
    for pid in vuln_ids:
        lines.append(f"{pid} (vulnerable)")
        chain = []
        cur, depth = pid, 0
        while depth < 8:
            ups = parents.get(cur) or []
            if not ups:
                break
            cur = sorted(ups)[0]
            chain.append(cur)
            depth += 1
        for i, anc in enumerate(chain):
            lines.append("    " * i + "└── " + anc)
    return "\n".join(lines) + "\n"


def _render_result(res: Result, color: bool, sev_names) -> str:
    header_lines = []
    body = ""
    if res.vulnerabilities or res.result_class in ("os-pkgs", "lang-pkgs"):
        counts = {s: 0 for s in _SEV_ORDER}
        for v in res.vulnerabilities:
            counts[str(v.severity)] = counts.get(str(v.severity), 0) + 1
        total = len(res.vulnerabilities)
        summary = ", ".join(
            f"{_sev(s, color)}: {counts.get(s, 0)}" for s in sev_names
        )
        title = f"{res.target} ({res.type})" if res.type else res.target
        header_lines.append(f"{_BOLD if color else ''}{title}{_RESET if color else ''}")
        header_lines.append("=" * len(_plain(title)))
        header_lines.append(f"Total: {total} ({summary})")
        rows = [
            [
                v.pkg_name,
                v.vulnerability_id,
                _sev(str(v.severity), color),
                v.status.label if v.status.value else "",
                v.installed_version,
                v.fixed_version,
                (v.info.title if v.info else "") or v.primary_url,
            ]
            for v in res.vulnerabilities
            if str(v.severity) in sev_names
        ]
        body = _render_grid(
            ["Library", "Vulnerability", "Severity", "Status",
             "Installed Version", "Fixed Version", "Title"],
            rows, color,
        )
    elif res.secrets:
        title = f"{res.target} (secrets)"
        header_lines.append(title)
        header_lines.append("=" * len(title))
        rows = [
            [s.category, s.rule_id, _sev(s.severity, color),
             f"{s.start_line}-{s.end_line}", s.title]
            for s in res.secrets
        ]
        body = _render_grid(
            ["Category", "Rule", "Severity", "Lines", "Title"], rows, color
        )
    elif res.misconfigurations:
        title = f"{res.target} ({res.type})"
        header_lines.append(title)
        header_lines.append("=" * len(title))
        if res.misconf_summary:
            header_lines.append(
                f"Tests: {res.misconf_summary.successes + res.misconf_summary.failures} "
                f"(SUCCESSES: {res.misconf_summary.successes}, "
                f"FAILURES: {res.misconf_summary.failures})"
            )
        rows = [
            [m.id, _sev(m.severity, color), m.status, m.message]
            for m in res.misconfigurations
            if m.status == "FAIL" and m.severity in sev_names
        ]
        body = _render_grid(
            ["ID", "Severity", "Status", "Message"], rows, color
        )
    elif res.licenses:
        title = f"{res.target} (license)"
        header_lines.append(title)
        header_lines.append("=" * len(title))
        rows = [
            [l.pkg_name or l.file_path, l.name, l.category,
             _sev(l.severity, color)]
            for l in res.licenses
            if l.severity in sev_names
        ]
        body = _render_grid(
            ["Package/File", "License", "Category", "Severity"], rows, color
        )
    else:
        if not res.modified_findings:
            return ""
    tail = _render_suppressed(res, color)
    if not header_lines and not tail:
        return ""
    head = "\n".join(header_lines) + "\n\n" if header_lines else ""
    return head + (body or "") + tail + "\n"


def _render_suppressed(res: Result, color: bool) -> str:
    """--show-suppressed section (reference pkg/report/table renders
    suppressed vulnerabilities with status/statement/source columns)."""
    if not res.modified_findings:
        return ""
    rows = []
    for m in res.modified_findings:
        f = m.get("Finding", {})
        rows.append([
            f.get("PkgName", ""),
            f.get("VulnerabilityID", ""),
            _sev(f.get("Severity", "UNKNOWN"), color),
            m.get("Status", ""),
            m.get("Statement", ""),
            m.get("Source", ""),
        ])
    title = f"\nSuppressed Vulnerabilities (Total: {len(rows)})\n"
    return title + "=" * (len(title) - 2) + "\n" + _render_grid(
        ["Library", "Vulnerability", "Severity", "Status", "Statement",
         "Source"],
        rows, color,
    )
