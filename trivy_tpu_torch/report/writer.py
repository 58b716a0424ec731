"""Report writer dispatch (reference pkg/report/writer.go:45-99).

Copy of trivy_tpu/report/writer.py.
"""

from __future__ import annotations

import sys

from trivy_tpu_torch.types.report import Report

FORMATS = ("table", "json", "sarif", "cyclonedx", "spdx-json", "github",
           "cosign-vuln", "template")


def write_report(
    report: Report,
    fmt: str = "table",
    output: str | None = None,
    template: str | None = None,
    severities=None,
    dependency_tree: bool = False,
) -> None:
    if fmt == "json":
        from trivy_tpu_torch.report.json_writer import render_json

        text = render_json(report)
    elif fmt == "table":
        from trivy_tpu_torch.report.table import render_table

        text = render_table(report, severities=severities,
                            dependency_tree=dependency_tree)
    elif fmt == "sarif":
        from trivy_tpu_torch.report.sarif import render_sarif

        text = render_sarif(report)
    elif fmt == "cyclonedx":
        from trivy_tpu_torch.report.cyclonedx import render_cyclonedx

        text = render_cyclonedx(report)
    elif fmt == "spdx-json":
        from trivy_tpu_torch.report.spdx import render_spdx_json

        text = render_spdx_json(report)
    elif fmt == "github":
        from trivy_tpu_torch.report.github import render_github

        text = render_github(report)
    elif fmt == "cosign-vuln":
        from trivy_tpu_torch.report.cosign import render_cosign_vuln

        text = render_cosign_vuln(report)
    elif fmt == "template":
        from trivy_tpu_torch.report.template import render_template

        if not template:
            raise ValueError("--format template requires --template")
        text = render_template(report, template)
    else:
        raise ValueError(f"unknown format {fmt!r} (supported: {FORMATS})")

    if output:
        # lint: allow[atomic-write] user-requested report stream (--output), partial file is visible to the user
        with open(output, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)


def read_report_json(path: str) -> dict:
    import json

    with open(path) as f:
        return json.load(f)
