"""Report writer dispatch (reference pkg/report/writer.go:45-99).

Copy of trivy_tpu/report/writer.py, trimmed to the formats the port
renders (`FORMATS`). The reference's other formats raise "not ported
yet".
"""

from __future__ import annotations

import sys

from trivy_tpu_torch.types.report import Report

FORMATS = ("table", "json")
# formats trivy_tpu renders that the port does not yet
NOT_PORTED = ("sarif", "cyclonedx", "spdx-json", "github", "cosign-vuln",
              "template")


def write_report(
    report: Report,
    fmt: str = "table",
    output: str | None = None,
    severities=None,
) -> None:
    if fmt == "json":
        from trivy_tpu_torch.report.json_writer import render_json

        text = render_json(report)
    elif fmt == "table":
        from trivy_tpu_torch.report.table import render_table

        text = render_table(report, severities=severities)
    elif fmt in NOT_PORTED:
        raise ValueError(f"format {fmt!r} is not ported yet "
                         f"(supported: {', '.join(FORMATS)})")
    else:
        raise ValueError(f"unknown format {fmt!r} (supported: {FORMATS})")

    if output:
        with open(output, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
