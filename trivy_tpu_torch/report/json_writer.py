"""JSON report writer (reference pkg/report JSON format, 2-space indent).

Copy of trivy_tpu/report/json_writer.py.
"""

from __future__ import annotations

import json

from trivy_tpu_torch.types.report import Report


def render_json(report: Report) -> str:
    return json.dumps(report.to_dict(), indent=2, ensure_ascii=False) + "\n"
