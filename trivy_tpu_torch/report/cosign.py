"""Cosign vulnerability-attestation predicate writer
(reference pkg/report/predicate/vuln.go).

Wraps the full JSON report in the https://cosign.sigstore.dev/attestation/
vuln/v1 predicate shape so it can be attached to an image with
`cosign attest --type vuln`.

Copy of trivy_tpu/report/cosign.py.
"""

from __future__ import annotations

import json

import trivy_tpu_torch
from trivy_tpu_torch.types.report import Report
from trivy_tpu_torch.utils import clock, uuid as uuidgen


def render_cosign_vuln(report: Report) -> str:
    now = clock.now_rfc3339()
    doc = {
        "invocation": {
            "parameters": None,
            "uri": "",
            "event_id": uuidgen.new(),
            "builder.id": "",
        },
        "scanner": {
            "uri": f"pkg:github/trivy-tpu@{trivy_tpu_torch.__version__}",
            "version": trivy_tpu_torch.__version__,
            "db": {
                "uri": "",
                "version": "",
            },
            "result": report.to_dict(),
        },
        "metadata": {
            "scanStartedOn": now,
            "scanFinishedOn": now,
        },
    }
    return json.dumps(doc, indent=2, ensure_ascii=False) + "\n"
