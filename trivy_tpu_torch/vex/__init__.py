"""VEX (Vulnerability Exploitability eXchange) suppression
(reference pkg/vex): OpenVEX, CycloneDX VEX, and CSAF documents filter
detected vulnerabilities whose status a vendor has asserted.

Copy of trivy_tpu/vex/__init__.py.
"""

from trivy_tpu_torch.vex.vex import (  # noqa: F401
    VexDocument,
    VexStatement,
    filter_report_vex,
    load_vex,
)
