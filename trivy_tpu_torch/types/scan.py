"""Scan options (reference pkg/types/scan.go:115-126).

Copy of trivy_tpu/types/scan.py without ScanTarget. Every field of the
reference's ScanOptions is kept, so a scan request encodes to the same
wire bytes in both packages; `pkg_relationships`, `severities`,
`detection_priority`, `license_full` and `distro` travel over the wire
but no scan path of either package reads them (`license_categories` is
read by `licensing/scanner.py`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch.types.enums import Scanner, Severity


@dataclass
class ScanOptions:
    pkg_types: list[str] = field(default_factory=lambda: ["os", "library"])
    pkg_relationships: list[str] = field(default_factory=list)
    scanners: list[Scanner] = field(
        default_factory=lambda: [Scanner.VULN, Scanner.SECRET]
    )
    severities: list[Severity] = field(default_factory=list)
    include_dev_deps: bool = False
    detection_priority: str = "precise"  # "precise" | "comprehensive"
    license_full: bool = False
    license_categories: dict[str, list[str]] = field(default_factory=dict)
    distro: str = ""
    list_all_pkgs: bool = False
    # SBOM discovery sources for unpackaged binaries ("rekor")
    sbom_sources: list[str] = field(default_factory=list)
    rekor_url: str = "https://rekor.sigstore.dev"
