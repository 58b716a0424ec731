"""Scan options (reference pkg/types/scan.go:115-126).

Copy of trivy_tpu/types/scan.py, trimmed to the options the port's
scan paths read.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch.types.enums import Scanner


@dataclass
class ScanOptions:
    pkg_types: list[str] = field(default_factory=lambda: ["os", "library"])
    scanners: list[Scanner] = field(
        default_factory=lambda: [Scanner.VULN, Scanner.SECRET]
    )
    include_dev_deps: bool = False
    list_all_pkgs: bool = False
    # SBOM discovery sources for unpackaged binaries ("rekor")
    sbom_sources: list[str] = field(default_factory=list)
    rekor_url: str = "https://rekor.sigstore.dev"
