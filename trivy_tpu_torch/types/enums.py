"""Enumerations for the data model.

Copy of trivy_tpu/types/enums.py, trimmed to the enums the sbom scan
path uses: Severity, Scanner, ResultClass and Status.

References: pkg/types/scan.go:31-50 (Scanners), dbTypes severity.
"""

from __future__ import annotations

import enum


class Severity(enum.IntEnum):
    """Ordered severity (reference trivy-db types: Unknown..Critical)."""

    UNKNOWN = 0
    LOW = 1
    MEDIUM = 2
    HIGH = 3
    CRITICAL = 4

    def __str__(self) -> str:  # renders like the reference report JSON
        return self.name

    @classmethod
    def parse(cls, s: str) -> "Severity":
        try:
            return cls[s.strip().upper()]
        except KeyError:
            return cls.UNKNOWN


class Scanner(str, enum.Enum):
    """Which scanner classes run (reference pkg/types/scan.go:31-50)."""

    VULN = "vuln"
    MISCONFIG = "misconfig"
    SECRET = "secret"
    LICENSE = "license"
    NONE = "none"


class ResultClass(str, enum.Enum):
    """Result.Class (reference pkg/types/report.go ClassOSPkg etc.)."""

    OS_PKGS = "os-pkgs"
    LANG_PKGS = "lang-pkgs"
    CONFIG = "config"
    SECRET = "secret"
    LICENSE = "license"
    LICENSE_FILE = "license-file"
    CUSTOM = "custom"

    def __str__(self) -> str:  # str() must render the wire value
        return self.value


class Status(enum.IntEnum):
    """Vulnerability status (reference trivy-db types.Status)."""

    UNKNOWN = 0
    NOT_AFFECTED = 1
    AFFECTED = 2
    FIXED = 3
    UNDER_INVESTIGATION = 4
    WILL_NOT_FIX = 5
    FIX_DEFERRED = 6
    END_OF_LIFE = 7

    @property
    def label(self) -> str:
        return self.name.lower()

    def __str__(self) -> str:
        return self.label

    @classmethod
    def parse(cls, s: str) -> "Status":
        try:
            return cls[s.strip().upper()]
        except KeyError:
            return cls.UNKNOWN
