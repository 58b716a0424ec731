"""Misconfiguration -> report Result shaping (reference
pkg/scanner/local/scan.go:371 misconfsToResults).

Copy of trivy_tpu/misconf/result.py, whole.
"""

from __future__ import annotations

from trivy_tpu_torch.types.artifact import Misconfiguration
from trivy_tpu_torch.types.enums import ResultClass
from trivy_tpu_torch.types.report import (
    DetectedMisconfiguration,
    MisconfSummary,
    Result,
)
from trivy_tpu_torch.types.serde import from_dict


def _rebuild(items) -> list[DetectedMisconfiguration]:
    # Misconfiguration.successes/failures are untyped lists, so entries
    # come back as plain dicts after a cache round-trip
    return [
        m if isinstance(m, DetectedMisconfiguration)
        else from_dict(DetectedMisconfiguration, m)
        for m in items
    ]


def to_result(misconf: Misconfiguration) -> Result | None:
    misconf.successes = _rebuild(misconf.successes)
    misconf.failures = _rebuild(misconf.failures)
    if not misconf.successes and not misconf.failures:
        return None
    return Result(
        target=misconf.file_path,
        result_class=ResultClass.CONFIG,
        type=misconf.file_type,
        misconf_summary=MisconfSummary(
            successes=len(misconf.successes),
            failures=len(misconf.failures),
        ),
        misconfigurations=sorted(
            list(misconf.failures) + list(misconf.successes),
            key=lambda m: m.sort_key(),
        ),
    )
