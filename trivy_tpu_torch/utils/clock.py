"""Context-injectable clock (reference pkg/clock/clock.go:20-37): report
timestamps must be fakeable so golden files byte-match in tests.

Copy of trivy_tpu/utils/clock.py. It reads the same
TRIVY_TPU_FAKE_TIME, so one fixture fakes both packages' clocks.
"""

from __future__ import annotations

import datetime
import os

_fixed: datetime.datetime | None = None


def set_fixed(dt: datetime.datetime | None) -> None:
    global _fixed
    _fixed = dt


def _split_ns(iso: str) -> tuple[str, int]:
    """ISO string with a >6-digit fraction -> (µs-precision ISO, extra
    sub-microsecond nanoseconds). datetime only holds microseconds; the
    remainder is kept so Go-layout formatting can byte-match reference
    goldens rendered with a nanosecond fake clock."""
    import re

    m = re.search(r"\.(\d{7,9})", iso)
    if not m:
        return iso, 0
    digits = m.group(1).ljust(9, "0")
    return iso.replace(m.group(0), "." + digits[:6]), int(digits[6:9])


def now() -> datetime.datetime:
    if _fixed is not None:
        return _fixed
    env = os.environ.get("TRIVY_TPU_FAKE_TIME")
    if env:
        return datetime.datetime.fromisoformat(_split_ns(env)[0])
    return datetime.datetime.now(datetime.timezone.utc)


def ns_extra() -> int:
    """Sub-microsecond nanoseconds (0-999) of the fake time; 0 outside
    tests (real timestamps don't need ns)."""
    env = os.environ.get("TRIVY_TPU_FAKE_TIME")
    return _split_ns(env)[1] if env else 0


def now_rfc3339() -> str:
    t = now()
    if t.tzinfo is None:
        t = t.replace(tzinfo=datetime.timezone.utc)
    return t.isoformat().replace("+00:00", "Z")
