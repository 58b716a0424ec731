"""UUID source, switchable to deterministic for tests
(reference pkg/uuid).

Copy of trivy_tpu/utils/uuid.py. The counter is the port's own: tests
that compare reports with the reference's under
TRIVY_TPU_DETERMINISTIC_UUID=1 reset both.
"""

from __future__ import annotations

import os
import uuid as _uuid

_counter = 0


def new() -> str:
    global _counter
    if os.environ.get("TRIVY_TPU_DETERMINISTIC_UUID") == "1":
        _counter += 1
        return f"00000000-0000-0000-0000-{_counter:012d}"
    return str(_uuid.uuid4())


def reset() -> None:
    global _counter
    _counter = 0


def set_lane(lane: int) -> None:
    """Jump the deterministic counter to a per-slot lane (no-op effect
    outside TRIVY_TPU_DETERMINISTIC_UUID=1, where uuids are random
    anyway). Fleet scans pin each artifact to lane = its fleet index,
    so a resumed run hands every artifact the same uuid stream as an
    uninterrupted one — a prerequisite for byte-identical reports when
    blob ids are uuid-keyed (fs artifacts)."""
    global _counter
    _counter = lane * 1_000_000
