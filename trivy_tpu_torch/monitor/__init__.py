"""Continuous monitoring: advisory-delta incremental re-matching.

An hourly trivy-db refresh used to mean re-scanning every indexed
artifact from scratch, even though a typical advisory delta touches a
tiny fraction of (space, name) keys. This subsystem turns a DB
generation promote into a seconds-scale fleet re-score:

- `delta`   — diff two generations' advisory-key fingerprint tables
  (persisted next to the compiled-DB cache) into a touched-key set,
  with "everything touched" fallbacks on schema/format/window changes;
- `index`   — a durable inverted (space, name) → artifact index +
  per-artifact match state, an append log (crash-safe, torn-tail
  tolerant, rebuildable from a scan journal);
- `capture` — a zero-cost-when-off tap that records each scan's
  package inventory and engine-level findings into the index;
- `rematch` — re-match ONLY the affected artifacts through
  `MatchEngine.submit()` micro-batches (the match kernel on the card),
  emit introduced/resolved events, provably equal to a from-scratch
  re-match;
- `watch`   — the `watch` loop and the server-side monitor service
  hooked into the DB hot swap.

`TRIVY_TPU_MONITOR=0` is the kill switch: scans stop recording index
state and promotes stop triggering re-scores.

Copy of trivy_tpu/monitor without the metric handles and the tracing
spans: an event carries the re-score's scan id (drawn from
`utils.uuid`, as the reference's scan scope draws it), never a trace id.
"""

from __future__ import annotations

import os


def enabled() -> bool:
    """TRIVY_TPU_MONITOR=0 disables the monitor subsystem entirely."""
    return os.environ.get("TRIVY_TPU_MONITOR", "1") != "0"


from trivy_tpu_torch.monitor.capture import capture_scan, tap  # noqa: E402
from trivy_tpu_torch.monitor.delta import DeltaPlan, compute_delta  # noqa: E402
from trivy_tpu_torch.monitor.index import (  # noqa: E402
    MonitorIndex,
    MonitorIndexError,
)
from trivy_tpu_torch.monitor.rematch import RescoreReport, rescore  # noqa: E402

__all__ = [
    "DeltaPlan",
    "MonitorIndex",
    "MonitorIndexError",
    "RescoreReport",
    "capture_scan",
    "compute_delta",
    "enabled",
    "rescore",
    "tap",
]
