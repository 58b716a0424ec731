"""Durability layer: crash-safe state for the port's durable paths.

- `atomic` — tmp+fsync+rename writes, sha256 checksum framing, stale-tmp
  sweeping, whole-tree fsync for staged directories
- `journal` — append-only JSONL fleet-scan journal with torn-tail
  tolerant replay (read by the monitor index's rebuild; the fleet mode
  that writes one is not ported yet)
- `appendlog` — the generic fsynced JSONL append-log primitive the
  journal pioneered, reused by the monitor's package→artifact index

Copy of trivy_tpu/durability/__init__.py. Stdlib-only, so it imports
from the cache, the DB lifecycle, the server and tests without torch.
"""

from trivy_tpu_torch.durability.appendlog import AppendLog, AppendLogError
from trivy_tpu_torch.durability.atomic import (
    CorruptEntry,
    atomic_write,
    frame,
    fsync_dir,
    fsync_tree,
    sweep_stale_tmp,
    unframe,
)
from trivy_tpu_torch.durability.journal import (
    JournalError,
    ScanJournal,
    options_fingerprint,
    report_digest,
)

__all__ = [
    "AppendLog",
    "AppendLogError",
    "CorruptEntry",
    "JournalError",
    "ScanJournal",
    "atomic_write",
    "frame",
    "fsync_dir",
    "fsync_tree",
    "options_fingerprint",
    "report_digest",
    "sweep_stale_tmp",
    "unframe",
]
