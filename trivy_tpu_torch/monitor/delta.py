"""Compiled-DB delta diff: old generation vs new → touched advisory keys.

Both sides load cheaply: `tensorize.cache.save_keymap` persists a
per-(space, name) content-fingerprint table next to each generation's
compiled tensor entry, so a promote-time diff reads two small gzipped
tables instead of two full advisory DBs. When the old table is gone
(pruned, pre-monitor generation) the old generation directory itself is
tried; when that is gone too — or schema / fingerprint-format / window
parameters changed — the plan degrades to "everything touched", which
re-matches every indexed artifact. Every fallback rung is *more* work,
never a wrong answer.

Copy of trivy_tpu/monitor/delta.py.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import tracing

_log = logger("monitor.delta")

# above this touched-key fraction an incremental pass stops paying for
# itself (the index intersection + per-artifact bookkeeping approaches
# the cost of just re-matching everything)
DEFAULT_FULL_THRESHOLD = 0.5


def full_threshold() -> float:
    raw = os.environ.get("TRIVY_TPU_DELTA_FULL_THRESHOLD", "")
    try:
        return float(raw) if raw else DEFAULT_FULL_THRESHOLD
    except ValueError:
        _log.warn("malformed TRIVY_TPU_DELTA_FULL_THRESHOLD; using "
                  "default", value=raw)
        return DEFAULT_FULL_THRESHOLD


@dataclass
class DeltaPlan:
    """What a promote means for the fleet: which advisory keys moved.

    ``full=True`` → the touched set could not be (cheaply and provably)
    bounded; re-match everything. ``full=False`` with an empty
    ``touched`` set → a no-op promote (same content digest)."""

    old_digest: str | None
    new_digest: str | None
    full: bool = False
    reason: str = ""  # why full (empty for an incremental plan)
    touched: frozenset = field(default_factory=frozenset)
    n_keys: int = 0  # size of the new generation's key table


def compute_delta(db_path: str, old_digest: str | None, new_db,
                  new_digest: str | None = None,
                  params_changed: str | None = None) -> DeltaPlan:
    """Diff the `old_digest` generation against `new_db` (the already
    loaded candidate) → DeltaPlan. `params_changed` names a
    non-content reason to distrust the diff (window params, fingerprint
    format) and forces a full plan."""
    from trivy_tpu_torch.tensorize import cache as compile_cache

    t0 = time.perf_counter()
    with tracing.span("delta.diff", old=old_digest or "",
                      new=new_digest or ""):
        plan = _compute(db_path, old_digest, new_db, new_digest,
                        params_changed, compile_cache)
    obs_metrics.DELTA_DIFF_SECONDS.observe(time.perf_counter() - t0)
    if plan.full:
        obs_metrics.DELTA_FULL_RESCANS.inc(reason=plan.reason or "unknown")
        _log.warn("advisory delta fell back to a full re-score",
                  reason=plan.reason, old=plan.old_digest,
                  new=plan.new_digest)
    else:
        obs_metrics.DELTA_TOUCHED_KEYS.set(len(plan.touched))
        _log.info("advisory delta computed", touched=len(plan.touched),
                  keys=plan.n_keys, old=plan.old_digest,
                  new=plan.new_digest,
                  diff_s=round(time.perf_counter() - t0, 3))
    return plan


def _compute(db_path: str, old_digest: str | None, new_db,
             new_digest: str | None, params_changed: str | None,
             compile_cache) -> DeltaPlan:
    new_digest = new_digest or compile_cache.db_digest(db_path)

    def full(reason: str) -> DeltaPlan:
        return DeltaPlan(old_digest, new_digest, full=True, reason=reason)

    if params_changed:
        return full(params_changed)
    if new_digest is None:
        return full("new-digest-unavailable")
    if old_digest is None:
        return full("no-baseline-generation")
    if old_digest == new_digest:
        # same content: nothing moved, nothing to re-match
        return DeltaPlan(old_digest, new_digest)
    # the new side: persist-then-load keeps one canonical computation
    compile_cache.save_keymap(db_path, new_db, digest=new_digest)
    new_map = compile_cache.load_keymap(db_path, new_digest)
    if new_map is None:
        # cache disabled/unwritable: compute in memory, still exact
        new_map = {"schema": new_db.meta.version,
                   "keys": compile_cache.advisory_fingerprints(new_db)}
    old_map = compile_cache.load_keymap(db_path, old_digest)
    if old_map is None:
        old_map = _fingerprints_from_generation(db_path, old_digest,
                                                compile_cache)
    if old_map is None:
        return full("old-fingerprints-unavailable")
    if old_map.get("schema") != new_map.get("schema"):
        return full("schema-version-changed")
    old_keys, new_keys = old_map["keys"], new_map["keys"]
    touched = {k for k in old_keys.keys() | new_keys.keys()
               if old_keys.get(k) != new_keys.get(k)}
    n_keys = max(len(new_keys), 1)
    if len(touched) / n_keys > full_threshold():
        return full("touched-fraction-above-threshold")
    return DeltaPlan(old_digest, new_digest,
                     touched=frozenset(touched), n_keys=len(new_keys))


def _fingerprints_from_generation(db_path: str, old_digest: str,
                                  compile_cache):
    """Fallback old side: the previous generation directory is usually
    still installed under generations/ — load it and fingerprint in
    memory. None when the bytes are gone (→ full re-score)."""
    if not old_digest.startswith("sha256-"):
        return None
    from trivy_tpu_torch.db import generations
    from trivy_tpu_torch.db.store import AdvisoryDB

    gen_dir = os.path.join(generations.generations_root(db_path),
                           old_digest)
    if not os.path.isdir(gen_dir):
        return None
    try:
        old_db = AdvisoryDB.load(gen_dir)
    except (OSError, EOFError, ValueError, KeyError, TypeError) as exc:
        _log.warn("previous generation unreadable for delta diff",
                  path=gen_dir, err=str(exc))
        return None
    _log.info("fingerprinting previous generation from disk (no cached "
              "keymap)", path=gen_dir)
    return {"schema": old_db.meta.version,
            "keys": compile_cache.advisory_fingerprints(old_db)}
