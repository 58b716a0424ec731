"""Advisory-DB generation layout.

A DB root managed by the verified download path looks like:

    <db_root>/
      generations/
        sha256-<hex>/             one fully-staged, fsynced install
        sha256-<hex>.quarantine   a generation that failed validation
      last-good -> generations/sha256-<hex>     (symlink, atomically swapped)

Readers (`AdvisoryDB.load`, the compiled-DB cache's digest) resolve the
root through `resolve()`: when a `last-good` link exists it wins,
otherwise the root itself is the (legacy, flat) DB directory — so
`db import`-style flat installs keep working unchanged.

Invariants:

- a generation directory appears in `generations/` only after every
  file in it has been fsynced and the staging dir atomically renamed;
- `last-good` only ever points at a generation that passed validation,
  and is swapped via symlink-rename, never edited in place.

Copy of trivy_tpu/db/generations.py with the reader side, what `db
download` (`db/oci.py` `install_artifact`) needs to install and promote
a generation, the server's quarantine of a rejected one, and the
fleet rollout's `current_generation`; the generation listing is not
ported yet.
"""

from __future__ import annotations

import contextlib
import os
import time

from trivy_tpu_torch.durability import atomic
from trivy_tpu_torch.log import logger

_log = logger("db.generations")

GENERATIONS_DIR = "generations"
LAST_GOOD = "last-good"
QUARANTINE_SUFFIX = ".quarantine"


def gen_name(digest: str) -> str:
    """OCI digest -> filesystem-safe generation directory name."""
    return digest.replace(":", "-")


def generations_root(db_root: str) -> str:
    return os.path.join(db_root, GENERATIONS_DIR)


def last_good_path(db_root: str) -> str:
    return os.path.join(db_root, LAST_GOOD)


def resolve(db_root: str) -> str:
    """The directory a reader should load: the last-good generation when
    one is installed, else the root itself (legacy flat layout)."""
    lg = last_good_path(db_root)
    if os.path.isdir(lg):  # follows the symlink
        return lg
    return db_root


def current_generation(db_root: str) -> str | None:
    """Real path of the generation last-good points at, or None."""
    lg = last_good_path(db_root)
    if not os.path.islink(lg):
        return None
    target = os.path.realpath(lg)
    return target if os.path.isdir(target) else None


def promote(db_root: str, gen_dir: str) -> None:
    """Atomically repoint last-good at `gen_dir` (symlink + rename; a
    crash leaves either the old or the new link, never neither)."""
    rel = os.path.relpath(gen_dir, db_root)
    tmp = os.path.join(db_root, f".{LAST_GOOD}.tmp-{os.getpid()}")
    # collect tmp symlinks orphaned by a crash mid-promote (age-gated:
    # a younger one may belong to a live concurrent promoter)
    for name in os.listdir(db_root):
        if not name.startswith(f".{LAST_GOOD}.tmp-"):
            continue
        p = os.path.join(db_root, name)
        with contextlib.suppress(OSError):
            if p == tmp or \
                    os.lstat(p).st_mtime < time.time() - atomic.STALE_TMP_AGE_S:
                os.unlink(p)
    os.symlink(rel, tmp)
    # lint: allow[atomic-write] this IS the atomic promote: tmp symlink + rename
    os.replace(tmp, last_good_path(db_root))
    atomic.fsync_dir(db_root)


def quarantine(db_root: str, gen_dir: str) -> str | None:
    """Move a rejected generation aside so it is never served or
    silently reinstalled; repairs last-good if it pointed there.
    Returns the quarantine path (None when gen_dir is already gone)."""
    if not os.path.isdir(gen_dir):
        return None
    dest = gen_dir.rstrip("/") + QUARANTINE_SUFFIX
    n = 0
    while os.path.exists(dest):
        n += 1
        dest = f"{gen_dir.rstrip('/')}{QUARANTINE_SUFFIX}.{n}"
    os.rename(gen_dir, dest)
    atomic.fsync_dir(os.path.dirname(gen_dir))
    lg = last_good_path(db_root)
    if os.path.islink(lg) and not os.path.isdir(lg):
        # last-good dangled at the quarantined generation: drop it so
        # readers fall back to the flat layout instead of ENOENT
        with contextlib.suppress(FileNotFoundError):
            os.unlink(lg)
    _log.warn("quarantined advisory-DB generation", path=dest)
    return dest


def sweep_staging(db_root: str,
                  min_age_s: float = atomic.STALE_TMP_AGE_S) -> int:
    """Remove crash leftovers: staging dirs whose rename never happened,
    older than `min_age_s` (so a concurrent installer's live staging
    survives). Returns how many were removed."""
    import shutil

    root = generations_root(db_root)
    removed = 0
    cutoff = time.time() - min_age_s
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    for name in names:
        if ".tmp-" not in name:
            continue
        p = os.path.join(root, name)
        try:
            if os.stat(p).st_mtime > cutoff:
                continue
        except OSError:
            continue
        shutil.rmtree(p, ignore_errors=True)
        removed += 1
    return removed


def is_quarantined(db_root: str, name: str) -> bool:
    """Was a generation of this name ever quarantined? A re-download of
    the same digest must not silently reinstall known-bad bytes."""
    root = generations_root(db_root)
    try:
        names = os.listdir(root)
    except OSError:
        return False
    return any(n.startswith(name + QUARANTINE_SUFFIX) for n in names)
