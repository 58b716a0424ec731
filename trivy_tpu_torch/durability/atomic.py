"""Crash-safe write primitives (docs/durability.md).

Every durable state path in the system — cache entries, advisory-DB
files, journal segments — funnels through these helpers so the
durability contract lives in one place:

- a reader never observes a half-written file (tmp + fsync + rename);
- silent corruption is detectable (sha256 footer on framed payloads);
- crash points are deterministically testable (resilience.faults
  ``kill`` / ``torn-write`` / ``bitflip`` rules keyed by write site).

Copy of trivy_tpu/durability/atomic.py.
"""

from __future__ import annotations

import contextlib
import errno
import hashlib
import os
import uuid

from trivy_tpu_torch.resilience import faults

# footer marker for checksummed payloads: <body> "\n#sha256:" <hex>
CHECKSUM_MARK = b"\n#sha256:"


class CorruptEntry(Exception):
    """A framed payload failed its checksum (or never finished)."""


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename/creation inside it is durable.
    Best-effort on platforms that refuse O_RDONLY dir fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        with contextlib.suppress(OSError):
            os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write(path: str, data: bytes, fault_site: str = "") -> None:
    """Write `data` to `path` atomically: unique tmp sibling, fsync,
    rename over the destination, fsync the directory.

    `fault_site` names the write for the fault injector: torn-write /
    bitflip rules mangle the payload (simulating rot the reader must
    catch), and a ``kill`` rule at ``<site>.commit`` dies after the tmp
    file is durable but before the rename, proving a crash there leaves
    the previous version intact and only a stale tmp behind."""
    if fault_site:
        data = faults.mangle_write(fault_site, data)
    d = os.path.dirname(path) or "."
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp-{uuid.uuid4().hex}")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
    with os.fdopen(fd, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    if fault_site:
        faults.check_kill(fault_site + ".commit")
    os.replace(tmp, path)
    fsync_dir(d)


def frame(body: bytes) -> bytes:
    """Append the sha256 checksum footer the reader verifies."""
    return body + CHECKSUM_MARK + hashlib.sha256(body).hexdigest().encode()


def unframe(raw: bytes) -> bytes:
    """Strip and verify the checksum footer.

    Raises CorruptEntry on a bad or truncated footer. Payloads without
    any footer are returned as-is — pre-durability writers produced
    bare JSON, and their entries must keep loading (the caller's parser
    is the integrity check for those)."""
    body, sep, footer = raw.rpartition(CHECKSUM_MARK)
    if not sep:
        return raw
    if hashlib.sha256(body).hexdigest().encode() != footer.strip():
        raise CorruptEntry("checksum footer mismatch")
    return body


# a tmp file this old cannot belong to a live writer; younger ones
# might (a concurrently starting process must not unlink an in-flight
# sibling out from under its os.replace)
STALE_TMP_AGE_S = 3600.0


def sweep_stale_tmp(directory: str, min_age_s: float = STALE_TMP_AGE_S) -> int:
    """Remove leftover atomic-write tmp files (a crash between fsync and
    rename orphans exactly one) older than `min_age_s` — the age gate
    keeps a startup sweep from racing a live writer. Returns how many
    were removed."""
    import time

    removed = 0
    cutoff = time.time() - min_age_s
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    for name in names:
        if not (name.startswith(".") and ".tmp-" in name):
            continue
        p = os.path.join(directory, name)
        with contextlib.suppress(FileNotFoundError, IsADirectoryError):
            try:
                if os.stat(p).st_mtime > cutoff:
                    continue
                os.unlink(p)
                removed += 1
            except OSError as e:  # pragma: no cover - platform specific
                if e.errno != errno.EISDIR:
                    raise
    return removed


def fsync_tree(root: str) -> None:
    """fsync every regular file under `root`, then the directories —
    used before atomically renaming a fully-staged directory into
    place (DB generation install)."""
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            p = os.path.join(dirpath, name)
            try:
                fd = os.open(p, os.O_RDONLY)
            except OSError:
                continue
            try:
                with contextlib.suppress(OSError):
                    os.fsync(fd)
            finally:
                os.close(fd)
        fsync_dir(dirpath)
