"""Analysis-result cache.

Interfaces mirror the reference (pkg/cache/cache.go:16-43):
- ArtifactCache (write): put_artifact / put_blob / missing_blobs
- LocalArtifactCache (read): get_artifact / get_blob
Backends: in-memory and filesystem JSON (the reference's BoltDB fs cache,
pkg/cache/fs.go, re-expressed as one JSON file per key).

Copy of trivy_tpu/cache/cache.py (the redis backend is
cache/redis.py); corrupt-entry evictions are counted in trivy_tpu_cache_corrupt_total.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import re
from dataclasses import asdict

from trivy_tpu_torch.analysis.witness import make_lock
from trivy_tpu_torch.durability import atomic
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.types.artifact import ArtifactInfo, BlobInfo

_log = logger("cache")


def corrupt_evictions() -> int:
    """Corrupt-entry evictions across every FSCache in the process
    (the trivy_tpu_cache_corrupt_total counter, kept as a function for
    historical callers)."""
    return int(obs_metrics.CACHE_CORRUPT.value())


def _count_corrupt_eviction() -> None:
    obs_metrics.CACHE_CORRUPT.inc()


def cache_key(
    base: str,
    analyzer_versions: dict[str, int] | None = None,
    hook_versions: dict[str, int] | None = None,
    skip_files: list[str] | None = None,
    skip_dirs: list[str] | None = None,
    patterns: list[str] | None = None,
    policy: list[str] | None = None,
) -> str:
    """Derive a cache key from a base ID + everything that can change the
    analysis result (reference pkg/cache/key.go:19-69)."""
    h = hashlib.sha256()
    payload = {
        "artifact": base,
        "analyzerVersions": analyzer_versions or {},
        "hookVersions": hook_versions or {},
        "skipFiles": skip_files or [],
        "skipDirs": skip_dirs or [],
        "patterns": patterns or [],
        "policy": policy or [],
    }
    h.update(json.dumps(payload, sort_keys=True).encode())
    return "sha256:" + h.hexdigest()


class MemoryCache:
    """reference pkg/cache/memory.go"""

    def __init__(self):
        self._artifacts: dict[str, dict] = {}
        self._blobs: dict[str, dict] = {}

    # write (ArtifactCache)
    def put_artifact(self, artifact_id: str, info: ArtifactInfo | dict) -> None:
        self._artifacts[artifact_id] = _as_dict(info)

    def put_blob(self, blob_id: str, blob: BlobInfo | dict) -> None:
        self._blobs[blob_id] = _as_dict(blob)

    def missing_blobs(self, artifact_id: str, blob_ids: list[str]):
        missing_artifact = artifact_id not in self._artifacts
        missing = [b for b in blob_ids if b not in self._blobs]
        return missing_artifact, missing

    # read (LocalArtifactCache)
    def get_artifact(self, artifact_id: str) -> dict:
        return self._artifacts.get(artifact_id, {})

    def get_blob(self, blob_id: str) -> dict:
        return self._blobs.get(blob_id, {})

    def delete_blobs(self, blob_ids: list[str]) -> None:
        for b in blob_ids:
            self._blobs.pop(b, None)

    def clear(self) -> None:
        self._artifacts.clear()
        self._blobs.clear()

    def close(self) -> None:
        pass


# filenames that need no mangling: short, and only chars every
# filesystem spells the same way
_SAFE_KEY_RX = re.compile(r"^[A-Za-z0-9._-]{1,200}$")


class FSCache(MemoryCache):
    """Filesystem-backed cache under <root>/fanal (one JSON per key),
    mirroring the role of the reference's BoltDB file cache.

    Durability contract: entries are written atomically
    (tmp+fsync+rename) with a sha256 checksum footer; a torn or
    bit-rotted entry is detected at read time, evicted, counted, and
    served as a cache miss — a corrupt cache can cost a re-scan, never
    a wrong or crashed one."""

    # verified docs carried from the missing_blobs integrity pass to the
    # get_* that follows in the same scan — bounds memory, saves the
    # second full read+hash+parse per entry on the hot path
    _STASH_CAP = 256

    def __init__(self, root: str):
        super().__init__()
        self.root = os.path.join(root, "fanal")
        os.makedirs(os.path.join(self.root, "artifact"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "blob"), exist_ok=True)
        atomic.sweep_stale_tmp(os.path.join(self.root, "artifact"))
        atomic.sweep_stale_tmp(os.path.join(self.root, "blob"))
        from collections import OrderedDict

        self._stash: "OrderedDict[tuple[str, str], dict]" = OrderedDict()
        self._stash_lock = make_lock("cache.cache._stash_lock")

    def _stash_put(self, bucket: str, key: str, doc: dict) -> None:
        with self._stash_lock:
            self._stash[(bucket, key)] = doc
            while len(self._stash) > self._STASH_CAP:
                self._stash.popitem(last=False)

    def _stash_pop(self, bucket: str, key: str) -> dict | None:
        with self._stash_lock:
            return self._stash.pop((bucket, key), None)

    def _path(self, bucket: str, key: str) -> str:
        """Collision-free key -> filename: safe keys keep their name,
        anything else is content-addressed by the sha256 of the FULL
        key (the old replace('/','_')/replace(':','_') mangling mapped
        'a/b' and 'a:b' to the same file)."""
        if _SAFE_KEY_RX.match(key):
            name = key
        else:
            name = "k" + hashlib.sha256(key.encode()).hexdigest()
        return os.path.join(self.root, bucket, name + ".json")

    def _legacy_path(self, bucket: str, key: str) -> str:
        """Pre-hashing scheme; still read so existing caches survive
        the upgrade (entries migrate to the new name on read)."""
        safe = key.replace("/", "_").replace(":", "_")
        return os.path.join(self.root, bucket, safe + ".json")

    def _write(self, bucket: str, key: str, doc: dict) -> None:
        self._stash_pop(bucket, key)  # never serve a superseded doc
        body = json.dumps(doc).encode()
        atomic.atomic_write(self._path(bucket, key), atomic.frame(body),
                            fault_site="cache.write")

    def put_artifact(self, artifact_id: str, info) -> None:
        self._write("artifact", artifact_id, _as_dict(info))

    def put_blob(self, blob_id: str, blob) -> None:
        self._write("blob", blob_id, _as_dict(blob))

    def _exists(self, bucket: str, key: str) -> bool:
        # integrity-verified, not a bare os.path.exists: a corrupt entry
        # must read as MISSING here so the caller re-analyzes the layer
        # now — otherwise analysis is skipped and the later get_blob
        # miss kills the very scan that discovered the corruption. The
        # verified doc is stashed so that get_blob/get_artifact does
        # not pay a second read+hash+parse for the same entry.
        doc = self._read(bucket, key)
        if not doc:
            return False
        self._stash_put(bucket, key, doc)
        return True

    def missing_blobs(self, artifact_id: str, blob_ids: list[str]):
        missing_artifact = not self._exists("artifact", artifact_id)
        missing = [b for b in blob_ids if not self._exists("blob", b)]
        return missing_artifact, missing

    def get_artifact(self, artifact_id: str) -> dict:
        doc = self._stash_pop("artifact", artifact_id)
        return doc if doc is not None else self._read("artifact", artifact_id)

    def get_blob(self, blob_id: str) -> dict:
        doc = self._stash_pop("blob", blob_id)
        return doc if doc is not None else self._read("blob", blob_id)

    def _read(self, bucket: str, key: str) -> dict:
        p = self._path(bucket, key)
        doc = self._read_file(p, key)
        if doc is not None:
            return doc
        legacy = self._legacy_path(bucket, key)
        if legacy != p:
            doc = self._read_file(legacy, key)
            if doc is not None:
                # migrate: rewrite under the collision-free name (with
                # checksum) so the shim is only paid once per entry
                self._write(bucket, key, doc)
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(legacy)
                return doc
        return {}

    def _load(self, path: str, key: str) -> bytes | None:
        """Entry file -> checksum-verified body bytes; None = miss. A
        bad checksum self-heals here: evict + count + miss. (The frame
        marker contains a raw newline, which escaped JSON bodies can
        never contain — the footer split is unambiguous.)"""
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        except OSError as e:
            _log.warn("unreadable cache entry; treating as miss",
                      key=key, err=str(e))
            return None
        try:
            return atomic.unframe(raw)
        except atomic.CorruptEntry as e:
            self._evict_corrupt(path, key, e)
            return None

    def _evict_corrupt(self, path: str, key: str, err) -> None:
        _count_corrupt_eviction()
        _log.warn("corrupt cache entry evicted", key=key, err=str(err))
        with contextlib.suppress(FileNotFoundError):
            os.unlink(path)

    def _read_file(self, path: str, key: str) -> dict | None:
        """One entry file -> dict; None = miss. Corruption (bad
        checksum, truncated/invalid JSON) self-heals: evict + count +
        miss, instead of the old json.JSONDecodeError mid-scan."""
        body = self._load(path, key)
        if body is None:
            return None
        try:
            doc = json.loads(body)
            if not isinstance(doc, dict):
                raise ValueError("cache entry is not a JSON object")
            return doc
        except ValueError as e:
            self._evict_corrupt(path, key, e)
            return None

    def delete_blobs(self, blob_ids: list[str]) -> None:
        # concurrent scanners race on the same entries: suppress, don't
        # exists()-then-unlink (TOCTOU)
        for b in blob_ids:
            self._stash_pop("blob", b)
            for p in (self._path("blob", b), self._legacy_path("blob", b)):
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(p)

    def clear(self) -> None:
        import shutil

        with self._stash_lock:
            self._stash.clear()
        shutil.rmtree(self.root, ignore_errors=True)
        os.makedirs(os.path.join(self.root, "artifact"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "blob"), exist_ok=True)


def _as_dict(obj) -> dict:
    if isinstance(obj, dict):
        return obj
    # dataclass blobs serialize structurally (not report-JSON): keep all
    # fields so the applier round-trips exactly
    return asdict(obj)
