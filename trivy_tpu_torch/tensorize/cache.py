"""Persistent compiled-DB artifact cache.

Tensorizing a real advisory DB costs seconds of CPU per process start
while the resulting tensor set is tens of MB — so an unchanged DB should
compile ONCE per digest and every later process (CLI re-runs, server
restarts) should load the finished tensors instead.

Layout, riding the durability primitives:

    <db_root>/compiled-torch/
      <digest>.<params>.npz             one checksummed tensor set
      <digest>.<params>.mesh<D>.npz     a serving mesh's D shard slices
      <digest>.<params>.dcn<H>h<h>.mesh<D>.npz
                                        host h's run of the distributed
                                        MeshDB's D global shards
      <digest>.keys1.json.gz            the advisory-key fingerprints
                                        (the monitor's delta diff)
      <digest>.<params>.npz.quarantine  an entry that failed its
                                        checksum or decode (never
                                        silently reused)

- the npz payload is framed with the `durability.atomic` sha256 footer
  and written via `atomic_write` (tmp + fsync + rename), so a reader
  never sees a torn entry and silent bit rot is caught at load;
- entries are keyed by advisory-DB digest (the OCI generation name
  when the root is generation-managed, else a content hash) plus the
  compile parameters and a format version — any mismatch is a miss;
- a corrupt entry is quarantined aside (like a rejected DB generation)
  and the caller recompiles from the DB: scan results can never differ
  because of cache state, only warm-start latency can.

Hits and misses (of both entry kinds) are counted in `COUNTS` and in
trivy_tpu_compile_cache_{hits,misses}_total (the NFA entries in
`NFA_COUNTS` and trivy_tpu_secret_nfa_cache_{hits,misses}_total).

Copy of the compiled-DB part of trivy_tpu/tensorize/cache.py. The
port's entries live under their own directory (`compiled-torch`, the
reference's are under `compiled`), so the two packages never load each
other's entries. The compiled secret-NFA programs of
`secret/scanner.py` live in the same directory (`nfa-<digest>...`).
A keymap entry's bytes are the reference's for the same root and
digest. The host-slice entries (the distributed MeshDB's, ops/dcn.py)
count in `COUNTS` beside the others.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import time

import numpy as np

from trivy_tpu_torch.durability import atomic
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs import metrics as obs_metrics

_log = logger("tensorize.cache")

CACHE_DIR = "compiled-torch"
QUARANTINE_SUFFIX = ".quarantine"
# bump on any change to the serialized layout or to compile_db's row
# semantics that old tensors would misrepresent
FORMAT_VERSION = 1

# bulk CompiledDB array fields serialized verbatim (optional ones may be
# None and are simply absent from the npz)
_ARRAY_FIELDS = (
    "row_h1", "row_h2", "row_lo", "row_hi", "row_flags", "row_adv",
    "hot_h1", "hot_h2", "hot_lo", "hot_hi", "hot_flags", "hot_adv",
    "tall_h1", "tall_h2", "tall_lo", "tall_hi", "tall_flags", "tall_adv",
)

# compiled-DB and compiled secret-NFA cache lookups of this process,
# by outcome
COUNTS = {"hits": 0, "misses": 0}
NFA_COUNTS = {"hits": 0, "misses": 0}


def enabled() -> bool:
    """TRIVY_TPU_COMPILE_CACHE=0 disables the cache entirely."""
    return os.environ.get("TRIVY_TPU_COMPILE_CACHE", "1") != "0"


def params_key(window: int | None) -> str:
    """Compile-parameter component of the entry key. `window` is the
    REQUESTED window (None = auto-sized), not the resolved one — an
    auto entry must not satisfy an explicit-window request."""
    w = "auto" if window is None else str(int(window))
    return f"w{w}-f{FORMAT_VERSION}"


def cache_root(db_root: str) -> str:
    return os.path.join(db_root, CACHE_DIR)


def entry_path(db_root: str, digest: str, window: int | None) -> str:
    return os.path.join(cache_root(db_root),
                        f"{digest}.{params_key(window)}.npz")


def shard_entry_path(db_root: str, digest: str, window: int | None,
                     n_db: int) -> str:
    """Key of a serving mesh's shard-slice set: the base params plus the
    db-shard count (the slices depend on nothing else; dp only
    replicates them). A single-device engine and a 1x1 mesh never write
    one, so the base entry's key is the same with or without a mesh."""
    return os.path.join(
        cache_root(db_root),
        f"{digest}.{params_key(window)}.mesh{int(n_db)}.npz")


def db_digest(db_path: str) -> str | None:
    """Digest identifying the advisory-DB bytes an entry was compiled
    from. A generation-managed root reuses the generation's OCI digest
    (its directory name — already verified at install); a flat layout
    hashes the DB payload + metadata files. None when there is no DB."""
    from trivy_tpu_torch.db import generations

    real = os.path.realpath(generations.resolve(db_path))
    base = os.path.basename(real)
    if base.startswith("sha256-"):
        return base
    h = hashlib.sha256()
    found = False
    for name in ("trivy_tpu.db.json.gz", "trivy_tpu.db.json",
                 "trivy.db", "metadata.json"):
        p = os.path.join(real, name)
        try:
            with open(p, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
        except OSError:
            continue
        h.update(b"\x00" + name.encode() + b"\x00")
        if name != "metadata.json":
            found = True
    return "content-" + h.hexdigest() if found else None


def _quarantine(path: str) -> str | None:
    """Move a bad entry aside (numbered, like db.generations) so the
    next lookup recompiles instead of re-reading known-bad bytes."""
    dest = path + QUARANTINE_SUFFIX
    n = 0
    while os.path.exists(dest):
        n += 1
        dest = f"{path}{QUARANTINE_SUFFIX}.{n}"
    try:
        # lint: allow[atomic-write] quarantine move of an already-corrupt entry; rename is atomic
        os.replace(path, dest)
    except OSError:
        return None
    atomic.fsync_dir(os.path.dirname(path))
    _log.warn("quarantined corrupt compiled-DB cache entry", path=dest)
    return dest


def _prune_superseded(root: str, keep_digest: str,
                      min_age_s: float = atomic.STALE_TMP_AGE_S) -> int:
    """Remove entries (and their quarantine copies) for OTHER digests,
    age-gated so a sibling process actively serving the previous
    generation isn't raced mid-rollout. Mirrors db/generations'
    staging sweep: without this, every DB update would leave its
    tensor set behind forever. Returns how many were removed."""
    removed = 0
    cutoff = time.time() - min_age_s
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    for name in names:
        if name.startswith(keep_digest + ".") or ".tmp-" in name:
            continue
        if ".keys" in name:
            # advisory-key fingerprint entries (save_keymap) are the
            # OLD side of the monitor's promote-time delta diff: the
            # previous generation's keymap must survive the promote.
            # They age out on their own (KEYMAP_KEEP_S in save_keymap).
            continue
        p = os.path.join(root, name)
        try:
            if os.stat(p).st_mtime > cutoff:
                continue
            os.unlink(p)
            removed += 1
        except OSError:
            continue
    if removed:
        _log.info("pruned superseded compiled-DB cache entries",
                  removed=removed)
    return removed


def save_compiled(db_path: str, cdb, window: int | None,
                  digest: str | None = None,
                  db_meta: dict | None = None) -> str | None:
    """Serialize a CompiledDB under its DB digest + compile params.
    Returns the entry path, or None when saving is impossible/disabled.
    Never raises: the cache is an accelerator, not a dependency."""
    if not enabled():
        return None
    try:
        digest = digest or db_digest(db_path)
        if digest is None:
            return None
        root = cache_root(db_path)
        os.makedirs(root, exist_ok=True)
        atomic.sweep_stale_tmp(root)
        _prune_superseded(root, digest)
        t0 = time.perf_counter()
        arrays = {}
        for f in _ARRAY_FIELDS:
            a = getattr(cdb, f)
            if a is not None:
                arrays[f] = a
        schemes = sorted(cdb.boundaries)
        for i, s in enumerate(schemes):
            arrays[f"bnd_{i}"] = cdb.boundaries[s]
        meta = {
            "format": FORMAT_VERSION,
            "digest": digest,
            "params": params_key(window),
            # identity of the DB object the tensors were compiled FROM
            # (not just the path): guards the load-then-promote race
            # where the on-disk digest has moved to a different
            # generation than the advisories in memory
            "db_meta": db_meta or {},
            "n_advisories": len(cdb.advisories),
            "window": cdb.window,
            "hot_window": cdb.hot_window,
            "tall_window": cdb.tall_window,
            "schemes": schemes,
            "tall_names": sorted(list(k) for k in cdb.tall_names),
            "host_fallback": sorted(
                [s, n, v] for (s, n), v in cdb.host_fallback.items()),
            "stats": cdb.stats,
        }
        arrays["meta_json"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8).copy()
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        path = entry_path(db_path, digest, window)
        atomic.atomic_write(path, atomic.frame(buf.getvalue()),
                            fault_site="compile_cache.save")
        _log.info("compiled-DB cache entry saved", path=path,
                  mb=round(buf.tell() / 1e6, 1),
                  save_s=round(time.perf_counter() - t0, 2))
        return path
    except Exception as exc:  # pragma: no cover - best-effort
        _log.warn("compiled-DB cache save failed", err=str(exc))
        return None


def load_compiled(db_path: str, db, window: int | None,
                  digest: str | None = None,
                  db_meta: dict | None = None):
    """-> CompiledDB from the cache, or None on a miss.

    `db` is the (already loaded) AdvisoryDB the tensors index into:
    the flat advisory list is rebuilt from it in the canonical order
    (`compile.flat_advisories`) — the digest key guarantees the DB
    bytes match what the entry was compiled from, and `db_meta` (the
    loaded DB's metadata document) cross-checks that the in-memory DB
    is the one the entry was compiled FROM even if the on-disk digest
    moved between the DB load and this lookup (concurrent generation
    promote). A metadata mismatch is a plain miss; only corruption
    quarantines.

    A corrupt or inconsistent entry is quarantined and reported as a
    miss so the caller recompiles — zero-diff by construction."""
    from trivy_tpu_torch.tensorize.compile import CompiledDB, flat_advisories

    if not enabled():
        return None
    digest = digest or db_digest(db_path)
    path = entry_path(db_path, digest, window) if digest else None
    if path is None or not os.path.exists(path):
        COUNTS["misses"] += 1
        obs_metrics.COMPILE_CACHE_MISSES.inc()
        return None
    t0 = time.perf_counter()
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as exc:
        # transient read failure (EMFILE, NFS blip): a miss, NOT a
        # quarantine — the entry on disk may be perfectly healthy
        COUNTS["misses"] += 1
        obs_metrics.COMPILE_CACHE_MISSES.inc()
        _log.warn("compiled-DB cache entry unreadable (io); recompiling",
                  path=path, err=str(exc))
        return None
    try:
        body = atomic.unframe(raw)
        if body is raw:
            # a framed entry is the only thing save_compiled writes: a
            # missing footer means the tail was torn off exactly at the
            # marker boundary or the file predates framing — reject
            raise atomic.CorruptEntry("missing checksum footer")
        z = np.load(io.BytesIO(body), allow_pickle=False)
        meta = json.loads(z["meta_json"].tobytes())
        if meta.get("format") != FORMAT_VERSION \
                or meta.get("digest") != digest \
                or meta.get("params") != params_key(window):
            raise atomic.CorruptEntry("metadata/key mismatch")
        if db_meta is not None and meta.get("db_meta") != db_meta:
            # the loaded DB is not the one this entry was compiled
            # from (digest moved under us): a healthy entry for a
            # DIFFERENT generation — miss, don't quarantine
            COUNTS["misses"] += 1
            obs_metrics.COMPILE_CACHE_MISSES.inc()
            _log.warn("compiled-DB cache entry is for a different DB "
                      "generation; recompiling", path=path)
            return None
        advisories = flat_advisories(db)
        if len(advisories) != meta["n_advisories"]:
            raise atomic.CorruptEntry(
                f"advisory count mismatch (entry {meta['n_advisories']}, "
                f"db {len(advisories)})")
        arr = {f: (z[f] if f in z.files else None)
               for f in _ARRAY_FIELDS}
        for f in _ARRAY_FIELDS[:6]:  # main row tensors are mandatory
            if arr[f] is None:
                raise atomic.CorruptEntry(f"missing array {f}")
        boundaries = {s: z[f"bnd_{i}"]
                      for i, s in enumerate(meta["schemes"])}
        cdb = CompiledDB(
            **arr,
            boundaries=boundaries,
            advisories=advisories,
            host_fallback={(s, n): v
                           for s, n, v in meta["host_fallback"]},
            window=meta["window"],
            hot_window=meta["hot_window"],
            tall_window=meta["tall_window"],
            tall_names={tuple(t) for t in meta["tall_names"]},
            stats=dict(meta["stats"], compile_cache="hit"),
        )
    except Exception as exc:
        _quarantine(path)
        COUNTS["misses"] += 1
        obs_metrics.COMPILE_CACHE_MISSES.inc()
        _log.warn("compiled-DB cache entry unreadable; recompiling",
                  path=path, err=str(exc))
        return None
    COUNTS["hits"] += 1
    obs_metrics.COMPILE_CACHE_HITS.inc()
    _log.info("compiled-DB cache hit", path=path,
              load_s=round(time.perf_counter() - t0, 3),
              rows=cdb.n_rows)
    return cdb


# ------------------------------------------------------- mesh shard slices


def save_shards(db_path: str, cdb, n_db: int, shards,
                window: int | None = None, digest: str | None = None,
                db_meta: dict | None = None) -> str | None:
    """Serialize a mesh's shard slices (`shards` = (h1s [D, S], tables
    [D, S, L], shard_len, shard_base) from ops/match.host_shards) under
    the digest + params + shard-count key. The same framing and
    never-raise contract as save_compiled."""
    if not enabled():
        return None
    try:
        digest = digest or db_digest(db_path)
        if digest is None:
            return None
        h1s, tables, shard_len, shard_base = shards
        root = cache_root(db_path)
        os.makedirs(root, exist_ok=True)
        t0 = time.perf_counter()
        meta = {
            "format": FORMAT_VERSION,
            "digest": digest,
            "params": params_key(window),
            "db_meta": db_meta or {},
            "n_db": int(n_db),
            "n_rows": int(cdb.n_rows),
            # the RESOLVED window (the halo width of the slices), not
            # the requested one in `params`
            "window": int(cdb.window),
            "shard_len": int(shard_len),
            "shard_base": int(shard_base),
        }
        buf = io.BytesIO()
        np.savez(buf, h1s=h1s, tables=tables,
                 meta_json=np.frombuffer(json.dumps(meta).encode(),
                                         dtype=np.uint8).copy())
        path = shard_entry_path(db_path, digest, window, n_db)
        atomic.atomic_write(path, atomic.frame(buf.getvalue()),
                            fault_site="compile_cache.save")
        _log.info("mesh shard-slice cache entry saved", path=path,
                  n_db=n_db, mb=round(buf.tell() / 1e6, 1),
                  save_s=round(time.perf_counter() - t0, 2))
        return path
    except Exception as exc:  # pragma: no cover - best-effort
        _log.warn("mesh shard-slice cache save failed", err=str(exc))
        return None


def load_shards(db_path: str, cdb, n_db: int,
                window: int | None = None, digest: str | None = None,
                db_meta: dict | None = None):
    """-> (h1s, tables, shard_len, shard_base) from the cache, or None
    on a miss. `cdb` is the CompiledDB the slices must belong to: its
    row count and resolved window cross-check the entry. A `db_meta`
    mismatch is a plain miss (the generation moved); a corrupt entry is
    quarantined and the caller slices again."""
    if not enabled():
        return None
    digest = digest or db_digest(db_path)
    path = shard_entry_path(db_path, digest, window, n_db) \
        if digest else None
    if path is None or not os.path.exists(path):
        COUNTS["misses"] += 1
        obs_metrics.COMPILE_CACHE_MISSES.inc()
        return None
    t0 = time.perf_counter()
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as exc:
        COUNTS["misses"] += 1
        obs_metrics.COMPILE_CACHE_MISSES.inc()
        _log.warn("mesh shard-slice cache entry unreadable (io); "
                  "slicing again", path=path, err=str(exc))
        return None
    try:
        body = atomic.unframe(raw)
        if body is raw:
            raise atomic.CorruptEntry("missing checksum footer")
        z = np.load(io.BytesIO(body), allow_pickle=False)
        meta = json.loads(z["meta_json"].tobytes())
        if meta.get("format") != FORMAT_VERSION \
                or meta.get("digest") != digest \
                or meta.get("params") != params_key(window) \
                or meta.get("n_db") != int(n_db):
            raise atomic.CorruptEntry("metadata/key mismatch")
        if db_meta is not None and meta.get("db_meta") != db_meta:
            COUNTS["misses"] += 1
            obs_metrics.COMPILE_CACHE_MISSES.inc()
            _log.warn("mesh shard-slice cache entry is for a different "
                      "DB generation; slicing again", path=path)
            return None
        if meta.get("n_rows") != int(cdb.n_rows) \
                or meta.get("window") != int(cdb.window):
            raise atomic.CorruptEntry(
                f"slice/DB mismatch (entry rows={meta.get('n_rows')} "
                f"window={meta.get('window')}, db rows={cdb.n_rows} "
                f"window={cdb.window})")
        h1s, tables = z["h1s"], z["tables"]
        shard_len = int(meta["shard_len"])
        shard_base = int(meta["shard_base"])
        if h1s.shape != (n_db, shard_len) or h1s.dtype != np.uint32 \
                or tables.shape != (n_db, shard_len, 8) \
                or tables.dtype != np.int32:
            raise atomic.CorruptEntry("shard array shape mismatch")
    except Exception as exc:
        _quarantine(path)
        COUNTS["misses"] += 1
        obs_metrics.COMPILE_CACHE_MISSES.inc()
        _log.warn("mesh shard-slice cache entry unreadable; slicing "
                  "again", path=path, err=str(exc))
        return None
    COUNTS["hits"] += 1
    obs_metrics.COMPILE_CACHE_HITS.inc()
    _log.info("mesh shard-slice cache hit", path=path, n_db=n_db,
              load_s=round(time.perf_counter() - t0, 3))
    return h1s, tables, shard_len, shard_base


# -------------------------------------------------- cross-host slice entries


def host_slice_entry_path(db_root: str, digest: str,
                          window: int | None, n_hosts: int,
                          host_index: int, n_db: int) -> str:
    """Key of ONE host's slice of the distributed MeshDB's global shard
    partition (ops/dcn.py): the base params plus the host topology and
    the GLOBAL shard count. Each host warm-loads only its own entry,
    never the whole table."""
    return os.path.join(
        cache_root(db_root),
        f"{digest}.{params_key(window)}"
        f".dcn{int(n_hosts)}h{int(host_index)}.mesh{int(n_db)}.npz")


def save_host_slice(db_path: str, *, digest: str, window: int | None,
                    db_meta: dict | None, n_hosts: int, host_index: int,
                    n_db: int, n_rows: int, resolved_window: int,
                    shard_len: int, shard_base: int,
                    h1s, tables) -> str | None:
    """Serialize one host's slice (its run of global shards, `h1s`
    [db_local, S] / `tables` [db_local, S, L]) under the digest + params
    + host-topology key. The same framing, quarantine and never-raise
    contract as the other entries. The coordinator writes every host's
    entry when it slices the whole table; a worker writes its own when
    its slice was pushed."""
    if not enabled():
        return None
    try:
        if digest is None:
            return None
        root = cache_root(db_path)
        os.makedirs(root, exist_ok=True)
        t0 = time.perf_counter()
        meta = {
            "format": FORMAT_VERSION,
            "digest": digest,
            "params": params_key(window),
            "db_meta": db_meta or {},
            "n_hosts": int(n_hosts),
            "host_index": int(host_index),
            "n_db": int(n_db),
            "n_rows": int(n_rows),
            "window": int(resolved_window),
            "shard_len": int(shard_len),
            "shard_base": int(shard_base),
        }
        buf = io.BytesIO()
        np.savez(buf, h1s=np.asarray(h1s), tables=np.asarray(tables),
                 meta_json=np.frombuffer(json.dumps(meta).encode(),
                                         dtype=np.uint8).copy())
        path = host_slice_entry_path(db_path, digest, window, n_hosts,
                                     host_index, n_db)
        atomic.atomic_write(path, atomic.frame(buf.getvalue()),
                            fault_site="compile_cache.save")
        _log.info("host-slice cache entry saved", path=path,
                  host=host_index, n_hosts=n_hosts,
                  mb=round(buf.tell() / 1e6, 1),
                  save_s=round(time.perf_counter() - t0, 2))
        return path
    except Exception as exc:  # pragma: no cover - best-effort
        _log.warn("host-slice cache save failed", err=str(exc))
        return None


def load_host_slice(db_path: str, *, digest: str | None,
                    window: int | None, db_meta: dict | None,
                    n_hosts: int, host_index: int, n_db: int,
                    n_rows: int | None = None,
                    resolved_window: int | None = None):
    """-> {"h1s", "tables", "shard_len", "shard_base", "n_rows",
    "window"} of one host's cached slice, or None on a miss. The key and
    the row / window cross-checks make the slice exactly what
    ops/match.host_shards cuts from the same DB. A `db_meta` mismatch
    (the generation moved) is a plain miss; a corrupt entry is
    quarantined and the host's slice is pushed instead."""
    if not enabled() or not digest:
        return None
    path = host_slice_entry_path(db_path, digest, window, n_hosts,
                                 host_index, n_db)
    if not os.path.exists(path):
        COUNTS["misses"] += 1
        obs_metrics.COMPILE_CACHE_MISSES.inc()
        return None
    t0 = time.perf_counter()
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as exc:
        COUNTS["misses"] += 1
        obs_metrics.COMPILE_CACHE_MISSES.inc()
        _log.warn("host-slice cache entry unreadable (io)",
                  path=path, err=str(exc))
        return None
    try:
        body = atomic.unframe(raw)
        if body is raw:
            raise atomic.CorruptEntry("missing checksum footer")
        z = np.load(io.BytesIO(body), allow_pickle=False)
        meta = json.loads(z["meta_json"].tobytes())
        if meta.get("format") != FORMAT_VERSION \
                or meta.get("digest") != digest \
                or meta.get("params") != params_key(window) \
                or meta.get("n_hosts") != int(n_hosts) \
                or meta.get("host_index") != int(host_index) \
                or meta.get("n_db") != int(n_db):
            raise atomic.CorruptEntry("metadata/key mismatch")
        if db_meta is not None and meta.get("db_meta") != db_meta:
            COUNTS["misses"] += 1
            obs_metrics.COMPILE_CACHE_MISSES.inc()
            _log.warn("host-slice cache entry is for a different DB "
                      "generation; falling back", path=path)
            return None
        if (n_rows is not None and meta.get("n_rows") != int(n_rows)) \
                or (resolved_window is not None
                    and meta.get("window") != int(resolved_window)):
            raise atomic.CorruptEntry(
                f"slice/DB mismatch (entry rows={meta.get('n_rows')} "
                f"window={meta.get('window')}, want rows={n_rows} "
                f"window={resolved_window})")
        h1s, tables = z["h1s"], z["tables"]
        db_local = int(n_db) // int(n_hosts)
        shard_len = int(meta["shard_len"])
        if h1s.shape != (db_local, shard_len) or h1s.dtype != np.uint32 \
                or tables.shape != (db_local, shard_len, 8) \
                or tables.dtype != np.int32:
            raise atomic.CorruptEntry("slice array shape mismatch")
    except Exception as exc:
        _quarantine(path)
        COUNTS["misses"] += 1
        obs_metrics.COMPILE_CACHE_MISSES.inc()
        _log.warn("host-slice cache entry unreadable; falling back",
                  path=path, err=str(exc))
        return None
    COUNTS["hits"] += 1
    obs_metrics.COMPILE_CACHE_HITS.inc()
    _log.info("host-slice cache hit", path=path, host=host_index,
              load_s=round(time.perf_counter() - t0, 3))
    return {
        "h1s": h1s, "tables": tables,
        "shard_len": shard_len,
        "shard_base": int(meta["shard_base"]),
        "n_rows": int(meta["n_rows"]),
        "window": int(meta["window"]),
    }


# ---------------------------------------------- compiled secret-NFA programs

# bump on any change to the serialized tier layout; the ruleset digest
# already folds in the kernel/anchor constants (secret/scanner.py
# _ruleset_digest), so semantic screen changes key new entries on their
# own
NFA_FORMAT_VERSION = 1


def nfa_entry_path(cache_dir: str, digest: str) -> str:
    return os.path.join(cache_dir, CACHE_DIR,
                        f"nfa-{digest}.f{NFA_FORMAT_VERSION}.npz")


def save_nfa(cache_dir: str, digest: str, arrays: dict,
             meta: dict) -> str | None:
    """Persist a compiled secret-NFA program (anchor class rows + tier
    metadata, serialized by SecretScanner) under its ruleset digest.
    Same framing / atomic-write / never-raise contract as the
    compiled-DB tensor entries: the cache is an accelerator, not a
    dependency."""
    if not enabled():
        return None
    try:
        root = os.path.join(cache_dir, CACHE_DIR)
        os.makedirs(root, exist_ok=True)
        atomic.sweep_stale_tmp(root)
        t0 = time.perf_counter()
        doc = dict(meta, format=NFA_FORMAT_VERSION, digest=digest)
        payload = dict(arrays)
        payload["meta_json"] = np.frombuffer(
            json.dumps(doc).encode(), dtype=np.uint8).copy()
        buf = io.BytesIO()
        np.savez(buf, **payload)
        path = nfa_entry_path(cache_dir, digest)
        atomic.atomic_write(path, atomic.frame(buf.getvalue()),
                            fault_site="compile_cache.save")
        _log.debug("compiled secret-NFA cache entry saved", path=path,
                   kb=round(buf.tell() / 1e3, 1),
                   save_s=round(time.perf_counter() - t0, 3))
        return path
    except Exception as exc:  # pragma: no cover - best-effort
        _log.warn("compiled secret-NFA cache save failed", err=str(exc))
        return None


def load_nfa(cache_dir: str, digest: str):
    """-> (arrays dict, meta dict) for a cached compiled-NFA program,
    or None on a miss.  Corrupt / mismatched entries are quarantined
    and the scanner recompiles from the ruleset — scan results can
    never differ because of cache state, only warm-start latency can."""
    if not enabled():
        return None
    path = nfa_entry_path(cache_dir, digest)
    if not os.path.exists(path):
        NFA_COUNTS["misses"] += 1
        obs_metrics.SECRET_NFA_CACHE_MISSES.inc()
        return None
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as exc:
        # transient read failure: a miss, NOT a quarantine
        NFA_COUNTS["misses"] += 1
        obs_metrics.SECRET_NFA_CACHE_MISSES.inc()
        _log.warn("compiled secret-NFA cache entry unreadable (io); "
                  "recompiling", path=path, err=str(exc))
        return None
    try:
        body = atomic.unframe(raw)
        if body is raw:
            raise atomic.CorruptEntry("missing checksum footer")
        z = np.load(io.BytesIO(body), allow_pickle=False)
        meta = json.loads(z["meta_json"].tobytes())
        if meta.get("format") != NFA_FORMAT_VERSION \
                or meta.get("digest") != digest:
            raise atomic.CorruptEntry("metadata/key mismatch")
        arrays = {k: z[k] for k in z.files if k != "meta_json"}
    except Exception as exc:
        _quarantine(path)
        NFA_COUNTS["misses"] += 1
        obs_metrics.SECRET_NFA_CACHE_MISSES.inc()
        _log.warn("compiled secret-NFA cache entry unreadable; "
                  "recompiling", path=path, err=str(exc))
        return None
    NFA_COUNTS["hits"] += 1
    obs_metrics.SECRET_NFA_CACHE_HITS.inc()
    _log.debug("compiled secret-NFA cache hit", path=path)
    return arrays, meta


# ------------------------------------------------- advisory-key fingerprints

# bump on any change to the fingerprint computation: old/new entries
# with different formats never diff against each other (the monitor
# falls back to a full rescan instead)
KEYMAP_VERSION = 1
# fingerprint entries for superseded digests are kept this long (they
# are the OLD side of promote-time delta diffs, so the _prune_superseded
# sweep exempts them), then aged out by save_keymap
KEYMAP_KEEP_S = 7 * 24 * 3600.0


def keymap_path(db_root: str, digest: str) -> str:
    return os.path.join(cache_root(db_root),
                        f"{digest}.keys{KEYMAP_VERSION}.json.gz")


def advisory_fingerprints(db) -> dict[tuple[str, str], str]:
    """Per-(space, name) content digest of a loaded AdvisoryDB.

    The key space matches the match engine's query space exactly
    (`tensorize.compile.space_of_bucket`): all language buckets of one
    ecosystem collapse onto the "eco::" prefix space, OS buckets are
    their own space, and buckets with no resolvable scheme are skipped —
    they are invisible to matching, so their churn cannot change any
    finding.  Two DB generations agreeing on a key's digest therefore
    match identically for every query on that key, which is the load-
    bearing invariant of the monitor's delta re-scoring
    (trivy_tpu_torch/monitor)."""
    from trivy_tpu_torch.tensorize.compile import space_of_bucket

    acc: dict[tuple[str, str], list[str]] = {}
    space_by_bucket: dict[str, str | None] = {}
    for bucket, pkgs in db.buckets.items():
        space = space_by_bucket.get(bucket, "?")
        if space == "?":
            resolved = space_of_bucket(bucket)
            space = resolved[0] if resolved else None
            space_by_bucket[bucket] = space
        if space is None:
            continue
        for name, advs in pkgs.items():
            entries = acc.setdefault((space, name), [])
            for a in advs:
                entries.append(bucket + "\x1f" + json.dumps(
                    a.to_json(), sort_keys=True, separators=(",", ":")))
    out: dict[tuple[str, str], str] = {}
    for key, entries in acc.items():
        h = hashlib.sha256()
        for e in sorted(entries):
            h.update(e.encode())
            h.update(b"\x00")
        out[key] = h.hexdigest()[:32]
    return out


def save_keymap(db_path: str, db, digest: str | None = None) -> str | None:
    """Persist the advisory-key fingerprint table for `digest` next to
    the compiled entries (skipped when it already exists — fingerprints
    are content-addressed by the digest).  Same framing / atomic-write /
    never-raise contract as the tensor entries.

    Guarded against the load-then-promote race the tensor entries guard
    with their db_meta cross-check: if the on-disk root no longer
    resolves to `digest`, or its metadata document disagrees with the
    in-memory DB's, the save is SKIPPED — writing another generation's
    fingerprints under this digest would poison every later delta diff
    that trusts the content-addressed entry."""
    import gzip

    if not enabled():
        return None
    try:
        digest = digest or db_digest(db_path)
        if digest is None:
            return None
        if db_digest(db_path) != digest:
            _log.warn("advisory-key fingerprint save skipped: DB root "
                      "moved to another generation", digest=digest)
            return None
        from trivy_tpu_torch.db import generations

        meta_path = os.path.join(
            os.path.realpath(generations.resolve(db_path)),
            "metadata.json")
        try:
            with open(meta_path, encoding="utf-8") as f:
                on_disk_meta = json.load(f)
        except (OSError, ValueError):
            on_disk_meta = None
        if on_disk_meta is not None \
                and on_disk_meta != db.meta.to_json():
            _log.warn("advisory-key fingerprint save skipped: loaded "
                      "DB's metadata disagrees with the on-disk root",
                      digest=digest)
            return None
        path = keymap_path(db_path, digest)
        if os.path.exists(path):
            return path
        root = cache_root(db_path)
        os.makedirs(root, exist_ok=True)
        # age out fingerprint entries for long-gone generations (they
        # survive _prune_superseded by design; see KEYMAP_KEEP_S)
        keep_cutoff = time.time() - KEYMAP_KEEP_S
        for name in os.listdir(root):
            if ".keys" not in name or name.startswith(digest + "."):
                continue
            p = os.path.join(root, name)
            try:
                if os.stat(p).st_mtime < keep_cutoff:
                    os.unlink(p)
            except OSError:
                continue
        t0 = time.perf_counter()
        keys = advisory_fingerprints(db)
        doc = {
            "format": KEYMAP_VERSION,
            "digest": digest,
            "schema": db.meta.version,
            "keys": [[s, n, d] for (s, n), d in sorted(keys.items())],
        }
        payload = gzip.compress(
            json.dumps(doc, separators=(",", ":")).encode(), mtime=0)
        atomic.atomic_write(path, atomic.frame(payload),
                            fault_site="compile_cache.save")
        _log.info("advisory-key fingerprint entry saved", path=path,
                  keys=len(keys),
                  save_s=round(time.perf_counter() - t0, 2))
        return path
    except Exception as exc:  # pragma: no cover - best-effort
        _log.warn("advisory-key fingerprint save failed", err=str(exc))
        return None


def load_keymap(db_path: str, digest: str | None):
    """-> {"schema": int, "keys": {(space, name): digest}} for a cached
    fingerprint entry, or None on a miss.  Corrupt entries quarantine
    (the monitor then recomputes or falls back to a full rescan — never
    a wrong delta)."""
    import gzip

    if not enabled() or not digest:
        return None
    path = keymap_path(db_path, digest)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as exc:
        _log.warn("advisory-key fingerprint entry unreadable (io)",
                  path=path, err=str(exc))
        return None
    try:
        body = atomic.unframe(raw)
        if body is raw:
            raise atomic.CorruptEntry("missing checksum footer")
        doc = json.loads(gzip.decompress(body))
        if doc.get("format") != KEYMAP_VERSION \
                or doc.get("digest") != digest:
            raise atomic.CorruptEntry("metadata/key mismatch")
        keys = {(s, n): d for s, n, d in doc["keys"]}
    except Exception as exc:
        _quarantine(path)
        _log.warn("advisory-key fingerprint entry corrupt; quarantined",
                  path=path, err=str(exc))
        return None
    return {"schema": doc.get("schema"), "keys": keys}
