"""Match engine: the card-offloaded replacement for the reference's
per-package detection loops, plus the pure-host oracle used as the
zero-diff reference.

Port of trivy_tpu/detector/engine.py. Pipeline per batch:
  host encode (hash + rank) -> CUDA kernel (join + containment) ->
  host decode (native collect.cpp where it builds, numpy otherwise) ->
  exact rescreen of candidates -> matches.
With a serving mesh (`mesh` / `mesh_spec`, ops/mesh.py) the main tier's
kernel runs once per (data group, db shard) cell and the host merges
the shards' masks; the hot and tall tiers stay on the engine's device.
With a spec spanning hosts (ops/dcn.py HostMeshDB) the cells of the
other hosts run in their worker processes, and `close()` ends them.

Device-loss ladders: the fault site ``engine`` (a DeviceLost flips the
engine to the host oracle for good, logged once and counted in
`degraded` and trivy_tpu_degraded_total) and ``engine.device`` (the in-flight stage: delay, drop
with a second dispatch, device-lost). Any other device error raises.

The oracle path runs the exact check over every advisory for each name via
dict lookup — semantically identical to the reference's
bucket-get-then-compare loop. `MatchEngine.detect` must return exactly the
oracle's answer for every input.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from trivy_tpu_torch.analysis.witness import make_lock
from trivy_tpu_torch.db.store import AdvisoryDB
from trivy_tpu_torch.detector.exact import AdvisoryChecker
from trivy_tpu_torch.device import resolve_device
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.native import collect as ncollect
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import tracing
from trivy_tpu_torch.obs import usage
from trivy_tpu_torch.ops import match as m
from trivy_tpu_torch.resilience import faults
from trivy_tpu_torch.tensorize.compile import (
    CompiledDB,
    PackageBatch,
    compile_db,
    space_of_bucket,
)
from trivy_tpu_torch.versioning import get_scheme
from trivy_tpu_torch.versioning.base import ParseError

_log = logger("engine")


@dataclass(frozen=True)
class PkgQuery:
    """One (match-space, name, version) detection query.

    space: "eco::" for language packages, "<family> <release>" for OS.
    scheme_name: version scheme for the space."""

    space: str
    name: str
    version: str
    scheme_name: str
    # dedupe/memo key, built once at construction (the crawl hot loops
    # key every query)
    key: tuple = field(init=False, compare=False, repr=False)

    def __post_init__(self):
        object.__setattr__(
            self, "key",
            (self.space, self.name, self.version, self.scheme_name))


def queries_from_columns(spaces: list[str], names: list[str],
                         versions: list[str],
                         schemes: list[str]) -> list[PkgQuery]:
    """Bulk PkgQuery constructor for columnar ingest: builds each query
    and its precomputed ``key`` directly from parallel string columns,
    skipping the per-object dataclass ``__init__`` + ``__post_init__``
    walk."""
    new = PkgQuery.__new__
    setattr_ = object.__setattr__
    out: list[PkgQuery] = []
    for key in zip(spaces, names, versions, schemes):
        q = new(PkgQuery)
        setattr_(q, "space", key[0])
        setattr_(q, "name", key[1])
        setattr_(q, "version", key[2])
        setattr_(q, "scheme_name", key[3])
        setattr_(q, "key", key)
        out.append(q)
    return out


@dataclass(slots=True)
class MatchResult:
    query: PkgQuery
    adv_indices: list[int]  # indices into CompiledDB.advisories


def finding_keys(advisories, results) -> set[tuple]:
    """MatchResults → engine-level finding keys: the stable,
    DB-generation-independent identity of a finding —
    ``(space, name, version, scheme, vulnerability_id)``."""
    return {
        (r.query.space, r.query.name, r.query.version,
         r.query.scheme_name, advisories[i][2].vulnerability_id)
        for r in results for i in r.adv_indices}


def _meter_rows(results: list[MatchResult]) -> list[MatchResult]:
    """Accrue matched device rows to the ambient usage scope (no-op for
    the CLI's scope-less calls). Called only at detect()'s return sites
    — submit()/match_keys funnel through detect(), and the DeviceLost
    re-entry accrues in the inner call — so rows are never
    double-counted."""
    if usage.ambient() is not None:
        usage.add("rows_matched",
                  float(sum(len(r.adv_indices) for r in results)))
    return results


class MatchEngine:
    """Holds the advisory DB in compiled tensor form (and on the card)
    and answers batched detection queries."""

    def __init__(
        self,
        db: AdvisoryDB,
        window: int | None = None,
        use_device: bool = True,
        device=None,
        db_path: str | None = None,
        mesh=None,
        mesh_spec: str | None = None,
    ):
        """`use_device=False` is the explicit host-oracle path. With
        `use_device=True` the rows live on `device` (default ``cuda:0``;
        ``"cpu"`` only when asked for — the kernel's plain version then
        answers).

        `db_path`: the on-disk root `db` was loaded from. When given,
        the compiled tensor set is loaded from / saved to the persistent
        compiled-DB cache keyed by the DB digest + compile params
        (tensorize.cache) — a warm process start with an unchanged DB
        skips the recompile.

        `mesh`: a prebuilt `device.DeviceGrid`: the main tier serves
        from a sharded mesh (ops/mesh.py MeshDB) with per-shard fault
        isolation. `mesh_spec`: an operator topology string ("DPxDB",
        "auto", "off": --mesh / TRIVY_TPU_MESH), resolved against the
        compiled DB's row count on the CUDA devices (every cell on the
        CPU for ``device="cpu"``); an invalid spec, or one the devices
        cannot place, raises ValueError here. A spec spanning hosts
        ("HOSTSxDPxDB", or "auto" with TRIVY_TPU_DCN workers) serves the
        main tier from the distributed MeshDB (ops/dcn.py); a `mesh`
        given with it places the coordinator's own DP x DB cells."""
        self.db = db
        # where the build's time went: compile or cache load, and the
        # upload of the three tiers to the card
        self.build_stats: dict = {"compile_cache": "off"}
        t0 = time.perf_counter()
        self.cdb: CompiledDB | None = None
        digest = db_meta = None
        if db_path:
            from trivy_tpu_torch.tensorize import cache as compile_cache

            digest = compile_cache.db_digest(db_path) \
                if compile_cache.enabled() else None
            if digest is not None:
                # the loaded DB's metadata document cross-checks that
                # the entry was compiled from THIS db, not from another
                # generation the digest may have moved to meanwhile
                db_meta = db.meta.to_json()
                self.cdb = compile_cache.load_compiled(
                    db_path, db, window=window, digest=digest,
                    db_meta=db_meta)
                self.build_stats["compile_cache"] = \
                    "miss" if self.cdb is None else "hit"
                if self.cdb is None:
                    self.cdb = compile_db(db, window=window)
                    compile_cache.save_compiled(
                        db_path, self.cdb, window=window, digest=digest,
                        db_meta=db_meta)
        if self.cdb is None:
            self.cdb = compile_db(db, window=window)
        self.build_stats["compile_s"] = time.perf_counter() - t0
        if digest is not None:
            # advisory-key fingerprints ride along with the tensor entry
            # (content-addressed by digest, saved once): the OLD
            # generation's table is what makes a promote-time delta diff
            # cheap (trivy_tpu_torch/monitor). The save re-reads the
            # root's digest first, so on a flat root every build hashes
            # the DB file once more, warm ones included.
            t0 = time.perf_counter()
            compile_cache.save_keymap(db_path, db, digest=digest)
            self.build_stats["keymap_s"] = time.perf_counter() - t0
        # routes the mesh's shard slices through the compiled-DB cache
        self._cache_ctx = (db_path, digest, db_meta, window) \
            if db_path else None
        self.use_device = use_device
        self.device = resolve_device(device) if use_device else None
        dcn_plan = None
        if use_device and mesh_spec:
            from trivy_tpu_torch.ops import dcn as dcn_ops
            from trivy_tpu_torch.ops import mesh as mesh_ops

            parsed = mesh_ops.parse_spec(mesh_spec)
            if mesh is None or (isinstance(parsed, tuple)
                                and len(parsed) == 3):
                # a spec spanning hosts serves from the distributed
                # MeshDB instead of a local mesh
                dcn_plan = dcn_ops.plan_from_spec(
                    mesh_spec, n_rows=self.cdb.n_rows, device=self.device)
            if dcn_plan is None and mesh is None:
                mesh = mesh_ops.build_from_spec(
                    mesh_spec, n_rows=self.cdb.n_rows, device=self.device)
        self.mesh = mesh
        # (hosts, dp, db per host) of the distributed MeshDB, else None
        self.dcn_plan = dcn_plan
        # the requested spec, kept so an engine rebuild (the server's
        # hot DB reload) resolves the topology against the NEW DB
        # instead of dropping the mesh
        self.mesh_spec = mesh_spec
        self._mdb = None
        self._ddb = None
        self.rescreen_stats = {"candidates": 0, "confirmed": 0}
        # set when an (injected or real) device loss degraded this
        # engine to the host oracle mid-scan; `degraded` counts those
        # degradations (the reference's DEGRADED_TOTAL metric)
        self.device_lost = False
        self.degraded = 0
        # lazy (space, name) -> advisory-indices index for the oracle path
        self._oracle_index: dict | None = None
        # lazy per-advisory compiled checkers + parsed-version memo
        self._checkers: dict[int, AdvisoryChecker] = {}
        self._parse_cache: dict[tuple[str, str], object] = {}
        # (adv_idx, version-token) -> bool rescreen verdict memo, kept as
        # parallel sorted numpy arrays so a whole batch of flagged
        # candidates resolves with vectorized searchsorted instead of a
        # per-candidate dict probe. Versions intern to dense int tokens.
        # Two tiers: a big immutable sorted main array plus a small
        # sorted overlay that absorbs new verdicts cheaply; the overlay
        # merges into main only when it tops _MEMO_MERGE entries.
        self._version_tokens: dict[tuple[str, str], int] = {}
        # each tier is an immutable (keys, vals) pair swapped atomically
        # under _memo_lock — pipelined collect workers read a consistent
        # snapshot without holding the lock
        self._memo_main = (np.empty(0, dtype=np.int64),
                           np.empty(0, dtype=bool))
        self._memo_over = (np.empty(0, dtype=np.int64),
                           np.empty(0, dtype=bool))
        self._memo_lock = make_lock("detector.engine._memo_lock")
        # bumped whenever the version-token space resets: a batch
        # encoded under an older generation must not absorb its (stale
        # token-id) verdicts into the fresh memo
        self._memo_gen = 0
        # full per-query result memo for detect_many crawls: images share
        # most of their packages, so across a registry crawl nearly every
        # query after the first batches is a repeat. Bounded so a
        # long-lived server's RSS cannot climb with scan diversity.
        self._crawl_cache: dict[tuple, list[int]] = {}
        self.crawl_cache_max = 2_000_000
        self._ddb_hot = None
        self._ddb_tall = None
        # stage accounting of the most recent pipelined crawl (wall,
        # per-stage busy seconds, occupancy) — diagnostics
        self.last_pipeline_stats: dict | None = None
        # which decoder the last _crunch ran: "native" or "numpy"
        self.collector: str | None = None
        self._name_tokens: dict[tuple[str, str], int] | None = None
        self._adv_tok = None
        t0 = time.perf_counter()
        if use_device:
            # let encode_packages fill per-query tokens in its existing
            # pass (saves a second per-query loop at collection time)
            self._ensure_tokens()
            self.cdb.name_tokens = self._name_tokens
            self.cdb.version_tokens = self._version_tokens
            if dcn_plan is not None:
                from trivy_tpu_torch.ops import dcn as dcn_ops

                # cross-host: this process serves only its slice on its
                # own grid, the peers theirs behind the worker protocol,
                # merged by the same shard decoder (HostMeshDB has
                # MeshDB's surface)
                n_hosts, dp, db_local = dcn_plan
                self._mdb = dcn_ops.HostMeshDB.from_compiled(
                    self.cdb, n_hosts, dp, db_local,
                    cache_ctx=self._cache_ctx, device=self.device,
                    devices=None if mesh is None else
                    [d for row in mesh.devices for d in row])
                self.build_stats.update(
                    {f"mesh_{k}": v
                     for k, v in self._mdb.build_stats.items()})
            elif mesh is not None:
                from trivy_tpu_torch.ops import mesh as mesh_ops

                self._mdb = mesh_ops.MeshDB.from_compiled(
                    self.cdb, mesh, cache_ctx=self._cache_ctx)
                self.build_stats.update(
                    {f"mesh_{k}": v
                     for k, v in self._mdb.build_stats.items()})
            else:
                self._ddb = m.DeviceDB.from_compiled(self.cdb, self.device)
            # hot names match on the card against their own partitions
            # (mid tier + tall "linux"-class tier)
            self._ddb_hot = m.DeviceDB.hot_from_compiled(self.cdb,
                                                         self.device)
            self._ddb_tall = m.DeviceDB.tall_from_compiled(self.cdb,
                                                           self.device)
        self.build_stats["upload_s"] = time.perf_counter() - t0

    # ------------------------------------------------------------ helpers

    @property
    def device_db(self):
        """The resident main-tier DB tensors (None in mesh and host
        modes) — public handle for benches and diagnostics."""
        return self._ddb

    @property
    def mesh_data_axis(self) -> int:
        """Data-parallel width of the serving mesh (1 = single device).
        The match scheduler composes its coalesced batches to fill
        it."""
        return self._mdb.n_data if self._mdb is not None else 1

    @property
    def mesh_row_floor(self) -> int:
        """Largest batch bucket the mesh's cells have been dispatched
        (ops/match DeviceDB.bucket_floor; 0 = single device / cold): the
        match scheduler tops coalesced batches up to it."""
        if self._mdb is None:
            return 0
        return max((ddb.bucket_floor for row in self._mdb.grid
                    for ddb in row), default=0)

    def shard_health(self) -> dict | None:
        """Mesh shard health for /readyz: the topology and which db
        shards are degraded to the host mask (and, on the distributed
        MeshDB, which peer hosts are). None on the single-device
        path."""
        return self._mdb.health() if self._mdb is not None else None

    def reresolve_mesh(self) -> bool:
        """Upload degraded shards' slices to their devices again; the
        distributed MeshDB re-partitions over its surviving hosts
        (ops/dcn.py). Callers quiesce in-flight scans first (the server
        takes its write lock). True when the topology or a shard's
        residency changed; a single-device engine or a healthy mesh is a
        no-op."""
        return self._mdb.reresolve() if self._mdb is not None else False

    def close(self) -> None:
        """Release what the engine owns outside this process: the
        distributed MeshDB's worker processes and connections (every
        other engine has nothing to release). The server calls it on the
        old engine after a hot swap, once the write lock has quiesced
        its scans, and on shutdown."""
        close = getattr(self._mdb, "close", None)
        if close is not None:
            close()

    @staticmethod
    def dedupe_queries(queries: list[PkgQuery]):
        """-> (unique queries, index map original->unique)."""
        key_of: dict[tuple, int] = {}
        uniq: list[PkgQuery] = []
        idx_map = [0] * len(queries)
        for j, q in enumerate(queries):
            k = q.key
            u = key_of.get(k)
            if u is None:
                u = len(uniq)
                key_of[k] = u
                uniq.append(q)
            idx_map[j] = u
        return uniq, idx_map

    def _checker(self, adv_idx: int) -> AdvisoryChecker | None:
        ch = self._checkers.get(adv_idx)
        if ch is None:
            bucket, _name, adv = self.cdb.advisories[adv_idx]
            resolved = space_of_bucket(bucket)
            if resolved is None:
                return None
            ch = AdvisoryChecker(adv, resolved[1])
            self._checkers[adv_idx] = ch
        return ch

    def _ensure_tokens(self) -> None:
        """Integer token per (space, name), and per advisory: turns the
        per-candidate hash-collision check (string compares in Python)
        into one vectorized int compare."""
        if self._name_tokens is not None:
            return
        names: dict[tuple[str, str], int] = {}
        space_by_bucket: dict[str, str | None] = {}
        toks = np.empty(len(self.cdb.advisories), dtype=np.int64)
        for i, (bucket, name, _adv) in enumerate(self.cdb.advisories):
            space = space_by_bucket.get(bucket, "?")
            if space == "?":
                resolved = space_of_bucket(bucket)
                space = resolved[0] if resolved else None
                space_by_bucket[bucket] = space
            if space is None:
                toks[i] = -1
                continue
            key = (space, name)
            tok = names.get(key)
            if tok is None:
                tok = len(names)
                names[key] = tok
            toks[i] = tok
        self._name_tokens = names
        self._adv_tok = toks

    def _parse_version(self, scheme_name: str, version: str):
        """-> parsed version or None; memoized."""
        key = (scheme_name, version)
        if key in self._parse_cache:
            return self._parse_cache[key]
        try:
            v = get_scheme(scheme_name).parse(version)
        except ParseError:
            v = None
        self._parse_cache[key] = v
        return v

    # ------------------------------------------------------------ oracle

    def _oracle_name_index(self) -> dict:
        """name -> advisory indices, from the compiled flat list so
        indices are comparable across paths. Built once per engine."""
        if self._oracle_index is None:
            index: dict[tuple[str, str], list[int]] = {}
            for i, (bucket, name, _adv) in enumerate(self.cdb.advisories):
                resolved = space_of_bucket(bucket)
                if resolved is None:
                    continue
                index.setdefault((resolved[0], name), []).append(i)
            self._oracle_index = index
        return self._oracle_index

    def oracle_detect(self, queries: list[PkgQuery]) -> list[MatchResult]:
        """Pure-host exact detection over the uncompiled DB (the reference
        loop shape: bucket get per name, compare per advisory)."""
        index = self._oracle_name_index()
        out = []
        for q in queries:
            hits = []
            ver = self._parse_version(q.scheme_name, q.version)
            for i in index.get((q.space, q.name), []):
                ch = self._checker(i)
                if ch is None:
                    continue
                if ver is None:
                    # unparseable installed version: only the
                    # empty-range "always vulnerable" advisories match
                    if ch.adv.is_range_style and ch.always:
                        hits.append(i)
                    continue
                if ch.check_parsed(ver):
                    hits.append(i)
            out.append(MatchResult(q, sorted(hits)))
        self._enforce_memo_bounds()
        return out

    # ------------------------------------------------------------ device

    def detect(self, queries: list[PkgQuery]) -> list[MatchResult]:
        """Kernel + host rescreen. Identical output to oracle_detect.

        Duplicate queries (the dominant shape of a registry crawl —
        images share most of their packages) are deduplicated before the
        kernel and rescreen; results fan back out by index."""
        if not queries:
            return []
        uniq, idx_map = self.dedupe_queries(queries)
        if not self.use_device:
            if len(uniq) < len(queries):
                u = self.oracle_detect(uniq)
                return _meter_rows(
                    [MatchResult(q, u[idx_map[j]].adv_indices)
                     for j, q in enumerate(queries)])
            return _meter_rows(self.oracle_detect(queries))
        try:
            faults.check_device("engine")
            if len(uniq) < len(queries):
                uniq_hits = self._detect_unique(uniq)
                out = [MatchResult(q, uniq_hits[idx_map[j]])
                       for j, q in enumerate(queries)]
            else:
                hits = self._detect_unique(queries)
                out = [MatchResult(q, h) for q, h in zip(queries, hits)]
        except faults.DeviceLost as exc:
            self._degrade_device(exc)
            # re-enter through the (now) host branch so the fallback
            # pass dedupes like every other detect call
            return self.detect(queries)
        self._enforce_memo_bounds()
        return _meter_rows(out)

    def submit(self, query_lists: list[list[PkgQuery]]
               ) -> list[list[MatchResult]]:
        """Batched entry point for the cross-request match scheduler:
        ONE dedupe + device dispatch over the union of several requests'
        query lists, fanned back out per request. Byte-identical to
        per-request detect() calls: per-query answers do not depend on
        batch composition."""
        flat: list[PkgQuery] = []
        for qs in query_lists:
            flat.extend(qs)
        res = self.detect(flat)
        out: list[list[MatchResult]] = []
        i = 0
        for qs in query_lists:
            out.append(res[i: i + len(qs)])
            i += len(qs)
        return out

    def match_keys(self, query_lists: list[list[PkgQuery]]
                   ) -> list[list[tuple]]:
        """Batched finding-key extraction for delta re-scoring: ONE
        submit() micro-batch over many artifacts' query lists, reduced
        to per-list sorted ``(space, name, version, scheme,
        vulnerability_id)`` tuples."""
        res_lists = self.submit(query_lists)
        advs = self.cdb.advisories
        return [sorted(finding_keys(advs, rl)) for rl in res_lists]

    def detect_many(self, queries: list[PkgQuery], batch_size: int = 65536,
                    depth: int = 3) -> list[MatchResult]:
        """Pipelined crawl: up to `depth` batches are deduped, encoded and
        *dispatched* to the card before the first result is collected,
        so device work overlaps the host post-processing of earlier
        batches (launches and their copies back are asynchronous).

        Unique-query results memoize ACROSS batches: a registry crawl's
        images share most of their packages, so later batches dispatch
        only the queries never seen before."""
        if self.use_device:
            try:
                faults.check_device("engine")
                return self._detect_many_device(queries, batch_size, depth)
            except faults.DeviceLost as exc:
                self._degrade_device(exc)
        out = []
        for i in range(0, len(queries), batch_size):
            out.extend(self.oracle_detect(queries[i: i + batch_size]))
        return out

    def _degrade_device(self, exc: Exception) -> None:
        """The card was lost mid-scan: flip this engine to the host
        oracle for good (the compiled host copies answer every query
        the kernel would: zero match diff, only slower), log it once and
        count it. Only a DeviceLost gets here; any other device error
        raises to the caller."""
        _log.warn("device lost; degrading match engine to the host "
                  "oracle", err=str(exc))
        with self._memo_lock:
            self.degraded += 1
        obs_metrics.DEGRADED_TOTAL.inc(component="engine")
        self.use_device = False
        self.device_lost = True

    # pipelined-executor tuning: collect workers overlap the host
    # compress/rescreen of earlier batches with the encode+dispatch of
    # later ones (TRIVY_TPU_PIPELINE=0 forces the serial path,
    # TRIVY_TPU_PIPELINE_WORKERS overrides the collect-worker count)
    @staticmethod
    def _pipeline_workers() -> int:
        if os.environ.get("TRIVY_TPU_PIPELINE", "1") == "0":
            return 0
        w = os.environ.get("TRIVY_TPU_PIPELINE_WORKERS")
        if w:
            try:
                return max(int(w), 0)
            except ValueError:
                _log.warn("bad TRIVY_TPU_PIPELINE_WORKERS; using default",
                          value=w)
        return min(2, os.cpu_count() or 1)

    def _check_device_stage(self, ctx: dict, queries: list[PkgQuery]):
        """Fault hook of the in-flight device stage (site
        ``engine.device``): ``delay`` sleeps (a slow link), ``drop``
        discards the in-flight result and dispatches the batch again
        (a lost result is recomputed: the match set stays the same),
        ``device-lost`` raises so the scan degrades to the host
        oracle."""
        redo = False
        for r in faults.fire("engine.device"):
            if r.action == "delay":
                time.sleep(r.param if r.param is not None else 0.05)
            elif r.action == "drop":
                redo = True
            elif r.action == "device-lost":
                raise faults.DeviceLost(
                    "injected device loss at engine.device")
        if redo:
            # safe from a crunch lane: these queries were encoded once
            # already, so the re-encode only reads the intern tables
            ctx = self._dispatch_unique(queries)
        return ctx

    def _detect_many_device(self, queries: list[PkgQuery],
                            batch_size: int, depth: int
                            ) -> list[MatchResult]:
        cache = self._crawl_cache
        # ONE crawl-wide dedupe pass, then the pipeline only ever sees
        # unique queries
        key_of: dict[tuple, int] = {}
        uniq: list[PkgQuery] = []
        idx_map = [0] * len(queries)
        hits_by_u: list = []
        fresh: list[PkgQuery] = []
        fresh_u: list[int] = []
        # registry crawls repeat the SAME PkgQuery instances across
        # images, so an id() memo in front of the tuple-key dict answers
        # duplicates with one int-key get — ids are stable for the call
        # because `queries` keeps every object alive
        id_of: dict[int, int] = {}
        for j, q in enumerate(queries):
            u = id_of.get(id(q))
            if u is None:
                k = q.key
                u = key_of.get(k)
                if u is None:
                    u = len(uniq)
                    key_of[k] = u
                    uniq.append(q)
                    h = cache.get(k)
                    hits_by_u.append(h)
                    if h is None:
                        fresh.append(q)
                        fresh_u.append(u)
                id_of[id(q)] = u
            idx_map[j] = u

        # dispatch fresh uniques in device-sized chunks; `depth` chunks
        # stay in flight. chunk ~ batch_size scaled by the crawl's
        # observed dedupe ratio
        ratio = max(len(queries) // max(len(uniq), 1), 1)
        chunk = max(batch_size // ratio, 1024)
        workers = self._pipeline_workers()
        if workers and len(fresh) > chunk and depth > 1:
            self._run_pipelined(fresh, fresh_u, hits_by_u,
                                max(chunk // 2, 1024), depth, workers)
        else:
            pend: deque = deque()

            def flush_one():
                us, qs, ctx = pend.popleft()
                ctx = self._check_device_stage(ctx, qs)
                for u, q, h in zip(us, qs, self._collect_unique(ctx)):
                    hits_by_u[u] = h
                    cache[q.key] = h

            for i in range(0, len(fresh), chunk):
                qs = fresh[i: i + chunk]
                faults.check_device("engine")
                pend.append((fresh_u[i: i + chunk], qs,
                             self._dispatch_unique(qs)))
                while len(pend) >= depth:
                    flush_one()
            while pend:
                flush_one()
        # crawl-granularity LRU: one move-to-end pass per crawl keeps
        # every key this crawl used at the recent end of the dict, so
        # _enforce_memo_bounds sheds keys from OLD crawls first
        if len(cache) > len(uniq):
            for q in uniq:
                k = q.key
                cache[k] = cache.pop(k)
        self._enforce_memo_bounds()
        return [MatchResult(q, hits_by_u[u])
                for q, u in zip(queries, idx_map)]

    def _run_pipelined(self, fresh: list[PkgQuery], fresh_u: list[int],
                       hits_by_u: list, chunk: int, depth: int,
                       workers: int) -> None:
        """Pipelined executor over the fresh unique queries, lanes split
        by GIL affinity:

        - coordinator lane (this thread): encode + kernel launch of
          chunk N+1, then materialize + crawl-cache write of chunk N-1;
        - crunch lane(s) (`workers` threads): decode/token-screen/sort-
          dedupe/rescreen of chunk N — numpy kernels that drop the GIL;
        - the card computes chunk N's words between its launch and the
          crunch lane's wait on the copy-back event.

        The coordinator owns the intern tables and the crawl cache;
        crunch lanes share only the lock-guarded rescreen memo. All
        launches happen on this thread's current stream; crunch lanes
        wait only on each batch's event."""
        cache = self._crawl_cache
        busy = {"encode": 0.0, "crunch": 0.0, "finalize": 0.0}
        busy_lock = make_lock("detector.engine.busy_lock")
        trace_ctx = tracing.capture()

        def crunch_stage(ctx, qs):
            with tracing.adopt(trace_ctx):
                t0 = time.perf_counter()
                ctx = self._check_device_stage(ctx, qs)
                with tracing.span("pipeline.crunch", queries=len(qs)):
                    ids_c, bounds = self._crunch(ctx)
                    # tolist here (single C calls) so the coordinator's
                    # finalize only pays the per-query slicing
                    crunched = (ids_c.tolist(), bounds.tolist())
                with busy_lock:
                    busy["crunch"] += time.perf_counter() - t0
                return crunched

        wall0 = time.perf_counter()
        crunch_ex = ThreadPoolExecutor(workers,
                                       thread_name_prefix="ttpu-crunch")
        pend: deque = deque()  # (us, qs, crunch future)

        def drain_one():
            us, qs, cf = pend.popleft()
            crunched = cf.result()
            t0 = time.perf_counter()
            with tracing.span("pipeline.finalize", queries=len(qs)):
                hits = self._materialize(crunched, len(qs))
                for u, h in zip(us, hits):
                    hits_by_u[u] = h
                # one C-level bulk insert instead of a per-key loop
                cache.update(zip((q.key for q in qs), hits))
            busy["finalize"] += time.perf_counter() - t0

        try:
            for i in range(0, len(fresh), chunk):
                qs = fresh[i: i + chunk]
                t0 = time.perf_counter()
                faults.check_device("engine")
                with tracing.span("pipeline.encode", queries=len(qs)):
                    ctx = self._dispatch_unique(qs)
                busy["encode"] += time.perf_counter() - t0
                pend.append((fresh_u[i: i + chunk], qs,
                             crunch_ex.submit(crunch_stage, ctx, qs)))
                # drain finished chunks eagerly, and block once `depth`
                # chunks are in flight
                while pend and (len(pend) >= depth or pend[0][2].done()):
                    drain_one()
            while pend:
                drain_one()
        finally:
            # on an error path undrained futures must not leak
            # "exception never retrieved" noise. A cancelled future has
            # none to retrieve: reading it would raise CancelledError
            # over the DeviceLost that detect_many degrades on (the
            # reference reads it, and its pipelined crawl then fails on
            # an engine.device loss instead of degrading)
            crunch_ex.shutdown(wait=False, cancel_futures=True)
            for _us, _qs, f in list(pend):
                if f.done() and not f.cancelled():
                    f.exception()
        wall = max(time.perf_counter() - wall0, 1e-9)
        lanes = 1 + workers
        self.last_pipeline_stats = {
            "wall_s": wall,
            "encode_busy_s": busy["encode"],
            "crunch_busy_s": busy["crunch"],
            "finalize_busy_s": busy["finalize"],
            "chunks": -(-len(fresh) // chunk),
            "chunk": chunk,
            "workers": workers,
            "occupancy": min(sum(busy.values()) / (lanes * wall), 1.0),
            "collector": self.collector,
        }
        obs_metrics.PIPELINE_OCCUPANCY.set(
            self.last_pipeline_stats["occupancy"])

    def _enforce_memo_bounds(self) -> None:
        """RSS bound for long-lived servers over every diversity-keyed
        memo. Called between crawls/batches only — never with dispatches
        pending. A single crawl is bounded by its own query count."""

        def shed_oldest(memo: dict) -> None:
            # shed down to half capacity instead of a wholesale clear;
            # _crawl_cache is LRU at crawl granularity, the sibling
            # memos shed in first-computed order
            excess = len(memo) - self.crawl_cache_max // 2
            for k in list(memo)[:excess]:
                del memo[k]

        if len(self._crawl_cache) > self.crawl_cache_max:
            shed_oldest(self._crawl_cache)
        if len(self._version_tokens) > self.crawl_cache_max:
            # memo keys embed version tokens: the two reset together,
            # with both locks held, and the memo generation is bumped so
            # in-flight batches encoded under the old token space cannot
            # absorb stale-token verdicts afterwards
            with self._memo_lock, self.cdb._intern_lock:
                self.cdb.reset_intern()
                self._version_tokens.clear()
                empty = (np.empty(0, dtype=np.int64),
                         np.empty(0, dtype=bool))
                self._memo_main = empty
                self._memo_over = empty
                self._memo_gen += 1
        elif len(self.cdb._names) > self.crawl_cache_max:
            # name interning grows with scan diversity too; version ids
            # must NOT reset here (the rescreen memo keys embed them)
            with self.cdb._intern_lock:
                self.cdb.reset_name_intern()
        if len(self._parse_cache) > self.crawl_cache_max:
            shed_oldest(self._parse_cache)

    # overlay size at which it folds into the main memo (one O(main)
    # np.insert per merge instead of one per batch)
    _MEMO_MERGE = 8192

    def _memo_absorb(self, new_keys, new_vals) -> None:
        """Fold freshly computed rescreen verdicts into the overlay
        tier; fold the overlay into main when it tops _MEMO_MERGE.
        Caller holds _memo_lock. Keys are deduped against both tiers
        (verdicts are deterministic, so dropping a duplicate that a
        concurrent worker absorbed first is always safe)."""

        def known(mk, keys):
            if not len(mk) or not len(keys):
                return np.zeros(len(keys), dtype=bool)
            pos = np.minimum(np.searchsorted(mk, keys), len(mk) - 1)
            return mk[pos] == keys

        fresh = ~(known(self._memo_main[0], new_keys)
                  | known(self._memo_over[0], new_keys))
        new_keys, new_vals = new_keys[fresh], new_vals[fresh]
        mk2, mv2 = self._memo_over
        if len(new_keys):
            ins = np.searchsorted(mk2, new_keys)
            mk2 = np.insert(mk2, ins, new_keys)
            mv2 = np.insert(mv2, ins, new_vals)
        if len(mk2) >= self._MEMO_MERGE:
            mk, mv = self._memo_main
            ins = np.searchsorted(mk, mk2)
            self._memo_main = (np.insert(mk, ins, mk2),
                               np.insert(mv, ins, mv2))
            self._memo_over = (np.empty(0, dtype=np.int64),
                               np.empty(0, dtype=bool))
        else:
            self._memo_over = (mk2, mv2)

    def _rescreen_one(self, adv_idx: int, q: PkgQuery) -> bool:
        """Exact host verdict for one flagged (advisory, query) candidate."""
        ch = self._checker(adv_idx)
        if ch is None:
            return False
        ver = self._parse_version(q.scheme_name, q.version)
        if ver is None:
            # unparseable installed version: only the empty-range
            # "always vulnerable" advisories match
            return ch.adv.is_range_style and ch.always
        return ch.check_parsed(ver)

    def _dispatch_unique(self, queries: list[PkgQuery]) -> dict:
        """Encode and launch the device work for a unique-query batch
        without blocking. -> opaque ctx for _collect_unique."""
        batch = self.cdb.encode_packages([q.key for q in queries])
        ctx = {"queries": queries, "batch": batch,
               "memo_gen": self._memo_gen,
               "main": None, "sharded": None, "hot": None, "tall": None}
        # the device_dispatch attribution lane: kernel launches are
        # asynchronous, so this span times the launch work, not the
        # card's compute (that is the torch.profiler capture's)
        with tracing.span("engine.dispatch", queries=len(queries)):
            if self._mdb is not None:
                ctx["sharded"] = self._mdb.dispatch(batch)
            else:
                ctx["main"] = m.match_dispatch(self._ddb, batch)
        # hot/tall tier routing comes gathered from the name intern
        # table (batch.route)
        hot_idx = np.nonzero(batch.route == 1)[0]
        tall_idx = np.nonzero(batch.route == 2)[0]

        def sub_dispatch(idx, ddb):
            sub = PackageBatch(
                h1=batch.h1[idx], h2=batch.h2[idx],
                rank=batch.rank[idx], flags=batch.flags[idx],
                queries=[batch.queries[j] for j in idx],
            )
            return (idx, m.match_dispatch(ddb, sub), sub)

        if len(hot_idx) and self._ddb_hot is not None:
            with tracing.span("engine.dispatch", queries=len(hot_idx)):
                ctx["hot"] = sub_dispatch(hot_idx, self._ddb_hot)
        if len(tall_idx) and self._ddb_tall is not None:
            with tracing.span("engine.dispatch", queries=len(tall_idx)):
                ctx["tall"] = sub_dispatch(tall_idx, self._ddb_tall)
        return ctx

    def _detect_unique(self, queries: list[PkgQuery]) -> list[list[int]]:
        ctx = self._check_device_stage(self._dispatch_unique(queries),
                                       queries)
        return self._collect_unique(ctx)

    def _collect_unique(self, ctx: dict) -> list[list[int]]:
        """-> sorted advisory-index list per (unique) query."""
        return self._materialize(self._crunch(ctx), len(ctx["queries"]))

    def _crunch(self, ctx: dict):
        """Array-level result collection: -> (ids_c, bounds) CSR pair
        (confirmed advisory ids, per-query slice bounds).

        The kernel returns bit-packed hit words; the host maps set bits
        to row indices with its own searchsorted over the resident numpy
        copies, screens hash collisions with one vectorized token
        compare, and confirms exact hits with no per-hit Python at all:
        the native collector (native/collect.cpp) decodes, sort-dedupes
        and groups where it builds, numpy otherwise.
        Only flagged rescreen candidates — needs-host versions and npm
        pre-release queries — reach the per-advisory Python comparators,
        behind an (advisory, version) verdict memo."""
        cdb = self.cdb
        queries = ctx["queries"]
        batch = ctx["batch"]
        flag_mask = m.FLAG_NEEDS_HOST | m.FLAG_RESCREEN

        # query tokens, interned during encode_packages (the engine
        # injects its token dicts into the CompiledDB at construction)
        q_tok, q_vt = batch.ntok, batch.vtok

        native = ncollect if ncollect.available() else None
        self.collector = "numpy" if native is None else "native"

        # each part: token-screened (rows, ids, resc) for one device
        # source, rows in original query indices
        parts: list[tuple] = []

        def decode_numpy(mask, start, adv, rfl_col, fl, tok):
            """numpy fallback decode of one source's bool mask."""
            rows0, offs0 = np.nonzero(mask)
            ridx = start[rows0] + offs0
            # mask bits past the row table are skipped, matching the
            # native decoder's bound
            inb = ridx < len(adv)
            rows0, ridx = rows0[inb], ridx[inb]
            ids0 = adv[ridx].astype(np.int64)
            resc0 = ((rfl_col[ridx] | fl[rows0]) & flag_mask) != 0
            valid = self._adv_tok[ids0] == tok[rows0]
            return rows0[valid], ids0[valid], resc0[valid]

        def add_part(pending, key_h1, adv, rfl_col, sub=None, qidx=None):
            """Decode one source's words. sub = sub-batch (hot/tall
            partition); qidx maps its rows back to original query
            indices."""
            h1 = sub.h1 if sub is not None else batch.h1
            fl = sub.flags if sub is not None else batch.flags
            tok = q_tok if qidx is None else q_tok[qidx]
            start = np.searchsorted(key_h1, h1).astype(np.int64)
            decoded = None
            if native is not None:
                decoded = native.decode_mask(
                    pending.collect_words(), start, len(key_h1),
                    adv, rfl_col, self._adv_tok, tok, fl, flag_mask)
            if decoded is None:
                decoded = decode_numpy(pending.collect(), start, adv,
                                       rfl_col, fl, tok)
            rows0, ids0, resc0 = decoded
            if qidx is not None:
                rows0 = np.asarray(qidx, dtype=np.int64)[rows0]
            parts.append((rows0, ids0, resc0))

        if ctx["sharded"] is not None:
            # the mesh's [D, B, W] shard masks: shard d's window starts
            # at the query's place in its own rows (numpy decode)
            masks = ctx["sharded"].collect()
            base = self._mdb.shard_base
            for d in range(masks.shape[0]):
                lo_i = d * base
                hi_i = min(lo_i + self._mdb.shard_len, cdb.n_rows)
                if lo_i >= cdb.n_rows:
                    break
                start = np.searchsorted(
                    cdb.row_h1[lo_i:hi_i], batch.h1).astype(np.int64) + lo_i
                parts.append(decode_numpy(
                    masks[d], start, cdb.row_adv, cdb.row_flags,
                    batch.flags, q_tok))
        elif ctx["main"] is not None:
            add_part(ctx["main"], cdb.row_h1, cdb.row_adv, cdb.row_flags)
        # hot-name queries additionally run against their tier's
        # partition
        if ctx["hot"] is not None:
            hot_idx, hot_pending, sub = ctx["hot"]
            add_part(hot_pending, cdb.hot_h1, cdb.hot_adv, cdb.hot_flags,
                     sub=sub, qidx=hot_idx)
        if ctx["tall"] is not None:
            tall_idx, tall_pending, sub = ctx["tall"]
            add_part(tall_pending, cdb.tall_h1, cdb.tall_adv,
                     cdb.tall_flags, sub=sub, qidx=tall_idx)

        parts = [p for p in parts if len(p[0])]
        if not parts:
            # empty CSR: every query gets an empty hit list
            return (np.empty(0, dtype=np.int64),
                    np.zeros(len(queries) + 1, dtype=np.int64))
        rows = np.concatenate([p[0] for p in parts])
        ids = np.concatenate([p[1] for p in parts])
        resc = np.concatenate([p[2] for p in parts])

        # dedupe (row, id) keeping the exact (non-rescreen) occurrence
        # (multi-interval advisories, pre-only twin rows); native
        # packed-key sort when available, np.lexsort fallback
        deduped = None
        if native is not None:
            deduped = native.sort_dedupe(rows, ids, resc)
        if deduped is not None:
            rows, ids, resc = deduped
        else:
            order = np.lexsort((resc, ids, rows))
            rows, ids, resc = rows[order], ids[order], resc[order]
            keep = np.ones(len(rows), dtype=bool)
            keep[1:] = (rows[1:] != rows[:-1]) | (ids[1:] != ids[:-1])
            rows, ids, resc = rows[keep], ids[keep], resc[keep]

        # exact hits confirm as-is; flagged candidates collapse to unique
        # (advisory, version) pairs; the sorted-array memo answers
        # repeats with one searchsorted, and only first-seen pairs reach
        # the Python comparators
        conf = ~resc
        flagged = np.nonzero(resc)[0]
        if len(flagged):
            fkeys = (ids[flagged] << np.int64(32)) | q_vt[rows[flagged]]
            fverd = np.zeros(len(fkeys), dtype=bool)
            hit = np.zeros(len(fkeys), dtype=bool)
            # two-tier sorted lookup: each tier is an atomically-swapped
            # immutable pair, so the lockless read sees a consistent
            # keys/vals snapshot
            for mk, mv in (self._memo_main, self._memo_over):
                if not len(mk):
                    continue
                pos = np.searchsorted(mk, fkeys)
                pos_c = np.minimum(pos, len(mk) - 1)
                h = mk[pos_c] == fkeys
                fverd[h] = mv[pos_c[h]]
                hit |= h
            miss_f = np.nonzero(~hit)[0]
            if len(miss_f):
                ukeys, first_rel = np.unique(fkeys[miss_f],
                                             return_index=True)
                first = flagged[miss_f[first_rel]]
                uverd = np.empty(len(ukeys), dtype=bool)
                # exact verdicts compute OUTSIDE the memo lock (they are
                # deterministic — a concurrent lane computing the same
                # pair just produces a duplicate the absorb drops)
                for u, k in enumerate(first.tolist()):
                    uverd[u] = self._rescreen_one(
                        int(ids[k]), queries[rows[k]])
                with self._memo_lock:
                    if ctx.get("memo_gen") == self._memo_gen:
                        self._memo_absorb(ukeys, uverd)
                    # else: the token space reset since this batch was
                    # encoded — its keys embed stale version ids and
                    # must not enter the fresh memo
                fverd[miss_f] = uverd[
                    np.searchsorted(ukeys, fkeys[miss_f])]
            conf[flagged] |= fverd

        grouped = None
        if native is not None:
            grouped = native.group_confirmed(rows, ids, conf, len(queries))
        if grouped is not None:
            ids_c, bounds = grouped
        else:
            rows_c, ids_c = rows[conf], ids[conf]
            bounds = np.searchsorted(rows_c, np.arange(len(queries) + 1))
        with self._memo_lock:  # collect workers run concurrently
            self.rescreen_stats["candidates"] += len(rows)
            self.rescreen_stats["confirmed"] += len(ids_c)
        return ids_c, bounds

    @staticmethod
    def _materialize(crunched, n_queries: int) -> list[list[int]]:
        """(ids_c, bounds) -> per-query sorted hit lists. ids are sorted
        ascending within each row, so slicing on row boundaries yields
        the final per-query sorted hit lists. Accepts the arrays
        pre-converted to Python lists (the pipelined crunch lane does
        the tolist)."""
        ids_c, bounds = crunched
        bl = bounds if isinstance(bounds, list) else bounds.tolist()
        idlist = ids_c if isinstance(ids_c, list) else ids_c.tolist()
        return [idlist[bl[j]: bl[j + 1]] for j in range(n_queries)]
