"""Serving mesh for the match spine: the advisory rows sharded over a
(data x db) grid of devices, each cell launching the match kernel.

Port of trivy_tpu/ops/mesh.py. `MatchEngine(mesh=...)` (a
`device.DeviceGrid`) or `MatchEngine(mesh_spec=...)` builds a `MeshDB`
here, and every `detect` / `submit` / `detect_many` batch of the main
tier dispatches onto it.

Layout:

  "db" axis    the main tier's row table cut into halo-padded slices
               (ops/match.py `host_shards`), one slice per shard, each
               resident on its own device: the axis for advisory sets
               larger than one card's memory.
  "data" axis  the query batch split into contiguous row groups, one
               group per data-parallel replica set: the axis for query
               throughput.

Each (data group, db shard) cell is its own `match_dispatch` on that
cell's device (the existing match kernel, no collective), so a failing
cell is retried (`TRIVY_TPU_MESH_SHARD_RETRIES`, default 1) and then
only that shard's slice degrades to the host mask, the match kernel's
plain version (ops/match.py `match_words_ref`) over the same slice;
the healthy shards keep serving on their devices. The host merges the shards' bitmaps
(detector/engine.py `_crunch`).

Topology comes from `--mesh DPxDB` / `TRIVY_TPU_MESH` ("auto" sizes the
db axis so each shard fits the per-device memory budget,
`TRIVY_TPU_MESH_HBM_GB`, and gives every other device to "data"; on one
device it stays on the single-device path). The slices warm-start from
the compiled-DB cache (tensorize/cache.py `load_shards`; a 1x1 mesh
writes no shard entry).

Fault site ``engine.shard``: ``drop`` discards one cell's in-flight
result and dispatches it again, ``delay`` stalls the collect, ``error``
fails the cell (retry, then degrade), ``device-lost`` degrades the
shard at once. Only these injected faults degrade a shard: any other
error of a cell (a kernel that cannot launch, a CUDA error) raises.
Degradations are counted per shard in `MeshDB.degradations`, shown in
`health()` and in the server's /readyz.

The cross-host spec ``HOSTSxDPxDB`` is the distributed MeshDB
(ops/dcn.py): host 0's slice of its global shard partition is a MeshDB
here whose `n_global` names that partition. The reference's mesh
metrics (`trivy_tpu_mesh_*`) are fed, and the MeshDB keeps its plain
counters beside them.
"""

from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from trivy_tpu_torch.analysis.witness import make_lock
from trivy_tpu_torch.device import DeviceError, DeviceGrid, build_mesh
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import tracing
from trivy_tpu_torch.ops import match as m
from trivy_tpu_torch.resilience import faults

__all__ = ["DeviceGrid", "MeshDB", "MeshPending", "ShardFault",
           "ShardLost", "build_from_spec", "build_mesh", "choose_topology",
           "parse_spec", "shard_retries", "spec_from_env"]

_log = logger("mesh")

ENV_MESH = "TRIVY_TPU_MESH"
ENV_RETRIES = "TRIVY_TPU_MESH_SHARD_RETRIES"
ENV_HBM = "TRIVY_TPU_MESH_HBM_GB"

DEFAULT_RETRIES = 1
# per-device budget for the resident advisory slices: a budget, not a
# measurement. An H100 has 80 GB; half of it leaves room for the batch
# buffers, the hot and tall tiers, the secret screens and other users
# of the card
DEFAULT_HBM_GB = 40.0

_SPEC_RX = re.compile(r"^(?:(\d+)\s*[xX]\s*)?(\d+)\s*[xX]\s*(\d+)$")


class ShardFault(faults.FaultError):
    """A mesh cell failed (injected ``engine.shard`` error): retried,
    then the shard degrades to the host mask."""


class ShardLost(ShardFault):
    """A mesh cell's device is gone (injected ``engine.shard``
    device-lost): the shard degrades without a retry."""


def spec_from_env() -> str:
    """The ambient mesh spec (TRIVY_TPU_MESH); "" = single device."""
    return os.environ.get(ENV_MESH, "")


def shard_retries() -> int:
    raw = os.environ.get(ENV_RETRIES, "")
    if raw:
        try:
            return max(int(raw), 0)
        except ValueError:
            _log.warn("bad TRIVY_TPU_MESH_SHARD_RETRIES; using default",
                      value=raw)
    return DEFAULT_RETRIES


def _hbm_budget_bytes() -> float:
    raw = os.environ.get(ENV_HBM, "")
    if raw:
        try:
            return max(float(raw), 0.001) * 1e9
        except ValueError:
            _log.warn("bad TRIVY_TPU_MESH_HBM_GB; using default",
                      value=raw)
    return DEFAULT_HBM_GB * 1e9


def parse_spec(spec: str):
    """"" / "0" / "off" / "none" -> None (single device), "auto" ->
    "auto", "DPxDB" -> (dp, db), "HOSTSxDPxDB" with hosts >= 2 ->
    (hosts, dp, db): the cross-host distributed MeshDB (ops/dcn.py; dp x
    db is each host's own grid). A "1xDPxDB" spec collapses to the local
    (dp, db). Raises ValueError on anything else so an operator typo
    fails at startup, not mid-crawl."""
    s = (spec or "").strip().lower()
    if s in ("", "0", "off", "none"):
        return None
    if s == "auto":
        return "auto"
    mt = _SPEC_RX.match(s)
    if not mt:
        raise ValueError(
            f"bad mesh spec {spec!r}: want 'DPxDB' (e.g. 2x4), "
            "'HOSTSxDPxDB' (e.g. 2x1x4), 'auto', or 'off'")
    hosts = int(mt.group(1)) if mt.group(1) is not None else 1
    dp, db = int(mt.group(2)), int(mt.group(3))
    if hosts < 1 or dp < 1 or db < 1:
        raise ValueError(f"mesh axes must be >= 1, got {spec!r}")
    if hosts == 1:
        return dp, db
    return hosts, dp, db


def choose_topology(n_devices: int, n_rows: int) -> tuple[int, int]:
    """(dp, db) for `n_devices` and an `n_rows`-row advisory table: the
    db axis is the smallest divisor of the device count whose per-shard
    slice fits the memory budget, and every other device goes to
    data."""
    n_devices = max(int(n_devices), 1)
    row_bytes = 4 * (1 + m.TABLE_LANES)  # h1 column + interleaved table
    budget = _hbm_budget_bytes()
    db = n_devices
    for cand in range(1, n_devices + 1):
        if n_devices % cand:
            continue
        if -(-max(n_rows, 1) // cand) * row_bytes <= budget:
            db = cand
            break
    return n_devices // db, db


def local_device_count(device: torch.device) -> int:
    """Devices "auto" may spread over: the CUDA devices for a cuda
    engine, one for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device_count()
    return 1


def build_from_spec(spec: str, n_rows: int,
                    device: torch.device) -> DeviceGrid | None:
    """Grid from an operator spec, or None for the single-device path.
    For a cuda `device` the cells are the first dp*db CUDA devices
    (raising when there are fewer); for the CPU every cell is the CPU.
    "auto" picks the topology from the DB size and the device count,
    and stays on the single-device path on one device."""
    parsed = parse_spec(spec)
    if parsed is None:
        return None
    if parsed != "auto" and len(parsed) == 3:
        # the engine routes a cross-host spec to the distributed MeshDB
        # (ops/dcn.py) before this point: a caller skipped that
        raise ValueError(
            f"mesh spec {spec!r} spans hosts; cross-host serving is "
            "the distributed MeshDB (ops/dcn.py), not a local mesh")
    if parsed == "auto":
        n_local = local_device_count(device)
        if n_local <= 1:
            return None
        dp, db = choose_topology(n_local, n_rows)
    else:
        dp, db = parsed
    grid = build_mesh(dp, db, devices=None if device.type == "cuda"
                      else [device] * (dp * db))
    _log.info("serving mesh topology selected", data=dp, db=db,
              devices=dp * db, spec=spec, rows=n_rows)
    return grid


# ------------------------------------------------------------------ MeshDB


@dataclass
class MeshPending:
    """An in-flight mesh match: one Pending per (data group, db shard)
    cell, collected into the [n_db, B, W] per-shard mask stack the
    engine's decoder reads. The engine.shard ladder runs at collect
    time, so a lost in-flight result can be dispatched again."""

    mdb: "MeshDB"
    # (lo, hi, sub_batch, [(group, Pending) or None per shard])
    groups: list
    b: int

    def collect(self) -> np.ndarray:
        w = m._words(self.mdb.window) * 32
        masks = np.zeros((self.mdb.n_db, self.b, w), dtype=bool)
        for d in range(self.mdb.n_db):
            for lo, hi, sub, pends in self.groups:
                masks[d, lo:hi] = self.mdb._collect_cell(d, sub, pends[d])
        return masks


@dataclass
class MeshDB:
    """The serving mesh: per-shard halo-padded row slices, each
    replicated across the data axis as one DeviceDB per cell on that
    cell's device."""

    cdb: object
    grid: list          # [n_data][n_db] DeviceDB
    devices: list       # [n_data][n_db] torch.device
    n_data: int
    n_db: int
    window: int
    shard_len: int
    shard_base: int
    # the shard count of the partition the slices come from: n_db on one
    # host (the default, 0), HOSTS * DB for the distributed MeshDB's
    # coordinator, whose shards are that partition's first n_db
    n_global: int = 0
    retries: int = field(default_factory=shard_retries)
    degraded: set = field(default_factory=set)
    # per shard: degradations, retries and re-resolves (the reference's
    # MESH_SHARD_DEGRADATIONS / MESH_SHARD_RETRIES / MESH_RERESOLVES)
    degradations: dict = field(default_factory=dict)
    shard_retry_count: dict = field(default_factory=dict)
    reresolves: int = 0
    # where the build's time went: the shard-cache lookup ("hit",
    # "miss" or "off"), the slices' load or cut and save, their upload
    build_stats: dict = field(default_factory=dict)
    # per degraded shard: its slice as a CPU DeviceDB, which the plain
    # version of the match kernel (ops/match.py match_words_ref) reads
    host_dbs: dict = field(default_factory=dict)
    _lock: object = field(
        default_factory=lambda: make_lock("ops.mesh.MeshDB._lock"))

    def __post_init__(self):
        self.n_global = self.n_global or self.n_db

    # -------------------------------------------------------- construction

    @classmethod
    def from_compiled(cls, cdb, mesh: DeviceGrid,
                      cache_ctx=None) -> "MeshDB":
        """Build the mesh-resident DB from a CompiledDB. `cache_ctx` =
        (db_path, digest, db_meta, requested_window) routes the shard
        slices through the compiled-DB cache (keyed by the shard count)
        so a warm start skips the slicing."""
        from trivy_tpu_torch.tensorize import cache as compile_cache

        t0 = time.perf_counter()
        n_data = mesh.shape["data"]
        n_db = mesh.shape["db"]
        shards = None
        db_path = digest = db_meta = window_req = None
        if cache_ctx:
            db_path, digest, db_meta, window_req = cache_ctx
        use_cache = bool(db_path) and n_db >= 2 and compile_cache.enabled()
        if use_cache:
            shards = compile_cache.load_shards(
                db_path, cdb, n_db, window=window_req, digest=digest,
                db_meta=db_meta)
        stats = {"shard_cache": "off" if not use_cache
                 else "miss" if shards is None else "hit"}
        if shards is None:
            shards = m.host_shards(cdb, n_db)
            if use_cache:
                compile_cache.save_shards(
                    db_path, cdb, n_db, shards, window=window_req,
                    digest=digest, db_meta=db_meta)
        t1 = time.perf_counter()
        stats["shard_s"] = t1 - t0
        h1s, tables, shard_len, shard_base = shards
        devices = [list(row) for row in mesh.devices]
        grid = [[m.shard_device_db(h1s[d], tables[d], cdb.window,
                                   devices[g][d])
                 for d in range(n_db)] for g in range(n_data)]
        stats["upload_s"] = time.perf_counter() - t1
        obs_metrics.MESH_SHAPE.set(n_data, axis="data")
        obs_metrics.MESH_SHAPE.set(n_db, axis="db")
        # a reload from a distributed topology back onto a local mesh
        # must not leave a stale cross-host gauge behind
        obs_metrics.MESH_SHAPE.set(1, axis="hosts")
        _log.info("mesh DB resident", data=n_data, db=n_db,
                  shard_rows=shard_len, total_rows=cdb.n_rows)
        return cls(cdb=cdb, grid=grid, devices=devices, n_data=n_data,
                   n_db=n_db, window=cdb.window, shard_len=shard_len,
                   shard_base=shard_base, build_stats=stats)

    # ------------------------------------------------------------ dispatch

    def dispatch(self, batch) -> MeshPending | None:
        """Launch a batch across the mesh without blocking: the query
        rows split into contiguous data-axis groups, each group's rows
        dispatch against every db shard's slice on that cell's device.
        None when there is no work."""
        b = len(batch.h1)
        if b == 0 or self.cdb.n_rows == 0:
            return None
        base, rem = divmod(b, self.n_data)
        groups = []
        lo = 0
        for g in range(self.n_data):
            hi = lo + base + (1 if g < rem else 0)
            if hi == lo:
                continue
            sub = m.PackageBatch(
                h1=batch.h1[lo:hi], h2=batch.h2[lo:hi],
                rank=batch.rank[lo:hi], flags=batch.flags[lo:hi],
                queries=batch.queries[lo:hi],
            )
            pends = []
            for d in range(self.n_db):
                if d in self.degraded:
                    pends.append(None)  # the host mask at collect
                else:
                    pends.append((g, m.match_dispatch(self.grid[g][d],
                                                      sub)))
            groups.append((lo, hi, sub, pends))
            lo = hi
        return MeshPending(mdb=self, groups=groups, b=b)

    # ------------------------------------------------------------- collect

    def _host_mask(self, d: int, sub) -> np.ndarray:
        """Shard d's mask on the host: the match kernel's plain version
        over the shard's own slice (pad rows and search index as on
        its device), so the bits equal the kernel's. `d` indexes the
        whole partition, so the distributed MeshDB asks here for a lost
        host's shards too."""
        with self._lock:
            ddb = self.host_dbs.get(d)
        if ddb is None:
            h1s, tables, _len, _base = m.host_shards(self.cdb,
                                                     self.n_global)
            ddb = m.shard_device_db(h1s[d], tables[d], self.window,
                                    torch.device("cpu"))
            with self._lock:
                ddb = self.host_dbs.setdefault(d, ddb)
        return m.match_batch(ddb, sub)

    def _degrade(self, d: int, exc: Exception) -> None:
        with self._lock:
            fresh = d not in self.degraded
            self.degraded.add(d)
            if fresh:
                self.degradations[d] = self.degradations.get(d, 0) + 1
        if fresh:
            obs_metrics.MESH_SHARD_DEGRADATIONS.inc(shard=str(d))
            _log.warn(
                "mesh shard degraded to the host mask (healthy shards "
                "keep serving on their devices; zero finding diff)",
                shard=d, err=str(exc))

    def _collect_cell(self, d: int, sub, cell) -> np.ndarray:
        """Block on one (data group, db shard) cell's result, running
        the engine.shard ladder: drop -> dispatch again, error -> retry
        then degrade, device-lost -> degrade now. Returns the kernel's
        mask either way: a degradation changes latency, never bits. An
        error that is not an injected fault raises."""
        t0 = time.perf_counter()
        # the device_wait attribution lane: this is where the match
        # path blocks on the card (the launch is asynchronous)
        with tracing.span("engine.shard", shard=d):
            try:
                return self._collect_cell_ladder(d, sub, cell)
            finally:
                obs_metrics.MESH_SHARD_DISPATCH_SECONDS.observe(
                    time.perf_counter() - t0, shard=str(d))

    def _collect_cell_ladder(self, d: int, sub, cell) -> np.ndarray:
        if cell is None or d in self.degraded:
            return self._host_mask(d, sub)
        g, pending = cell
        attempt = 0
        while True:
            try:
                redo = pending is None
                for r in faults.fire("engine.shard"):
                    if r.action == "delay":
                        time.sleep(r.param if r.param is not None
                                   else 0.02)
                    elif r.action == "drop":
                        redo = True
                    elif r.action == "error":
                        raise ShardFault(
                            f"injected shard error (shard {d})")
                    elif r.action == "device-lost":
                        raise ShardLost(
                            f"injected shard device loss (shard {d})")
                if redo:
                    # a dropped in-flight result is recomputed: the
                    # match set stays the same
                    pending = m.match_dispatch(self.grid[g][d], sub)
                return pending.collect()
            except (ShardLost, faults.DeviceLost) as exc:
                self._degrade(d, exc)
                return self._host_mask(d, sub)
            except ShardFault as exc:
                if attempt >= self.retries:
                    self._degrade(d, exc)
                    return self._host_mask(d, sub)
                attempt += 1
                with self._lock:
                    self.shard_retry_count[d] = \
                        self.shard_retry_count.get(d, 0) + 1
                obs_metrics.MESH_SHARD_RETRIES.inc(shard=str(d))
                _log.warn("mesh shard dispatch failed; retrying",
                          shard=d, attempt=attempt, err=str(exc))
                pending = None  # dispatched again on the next pass

    # ----------------------------------------------------------- reresolve

    def reresolve(self) -> bool:
        """Clear sticky shard degradation by uploading every degraded
        shard's slice to its cells' devices again (degradation is one
        way while serving, so a flapping device cannot switch bits on
        and off the card; recovery is an explicit decision). Returns
        True when a shard was restored; a healthy mesh is a no-op. An
        upload that fails (a CUDA error included) raises DeviceError to
        the caller and leaves its shard degraded."""
        with self._lock:
            degraded = sorted(self.degraded)
        if not degraded:
            return False
        h1s, tables, _len, _base = m.host_shards(self.cdb, self.n_global)
        for d in degraded:
            for g in range(self.n_data):
                dev = self.devices[g][d]
                try:
                    self.grid[g][d] = m.shard_device_db(
                        h1s[d], tables[d], self.window, dev)
                except Exception as exc:
                    raise DeviceError(
                        f"shard {d} upload onto {dev} failed: "
                        f"{type(exc).__name__}: {exc}") from exc
            with self._lock:
                self.degraded.discard(d)
        with self._lock:
            self.reresolves += 1
        obs_metrics.MESH_RERESOLVES.inc(scope="shard")
        _log.info("mesh shards re-resolved onto their devices",
                  shards=degraded)
        return True

    # -------------------------------------------------------------- health

    def health(self) -> dict:
        with self._lock:
            degraded = sorted(self.degraded)
        return {
            "shape": f"{self.n_data}x{self.n_db}",
            "data": self.n_data,
            "db": self.n_db,
            "degraded": degraded,
        }
