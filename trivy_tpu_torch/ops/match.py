"""Batched name-hash join + version-interval containment on a CUDA card.

Port of trivy_tpu/ops/match.py. The advisory rows stay on the device as
the sorted h1 key column plus the interleaved int32[N, 8] row table
(h1, h2, lo, hi, flags + 3 pad), exactly as in the reference, and one
kernel evaluates a whole query batch against them:

  1. lower-bound search of each query's h1 in the sorted row_h1
     (unsigned order);
  2. the ceil32(W) consecutive rows from there (the window);
  3. hit = (h1, h2 equal) AND (lo <= rank <= hi OR row NEEDS_HOST OR
           query NEEDS_HOST) AND (row not PRE_ONLY OR query RESCREEN or
           NEEDS_HOST);
  4. bit w%32 of word w//32 per query: int32[B, ceil(W/32)] words,
     read back as uint32.

`match_words` is the wrapper: on a CUDA tensor it launches the
hand-written kernel (ops/csrc/match.cu) on the grid `match_layout`
picks, on a CPU tensor it runs the plain PyTorch version
`match_words_ref`. The host maps set bits back to
advisory ids from its resident numpy copies (detector/engine.py).

Ids, hashes and flags are int32 tensors throughout: uint32 hashes ride
as their int32 bit pattern, and the search alone needs the unsigned
order (the kernel compares as uint32; the plain version searches an
int64 copy masked to 32 bits).
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch

from trivy_tpu_torch.tensorize.compile import CompiledDB, PackageBatch

FLAG_NEEDS_HOST = 1
FLAG_RESCREEN = 2  # pkg-level: interval hit is superset, rescreen needed
FLAG_PRE_ONLY = 4  # row-level: only candidates for pre-release queries

TABLE_LANES = 8  # int32 lanes per row: h1,h2,lo,hi,flags + 3 pad

_PAD_H1 = np.uint32(0xFFFFFFFF)
_MASK32 = 0xFFFFFFFF
_INT32_LIMIT = 1 << 31  # the kernel indexes rows and queries with int

_count_lock = threading.Lock()  # guards the launch counters


def _words(window: int) -> int:
    """Output words per query for a given guarantee window."""
    return -(-window // 32)


def _bucket(n: int) -> int:
    """Batch size rounded up to 128 * 2^k (the reference's jit-shape
    bucket; kept as the unit the scheduler tops batches up to)."""
    if n <= 128:
        return 128
    return 128 << (-(-n // 128) - 1).bit_length()


def _pack_table(h1, h2, lo, hi, flags) -> np.ndarray:
    """-> int32[N, TABLE_LANES] interleaved row table (one 32-byte row
    serves all fields). h1/h2 are bitcast; equality compares are
    unaffected."""
    n = len(h1)
    t = np.zeros((n, TABLE_LANES), dtype=np.int32)
    t[:, 0] = h1.view(np.int32)
    t[:, 1] = h2.view(np.int32)
    t[:, 2] = lo
    t[:, 3] = hi
    t[:, 4] = flags
    return t


def index_levels(n: int) -> int:
    """Levels of the search index above n keys: the fewest whose top
    level has at most 32 entries (csrc/match.cu index_levels)."""
    levels = 0
    while -(-n // 32 ** levels) > 32:
        levels += 1
    return levels


@functools.cache
def index_size(n: int) -> int:
    """Entries of search_index over n keys."""
    return sum(-(-n // 32 ** level)
               for level in range(1, index_levels(n) + 1))


def search_index(keys: np.ndarray) -> np.ndarray:
    """The match kernel's search index over sorted keys: for each level l
    from index_levels(n) down to 1, keys[::32 ** l] (every 32 ** l-th
    key: what one 32-ary search step reads, stored together), top level
    first; empty for 32 keys or fewer. -> uint32[~n / 31]."""
    keys = np.asarray(keys, dtype=np.uint32)
    levels = index_levels(len(keys))
    return np.concatenate([keys[:: 32 ** l] for l in range(levels, 0, -1)]
                          + [np.empty(0, np.uint32)])


@dataclass
class DeviceDB:
    """Advisory rows resident on a device: the sorted h1 key column
    (search target, int32 bit pattern of uint32 hashes), its search
    index (search_index) and the interleaved row table."""

    h1: torch.Tensor  # int32[N], sorted as uint32
    table: torch.Tensor  # int32[N, TABLE_LANES]
    n_rows: int
    window: int
    h1_index: torch.Tensor  # int32 bit patterns of search_index(h1)
    # largest batch bucket dispatched so far (bookkeeping the scheduler
    # reads; the CUDA kernel launches on the real batch size)
    bucket_floor: int = 0
    # kernel launches against this DB (CUDA path only), beside the
    # wrapper's total in match_words.launches
    launches: int = 0

    @property
    def device(self) -> torch.device:
        return self.table.device

    @classmethod
    def from_arrays(cls, h1: np.ndarray, h2: np.ndarray, lo: np.ndarray,
                    hi: np.ndarray, flags: np.ndarray, window: int,
                    device) -> "DeviceDB":
        """Numpy row columns of a CompiledDB (from either package) ->
        resident tensors on `device`."""
        h1 = np.ascontiguousarray(h1, dtype=np.uint32)
        return cls(
            h1=torch.from_numpy(h1.view(np.int32).copy()).to(device),
            table=torch.from_numpy(_pack_table(
                h1, np.asarray(h2, dtype=np.uint32), lo, hi,
                flags)).to(device),
            n_rows=len(h1),
            window=window,
            h1_index=torch.from_numpy(
                search_index(h1).view(np.int32)).to(device),
        )

    @classmethod
    def from_compiled(cls, cdb: CompiledDB, device) -> "DeviceDB":
        return cls.from_arrays(cdb.row_h1, cdb.row_h2, cdb.row_lo,
                               cdb.row_hi, cdb.row_flags, cdb.window,
                               device)

    @classmethod
    def hot_from_compiled(cls, cdb: CompiledDB,
                          device) -> "DeviceDB | None":
        """Hot mid-tier partition (names whose row group exceeds the
        main window) as its own DeviceDB, matched by the same kernel
        with its own window, only for queries routed to a hot name."""
        if cdb.hot_h1 is None or len(cdb.hot_h1) == 0:
            return None
        return cls.from_arrays(cdb.hot_h1, cdb.hot_h2, cdb.hot_lo,
                               cdb.hot_hi, cdb.hot_flags, cdb.hot_window,
                               device)

    @classmethod
    def tall_from_compiled(cls, cdb: CompiledDB,
                           device) -> "DeviceDB | None":
        """Tall tier ("linux"-class giant name groups): its large window
        is paid only by queries for those few names."""
        if cdb.tall_h1 is None or len(cdb.tall_h1) == 0:
            return None
        return cls.from_arrays(cdb.tall_h1, cdb.tall_h2, cdb.tall_lo,
                               cdb.tall_hi, cdb.tall_flags,
                               cdb.tall_window, device)


def match_words_ref(ddb: DeviceDB, h1: torch.Tensor, h2: torch.Tensor,
                    rank: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the match kernel: -> int32[B, W/32],
    bit w%32 of word w//32 set iff the row at (window start + w) is a
    hit for the query. Mirrors trivy_tpu.ops.match._match_kernel."""
    b = h1.shape[0]
    nw = _words(ddb.window)
    n = ddb.n_rows
    if n == 0 or b == 0:
        return torch.zeros((b, nw), dtype=torch.int32, device=h1.device)
    dev = ddb.table.device
    # unsigned order: search int64 copies masked to 32 bits, never the
    # int32 bit patterns (searchsorted would read them as signed)
    keys = ddb.h1.to(torch.int64) & _MASK32
    start = torch.searchsorted(keys, h1.to(torch.int64) & _MASK32,
                               side="left")
    offs = start[:, None] + torch.arange(nw * 32, device=dev)[None, :]
    in_bounds = offs < n
    rows = ddb.table[offs.clamp(max=n - 1)]  # [B, w, TABLE_LANES]
    name_eq = (in_bounds & (rows[..., 0] == h1[:, None])
               & (rows[..., 1] == h2[:, None]))
    r = rank[:, None]
    in_iv = (rows[..., 2] <= r) & (r <= rows[..., 3])
    rfl = rows[..., 4]
    qfl = flags[:, None]
    host = ((rfl & FLAG_NEEDS_HOST) != 0) | ((qfl & FLAG_NEEDS_HOST) != 0)
    pre_ok = ((rfl & FLAG_PRE_ONLY) == 0) | (
        (qfl & (FLAG_RESCREEN | FLAG_NEEDS_HOST)) != 0)
    hit = name_eq & (in_iv | host) & pre_ok
    weights = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, dtype=torch.int64, device=dev)
    words = (hit.reshape(b, nw, 32).to(torch.int64) * weights).sum(-1)
    # bit 31: wrap the uint32 value into int32 explicitly
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


MATCH_WARPS = 8  # warps a block of the match kernel (csrc/match.cu)
# warps an SM holds of the long-window kernel (4 blocks of 8 warps: its
# __launch_bounds__)
MATCH_RESIDENT_WARPS = 32


def match_layout(n_words: int, b: int, n_sm: int) -> int:
    """The layout of one match launch: `b` queries of `n_words` words on
    a card of `n_sm` SMs, in blocks of MATCH_WARPS warps. -> warps per
    query: a query's words are spread over 1, 2, 4 or 8 warps (word k to
    warp k mod warps per query), doubling while a warp would take more
    than 4 words and the doubled grid would still fit the card's
    resident warps at once. A grid that fills the card without spreading
    (the main tier's 2-word window, or a batch large for its window)
    keeps one warp a query; the kernel then loads 2 words at a time (the
    instance whose registers let 8 blocks share an SM), a spread query 4.
    The hot tier's 30 words (34 queries) take eight warps, the tall
    tier's 125 (993 queries) four."""
    wq = 1
    while (wq < MATCH_WARPS and n_words > 4 * wq
           and 2 * wq * max(b, 1) <= n_sm * MATCH_RESIDENT_WARPS):
        wq *= 2
    return wq


def match_words(ddb: DeviceDB, h1: torch.Tensor, h2: torch.Tensor,
                rank: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """-> int32[B, ceil(W/32)] packed hit words (uint32 bit patterns).

    On a CUDA tensor: the hand-written kernel (raises if it cannot
    launch). On a CPU tensor: `match_words_ref`. Queries are int32[B]
    each (h1/h2 as uint32 bit patterns), on the DB's device."""
    if ddb.table.device.type == "cpu":
        return match_words_ref(ddb, h1, h2, rank, flags)
    from trivy_tpu_torch.ops import kernels

    b = h1.shape[0]
    nw = _words(ddb.window)
    dev = ddb.table.device
    for name, t in (("h1", h1), ("h2", h2), ("rank", rank),
                    ("flags", flags)):
        if t.device != dev or t.dtype != torch.int32 or t.dim() != 1 \
                or t.shape[0] != b or not t.is_contiguous():
            raise ValueError(
                f"match_words: {name} must be a contiguous int32[{b}] "
                f"tensor on {dev}, got {t.dtype}{list(t.shape)} on "
                f"{t.device}")
    if ddb.h1.dtype != torch.int32 or ddb.h1.shape != (ddb.n_rows,) \
            or ddb.table.shape != (ddb.n_rows, TABLE_LANES) \
            or ddb.table.dtype != torch.int32 \
            or not ddb.h1.is_contiguous() or not ddb.table.is_contiguous() \
            or ddb.h1.device != dev or ddb.h1_index.device != dev \
            or ddb.h1_index.dtype != torch.int32 \
            or ddb.h1_index.shape != (index_size(ddb.n_rows),) \
            or not ddb.h1_index.is_contiguous():
        raise ValueError("match_words: malformed DeviceDB tensors")
    if ddb.n_rows >= _INT32_LIMIT or b >= _INT32_LIMIT:
        raise ValueError("match_words: more rows or queries than int32 holds")
    out = torch.empty((b, nw), dtype=torch.int32, device=dev)
    if ddb.n_rows == 0 or b == 0:
        return out.zero_()
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    kernels.match_words_cuda(ddb.h1, ddb.h1_index, ddb.table, h1, h2, rank,
                             flags, out,
                             match_layout(nw, b, kernels.sm_count(index)))
    with _count_lock:
        match_words.launches += 1
        ddb.launches += 1
    return out


match_words.launches = 0  # kernel launches (CUDA path only)


def _unpack_words(words: np.ndarray, window: int) -> np.ndarray:
    """uint32[B, W/32] -> bool[B, ceil32(W)] hit mask."""
    if words.size == 0:
        return np.zeros((words.shape[0], _words(window) * 32), dtype=bool)
    words = np.ascontiguousarray(words)
    return np.unpackbits(
        words.view(np.uint8).reshape(words.shape[0], -1),
        axis=1, bitorder="little").astype(bool)


def _sorted_padded(batch: PackageBatch, bucket: int):
    """Sort queries by h1 (near-monotonic row reads) and pad to the
    bucket with no-match sentinels. -> (order, h1, h2, rank, flags)."""
    order = np.argsort(batch.h1, kind="stable")
    pad = bucket - len(order)

    def prep(a, fill):
        s = a[order]
        if pad:
            s = np.concatenate([s, np.full(pad, fill, a.dtype)])
        return s

    return (
        order,
        prep(batch.h1, _PAD_H1),
        prep(batch.h2, _PAD_H1),
        prep(batch.rank, np.int32(0)),
        prep(batch.flags, np.int32(0)),
    )


def query_tensors(batch: PackageBatch, device):
    """h1-sorted query columns of a batch on `device` in one host-to-
    device copy. -> (order, (h1, h2, rank, flags) int32[B] tensors)."""
    order, h1, h2, rank, flags = _sorted_padded(batch, len(batch.h1))
    cols = np.stack([h1.view(np.int32), h2.view(np.int32),
                     rank.astype(np.int32, copy=False),
                     flags.astype(np.int32, copy=False)])
    q = torch.from_numpy(cols).to(device)
    return order, (q[0], q[1], q[2], q[3])


@dataclass
class Pending:
    """An in-flight match. On a card the words are copied into a pinned
    host buffer with `non_blocking=True` on the launch stream right
    after the launch, and an event marks the copy's end: collection
    (possibly on another thread, whose current stream differs) waits on
    that event alone."""

    host: torch.Tensor  # int32[B, W/32], pinned on a card
    event: "torch.cuda.Event | None"
    order: np.ndarray
    b: int
    window: int

    def collect_words(self) -> np.ndarray:
        """Block and -> uint32[B, W/32] packed hit words in original
        query order."""
        if self.event is not None:
            self.event.synchronize()
        ws = self.host.numpy().view(np.uint32)[: self.b]
        out = np.empty_like(ws)
        out[self.order] = ws
        return out

    def collect(self) -> np.ndarray:
        """Block and -> bool[B, ceil32(W)] mask in original query order."""
        return _unpack_words(self.collect_words(), self.window)


def match_dispatch(ddb: DeviceDB, batch: PackageBatch) -> Pending | None:
    """Enqueue a match without blocking. None when there is no work."""
    b = len(batch.h1)
    if ddb.n_rows == 0 or b == 0:
        return None
    ddb.bucket_floor = max(_bucket(b), ddb.bucket_floor)
    order, q = query_tensors(batch, ddb.device)
    words = match_words(ddb, *q)
    if words.device.type == "cpu":
        return Pending(host=words, event=None, order=order, b=b,
                       window=ddb.window)
    host = torch.empty(words.shape, dtype=words.dtype, pin_memory=True)
    host.copy_(words, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(words.device))
    return Pending(host=host, event=event, order=order, b=b,
                   window=ddb.window)


def match_batch(ddb: DeviceDB, batch: PackageBatch) -> np.ndarray:
    """Single-device match -> bool[B, ceil32(W)] hit mask in the original
    query order. Row index of bit (b, w) = searchsorted(row_h1, h1[b]) + w."""
    p = match_dispatch(ddb, batch)
    if p is None:
        return np.zeros((len(batch.h1), _words(ddb.window) * 32), dtype=bool)
    return p.collect()
