"""Port parity, match kernel: trivy_tpu_torch.ops.match against the JAX
package's trivy_tpu.ops.match._match_kernel, and the port's compiled DB
against trivy_tpu.tensorize.compile.

Same seeded inputs through both packages; outputs are integers, so the
tolerance is exact equality. On the CPU the port's wrapper runs the
kernel's plain PyTorch version; the CUDA kernel itself is held against
it by the `cuda`-marked test, which needs a card.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_match import _random_db, _random_queries

from trivy_tpu.ops import match as jm
from trivy_tpu.tensorize.compile import compile_db as jax_compile_db
from trivy_tpu_torch.db import Advisory, AdvisoryDB
from trivy_tpu_torch.ops import match as tm
from trivy_tpu_torch.tensorize.compile import compile_db

CPU = torch.device("cpu")
TIERS = ("row", "hot", "tall")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and idle OpenMP workers spin on cores their neighbours' timing
    tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_db(jdb) -> AdvisoryDB:
    """The JAX package's AdvisoryDB rebuilt in the port's own types."""
    db = AdvisoryDB()
    for bucket, pkgs in jdb.buckets.items():
        for name, advs in pkgs.items():
            for a in advs:
                db.put_advisory(bucket, name, Advisory(**{
                    k: getattr(a, k) for k in a.__dataclass_fields__}))
    return db


def tier_cols(cdb, tier: str):
    """(h1, h2, lo, hi, flags, window) of one tier of a CompiledDB."""
    if tier == "row":
        return (cdb.row_h1, cdb.row_h2, cdb.row_lo, cdb.row_hi,
                cdb.row_flags, cdb.window)
    return tuple(getattr(cdb, f"{tier}_{c}")
                 for c in ("h1", "h2", "lo", "hi", "flags", "window"))


def jax_words(cols, q, window: int) -> np.ndarray:
    h1, h2, lo, hi, flags = cols
    words = jm._match_kernel(
        jnp.asarray(h1), jnp.asarray(jm._pack_table(h1, h2, lo, hi, flags)),
        *(jnp.asarray(a) for a in q), window=window)
    return np.asarray(words)


def port_words(cols, q, window: int, fn=tm.match_words_ref) -> np.ndarray:
    ddb = tm.DeviceDB.from_arrays(*cols, window=window, device=CPU)
    qt = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
          for a in q]
    return fn(ddb, *qt).numpy().view(np.uint32)


def synth_case(rng: np.random.Generator, n: int, window: int, b: int):
    """Sorted random rows with name groups up to `window` wide (hits on
    bit 31), h1 values across the whole uint32 range, h1 collisions,
    every flag mix and shard pad rows (hi = -1); queries on group
    starts, h2 mismatches, misses and the last real row."""
    n_pad = min(n // 10, 4)
    n_real = n - n_pad
    sizes = []
    while sum(sizes) < n_real:
        sizes.append(int(rng.integers(1, window + 1)) if rng.random() < 0.3
                     else int(rng.integers(1, 6)))
    sizes[-1] -= sum(sizes) - n_real
    sizes = [s for s in sizes if s > 0]
    g_h1 = np.sort(rng.integers(0, 2**32 - 1, size=len(sizes),
                                dtype=np.uint64)).astype(np.uint32)
    share = rng.random(len(sizes)) < 0.15
    share[0] = False
    g_h1 = np.where(share, np.roll(g_h1, 1), g_h1).astype(np.uint32)
    g_h2 = rng.integers(0, 2**32 - 1, size=len(sizes),
                        dtype=np.uint64).astype(np.uint32)
    h1, h2 = np.repeat(g_h1, sizes), np.repeat(g_h2, sizes)
    order = np.lexsort((h2, h1))
    h1, h2 = h1[order], h2[order]
    lo = rng.integers(-4, 30, size=n_real).astype(np.int32)
    hi = (lo + rng.integers(-2, 30, size=n_real)).astype(np.int32)
    flags = rng.choice(np.array([0, 0, 1, 4, 5], np.int32), size=n_real)
    pad = np.full(n_pad, 0xFFFFFFFF, np.uint32)
    cols = (np.concatenate([h1, pad]), np.concatenate([h2, pad]),
            np.concatenate([lo, np.zeros(n_pad, np.int32)]),
            np.concatenate([hi, np.full(n_pad, -1, np.int32)]),
            np.concatenate([flags, np.zeros(n_pad, np.int32)]))
    pick = rng.integers(0, n_real, size=b)
    kind = rng.random(b)
    q_h1, q_h2 = h1[pick].copy(), h2[pick].copy()
    q_h2[(kind > 0.8) & (kind <= 0.9)] ^= np.uint32(1)
    miss = kind > 0.9
    q_h1[miss] = rng.integers(0, 2**32 - 1, size=int(miss.sum()),
                              dtype=np.uint64).astype(np.uint32)
    q_h1[-1], q_h2[-1] = h1[-1], h2[-1]
    q_rank = rng.integers(-4, 60, size=b).astype(np.int32)
    q_flags = rng.choice(np.array([0, 1, 2, 3], np.int32), size=b)
    q_flags[-1] = 1
    # the kernel sees queries h1-sorted, as match_dispatch sends them
    o = np.argsort(q_h1, kind="stable")
    return cols, (q_h1[o], q_h2[o], q_rank[o], q_flags[o])


@pytest.fixture(scope="module")
def jdb():
    return _random_db(random.Random(42))


@pytest.fixture(scope="module")
def queries():
    return [q.key for q in _random_queries(random.Random(7), n=900)]


@pytest.mark.parametrize("window", [None, 32, 40, 4])
def test_words_equal_jax_kernel_on_fixture_db(jdb, queries, window):
    """Every tier of the test_match.py fixture DB, JAX-compiled, through
    both kernels on the batch match_dispatch would send."""
    cdb = jax_compile_db(jdb, window=window)
    batch = cdb.encode_packages(queries)
    tiers_seen = 0
    for tier in TIERS:
        cols = tier_cols(cdb, tier)
        if cols[0] is None or len(cols[0]) == 0:
            continue
        tiers_seen += 1
        w = cols[-1]
        _order, *q = jm._sorted_padded(batch, len(batch.h1))
        want = jax_words(cols[:-1], q, w)
        got = port_words(cols[:-1], q, w)
        assert got.shape == want.shape == (len(queries), jm._words(w))
        np.testing.assert_array_equal(got, want)
        assert got.any()
    assert tiers_seen >= (2 if window == 4 else 1)


@pytest.mark.parametrize("n", [1, 37, 1000])
@pytest.mark.parametrize("window", [8, 40, 100])
@pytest.mark.parametrize("b", [1, 127, 129])
def test_words_equal_jax_kernel_on_random_rows(n, window, b):
    """Ragged N, W (not multiples of 32) and B (not multiples of 128),
    h1 >= 2**31, bit-31 hits, pad rows with hi = -1."""
    rng = np.random.default_rng(n * 1_000_003 + window * 1009 + b)
    cols, q = synth_case(rng, n, window, b)
    want = jax_words(cols, q, window)
    got = port_words(cols, q, window)
    np.testing.assert_array_equal(got, want)


def test_random_rows_cover_the_parity_traps():
    """The random cases above really reach the traps: h1 with the top
    bit set, hits on bit 31, and the last real row."""
    rng = np.random.default_rng(5)
    cols, q = synth_case(rng, 2000, 100, 129)
    got = port_words(cols, q, 100)
    assert (cols[0] >= 1 << 31).any() and (q[0] >= 1 << 31).any()
    assert ((got >> 31) & 1).any()
    np.testing.assert_array_equal(got, jax_words(cols, q, 100))
    last = 2000 - 4 - 1
    start = int(np.searchsorted(cols[0], cols[0][last]))
    qi = int(np.nonzero((q[0] == cols[0][last]) & (q[1] == cols[1][last])
                        & (q[3] == 1))[0][-1])
    off = last - start
    assert (got[qi, off // 32] >> (off % 32)) & 1


def test_unsigned_order_of_the_search():
    """row_h1 is sorted as uint32: a search on the int32 bit patterns
    would start the window in the wrong place for h1 >= 2**31."""
    h1 = np.array([5, 0x7FFFFFFF, 0x80000000, 0xFFFFFFF0], np.uint32)
    cols = (h1, h1.copy(), np.zeros(4, np.int32), np.full(4, 9, np.int32),
            np.zeros(4, np.int32))
    q = (h1[::-1].copy(), h1[::-1].copy(), np.zeros(4, np.int32),
         np.zeros(4, np.int32))
    got = port_words(cols, q, 8)
    np.testing.assert_array_equal(got, jax_words(cols, q, 8))
    assert got[:, 0].tolist() == [1, 1, 1, 1]


def group_bounds_model(keys: np.ndarray, x: np.ndarray):
    """A plain model of the match kernel's search (csrc/match.cu
    find_group): the lower and the upper bound of each x in the sorted
    uint32 keys, each by a 32-ary descent of search_index(keys) and then
    the keys themselves, the two in step. At each level a step reads the
    32 entries of the current block and counts those below the bound;
    the block one level down starts 32 entries after the last one below.
    -> (start int64[B], end int64[B], steps: the dependent steps of
    every query)."""
    keys = np.asarray(keys, dtype=np.uint32).astype(np.int64)
    x = np.asarray(x, dtype=np.uint32).astype(np.int64)[:, None]
    n = len(keys)
    levels = tm.index_levels(n)
    lane = np.arange(32)[None, :]
    j = {"lower": np.zeros((len(x), 1), np.int64),
         "upper": np.zeros((len(x), 1), np.int64)}
    for level in range(levels, -1, -1):
        entries = keys[:: 32 ** level]
        for side in j:
            at = j[side] + lane
            e = entries[np.minimum(at, len(entries) - 1)] if n else at
            below = (at < len(entries)) & (
                (e < x) if side == "lower" else (e <= x))
            cnt = below.sum(axis=1, keepdims=True)
            j[side] = j[side] + cnt if level == 0 \
                else (j[side] + np.maximum(cnt, 1) - 1) * 32
    return j["lower"][:, 0], j["upper"][:, 0], levels + 1


@pytest.mark.parametrize("n", [1, 32, 33, 1024, 1_752_822])
def test_search_model_equals_searchsorted(n):
    """The kernel's 32-ary search (group_bounds_model, the steps of
    csrc/match.cu find_group over search_index) finds the lower and the
    upper bound that torch.searchsorted and jnp.searchsorted find, over
    keys with bit 31 set, long runs of one key and queries below,
    between, on and past the keys; 1,752,822 rows (the main tier) take
    five steps."""
    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(0, 2**32, size=n, dtype=np.uint64)
                   ).astype(np.uint32)
    keys[n // 3: n // 3 + n // 4] = keys[n // 3]  # duplicates
    if n > 1:
        keys[-n // 2:] |= np.uint32(1 << 31)
        keys.sort()
    x = np.concatenate([
        keys[rng.integers(0, n, size=300)],
        rng.integers(0, 2**32, size=300, dtype=np.uint64).astype(np.uint32),
        keys[rng.integers(0, n, size=100)] + np.uint32(1),
        np.array([0, 2**31 - 1, 2**31, 2**32 - 1], dtype=np.uint32),
    ]).astype(np.uint32)
    start, end, steps = group_bounds_model(keys, x)
    k64 = torch.from_numpy(keys.astype(np.int64))
    x64 = torch.from_numpy(x.astype(np.int64))
    np.testing.assert_array_equal(start, torch.searchsorted(k64, x64).numpy())
    np.testing.assert_array_equal(
        end, torch.searchsorted(k64, x64, side="right").numpy())
    np.testing.assert_array_equal(
        start, np.asarray(jnp.searchsorted(jnp.asarray(keys),
                                           jnp.asarray(x), side="left")))
    np.testing.assert_array_equal(
        end, np.asarray(jnp.searchsorted(jnp.asarray(keys),
                                         jnp.asarray(x), side="right")))
    # one step for each level of the index, and one for the keys
    assert steps == {1: 1, 32: 1, 33: 2, 1024: 2, 1_752_822: 5}[n]
    assert steps == tm.index_levels(n) + 1
    index = tm.search_index(keys)
    assert len(index) == tm.index_size(n) == sum(
        -(-n // 32 ** level) for level in range(1, steps))
    if steps > 1:  # top level first; its last level is every 32nd key
        np.testing.assert_array_equal(index[-(-(-n // 32)):], keys[::32])


def test_words_past_the_group_are_zero():
    """The kernel reads only the words that reach into the query's name
    group (ceil((end - start) / 32), from the search) and stores the rest
    as zeros: in the JAX kernel's words, no bit lies past the group."""
    rng = np.random.default_rng(9)
    for n, window in ((2000, 100), (5000, 512)):
        cols, q = synth_case(rng, n, window, 129)
        want = jax_words(cols, q, window)
        start, end, _steps = group_bounds_model(cols[0], q[0])
        live = np.minimum(want.shape[1], -(-(end - start) // 32))
        past = np.arange(want.shape[1])[None, :] >= live[:, None]
        assert not want[past].any() and want[~past].any()
        assert (live < want.shape[1]).any() and (live == 0).any()


@pytest.mark.parametrize("tier,n_words,b,wq", [
    ("main", 2, 6553, 1),  # the crawl's main tier: W 56
    ("main_w512", 16, 6553, 1),
    ("hot", 30, 34, 8),  # W 960
    ("tall", 125, 993, 4),  # W 4,000
    ("tall_3166", 125, 3166, 1),
    ("tall_full_card", 125, 131_072, 1),
    ("one", 1, 1, 1),
])
def test_match_layout(tier, n_words, b, wq):
    """The grid of one match launch per tier's window and batch: the main
    tier keeps one warp a query; the long windows of the hot and tall
    tiers spread a query's words over several warps while the doubled
    grid still fits the card at once (eight for 34 queries, four for
    993), and not at all when the batch alone fills it; every word of
    every query has one warp."""
    assert tm.match_layout(n_words, b, 132) == wq
    assert tm.MATCH_WARPS % wq == 0
    owners = [k % wq for k in range(n_words)]  # word k -> warp k mod wq
    assert sorted(set(owners)) == list(range(min(wq, n_words)))
    if wq > 1:  # the doubled grid would not have fitted the card at once
        assert wq == tm.MATCH_WARPS or n_words <= 4 * wq \
            or 2 * wq * b > 132 * tm.MATCH_RESIDENT_WARPS


def test_wrapper_on_cpu_runs_the_plain_version():
    """A CPU tensor takes match_words_ref, and counts no launch."""
    rng = np.random.default_rng(11)
    cols, q = synth_case(rng, 300, 40, 129)
    before = tm.match_words.launches
    got = port_words(cols, q, 40, fn=tm.match_words)
    np.testing.assert_array_equal(got, port_words(cols, q, 40))
    assert tm.match_words.launches == before


def test_empty_db_and_empty_batch():
    """n_rows == 0 never reaches a kernel: match_dispatch has no work,
    the wrapper returns zero words of the right shape."""
    from trivy_tpu_torch.tensorize.compile import PackageBatch

    empty = np.empty(0, np.uint32)
    ddb = tm.DeviceDB.from_arrays(empty, empty, np.empty(0, np.int32),
                                  np.empty(0, np.int32),
                                  np.empty(0, np.int32), window=40,
                                  device=CPU)
    q = [torch.zeros(3, dtype=torch.int32) for _ in range(4)]
    words = tm.match_words(ddb, *q)
    assert words.shape == (3, 2) and not words.any()
    batch = PackageBatch(h1=np.zeros(3, np.uint32), h2=np.zeros(3, np.uint32),
                         rank=np.zeros(3, np.int32),
                         flags=np.zeros(3, np.int32), queries=[None] * 3)
    assert tm.match_dispatch(ddb, batch) is None
    assert tm.match_batch(ddb, batch).shape == (3, 64)
    cols, _ = synth_case(np.random.default_rng(1), 10, 8, 1)
    ddb = tm.DeviceDB.from_arrays(*cols, window=8, device=CPU)
    none = [torch.zeros(0, dtype=torch.int32) for _ in range(4)]
    assert tm.match_words(ddb, *none).shape == (0, 1)


@pytest.mark.parametrize("window", [32, 4])
def test_match_batch_equals_jax_match_batch(jdb, queries, window):
    """Dispatch + pinned copy-back + unsort: the port's bool masks in
    original query order equal the JAX package's, tier by tier, from
    DeviceDB.from_compiled of each package's own compile."""
    from trivy_tpu.tensorize.compile import PackageBatch as JBatch

    jcdb = jax_compile_db(jdb, window=window)
    cdb = compile_db(port_db(jdb), window=window)
    jbatch = jcdb.encode_packages(queries)
    batch = cdb.encode_packages(queries)
    for make in ("from_compiled", "hot_from_compiled", "tall_from_compiled"):
        jd = getattr(jm.DeviceDB, make)(jcdb)
        td = getattr(tm.DeviceDB, make)(cdb, CPU)
        assert (jd is None) == (td is None)
        if jd is None:
            continue
        if make == "from_compiled":
            want = jm.match_batch(jd, jbatch)
            got = tm.match_batch(td, batch)
        else:
            sel = np.nonzero(batch.route == (1 if make[0] == "h" else 2))[0]
            sub = dict(h1=batch.h1[sel], h2=batch.h2[sel],
                       rank=batch.rank[sel], flags=batch.flags[sel],
                       queries=[queries[j] for j in sel])
            want = jm.match_batch(jd, JBatch(**sub))
            got = tm.match_batch(td, type(batch)(**sub))
        np.testing.assert_array_equal(got, want)
        assert td.bucket_floor == tm._bucket(len(got))


@pytest.mark.parametrize("window", [None, 32, 40, 4])
def test_compiled_db_equals_jax_compile(jdb, queries, window):
    """Row columns, boundaries, tier split, windows and advisory order
    of the port's compile_db equal the JAX package's, and so does the
    query encoding."""
    jcdb = jax_compile_db(jdb, window=window)
    cdb = compile_db(port_db(jdb), window=window)
    assert_same_compile(jcdb, cdb)
    jb, tb = jcdb.encode_packages(queries), cdb.encode_packages(queries)
    for c in ("h1", "h2", "rank", "flags", "route"):
        np.testing.assert_array_equal(getattr(tb, c), getattr(jb, c))


def assert_same_compile(jcdb, cdb):
    for tier in TIERS:
        for c in ("h1", "h2", "lo", "hi", "flags", "adv"):
            a, b = getattr(jcdb, f"{tier}_{c}"), getattr(cdb, f"{tier}_{c}")
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(b, a)
    assert (cdb.window, cdb.hot_window, cdb.tall_window) == \
        (jcdb.window, jcdb.hot_window, jcdb.tall_window)
    assert cdb.boundaries.keys() == jcdb.boundaries.keys()
    for s, keys in jcdb.boundaries.items():
        np.testing.assert_array_equal(cdb.boundaries[s], keys)
    assert cdb.host_fallback == jcdb.host_fallback
    assert cdb.tall_names == jcdb.tall_names
    assert cdb.stats == jcdb.stats
    assert [(b, n, a.vulnerability_id) for b, n, a in cdb.advisories] == \
        [(b, n, a.vulnerability_id) for b, n, a in jcdb.advisories]


def test_synth_db_compiles_like_jax():
    """The same synthetic trivy-db shape from one seed, built and compiled
    by each package, gives identical tensors (hot and tall tiers
    included)."""
    from trivy_tpu.tensorize.synth import synth_trivy_db as jax_synth
    from trivy_tpu_torch.tensorize.synth import synth_trivy_db

    jcdb = jax_compile_db(jax_synth(n_advisories=30_000, seed=3))
    cdb = compile_db(synth_trivy_db(n_advisories=30_000, seed=3))
    assert cdb.hot_h1 is not None and cdb.tall_h1 is not None
    assert_same_compile(jcdb, cdb)


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_version():
    """On a card: the CUDA kernel against its plain version, bit for
    bit, on ragged shapes (the same check chip_smoke.py runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2)
    # the last two spread a query's words over eight warps
    for n, window, b in [(1, 8, 1), (1000, 40, 129), (5000, 512, 4501),
                         (20000, 960, 34), (20000, 4000, 993)]:
        cols, q = synth_case(rng, n, window, b)
        ddb = tm.DeviceDB.from_arrays(*cols, window=window, device=dev)
        qt = [torch.from_numpy(a.view(np.int32)).to(dev) for a in q]
        got = tm.match_words(ddb, *qt)
        torch.cuda.synchronize()
        assert torch.equal(got, tm.match_words_ref(ddb, *qt))
        np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                      jax_words(cols, q, window))
    with pytest.raises(ValueError, match="int32"):
        tm.match_words(ddb, qt[0].long(), *qt[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("wq", [1, 2, 4, 8])
def test_cuda_kernel_equals_plain_version_on_every_layout(monkeypatch, wq):
    """On a card: the kernel with a query's words on 1, 2, 4 or 8 warps,
    against its plain version, on a window longer than its groups."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    monkeypatch.setattr(tm, "match_layout", lambda nw, b, n_sm: wq)
    cols, q = synth_case(np.random.default_rng(wq), 8000, 700, 1001)
    ddb = tm.DeviceDB.from_arrays(*cols, window=700, device=dev)
    qt = [torch.from_numpy(a.view(np.int32)).to(dev) for a in q]
    got = tm.match_words(ddb, *qt)
    torch.cuda.synchronize()
    assert torch.equal(got, tm.match_words_ref(ddb, *qt))
