"""Port parity, the native match-result collector: trivy_tpu_torch's copy
of native/collect.cpp (decode_mask, sort_dedupe, group_confirmed)
against the numpy path it replaces in MatchEngine._crunch, on seeded
inputs, and the engine's answers with the collector on, with it forced
off, and from the JAX package's engine.

Every output is integer or boolean, so the tolerance is exact equality.
"""

import random

import numpy as np
import pytest
import torch
from test_match import _random_db, _random_queries
from test_torch_match import port_db

from trivy_tpu.detector.engine import MatchEngine as JaxEngine
from trivy_tpu.detector.engine import PkgQuery as JaxQuery
from trivy_tpu.native import collect as jax_collect
from trivy_tpu_torch.detector.engine import MatchEngine, PkgQuery
from trivy_tpu_torch.native import collect as ncollect

SEED = 20261017



@pytest.fixture()
def native():
    """The native library, built at first use (skips without g++)."""
    if not ncollect.available():
        pytest.skip("g++ toolchain unavailable")
    return ncollect


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and idle OpenMP workers spin on cores their neighbours' timing
    tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hits(results) -> list[list[int]]:
    return [r.adv_indices for r in results]


def numpy_decode(words, start, n_rows, row_adv, row_flags, adv_tok,
                 q_tok, q_flags, flag_mask):
    """The engine's numpy decode (_crunch decode_numpy) over packed
    words, bits in little-endian order within each word."""
    bits = np.unpackbits(words.view(np.uint8), axis=1,
                         bitorder="little").astype(bool)
    rows0, offs0 = np.nonzero(bits)
    ridx = start[rows0] + offs0
    inb = ridx < n_rows
    rows0, ridx = rows0[inb], ridx[inb]
    ids0 = row_adv[ridx].astype(np.int64)
    resc0 = ((row_flags[ridx] | q_flags[rows0]) & flag_mask) != 0
    valid = adv_tok[ids0] == q_tok[rows0]
    return rows0[valid], ids0[valid], resc0[valid]


def decode_case(seed: int, b: int, w32: int, n_rows: int, n_adv: int):
    """Seeded decode inputs: sparse hit words whose windows run past the
    table's end, token collisions and unknown-name queries."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(b, w32), dtype=np.uint64)
    words &= rng.integers(0, 1 << 32, size=(b, w32), dtype=np.uint64)
    words = words.astype(np.uint32)
    start = rng.integers(0, n_rows, size=b).astype(np.int64)
    row_adv = rng.integers(0, n_adv, size=n_rows).astype(np.int32)
    row_flags = rng.integers(0, 8, size=n_rows).astype(np.int32)
    adv_tok = rng.integers(-1, 6, size=n_adv).astype(np.int64)
    q_tok = rng.integers(-2, 6, size=b).astype(np.int64)
    q_flags = rng.integers(0, 8, size=b).astype(np.int32)
    return (words, start, n_rows, row_adv, row_flags, adv_tok, q_tok,
            q_flags)


@pytest.mark.parametrize("b,w32,n_rows,n_adv", [
    (1, 1, 1, 1), (7, 2, 40, 9), (200, 3, 500, 120), (64, 30, 2000, 700)])
@pytest.mark.parametrize("flag_mask", [0, 3, 6])
def test_decode_mask_equals_numpy(native, b, w32, n_rows, n_adv,
                                  flag_mask):
    case = decode_case(SEED + b + w32, b, w32, n_rows, n_adv)
    got = native.decode_mask(*case, flag_mask)
    want = numpy_decode(*case, flag_mask)
    assert got is not None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    jax_got = jax_collect.decode_mask(*case, flag_mask)
    for g, w in zip(got, jax_got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [1, 50, 4096, 20_000])
def test_sort_dedupe_equals_lexsort(native, n):
    """The packed-key sort (std::sort below 4,097 keys, radix above)
    equals the engine's lexsort fallback, keeping the exact twin of
    every (row, id) pair."""
    rng = np.random.default_rng(SEED + n)
    rows = rng.integers(0, max(n // 7, 1), size=n).astype(np.int64)
    ids = rng.integers(0, max(n // 3, 1), size=n).astype(np.int64)
    resc = rng.random(n) < 0.5
    order = np.lexsort((resc, ids, rows))
    r0, i0, s0 = rows[order], ids[order], resc[order]
    keep = np.ones(n, dtype=bool)
    keep[1:] = (r0[1:] != r0[:-1]) | (i0[1:] != i0[:-1])
    got = native.sort_dedupe(rows.copy(), ids.copy(), resc.copy())
    for g, w in zip(got, (r0[keep], i0[keep], s0[keep])):
        np.testing.assert_array_equal(g, w)


def test_sort_dedupe_and_group_contract(native):
    """Port of test_match.py::test_native_sort_dedupe_and_group: keep-
    first on (row, id) ties prefers the exact (resc=0) twin; grouping
    brackets every query; values past the packed ranges fall back."""
    rows = np.array([3, 1, 1, 3, 0, 1], dtype=np.int64)
    ids = np.array([7, 5, 5, 7, 2, 4], dtype=np.int64)
    resc = np.array([1, 1, 0, 0, 0, 1], dtype=bool)
    r, i, s = native.sort_dedupe(rows, ids, resc)
    assert r.tolist() == [0, 1, 1, 3]
    assert i.tolist() == [2, 4, 5, 7]
    assert s.tolist() == [False, True, False, False]

    out_ids, bounds = native.group_confirmed(r, i, ~s, 5)
    assert out_ids.tolist() == [2, 5, 7]
    assert bounds.tolist() == [0, 1, 2, 2, 3, 3]

    big = np.array([1 << 22], dtype=np.int64)
    one = np.array([1], dtype=np.int64)
    t = np.array([0], dtype=bool)
    assert native.sort_dedupe(big, one, t) is None
    assert native.sort_dedupe(one, np.array([1 << 43], dtype=np.int64),
                                t) is None
    assert native.sort_dedupe(np.array([-1], dtype=np.int64), one,
                                t) is None
    empty = np.empty(0, dtype=np.int64)
    assert native.sort_dedupe(empty, empty, np.empty(0, bool)) is None


@pytest.mark.parametrize("n_queries", [1, 9, 300])
def test_group_confirmed_equals_searchsorted(native, n_queries):
    rng = np.random.default_rng(SEED + n_queries)
    m = n_queries * 4
    rows = np.sort(rng.integers(0, n_queries, size=m)).astype(np.int64)
    ids = rng.integers(0, 1000, size=m).astype(np.int64)
    conf = rng.random(m) < 0.6
    out_ids, bounds = native.group_confirmed(rows, ids, conf, n_queries)
    rows_c, ids_c = rows[conf], ids[conf]
    np.testing.assert_array_equal(out_ids, ids_c)
    np.testing.assert_array_equal(
        bounds, np.searchsorted(rows_c, np.arange(n_queries + 1)))


@pytest.fixture(scope="module")
def dbs():
    jdb = _random_db(random.Random(42))
    return jdb, port_db(jdb)


@pytest.mark.parametrize("window", [32, 4])
def test_engine_native_on_off_and_jax(dbs, window, monkeypatch):
    """The port's engine gives the same matches with the native
    collector, with it forced off (numpy), and as the JAX engine, on
    detect and the pipelined detect_many; it records which collector
    ran."""
    jdb, db = dbs
    qs = [PkgQuery(*q.key)
          for q in _random_queries(random.Random(31), n=3000)]
    jqs = [JaxQuery(*q.key) for q in qs]
    want = hits(JaxEngine(jdb, window=window).detect(jqs))

    engine = MatchEngine(db, window=window, device="cpu")
    on = hits(engine.detect(qs))
    on_many = hits(engine.detect_many(qs, batch_size=256, depth=2))
    collector_on = engine.collector
    stats_on = engine.last_pipeline_stats
    monkeypatch.setattr(ncollect, "available", lambda: False)
    engine2 = MatchEngine(db, window=window, device="cpu")
    off = hits(engine2.detect(qs))
    off_many = hits(engine2.detect_many(qs, batch_size=256, depth=2))
    assert engine2.collector == "numpy"
    assert engine2.last_pipeline_stats["collector"] == "numpy"
    assert on == off == on_many == off_many == want
    if jax_collect.available():
        assert collector_on == "native"
        assert stats_on["collector"] == "native"
