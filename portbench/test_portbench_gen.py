"""The generators are deterministic per seed, and keep the work the same
from seed to seed."""

from __future__ import annotations

import pytest

from portbench.conftest import tiny
from portbench.gen import advisories, corpus, images


def _db(seed):
    cfg, _tr = tiny("crawl.fresh")
    return cfg, advisories.make_db(cfg, seed)


def test_db_is_deterministic_and_keeps_its_shape():
    cfg, a = _db(11)
    _, b = _db(11)
    _, c = _db(3_000_000_019)
    assert a == b
    assert a != c
    shape = {bk: {n: len(v) for n, v in names.items()}
             for bk, names in a.items()}
    assert shape == {bk: {n: len(v) for n, v in names.items()}
                     for bk, names in c.items()}
    assert sum(map(len, shape.values())) > 0
    assert 0.99 * cfg["advisories"] <= sum(
        sum(v.values()) for v in shape.values()) <= cfg["advisories"]


def test_db_round_trips(tmp_path):
    _cfg, a = _db(5)
    advisories.write_db(a, str(tmp_path))
    assert advisories.read_db(str(tmp_path)) == a


def _calls(workload: str, seed: int, n: int = 6):
    """-> (warm-up calls, the first `n` window calls with their kept
    positions) of a tiny `workload` on a DB of seed 7."""
    from portbench.systems.crawl import Calls

    cfg, tr = tiny(workload)
    _, db = _db(7)
    calls = Calls(cfg, tr, db, seed)
    return calls.warm, [calls.next_call() for _ in range(n)]


@pytest.mark.parametrize("workload", ["crawl.fresh", "trivydb-2m/registry"])
def test_calls_are_deterministic(workload):
    one = _calls(workload, 7, n=16)
    two = _calls(workload, 7, n=16)
    assert one[0] == two[0]
    assert [(c, p) for c, _i, p in one[1]] == [(c, p) for c, _i, p in two[1]]
    other = _calls(workload, 8, n=16)
    assert [c for c, _i, _p in other[1]] != [c for c, _i, _p in one[1]]
    if workload == "crawl.fresh":  # the same sizes, block by block
        per_block = 8
        for k in range(0, 16, per_block):
            assert sorted(len(img) for c, _i, _p in one[1][k:k + per_block]
                          for img in c) == \
                sorted(len(img) for c, _i, _p in other[1][k:k + per_block]
                       for img in c)


def test_fresh_calls_never_run_out():
    _warm, calls = _calls("crawl.fresh", 5, n=40)
    assert len(calls) == 40 and all(c for c, _i, _p in calls)


def test_fresh_keys_never_repeat():
    warm, calls = _calls("crawl.fresh", 9, n=10)
    keys = [k for c in warm + [c for c, _i, _p in calls]
            for img in c for k in img]
    assert len(keys) == len(set(keys))


def test_registry_keys_recur():
    warm, calls = _calls("trivydb-2m/registry", 9, n=20)
    keys = [k for c, _i, _p in calls for img in c for k in img]
    assert len(set(keys)) < len(keys)
    warm_keys = {k for c in warm for img in c for k in img}
    assert not warm_keys & set(keys)


def test_kept_positions_lie_in_their_call():
    _warm, calls = _calls("trivydb-2m/registry", 3, n=10)
    for c, idx, picks in calls:
        n = sum(map(len, c))
        assert picks and all(0 <= p < n for p in picks)
        assert len(idx) == len(c)


# the stream path's mix, `large`, is kept for a later cell
@pytest.mark.parametrize("workload", ["secret.source", "ci-secrets/large"])
def test_pool_is_deterministic(workload):
    cfg, tr = tiny(workload)
    a = corpus.make_pool(tr, cfg["shape_seed"], 21)
    b = corpus.make_pool(tr, cfg["shape_seed"], 21)
    c = corpus.make_pool(tr, cfg["shape_seed"], 22)
    assert [(f.ext, f.body, f.kinds) for f in a] == \
        [(f.ext, f.body, f.kinds) for f in b]
    assert [f.body for f in a] != [f.body for f in c]
    assert sorted(map(len, (f.body for f in a))) == \
        sorted(map(len, (f.body for f in c)))
    assert any(f.kinds for f in a)


def test_image_sizes_follow_the_shape():
    _cfg, tr = tiny("crawl.fresh")
    sizes = images.image_sizes(tr, 4000, 1)
    assert sizes[:100] == images.image_sizes(tr, 100, 1)
    assert min(sizes) >= tr["size_min"] and max(sizes) <= tr["size_max"]
    assert 400 <= sorted(sizes)[len(sizes) // 2] <= 600
