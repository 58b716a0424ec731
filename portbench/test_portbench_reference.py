"""The plain references agree with the port's CPU path at a tiny size,
and their controls (the references with the tempting shortcut) do not."""

from __future__ import annotations

import pytest

from portbench.conftest import tiny
from portbench.gen import advisories, corpus
from portbench.reference.crawl import CrawlReference
from portbench.reference.secret import SecretReference


@pytest.fixture(scope="module")
def crawl_case(tmp_path_factory):
    from trivy_tpu_torch.db.store import AdvisoryDB
    from trivy_tpu_torch.detector.engine import MatchEngine, PkgQuery

    from portbench.systems.crawl import Calls

    cfg, tr = tiny("crawl.fresh")
    root = str(tmp_path_factory.mktemp("db"))
    buckets = advisories.make_db(cfg, 4242)
    advisories.write_db(buckets, root)
    engine = MatchEngine(AdvisoryDB.load(root), device="cpu", db_path=root)
    calls = Calls(cfg, tr, buckets, 4242)
    window = [calls.next_call()[0] for _ in range(2)]
    keys = [k for c in calls.warm + window for img in c for k in img]
    res = engine.detect_many([PkgQuery(*k) for k in keys],
                             batch_size=tr["batch_size"])
    advs = engine.cdb.advisories
    got = [sorted((advs[i][0], advs[i][1], advs[i][2].vulnerability_id)
                  for i in r.adv_indices) for r in res]
    return buckets, keys, got


def test_crawl_reference_agrees_with_the_port(crawl_case):
    buckets, keys, got = crawl_case
    ref = CrawlReference(buckets)
    want = [ref.answer(k) for k in keys]
    assert sum(map(len, want)) > 0
    assert want == got


def test_crawl_control_disagrees(crawl_case):
    buckets, keys, got = crawl_case
    lossy = CrawlReference(buckets, lossy=True)
    assert sum(lossy.answer(k) != g for k, g in zip(keys, got)) > 0


def _scan_both(workload: str, seed: int):
    from trivy_tpu_torch.secret.scanner import SecretScanner

    from portbench.systems.secret import finding_rows, path_of

    cfg, tr = tiny(workload)
    pool = corpus.make_pool(tr, cfg["shape_seed"], seed)
    batch = [(path_of(0, j, f.ext), f.body) for j, f in enumerate(pool)]
    scanner = SecretScanner(device="cpu")
    try:
        res = {s.file_path: finding_rows(s)
               for s in scanner.scan_files(batch, use_device=True)}
    finally:
        scanner.close()
    return pool, batch, [res.get(p, []) for p, _c in batch]


# the stream path's mix, `large`, is kept for a later cell
@pytest.mark.parametrize("workload", ["secret.source", "ci-secrets/large"])
def test_secret_reference_agrees_with_the_port(workload):
    pool, batch, got = _scan_both(workload, 99)
    ref = SecretReference()
    want = [ref.scan(p, c) for p, c in batch]
    assert sum(map(len, want)) >= sum(len(f.kinds) for f in pool) > 0
    assert want == got
    lossy = SecretReference(lossy=True)
    assert sum(lossy.scan(p, c) != g
               for (p, c), g in zip(batch, got)) > 0
