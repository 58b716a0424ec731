"""Port parity, the slice as a whole: trivy_tpu_torch's MatchEngine
(device="cpu", so the match kernel's plain version answers) against the
JAX package's device engine and the host oracle, through every entry
point the scanner and the scheduler call: detect, detect_many, submit
and match_keys. Plus the port's import isolation and device policy.

Match sets are lists of advisory indices, so the tolerance is exact
equality.
"""

import ast
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from test_match import _random_db, _random_queries
from test_torch_match import port_db

from trivy_tpu.detector.engine import MatchEngine as JaxEngine
from trivy_tpu.detector.engine import PkgQuery as JaxQuery
from trivy_tpu.tensorize.synth import synth_trivy_db as jax_synth
from trivy_tpu_torch.db import Advisory, AdvisoryDB
from trivy_tpu_torch.detector.engine import (
    MatchEngine,
    PkgQuery,
    finding_keys,
    queries_from_columns,
)
from trivy_tpu_torch.device import resolve_device
from trivy_tpu_torch.tensorize.synth import synth_queries, synth_trivy_db

ROOT = Path(__file__).resolve().parents[1]
SEED = 20261016


def crawl(db, n_queries: int, seed: int = 13) -> list[PkgQuery]:
    """Registry-crawl shape (chip_smoke.py build_queries): a base-image
    core repeated in every image plus a per-image tail."""
    rng = random.Random(11)
    uniq = synth_queries(db, max(n_queries // 8, 1), seed=seed)
    out: list[PkgQuery] = []
    while len(out) < n_queries:
        out.extend(uniq[:100])
        out.extend(uniq[rng.randrange(len(uniq))] for _ in range(20))
    return out[:n_queries]


def hits(results) -> list[list[int]]:
    return [r.adv_indices for r in results]


@pytest.fixture(scope="module")
def synth():
    """One seed, ~30k synthetic advisories built by each package, a
    crawl of 12k queries (1.5k unique) and both engines."""
    db = synth_trivy_db(n_advisories=30_000, seed=SEED)
    jdb = jax_synth(n_advisories=30_000, seed=SEED)
    qs = crawl(db, 12_000)
    return {
        "engine": MatchEngine(db, device="cpu"),
        "jax": JaxEngine(jdb),
        "queries": qs,
        "jax_queries": [JaxQuery(*q.key) for q in qs],
    }


@pytest.fixture(scope="module")
def synth_oracle(synth):
    """The host oracle's answer per query (computed once per unique
    query: the crawl repeats each about eight times)."""
    engine = synth["engine"]
    uniq, idx_map = engine.dedupe_queries(synth["queries"])
    u = hits(engine.oracle_detect(uniq))
    return [u[i] for i in idx_map]


def test_synth_tiers_all_present(synth):
    """The slice's DB exercises all three device tiers."""
    e = synth["engine"]
    assert e._ddb is not None and e._ddb_hot is not None \
        and e._ddb_tall is not None
    routes = e.cdb.encode_packages([q.key for q in synth["queries"]]).route
    assert {0, 1, 2} <= set(routes.tolist())


def test_synth_detect_equals_jax_and_oracle(synth, synth_oracle):
    got = hits(synth["engine"].detect(synth["queries"]))
    assert got == synth_oracle
    assert got == hits(synth["jax"].detect(synth["jax_queries"]))
    assert sum(map(len, got)) > 10_000


@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_synth_detect_many_equals_jax_and_oracle(synth, synth_oracle,
                                                 pipeline, monkeypatch):
    """Pipelined (crunch lanes on worker threads) and serial crawls."""
    monkeypatch.setenv("TRIVY_TPU_PIPELINE", pipeline)
    db = synth_trivy_db(n_advisories=30_000, seed=SEED)
    engine = MatchEngine(db, device="cpu")  # cold crawl cache
    got = hits(engine.detect_many(synth["queries"], batch_size=8192))
    assert got == synth_oracle
    assert (engine.last_pipeline_stats is not None) == (pipeline == "1")
    assert got == hits(synth["jax"].detect_many(synth["jax_queries"],
                                                batch_size=8192))


def test_synth_submit_equals_jax(synth, synth_oracle):
    qs = synth["queries"]
    lists = [qs[:5000], qs[5000:5001], [], qs[5001:]]
    got = synth["engine"].submit(lists)
    assert [len(r) for r in got] == [len(x) for x in lists]
    assert [h for rl in got for h in hits(rl)] == synth_oracle
    jq = synth["jax_queries"]
    want = synth["jax"].submit([jq[:5000], jq[5000:5001], [], jq[5001:]])
    assert [hits(r) for r in got] == [hits(r) for r in want]


def test_synth_match_keys_equals_jax(synth):
    qs, jq = synth["queries"], synth["jax_queries"]
    got = synth["engine"].match_keys([qs[:3000], qs[3000:6000]])
    assert got == synth["jax"].match_keys([jq[:3000], jq[3000:6000]])
    assert all(got)


@pytest.fixture(scope="module")
def fixture_dbs():
    jdb = _random_db(random.Random(42))
    return jdb, port_db(jdb)


@pytest.mark.parametrize("window", [32, 4, 40])
def test_fixture_db_equals_jax_and_oracle(fixture_dbs, window):
    """The test_match.py DB and query loads, including a window small
    enough to push names into the hot tier."""
    jdb, db = fixture_dbs
    engine = MatchEngine(db, window=window, device="cpu")
    jengine = JaxEngine(jdb, window=window)
    qs = _random_queries(random.Random(21), n=1200)
    jqs = [JaxQuery(*q.key) for q in qs]
    pqs = [PkgQuery(*q.key) for q in qs]
    oracle = hits(engine.oracle_detect(pqs))
    assert hits(engine.detect(pqs)) == oracle
    assert hits(engine.detect_many(pqs, batch_size=256, depth=2)) == oracle
    assert hits(jengine.detect(jqs)) == oracle
    assert oracle == hits(jengine.oracle_detect(jqs))


def test_host_oracle_path_needs_no_card(fixture_dbs, monkeypatch):
    """use_device=False is the caller's explicit host path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _jdb, db = fixture_dbs
    engine = MatchEngine(db, window=32, use_device=False)
    assert engine.device is None and engine.device_db is None
    qs = [PkgQuery(*q.key) for q in _random_queries(random.Random(3), 300)]
    qs = qs + qs[:50]
    ref = MatchEngine(db, window=32, device="cpu")
    assert hits(engine.detect(qs)) == hits(ref.detect(qs))
    assert hits(engine.detect_many(qs, batch_size=64)) == hits(ref.detect(qs))


def test_empty_db_and_empty_queries():
    engine = MatchEngine(AdvisoryDB(), window=8, device="cpu")
    assert engine.detect([]) == []
    res = engine.detect([PkgQuery("npm::", "left-pad", "1.0.0", "npm")])
    assert res[0].adv_indices == []
    assert engine.submit([[], []]) == [[], []]


def test_npm_prerelease_inexact_key_in_subtracted_hull():
    """An npm pre-release version with an inexact key (NEEDS_HOST, no
    RESCREEN) still reaches the PRE_ONLY hull rows."""
    db = AdvisoryDB()
    db.put_advisory("npm::ghsa", "lodash", Advisory(
        vulnerability_id="CVE-X",
        vulnerable_versions=[">=1.5.0-alpha.1 <2.0.0"],
        patched_versions=[">=1.4.0"],
    ))
    engine = MatchEngine(db, window=32, device="cpu")
    q = PkgQuery("npm::", "lodash", "1.5.0-alpha." + "x" * 60, "npm")
    assert engine.detect([q])[0].adv_indices == \
        engine.oracle_detect([q])[0].adv_indices


def test_crawl_cache_bound_survives(fixture_dbs):
    """Tripping the crawl-cache bound between crawls keeps repeat-query
    lookups right."""
    _jdb, db = fixture_dbs
    engine = MatchEngine(db, window=32, device="cpu")
    engine.crawl_cache_max = 8
    qs = [PkgQuery(*q.key) for q in _random_queries(random.Random(5), 600)]
    qs = qs + qs[:200]
    got = engine.detect_many(qs, batch_size=64, depth=3)
    assert hits(got) == hits(engine.oracle_detect(qs))
    assert len(engine._crawl_cache) <= 8 or not engine._crawl_cache


def test_queries_from_columns_and_finding_keys(synth):
    qs = synth["queries"][:500]
    cols = [list(c) for c in zip(*(q.key for q in qs))]
    built = queries_from_columns(*cols)
    assert built == qs and [q.key for q in built] == [q.key for q in qs]
    e = synth["engine"]
    res = e.detect(built)
    keys = finding_keys(e.cdb.advisories, res)
    assert keys and all(k[:4] in {q.key for q in qs} for k in keys)


# ------------------------------------------------------ device policy


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        MatchEngine(AdvisoryDB(), window=8)


def test_resolve_device_defaults_to_the_first_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda", 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    with pytest.raises(ValueError):
        resolve_device("meta")


# ------------------------------------------------------ import isolation


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") \
        or name == "trivy_tpu" or name.startswith("trivy_tpu.")


def test_port_imports_no_jax_in_a_fresh_process():
    """Importing the port and running a CPU detect loads no jax module
    and nothing of the JAX package."""
    code = """
import sys
before = set(sys.modules)
from trivy_tpu_torch.detector.engine import MatchEngine, PkgQuery
from trivy_tpu_torch.ops import kernels, match
from trivy_tpu_torch.tensorize.synth import synth_queries, synth_trivy_db
db = synth_trivy_db(n_advisories=3000, seed=1)
engine = MatchEngine(db, device="cpu")
qs = synth_queries(db, 200, seed=2)
assert engine.detect(qs) and engine.detect_many(qs, batch_size=64)
print("\\n".join(sorted(set(sys.modules) - before)))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "trivy_tpu_torch.ops.match" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "trivy_tpu_torch").rglob("*.py"),
              ROOT / "chip_smoke.py"]))
def test_port_sources_import_no_jax(path):
    """Static scan: no import statement in the port names jax or the
    JAX package."""
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert [n for n in names if _forbidden(n)] == []
