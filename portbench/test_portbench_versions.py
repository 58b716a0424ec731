"""The reference's version order against an oracle outside this repo,
where one is at hand: `dpkg --compare-versions` for Debian versions and
the `packaging` library for PEP 440. The reference's comparators are
frozen copies of the program's, so a fault the two share would pass the
benchmark's comparison; these oracles are independent of both."""

from __future__ import annotations

import itertools
import random
import shutil
import subprocess

import pytest

from portbench.reference.versions import SCHEMES

DEB_EDGES = ["1.0", "1.0-1", "1.0-2", "1.0~rc1", "1.0~rc1-1", "1:0.9",
             "1.0+b1", "1.0.1", "1.00", "1.0a", "1.0-1+deb11u1",
             "1.0-1+deb12u1", "1.0-0ubuntu0.20.04.1", "2.0~~", "2.0~",
             "0:1.0-1", "1.0-1.1"]
PEP440_EDGES = ["1.0", "1.0.0", "1.0a1", "1.0b2", "1.0rc1", "1.0.post1",
                "1.0.dev1", "1!0.5", "1.0a1.dev2", "1.0.post1.dev1", "0.9.9",
                "1.0.0.0.1", "2.0"]


def _generated(space_prefix: str, seed: int) -> list[str]:
    """Versions the benchmark's generators write for one kind of
    bucket: installed versions and advisories' fixed versions."""
    from portbench.conftest import tiny
    from portbench.gen import advisories
    from portbench.systems.crawl import Calls

    cfg, tr = tiny("crawl.fresh")
    db = advisories.make_db(cfg, seed)
    out = [a["FixedVersion"] for b, names in db.items()
           if b.startswith(space_prefix) for advs in names.values()
           for a in advs if a.get("FixedVersion")][:60]
    calls = Calls(cfg, tr, db, seed)
    out += [k[2] for c, _i, _p in (calls.next_call() for _ in range(4))
            for img in c for k in img if k[0].startswith(space_prefix)][:60]
    return out


def _pairs(versions: list[str], n: int, seed: int) -> list[tuple]:
    pairs = list(itertools.combinations(sorted(set(versions)), 2))
    random.Random(seed).shuffle(pairs)
    return pairs[:n]


def _sign(x: int) -> int:
    return (x > 0) - (x < 0)


def test_deb_order_equals_dpkg():
    dpkg = shutil.which("dpkg")
    if dpkg is None:
        pytest.skip("needs dpkg, the oracle of Debian version order")
    deb = SCHEMES["deb"]
    versions = DEB_EDGES + _generated("debian", 31) + _generated("ubuntu", 32)
    for a, b in _pairs(versions, 300, 5):
        want = 0
        for op, sign in (("lt", -1), ("gt", 1)):
            if subprocess.run([dpkg, "--compare-versions", a, op, b],
                              check=False).returncode == 0:
                want = sign
        assert _sign(deb.compare(a, b)) == want, (a, b)


def test_pep440_order_equals_packaging():
    from packaging.version import Version

    pep = SCHEMES["pep440"]
    versions = PEP440_EDGES + [f"{a}.{b}.{c}" for a, b, c in itertools.product(
        (0, 1, 10), (0, 2, 20), (0, 3))]
    for a, b in _pairs(versions, 400, 6):
        want = _sign((Version(a) > Version(b)) - (Version(a) < Version(b)))
        assert _sign(pep.compare(a, b)) == want, (a, b)
