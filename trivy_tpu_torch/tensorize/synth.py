"""Synthetic advisory DBs shaped like real trivy-db, for scale testing
and benchmarking (VERDICT r1 item 2; ref workload shape
reference pkg/detector/ospkg/detect.go:66).

Real trivy-db characteristics reproduced here:
- millions of advisories, dominated by OS buckets (debian/ubuntu/
  redhat/alpine releases), each advisory a simple fixed-version row;
  language ecosystems are the minority but carry range expressions
- *name skew*: advisory counts per package follow a Zipf-like law —
  a few hot names ("linux", "firefox", "chromium", "mysql", ...) carry
  thousands of advisories each (debian's "linux" alone has several
  thousand), while the long tail has one or two
- version strings repeat heavily across advisories of one package
"""

from __future__ import annotations

import random

from trivy_tpu_torch.db.model import Advisory
from trivy_tpu_torch.db.store import AdvisoryDB

# hot OS package names, roughly by real advisory volume
HOT_NAMES = [
    "linux", "firefox-esr", "chromium", "mysql-5.7", "imagemagick",
    "openjdk-8", "php7.0", "wireshark", "tcpdump", "qemu", "xen",
    "mariadb-10.1", "ruby2.3", "openssl", "ffmpeg", "binutils",
    "thunderbird", "libreoffice", "ghostscript", "graphicsmagick",
]

OS_BUCKETS = [
    ("debian 11", "deb", "+deb11u"),
    ("debian 12", "deb", "+deb12u"),
    ("ubuntu 20.04", "deb", "-0ubuntu0.20.04."),
    ("ubuntu 22.04", "deb", "-0ubuntu0.22.04."),
    ("alpine 3.18", "apk", "-r"),
    ("alpine 3.19", "apk", "-r"),
    ("rocky 9", "rpm", ".el9"),
    ("redhat 8", "rpm", ".el8"),
]

LANG_ECOS = [
    ("npm", "npm"), ("pip", "pep440"), ("maven", "maven"),
    ("go", "generic"), ("rubygems", "rubygems"), ("cargo", "generic"),
    ("composer", "generic"), ("nuget", "generic"),
]


def _skewed_counts(rng: random.Random, total: int,
                   n_hot: int, hot_min: int) -> list[int]:
    """Advisory count per name summing to ~total: a hot head of up to
    n_hot names (the "linux" shape — capped at a third of the budget,
    scaled down if the budget is small but kept above any realistic
    gather window so eviction is still exercised), then a long
    exponential tail with mean ~5, matching real trivy-db where the
    median package has a couple of advisories."""
    counts: list[int] = []
    if n_hot > 0:
        head_budget = total // 3
        hot_eff = max(min(hot_min, head_budget // max(n_hot, 1) // 2), 600)
        while len(counts) < n_hot and sum(counts) + hot_eff <= head_budget:
            counts.append(hot_eff + rng.randint(0, hot_eff))
    remaining = total - sum(counts)
    while remaining > 0:
        c = 1 + min(int(rng.expovariate(1 / 4.0)), 200)
        c = min(c, remaining)
        counts.append(c)
        remaining -= c
    return counts


def synth_trivy_db(
    n_advisories: int = 2_000_000,
    seed: int = 20260729,
    os_fraction: float = 0.75,
    n_hot: int = 40,
    hot_min: int = 2000,
) -> AdvisoryDB:
    """Build a trivy-db-scale synthetic AdvisoryDB.

    n_hot names receive >= hot_min advisories each (guaranteed to blow
    past any reasonable gather window, exercising host-fallback
    eviction the way debian's "linux" does in the real DB)."""
    rng = random.Random(seed)
    db = AdvisoryDB()

    n_os = int(n_advisories * os_fraction)
    n_lang = n_advisories - n_os

    # --- OS advisories --------------------------------------------------
    # names per bucket chosen so the average name has ~6 advisories
    per_bucket = n_os // len(OS_BUCKETS)
    vcache: list[str] = [
        f"{rng.randint(0, 9)}.{rng.randint(0, 20)}.{rng.randint(0, 30)}"
        for _ in range(4096)
    ]
    for b_i, (bucket, _scheme, suffix) in enumerate(OS_BUCKETS):
        counts = _skewed_counts(
            rng, per_bucket,
            n_hot if b_i == 0 else n_hot // 4,
            hot_min)
        made = 0
        for name_i, cnt in enumerate(counts):
            if made >= per_bucket:
                break
            if cnt > 500:
                name = HOT_NAMES[name_i % len(HOT_NAMES)] + (
                    "" if name_i < len(HOT_NAMES) else f"-{name_i}")
            else:
                name = f"pkg-{bucket.split()[0]}-{name_i}"
            for j in range(cnt):
                if made >= per_bucket:
                    break
                base = vcache[rng.randrange(len(vcache))]
                fixed = "" if rng.random() < 0.08 else \
                    f"{base}{suffix}{rng.randint(1, 9)}"
                db.put_advisory(bucket, name, Advisory(
                    vulnerability_id=f"CVE-{2015 + j % 11}-{b_i}{name_i}{j}",
                    fixed_version=fixed))
                made += 1

    # --- language advisories -------------------------------------------
    per_eco = n_lang // len(LANG_ECOS)
    for e_i, (eco, _scheme) in enumerate(LANG_ECOS):
        counts = _skewed_counts(rng, per_eco, n_hot // 8, hot_min // 2)
        made = 0
        for name_i, cnt in enumerate(counts):
            if made >= per_eco:
                break
            name = f"{eco}-lib-{name_i}"
            for j in range(cnt):
                if made >= per_eco:
                    break
                lo = vcache[rng.randrange(len(vcache))]
                hi = f"{rng.randint(5, 30)}.{rng.randint(0, 20)}.0"
                style = rng.random()
                if style < 0.55:
                    adv = Advisory(
                        vulnerability_id=f"GHSA-{eco}-{name_i}-{j}",
                        vulnerable_versions=[f">={lo}, <{hi}"])
                elif style < 0.85:
                    adv = Advisory(
                        vulnerability_id=f"GHSA-{eco}-{name_i}-{j}",
                        vulnerable_versions=[f"<{hi}"],
                        patched_versions=[f">={hi}"])
                else:
                    adv = Advisory(
                        vulnerability_id=f"GHSA-{eco}-{name_i}-{j}",
                        vulnerable_versions=[f"<{lo} || >={lo}, <{hi}"])
                db.put_advisory(f"{eco}::ghsa", name, adv)
                made += 1
    return db


def synth_queries(db: AdvisoryDB, n_queries: int,
                  seed: int = 7, hot_frac: float = 0.15,
                  miss_frac: float = 0.1) -> list:
    """Draw queries against the synthetic DB: mix of hot names (the
    whole point of the fallback path), tail names, and misses.

    hot_frac=0.15 is the Zipf stress shape (every 7th package is a
    "linux"-class name — far denser than a real scan); hot_frac~0.01 with
    miss_frac~0.35 approximates a real registry crawl where most packages
    have no or few advisories (~1-5 matches/query)."""
    from trivy_tpu_torch.detector.engine import PkgQuery
    from trivy_tpu_torch.tensorize.compile import space_of_bucket

    rng = random.Random(seed)
    pool: list[tuple[str, str, str]] = []  # (space, name, scheme)
    hot_pool: list[tuple[str, str, str]] = []
    for bucket, pkgs in db.buckets.items():
        resolved = space_of_bucket(bucket)
        if resolved is None:
            continue
        space, scheme = resolved
        for name, advs in pkgs.items():
            entry = (space, name, scheme)
            (hot_pool if len(advs) > 500 else pool).append(entry)
    out = []
    for i in range(n_queries):
        r = rng.random()
        if r < hot_frac and hot_pool:
            space, name, scheme = hot_pool[rng.randrange(len(hot_pool))]
        elif r < 1.0 - miss_frac and pool:
            space, name, scheme = pool[rng.randrange(len(pool))]
        else:  # miss
            space, name, scheme = "debian 12", f"nosuch-{i}", "deb"
        v = f"{rng.randint(0, 9)}.{rng.randint(0, 20)}.{rng.randint(0, 30)}"
        if scheme in ("deb", "rpm", "apk"):
            v += f"-{rng.randint(1, 5)}"
        out.append(PkgQuery(space, name, v, scheme))
    return out
