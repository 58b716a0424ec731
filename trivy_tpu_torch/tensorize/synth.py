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


def _synth_version(rng: random.Random, advs: list, os_pkg: bool) -> str:
    """An installed version for a package with these advisories: a
    third at one advisory's fixed version (that advisory is fixed), a
    third low (most advisories match), a third anywhere."""
    r = rng.random()
    fixed = [a.fixed_version for a in advs if a.fixed_version]
    if r < 1 / 3 and fixed:
        return fixed[rng.randrange(len(fixed))]
    major = 0 if r < 2 / 3 else rng.randint(0, 30)
    v = f"{major}.{rng.randint(0, 20)}.{rng.randint(0, 30)}"
    return f"{v}-{rng.randint(1, 5)}" if os_pkg else v


def synth_sbom(db: AdvisoryDB, n_os: int = 1000, n_npm: int = 1500,
               n_pip: int = 500, seed: int = 20261017,
               fmt: str = "cyclonedx", os_bucket: str = "debian 12",
               os_version: str = "12.7", miss_frac: float = 0.1) -> dict:
    """A seeded SBOM document of a distro-based service image drawn from
    `db`: `n_os` OS packages of `os_bucket` (every name of the bucket
    with over 500 advisories first, so the hot and tall tiers run), one
    npm lockfile application of `n_npm` packages and `n_pip` pip
    packages with no parent (aggregated as "Python"). A `miss_frac`
    share of each group names no package of the DB. `fmt` is
    "cyclonedx" or "spdx" (JSON documents as trivy writes them)."""
    rng = random.Random(seed)
    family = os_bucket.split()[0]

    def draw(bucket: str, n: int, os_pkg: bool) -> list[tuple[str, str]]:
        pkgs = db.buckets.get(bucket, {})
        names = sorted(pkgs)
        hot = [nm for nm in names if len(pkgs[nm]) > 500]
        cold = [nm for nm in names if len(pkgs[nm]) <= 500]
        out: list[tuple[str, str]] = []
        for i in range(n):
            if i < len(hot):
                name = hot[i]
            elif rng.random() < miss_frac or not cold:
                name = f"nosuch-{bucket.split(':')[0].split()[0]}-{i}"
            else:
                name = cold[rng.randrange(len(cold))]
            out.append((name, _synth_version(rng, pkgs.get(name, []),
                                             os_pkg)))
        return out

    os_pkgs = draw(os_bucket, n_os, True)
    npm_pkgs = draw("npm::ghsa", n_npm, False)
    pip_pkgs = draw("pip::ghsa", n_pip, False)
    distro = f"{family}-{os_version}"
    purls = ([f"pkg:deb/{family}/{n}@{v}?distro={distro}" for n, v in os_pkgs]
             + [f"pkg:npm/{n}@{v}" for n, v in npm_pkgs]
             + [f"pkg:pypi/{n}@{v}" for n, v in pip_pkgs])
    versions = [v for _n, v in os_pkgs + npm_pkgs + pip_pkgs]
    names = [n for n, _v in os_pkgs + npm_pkgs + pip_pkgs]
    lock = "srv/app/package-lock.json"
    npm_refs = range(n_os, n_os + n_npm)
    if fmt == "spdx":
        packages = [
            {"SPDXID": "SPDXRef-OperatingSystem-0", "name": family,
             "versionInfo": os_version,
             "primaryPackagePurpose": "OPERATING-SYSTEM"},
            {"SPDXID": "SPDXRef-Application-0", "name": lock},
        ]
        packages += [{
            "SPDXID": f"SPDXRef-Package-{i}", "name": names[i],
            "versionInfo": versions[i],
            "externalRefs": [{"referenceCategory": "PACKAGE-MANAGER",
                              "referenceType": "purl",
                              "referenceLocator": purls[i]}],
        } for i in range(len(purls))]
        return {
            "spdxVersion": "SPDX-2.3", "dataLicense": "CC0-1.0",
            "SPDXID": "SPDXRef-DOCUMENT", "name": "registry.example/svc:1",
            "packages": packages,
            "relationships": [{
                "spdxElementId": "SPDXRef-Application-0",
                "relationshipType": "DEPENDS_ON",
                "relatedSpdxElement": f"SPDXRef-Package-{i}",
            } for i in npm_refs],
        }
    components = [{"bom-ref": "os", "type": "operating-system",
                   "name": family, "version": os_version},
                  {"bom-ref": "app", "type": "application", "name": lock,
                   "properties": [
                       {"name": "aquasecurity:trivy:Type", "value": "npm"},
                       {"name": "aquasecurity:trivy:FilePath",
                        "value": lock}]}]
    components += [{"bom-ref": f"pkg-{i}", "type": "library",
                    "name": names[i], "version": versions[i],
                    "purl": purls[i]} for i in range(len(purls))]
    return {
        "bomFormat": "CycloneDX", "specVersion": "1.5",
        "metadata": {"component": {
            "bom-ref": "root", "type": "container",
            "name": "registry.example/svc:1",
            "properties": [{"name": "aquasecurity:trivy:ImageID",
                            "value": "sha256:" + "ab" * 32}]}},
        "components": components,
        "dependencies": [
            {"ref": "root", "dependsOn": ["os", "app"]},
            {"ref": "app", "dependsOn": [f"pkg-{i}" for i in npm_refs]}],
    }
