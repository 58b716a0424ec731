"""Synthetic trivy-db advisories, as plain data.

A frozen copy of the port's generator (`tensorize/synth.py`
`synth_trivy_db`), kept here so that a later change to the program
cannot move the benchmark's inputs. It writes no program type: it
returns ``{bucket: {name: [advisory JSON object]}}`` in trivy-db's
field names, which `write_db` stores in the on-disk layout the port
loads (`trivy_tpu.db.json` plus `metadata.json`) and the reference
reads back as it is.

Two random streams. The *shape* stream (the configuration's
`shape_seed`) fixes how many advisories each name has, which names are
hot, whether an OS advisory is unfixed and which range style a language
advisory takes, so every run seed asks the same amount of work of the
program. The *content* stream (the run's `--seed`) draws every version
string, so each seed is a different DB generation.
"""

from __future__ import annotations

import json
import os
import random


def _skewed_counts(rng: random.Random, total: int, n_hot: int,
                   hot_min: int) -> list[int]:
    """Advisory count per name summing to `total`: a hot head of up to
    `n_hot` names (capped at a third of the budget), then a long
    exponential tail with mean about 5."""
    counts: list[int] = []
    if n_hot > 0:
        head_budget = total // 3
        hot_eff = max(min(hot_min, head_budget // max(n_hot, 1) // 2), 600)
        while len(counts) < n_hot and sum(counts) + hot_eff <= head_budget:
            counts.append(hot_eff + rng.randint(0, hot_eff))
    remaining = total - sum(counts)
    while remaining > 0:
        c = min(1 + min(int(rng.expovariate(1 / 4.0)), 200), remaining)
        counts.append(c)
        remaining -= c
    return counts


def lang_bucket(eco: str) -> str:
    return f"{eco}::ghsa"


def make_db(cfg: dict, seed: int) -> dict[str, dict[str, list[dict]]]:
    """-> {bucket: {name: [advisory]}} for configuration `cfg` (keys
    `advisories`, `os_fraction`, `n_hot`, `hot_min`, `hot_names`,
    `os_buckets`, `lang_ecosystems`, `shape_seed`) and run seed `seed`."""
    shape = random.Random(cfg["shape_seed"])
    rng = random.Random(seed)
    n_adv = cfg["advisories"]
    n_os = int(n_adv * cfg["os_fraction"])
    n_lang = n_adv - n_os
    n_hot, hot_min = cfg["n_hot"], cfg["hot_min"]
    hot_names = cfg["hot_names"]
    out: dict[str, dict[str, list[dict]]] = {}
    vcache = [f"{rng.randint(0, 9)}.{rng.randint(0, 20)}.{rng.randint(0, 30)}"
              for _ in range(4096)]
    os_buckets = cfg["os_buckets"]
    per_bucket = n_os // len(os_buckets)
    for b_i, (bucket, _scheme, suffix) in enumerate(os_buckets):
        counts = _skewed_counts(shape, per_bucket,
                                n_hot if b_i == 0 else n_hot // 4, hot_min)
        names = out.setdefault(bucket, {})
        made = 0
        for name_i, cnt in enumerate(counts):
            if made >= per_bucket:
                break
            if cnt > 500:
                name = hot_names[name_i % len(hot_names)] + (
                    "" if name_i < len(hot_names) else f"-{name_i}")
            else:
                name = f"pkg-{bucket.split()[0]}-{name_i}"
            advs = names.setdefault(name, [])
            for j in range(cnt):
                if made >= per_bucket:
                    break
                unfixed = shape.random() < 0.08
                base = vcache[rng.randrange(len(vcache))]
                tail = rng.randint(1, 9)
                adv = {"VulnerabilityID":
                       f"CVE-{2015 + j % 11}-{b_i}{name_i}{j}"}
                if not unfixed:
                    adv["FixedVersion"] = f"{base}{suffix}{tail}"
                advs.append(adv)
                made += 1
    ecos = cfg["lang_ecosystems"]
    per_eco = n_lang // len(ecos)
    for eco, _scheme in ecos:
        counts = _skewed_counts(shape, per_eco, n_hot // 8, hot_min // 2)
        names = out.setdefault(lang_bucket(eco), {})
        made = 0
        for name_i, cnt in enumerate(counts):
            if made >= per_eco:
                break
            advs = names.setdefault(f"{eco}-lib-{name_i}", [])
            for j in range(cnt):
                if made >= per_eco:
                    break
                style = shape.random()
                lo = vcache[rng.randrange(len(vcache))]
                hi = f"{rng.randint(5, 30)}.{rng.randint(0, 20)}.0"
                vid = f"GHSA-{eco}-{name_i}-{j}"
                if style < 0.55:
                    adv = {"VulnerabilityID": vid,
                           "VulnerableVersions": [f">={lo}, <{hi}"]}
                elif style < 0.85:
                    adv = {"VulnerabilityID": vid,
                           "VulnerableVersions": [f"<{hi}"],
                           "PatchedVersions": [f">={hi}"]}
                else:
                    adv = {"VulnerabilityID": vid,
                           "VulnerableVersions": [f"<{lo} || >={lo}, <{hi}"]}
                advs.append(adv)
                made += 1
    return out


def write_db(buckets: dict, path: str) -> None:
    """Store `buckets` at `path` in trivy-db's JSON layout: the DB file
    first, `metadata.json` last, each through a rename, so a directory
    with `metadata.json` holds a whole DB."""
    os.makedirs(path, exist_ok=True)
    body = json.dumps({"buckets": buckets, "vulnerability": {}},
                      separators=(",", ":")).encode()
    for name, data in (("trivy_tpu.db.json", body),
                       ("metadata.json", json.dumps({
                           "Version": 2, "NextUpdate": "", "UpdatedAt": "",
                           "DownloadedAt": ""}).encode())):
        tmp = os.path.join(path, name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, os.path.join(path, name))


def read_db(path: str) -> dict:
    """-> the buckets `write_db` stored at `path`."""
    with open(os.path.join(path, "trivy_tpu.db.json"), "rb") as f:
        return json.loads(f.read())["buckets"]
