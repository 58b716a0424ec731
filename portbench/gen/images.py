"""Package lists of container images, drawn against a generated DB.

The crawl generator behind every `traffic/*.json` of the crawl system.
It follows the frozen copies of the port's `synth_queries` and
`_synth_version` (`tensorize/synth.py`) and of `chip_smoke.py`'s
`build_queries`: an image holds OS packages of its one OS bucket plus
packages of one or two language ecosystems; a `hot_frac` share of its
names are hot (over 500 advisories), a `miss_frac` share name no package
of the DB, the rest are drawn from the long tail. An installed version
sits at one advisory's fixed version, low, or anywhere, a third each.

Every key (space, name, version) drawn is new to the run: the generator
keeps the keys it handed out and draws again on a repeat. Repeats across
calls come only from a registry's images being drawn again.

Image sizes come from the configuration's shape stream, the same for
every seed; the seed orders them and draws every name and version.
Calls are drawn one at a time, as the window asks for them, so a faster
program gets more of them and never runs out.
"""

from __future__ import annotations

import bisect
import itertools
import math
import random

HOT_MIN_ADVISORIES = 500


def size_stream(traffic: dict, shape_seed: int):
    """Package counts without end, log-normal around `size_median` with
    `size_sigma`, clipped to [`size_min`, `size_max`]."""
    rng = random.Random(shape_seed ^ 0x5EED)
    mu = math.log(traffic["size_median"])
    while True:
        yield min(max(int(round(math.exp(rng.gauss(mu, traffic["size_sigma"])))),
                      traffic["size_min"]), traffic["size_max"])


def image_sizes(traffic: dict, n: int, shape_seed: int) -> list[int]:
    """The first `n` counts of the shape stream."""
    return list(itertools.islice(size_stream(traffic, shape_seed), n))


class Space:
    """The names of one DB bucket a query can be drawn from."""

    def __init__(self, space: str, scheme: str, advs_by_name: dict,
                 os_pkg: bool, miss_tag: str):
        self.space = space
        self.scheme = scheme
        self.os_pkg = os_pkg
        self.miss_tag = miss_tag
        self.hot = sorted(n for n, a in advs_by_name.items()
                          if len(a) > HOT_MIN_ADVISORIES)
        self.tail = sorted(n for n, a in advs_by_name.items()
                           if len(a) <= HOT_MIN_ADVISORIES)
        # tuples of strings, which the collector stops tracking: the
        # generator lives through the window
        self.fixed = {n: tuple(a["FixedVersion"] for a in advs
                               if a.get("FixedVersion"))
                      for n, advs in advs_by_name.items()}


class ImageGen:
    """Draws images (lists of (space, name, version, scheme) keys)."""

    def __init__(self, cfg: dict, traffic: dict, buckets: dict, seed: int):
        self.traffic = traffic
        self.rng = random.Random(seed * 1_000_003 + 17)
        self.used: set[tuple] = set()
        self.n_miss = 0
        self.os_spaces = [
            Space(b, scheme, buckets.get(b, {}), True, b.split()[0])
            for b, scheme, _suffix in cfg["os_buckets"]]
        self.lang_spaces = [
            Space(f"{eco}::", scheme, buckets.get(f"{eco}::ghsa", {}), False,
                  eco)
            for eco, scheme in cfg["lang_ecosystems"]]

    def _version(self, sp: Space, name: str, spread: bool) -> str:
        rng = self.rng
        r = rng.random()
        fixed = sp.fixed.get(name)
        if r < 1 / 3 and fixed and not spread:
            return fixed[rng.randrange(len(fixed))]
        major = 0 if r < 2 / 3 and not spread else rng.randint(0, 30)
        v = f"{major}.{rng.randint(0, 20)}.{rng.randint(0, 30)}"
        if spread:
            v += f".{rng.randint(0, 999)}"
        return f"{v}-{rng.randint(1, 5)}" if sp.os_pkg else v

    def _package(self, sp: Space) -> tuple:
        rng = self.rng
        r = rng.random()
        if r < self.traffic["hot_frac"] and sp.hot:
            name = sp.hot[rng.randrange(len(sp.hot))]
        elif r < 1.0 - self.traffic["miss_frac"] and sp.tail:
            name = sp.tail[rng.randrange(len(sp.tail))]
        else:
            self.n_miss += 1
            name = f"nosuch-{sp.miss_tag}-{self.n_miss}"
        for attempt in range(64):
            key = (sp.space, name, self._version(sp, name, attempt >= 8),
                   sp.scheme)
            if key not in self.used:
                break
        else:
            raise RuntimeError(f"no fresh version left for {name}")
        self.used.add(key)
        return key

    def bump(self, key: tuple) -> tuple:
        """`key`'s package at a version new to the run."""
        space, name, _version, scheme = key
        sp = next(x for x in self.os_spaces + self.lang_spaces
                  if x.space == space)
        for attempt in range(64):
            new = (space, name, self._version(sp, name, attempt >= 8),
                   scheme)
            if new not in self.used:
                self.used.add(new)
                return new
        raise RuntimeError(f"no fresh version left for {name}")

    def image(self, size: int, os_i: int | None = None,
              base: list | None = None) -> list[tuple]:
        """One image of `size` packages: `os_share` of them OS packages of
        one bucket (`base` first, where given), the rest from one or two
        language ecosystems."""
        rng = self.rng
        sp_os = self.os_spaces[rng.randrange(len(self.os_spaces))
                               if os_i is None else os_i]
        n_eco = 1 + (rng.random() < 0.5)
        ecos = rng.sample(self.lang_spaces, n_eco)
        n_os = int(round(size * self.traffic["os_share"]))
        out = list(base or [])
        while len(out) < n_os:
            out.append(self._package(sp_os))
        while len(out) < size:
            out.append(self._package(ecos[len(out) % n_eco]))
        return out


def fresh_calls(gen: ImageGen, traffic: dict, shape_seed: int,
                per_call: int, block_calls: int = 8):
    """Calls of `per_call` images (key lists) each, without end, every
    key new to the run. Sizes come from the shape stream in blocks of
    `block_calls` calls, and the seed orders each block: every seed
    sends the same sizes, block by block."""
    sizes = size_stream(traffic, shape_seed)
    while True:
        block = list(itertools.islice(sizes, per_call * block_calls))
        gen.rng.shuffle(block)
        for i in range(0, len(block), per_call):
            yield [gen.image(size) for size in block[i: i + per_call]]


class Registry:
    """`images` image definitions: `repos` repositories of `images /
    repos` tags each, a repository on one of the base images (one per
    OS bucket). A repository's tags share its package list; each later
    tag moves a `tag_drift` share of the packages above the base to new
    versions. Image `i` is tag `i // repos` of repository `i % repos`,
    and is drawn by Zipf popularity (exponent `zipf_s`) over `i`."""

    def __init__(self, gen: ImageGen, reg: dict, sizes: list[int]):
        rng = gen.rng
        n_bases = len(gen.os_spaces)
        lo, hi = reg["base_pkgs"]
        self.bases = [[gen._package(gen.os_spaces[b])
                       for _ in range(lo + (hi - lo) * b // (n_bases - 1))]
                      for b in range(n_bases)]
        repos = reg["repos"]
        tags = reg["images"] // repos
        # sizes by repository come from the shape stream alone, so every
        # seed crawls the same sizes at the same popularity
        heads = []
        for r in range(repos):
            base = self.bases[r % n_bases]
            heads.append(gen.image(max(sizes[r], len(base) + 1),
                                   r % n_bases, base))
        by_tag = [heads]
        for _t in range(1, tags):
            row = []
            for r, prev in enumerate(by_tag[-1]):
                n_base = len(self.bases[r % n_bases])
                img = list(prev)
                for j in range(n_base, len(img)):
                    if rng.random() < reg["tag_drift"]:
                        img[j] = gen.bump(img[j])
                row.append(img)
            by_tag.append(row)
        self.images = [by_tag[i // repos][i % repos]
                       for i in range(repos * tags)]
        weights = [1.0 / (r + 1) ** reg["zipf_s"]
                   for r in range(len(self.images))]
        total = sum(weights)
        self.cum = []
        acc = 0.0
        for w in weights:
            acc += w / total
            self.cum.append(acc)
        self.rng = rng

    def draw(self) -> int:
        return min(bisect.bisect_left(self.cum, self.rng.random()),
                   len(self.images) - 1)

    def draw_call(self, per_call: int) -> list[int]:
        """The indices of one call's `per_call` images."""
        return [self.draw() for _ in range(per_call)]
