"""Bitnami version ordering (reference pkg/detector/library/compare/bitnami,
via bitnami/go-version).

Bitnami package versions are semver cores with an optional numeric revision
suffix: "1.2.3-4". Ordering: semver core first, then revision numerically
(missing revision == 0). Pre-release identifiers are not used by Bitnami.
"""

from __future__ import annotations

import re

from trivy_tpu_torch.versioning import base
from trivy_tpu_torch.versioning.base import ParseError, Scheme, cmp

_RX = re.compile(r"^[vV]?(?P<nums>\d+(?:\.\d+)*)(?:-(?P<rev>\d+))?$")

NUM_SLOTS = 4
TAG_NUM = 0x30


class BitnamiVersion:
    __slots__ = ("nums", "rev", "raw")

    def __init__(self, nums: tuple, rev: int, raw: str = ""):
        self.nums = nums
        self.rev = rev
        self.raw = raw

    def num(self, i: int) -> int:
        return self.nums[i] if i < len(self.nums) else 0


class BitnamiScheme(Scheme):
    name = "bitnami"

    def parse(self, s: str) -> BitnamiVersion:
        s = s.strip()
        m = _RX.match(s)
        if not m:
            raise ParseError(f"invalid bitnami version {s!r}")
        nums = tuple(int(x) for x in m.group("nums").split("."))
        return BitnamiVersion(nums, int(m.group("rev") or 0), s)

    def compare_parsed(self, a: BitnamiVersion, b: BitnamiVersion) -> int:
        for i in range(max(len(a.nums), len(b.nums))):
            d = cmp(a.num(i), b.num(i))
            if d:
                return d
        return cmp(a.rev, b.rev)

    def tokens(self, s: str):
        v = self.parse(s)
        if len(v.nums) > NUM_SLOTS and any(n for n in v.nums[NUM_SLOTS:]):
            raise base.Inexact(f"too many segments: {s!r}")
        toks = [(TAG_NUM, base.num_payload(v.num(i))) for i in range(NUM_SLOTS)]
        toks.append((TAG_NUM, base.num_payload(v.rev)))
        return toks

    def _tokens_lossy(self, s: str):
        v = self.parse(s)
        cap = (1 << 56) - 1
        toks = [
            (TAG_NUM, base.num_payload(min(v.num(i), cap)))
            for i in range(NUM_SLOTS)
        ]
        toks.append((TAG_NUM, base.num_payload(min(v.rev, cap))))
        return toks


SCHEME = BitnamiScheme()
