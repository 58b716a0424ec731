"""Flexible semver core shared by the generic/npm/bitnami schemes.

Models the behavior of aquasecurity/go-version (used by the reference's
GenericComparer, pkg/detector/library/compare/compare.go:58) and
node-semver ordering (aquasecurity/go-npm-version, compare/npm/):
- dot-separated numeric segments (any count; missing segments == 0)
- optional pre-release after '-' (dot-separated identifiers; numeric
  identifiers compare numerically and sort before alphanumeric ones;
  a version WITH pre-release sorts before the same version without)
- build metadata after '+' is ignored for ordering
"""

from __future__ import annotations

import re

from . import base
from .base import Inexact, ParseError, Scheme, cmp

_RX = re.compile(
    r"^[vV]?\s*(?P<nums>\d+(?:\.\d+)*)"
    r"(?:[-.](?P<pre>[0-9A-Za-z-]+(?:\.[0-9A-Za-z-]+)*))?"
    r"(?:\+(?P<build>[0-9A-Za-z.-]+))?$"
)

NUM_SLOTS = 5  # numeric segments kept exactly; more -> Inexact

# ascending tag order == ascending version order
TAG_PRE_MARK = 0x08  # has pre-release
TAG_REL_MARK = 0x10  # release (no pre-release)
TAG_PRE_NUM = 0x18  # numeric pre-release identifier (< alphanumeric)
TAG_PRE_STR = 0x20
TAG_PRE_END = 0x0c  # end of pre-release identifiers (sorts below more idents)
TAG_NUM = 0x30


class SemVersion:
    __slots__ = ("nums", "pre", "build", "raw")

    def __init__(self, nums, pre, build, raw):
        self.nums = nums  # tuple[int, ...]
        self.pre = pre  # tuple of int|str identifiers, () if release
        self.build = build
        self.raw = raw

    def num(self, i: int) -> int:
        return self.nums[i] if i < len(self.nums) else 0

    @property
    def major(self) -> int:
        return self.num(0)

    @property
    def minor(self) -> int:
        return self.num(1)

    @property
    def patch(self) -> int:
        return self.num(2)

    def core(self) -> tuple:
        return (self.major, self.minor, self.patch)


def parse_semver(s: str, loose_pre_dot: bool = False) -> SemVersion:
    raw = s
    s = s.strip()
    m = _RX.match(s)
    if not m:
        raise ParseError(f"invalid version {raw!r}")
    if not loose_pre_dot and m.group("pre") is not None:
        # strict: pre-release must be introduced by '-', not '.'
        core_end = m.end("nums")
        if core_end < len(s) and s[core_end] == ".":
            raise ParseError(f"invalid version {raw!r}")
    nums = tuple(int(x) for x in m.group("nums").split("."))
    pre_raw = m.group("pre")
    pre: tuple = ()
    if pre_raw is not None:
        pre = tuple(
            int(p) if p.isdigit() else p for p in pre_raw.split(".")
        )
    return SemVersion(nums, pre, m.group("build") or "", raw)


def cmp_prerelease(a: tuple, b: tuple) -> int:
    if not a and not b:
        return 0
    if not a:
        return 1  # release > pre-release
    if not b:
        return -1
    for xa, xb in zip(a, b):
        na, nb = isinstance(xa, int), isinstance(xb, int)
        if na and nb:
            d = cmp(xa, xb)
        elif na != nb:
            d = -1 if na else 1  # numeric idents sort before alphanumeric
        else:
            d = cmp(xa, xb)
        if d:
            return d
    return cmp(len(a), len(b))  # more identifiers = higher precedence


def cmp_semver(a: SemVersion, b: SemVersion) -> int:
    for i in range(max(len(a.nums), len(b.nums))):
        d = cmp(a.num(i), b.num(i))
        if d:
            return d
    return cmp_prerelease(a.pre, b.pre)


def semver_tokens(v: SemVersion) -> list:
    """Token stream for a parsed semver-ish version (see module docstring
    of base.py for the key contract)."""
    if len(v.nums) > NUM_SLOTS:
        # the extra segments would be silently dropped -> inexact unless zero
        if any(n != 0 for n in v.nums[NUM_SLOTS:]):
            raise Inexact(f"more than {NUM_SLOTS} numeric segments: {v.raw!r}")
    toks = [(TAG_NUM, base.num_payload(v.num(i))) for i in range(NUM_SLOTS)]
    if not v.pre:
        toks.append((TAG_REL_MARK, b"\x00" * 7))
        return toks
    toks.append((TAG_PRE_MARK, b"\x00" * 7))
    for ident in v.pre:
        if isinstance(ident, int):
            toks.append((TAG_PRE_NUM, base.num_payload(ident)))
        else:
            toks.append((TAG_PRE_STR, base.str_payload(ident)))
    toks.append((TAG_PRE_END, b"\x00" * 7))
    return toks


def semver_tokens_lossy(v: SemVersion) -> list:
    toks = []
    for i in range(NUM_SLOTS):
        toks.append((TAG_NUM, base.num_payload(min(v.num(i), (1 << 56) - 1))))
    if not v.pre:
        toks.append((TAG_REL_MARK, b"\x00" * 7))
        return toks
    toks.append((TAG_PRE_MARK, b"\x00" * 7))
    for ident in v.pre[:4]:
        if isinstance(ident, int):
            toks.append((TAG_PRE_NUM, base.num_payload(min(ident, (1 << 56) - 1))))
        else:
            toks.append((TAG_PRE_STR, base.str_payload(ident[:6])))
    toks.append((TAG_PRE_END, b"\x00" * 7))
    return toks


class GenericScheme(Scheme):
    """aquasecurity/go-version-style flexible semver (reference
    pkg/detector/library/compare/compare.go GenericComparer)."""

    name = "generic"

    def parse(self, s: str) -> SemVersion:
        return parse_semver(s)

    def compare_parsed(self, a: SemVersion, b: SemVersion) -> int:
        return cmp_semver(a, b)

    def tokens(self, s: str):
        return semver_tokens(self.parse(s))

    def _tokens_lossy(self, s: str):
        return semver_tokens_lossy(self.parse(s))


SCHEME = GenericScheme()
