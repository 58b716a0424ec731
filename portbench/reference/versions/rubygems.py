"""RubyGems Gem::Version ordering (reference uses aquasecurity/go-gem-version,
pkg/detector/library/compare/rubygems; also used for cocoapods).

Gem::Version semantics:
- segments = runs of digits or runs of letters, split on '.', '-' also
  separates (treated like '.pre.'? no: Gem treats '-' by replacing with
  '.pre.'), scanned as /[0-9]+|[a-z]+/i
- numeric segments compare numerically; a string segment vs numeric segment:
  the string is SMALLER (string segments mark pre-releases)
- both streams are conceptually padded with zeros
"""

from __future__ import annotations

import re

from . import base
from .base import Inexact, ParseError, Scheme, cmp

_VALID = re.compile(r"^\s*([0-9]+(\.[0-9a-zA-Z]+)*(-[0-9A-Za-z-]+(\.[0-9A-Za-z-]+)*)?)?\s*$")
_SEG = re.compile(r"[0-9]+|[a-z]+", re.IGNORECASE)

TAG_NUM = 0x30


class GemVersion:
    __slots__ = ("segments", "raw")

    def __init__(self, segments: tuple, raw: str):
        self.segments = segments
        self.raw = raw

    @property
    def is_prerelease(self) -> bool:
        return any(isinstance(s, str) for s in self.segments)

def _canonical(segments: list) -> tuple:
    # trailing zero segments never affect comparison
    while segments and segments[-1] == 0:
        segments.pop()
    return tuple(segments)


class RubyGemsScheme(Scheme):
    name = "rubygems"

    def parse(self, s: str) -> GemVersion:
        raw = s
        s = s.strip()
        if not _VALID.match(s):
            raise ParseError(f"invalid gem version {raw!r}")
        if not s:
            s = "0"
        # Gem::Version: "-" introduces a pre-release part
        s = s.replace("-", ".pre.")
        segs: list = []
        for m in _SEG.finditer(s):
            t = m.group(0)
            segs.append(int(t) if t.isdigit() else t)
        if not segs:
            segs = [0]
        return GemVersion(_canonical(segs), raw)

    def compare_parsed(self, a: GemVersion, b: GemVersion) -> int:
        sa, sb = a.segments, b.segments
        for i in range(max(len(sa), len(sb))):
            xa = sa[i] if i < len(sa) else 0
            xb = sb[i] if i < len(sb) else 0
            na, nb = isinstance(xa, int), isinstance(xb, int)
            if na and nb:
                d = cmp(xa, xb)
            elif na != nb:
                d = 1 if na else -1  # numbers beat strings (strings = pre)
            else:
                d = cmp(xa, xb)
            if d:
                return d
        return 0

    def tokens(self, s: str):
        v = self.parse(s)
        if v.is_prerelease:
            # string segments sort *below zero*, which a flat tag order
            # cannot express next to trailing-zero trimming; pre-release
            # gems are rare as installed versions -> host path
            raise Inexact(f"pre-release gem version: {s!r}")
        toks = [(TAG_NUM, base.num_payload(n)) for n in v.segments]
        # canonical form has no trailing zeros, so zero padding after the
        # last token is exactly Gem's infinite-zero padding
        return toks

    def _tokens_lossy(self, s: str):
        v = self.parse(s)
        cap = (1 << 56) - 1
        toks = []
        for seg in v.segments:
            if isinstance(seg, str):
                break
            toks.append((TAG_NUM, base.num_payload(min(seg, cap))))
        return toks


SCHEME = RubyGemsScheme()
