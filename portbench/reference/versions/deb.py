"""Debian package version comparison (Debian Policy 5.6.12).

Exact re-implementation of the ordering used by the reference via
knqyf263/go-deb-version (reference pkg/detector/ospkg/debian/debian.go:7).

Format: [epoch:]upstream[-revision]
- epoch: integer, default 0
- revision: split on the LAST '-'; absent revision == "0"
- verrevcmp: alternate longest non-digit / digit runs; non-digit runs compare
  char-wise with all letters before all non-letters and '~' before anything,
  including end-of-part; digit runs compare numerically.
"""

from __future__ import annotations

import re

from . import base
from .base import ParseError, Scheme, cmp

_VALID = re.compile(r"^[0-9][A-Za-z0-9.+:~-]*$|^[A-Za-z0-9.+:~-]+$")

TAG_STR = 0x20
TAG_NUM = 0x30


def _char_order(c: str) -> int:
    """Debian lexical order: '~' < end-of-part < letters < non-letters."""
    if c == "~":
        return base.STR_TERM - 1  # 0x01, below the terminator
    if c.isalpha():
        return base.STR_TERM + 1 + (ord(c) - 65)  # letters keep ASCII order
    return base.STR_TERM + 1 + 58 + min(ord(c), 150)  # non-letters after


def _split_runs(s: str) -> list:
    """-> alternating [str, int, str, int, ...] starting with a (possibly
    empty) non-digit run."""
    runs: list = []
    i, n = 0, len(s)
    while i < n:
        j = i
        while j < n and not s[j].isdigit():
            j += 1
        runs.append(s[i:j])
        i = j
        j = i
        while j < n and s[j].isdigit():
            j += 1
        runs.append(int(s[i:j]) if j > i else 0)
        i = j
    if not runs:
        runs = ["", 0]
    return runs


def _cmp_nondigit(a: str, b: str) -> int:
    for ca, cb in zip(a, b):
        d = cmp(_char_order(ca), _char_order(cb))
        if d:
            return d
    if len(a) == len(b):
        return 0
    # the shorter part ends first; end-of-part sorts before anything but '~'
    if len(a) < len(b):
        return -1 if b[len(a)] != "~" else 1
    return 1 if a[len(b)] != "~" else -1


def _verrevcmp(a: str, b: str) -> int:
    ra, rb = _split_runs(a), _split_runs(b)
    for i in range(max(len(ra), len(rb))):
        xa = ra[i] if i < len(ra) else ("" if i % 2 == 0 else 0)
        xb = rb[i] if i < len(rb) else ("" if i % 2 == 0 else 0)
        d = _cmp_nondigit(xa, xb) if i % 2 == 0 else cmp(xa, xb)
        if d:
            return d
    return 0


class DebVersion:
    __slots__ = ("epoch", "upstream", "revision")

    def __init__(self, epoch: int, upstream: str, revision: str):
        self.epoch = epoch
        self.upstream = upstream
        self.revision = revision


class DebScheme(Scheme):
    name = "deb"

    def parse(self, s: str) -> DebVersion:
        s = s.strip()
        if not s:
            raise ParseError("empty debian version")
        epoch = 0
        if ":" in s:
            e, _, rest = s.partition(":")
            if not e.isdigit():
                raise ParseError(f"bad epoch in {s!r}")
            epoch, s = int(e), rest
        if "-" in s:
            upstream, _, revision = s.rpartition("-")
        else:
            upstream, revision = s, "0"
        if not upstream:
            raise ParseError(f"empty upstream version in {s!r}")
        if not _VALID.match(upstream) or not re.match(r"^[A-Za-z0-9+.~]*$", revision):
            raise ParseError(f"invalid debian version {s!r}")
        return DebVersion(epoch, upstream, revision)

    def compare_parsed(self, a: DebVersion, b: DebVersion) -> int:
        return (
            cmp(a.epoch, b.epoch)
            or _verrevcmp(a.upstream, b.upstream)
            or _verrevcmp(a.revision, b.revision)
        )

    def _runs_tokens(self, runs: list, toks: list) -> None:
        for i, r in enumerate(runs):
            if i % 2 == 0:
                toks.append((TAG_STR, base.str_payload(r, _char_order)))
            else:
                toks.append((TAG_NUM, base.num_payload(r)))

    def tokens(self, s: str):
        v = self.parse(s)
        toks = [(TAG_NUM, base.num_payload(v.epoch))]
        self._runs_tokens(_split_runs(v.upstream), toks)
        # field separator doubles as end-of-upstream: empty string payload
        # sorts above '~'-led continuations and below everything else,
        # exactly like Debian end-of-part.
        toks.append((TAG_STR, base.str_payload("", _char_order)))
        self._runs_tokens(_split_runs(v.revision), toks)
        toks.append((TAG_STR, base.str_payload("", _char_order)))
        return toks

    def _tokens_lossy(self, s: str):
        v = self.parse(s)
        toks = [(TAG_NUM, base.num_payload(min(v.epoch, (1 << 56) - 1)))]
        for field in (v.upstream, v.revision):
            for i, r in enumerate(_split_runs(field)):
                if i % 2 == 0:
                    payload = bytearray()
                    for ch in r[:6]:
                        payload.append(_char_order(ch))
                    payload.append(base.STR_TERM)
                    payload = bytes(payload[:7]).ljust(7, b"\x00")
                    toks.append((TAG_STR, payload))
                else:
                    toks.append((TAG_NUM, base.num_payload(min(r, (1 << 56) - 1))))
            toks.append((TAG_STR, base.str_payload("", _char_order)))
        return toks


SCHEME = DebScheme()
