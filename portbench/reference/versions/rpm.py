"""RPM version comparison (rpmvercmp semantics with epoch:version-release).

Exact re-implementation of the ordering used by the reference via
knqyf263/go-rpm-version (reference pkg/detector/ospkg/redhat/redhat.go,
oracle, amazon, etc.).

rpmvercmp: tokenize into digit runs and alpha runs (separators delimit only);
'~' sorts before anything including end; '^' sorts after end but before any
further token; digit tokens beat alpha tokens; digit runs compare numerically
(leading zeros stripped); alpha runs compare by ASCII.
"""

from __future__ import annotations

import re

from . import base
from .base import ParseError, Scheme, cmp

# ascending tag order == ascending version order at a given position
TAG_TILDE = 0x08
TAG_END = 0x10  # also the epoch/version/release field separator
TAG_CARET = 0x18
TAG_ALPHA = 0x20
TAG_NUM = 0x30

_TOKEN = re.compile(r"[0-9]+|[A-Za-z]+|~|\^")


def _tokenize(s: str) -> list:
    """-> list of int | str | '~' | '^'; separators dropped."""
    out: list = []
    for m in _TOKEN.finditer(s):
        t = m.group(0)
        if t[0].isdigit():
            out.append(int(t))
        else:
            out.append(t)
    return out


def rpmvercmp(a: str, b: str) -> int:
    if a == b:
        return 0
    ta, tb = _tokenize(a), _tokenize(b)
    for i in range(max(len(ta), len(tb))):
        xa = ta[i] if i < len(ta) else None
        xb = tb[i] if i < len(tb) else None
        if xa == xb:
            continue
        # tilde sorts lowest, even vs end
        if xa == "~":
            return -1
        if xb == "~":
            return 1
        # caret: above end, below any other continuation
        if xa == "^":
            return 1 if xb is None else -1
        if xb == "^":
            return -1 if xa is None else 1
        if xa is None:
            return -1
        if xb is None:
            return 1
        na, nb = isinstance(xa, int), isinstance(xb, int)
        if na and nb:
            d = cmp(xa, xb)
        elif na != nb:
            d = 1 if na else -1  # digits beat alphas
        else:
            d = cmp(xa, xb)
        if d:
            return d
    return 0


class RpmVersion:
    __slots__ = ("epoch", "version", "release")

    def __init__(self, epoch: int, version: str, release: str):
        self.epoch = epoch
        self.version = version
        self.release = release


class RpmScheme(Scheme):
    name = "rpm"

    def parse(self, s: str) -> RpmVersion:
        s = s.strip()
        if not s:
            raise ParseError("empty rpm version")
        epoch = 0
        if ":" in s:
            e, _, rest = s.partition(":")
            if e.isdigit():
                epoch, s = int(e), rest
            elif e == "":
                s = rest
            else:
                raise ParseError(f"bad epoch in {s!r}")
        if "-" in s:
            version, _, release = s.rpartition("-")
        else:
            version, release = s, ""
        return RpmVersion(epoch, version, release)

    def compare_parsed(self, a: RpmVersion, b: RpmVersion) -> int:
        return (
            cmp(a.epoch, b.epoch)
            or rpmvercmp(a.version, b.version)
            or rpmvercmp(a.release, b.release)
        )

    def _field_tokens(self, field: str, toks: list) -> None:
        for t in _tokenize(field):
            if t == "~":
                toks.append((TAG_TILDE, b"\x00" * 7))
            elif t == "^":
                toks.append((TAG_CARET, b"\x00" * 7))
            elif isinstance(t, int):
                toks.append((TAG_NUM, base.num_payload(t)))
            else:
                toks.append((TAG_ALPHA, base.str_payload(t)))
        toks.append((TAG_END, b"\x00" * 7))

    def tokens(self, s: str):
        v = self.parse(s)
        toks = [(TAG_NUM, base.num_payload(v.epoch))]
        self._field_tokens(v.version, toks)
        self._field_tokens(v.release, toks)
        return toks

    def _tokens_lossy(self, s: str):
        v = self.parse(s)
        toks = [(TAG_NUM, base.num_payload(min(v.epoch, (1 << 56) - 1)))]
        for field in (v.version, v.release):
            for t in _tokenize(field):
                if t == "~":
                    toks.append((TAG_TILDE, b"\x00" * 7))
                elif t == "^":
                    toks.append((TAG_CARET, b"\x00" * 7))
                elif isinstance(t, int):
                    toks.append((TAG_NUM, base.num_payload(min(t, (1 << 56) - 1))))
                else:
                    payload = t.encode("ascii", "replace")[:6] + bytes([base.STR_TERM])
                    toks.append((TAG_ALPHA, payload.ljust(7, b"\x00")))
            toks.append((TAG_END, b"\x00" * 7))
        return toks


SCHEME = RpmScheme()
