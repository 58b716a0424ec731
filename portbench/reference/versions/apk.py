"""Alpine apk version comparison (apk-tools version.c semantics).

Exact re-implementation of the ordering used by the reference via
knqyf263/go-apk-version (reference pkg/detector/ospkg/alpine/alpine.go:8).

Format: digits('.'digits)* [letter] ('_'suffix[digits])* ['-r'digits]
Token kinds, by apk enum (higher enum = OLDER when kinds differ, with a
special case: a pre-release suffix is older than end-of-version):
  DIGIT(_OR_ZERO) < LETTER < SUFFIX < SUFFIX_NO < REVISION_NO < END
Pre suffixes: alpha < beta < pre < rc;  post: cvs < svn < git < hg < p.
Numeric components after the first compare as C strings when either side
has a leading zero (fractional semantics), else numerically.
"""

from __future__ import annotations

import re

from . import base
from .base import Inexact, ParseError, Scheme, cmp

_PRE = {"alpha": 0, "beta": 1, "pre": 2, "rc": 3}
_POST = {"cvs": 0, "svn": 1, "git": 2, "hg": 3, "p": 4}

_RX = re.compile(
    r"^(?P<nums>\d+(?:\.\d+)*)"
    r"(?P<letter>[a-z])?"
    r"(?P<suffixes>(?:_(?:alpha|beta|pre|rc|cvs|svn|git|hg|p)\d*)*)"
    r"(?P<rev>-r\d+)?$"
)

# ascending tag order == ascending version order at a given position.
# Derived from the apk rule "higher token enum is older" plus the
# pre-release exception (see module docstring):
#   SUFFIX_PRE < END < REVISION_NO < SUFFIX_NO < SUFFIX_POST < LETTER
#   < NUM_ZERO < NUM
TAG_SUFFIX_PRE = 0x08
TAG_END = 0x10
TAG_REV = 0x18
TAG_SUFFIX_NO = 0x20
TAG_SUFFIX_POST = 0x28
TAG_LETTER = 0x30
TAG_NUM_ZERO = 0x38  # numeric component with leading zero: string compare
TAG_NUM = 0x40

# token kinds for compare()
_K_NUM, _K_LETTER, _K_SUFFIX, _K_SUFFIX_NO, _K_REV, _K_END = range(6)


class ApkVersion:
    __slots__ = ("parts",)

    def __init__(self, parts: list):
        self.parts = parts  # [(kind, value)]


def _parse_tokens(s: str) -> list:
    m = _RX.match(s)
    if not m:
        raise ParseError(f"invalid apk version {s!r}")
    toks: list = []
    for i, comp in enumerate(m.group("nums").split(".")):
        # first component always numeric; later ones keep the raw string so
        # leading-zero fractional compare is possible
        toks.append((_K_NUM, comp if i > 0 else str(int(comp))))
    if m.group("letter"):
        toks.append((_K_LETTER, m.group("letter")))
    for suf in filter(None, m.group("suffixes").split("_")):
        name = suf.rstrip("0123456789")
        num = suf[len(name):]
        toks.append((_K_SUFFIX, name))
        if num:
            toks.append((_K_SUFFIX_NO, int(num)))
    if m.group("rev"):
        toks.append((_K_REV, int(m.group("rev")[2:])))
    return toks


def _cmp_numeric(a: str, b: str) -> int:
    # apk: if either has a leading zero (len>1), compare as C strings
    if (a.startswith("0") and len(a) > 1) or (b.startswith("0") and len(b) > 1):
        return cmp(a, b)
    return cmp(int(a), int(b))


class ApkScheme(Scheme):
    name = "apk"

    def parse(self, s: str) -> ApkVersion:
        return ApkVersion(_parse_tokens(s.strip()))

    def compare_parsed(self, a: ApkVersion, b: ApkVersion) -> int:
        ta, tb = a.parts, b.parts
        for i in range(max(len(ta), len(tb))):
            ka, va = ta[i] if i < len(ta) else (_K_END, None)
            kb, vb = tb[i] if i < len(tb) else (_K_END, None)
            if ka == kb:
                if ka == _K_END:
                    return 0
                if ka == _K_NUM:
                    d = _cmp_numeric(va, vb)
                elif ka == _K_SUFFIX:
                    pa, pb = va in _PRE, vb in _PRE
                    if pa != pb:
                        return -1 if pa else 1
                    table = _PRE if pa else _POST
                    d = cmp(table[va], table[vb])
                else:
                    d = cmp(va, vb)
                if d:
                    return d
                continue
            # different kinds: pre-release suffix is older than anything
            if ka == _K_SUFFIX and va in _PRE:
                return -1
            if kb == _K_SUFFIX and vb in _PRE:
                return 1
            # otherwise higher kind enum = older
            return 1 if ka < kb else -1
        return 0

    def tokens(self, s: str):
        toks = []
        for k, v in self.parse(s).parts:
            if k == _K_NUM:
                # any '0'-led component (including "0" itself) sorts below all
                # 1-9-led ones both under apk string compare and numerically,
                # so NUM_ZERO(string payload) < NUM(numeric payload) is exact
                if v.startswith("0"):
                    toks.append((TAG_NUM_ZERO, base.str_payload(v)))
                else:
                    toks.append((TAG_NUM, base.num_payload(int(v))))
            elif k == _K_LETTER:
                toks.append((TAG_LETTER, base.str_payload(v)))
            elif k == _K_SUFFIX:
                if v in _PRE:
                    toks.append((TAG_SUFFIX_PRE, base.num_payload(_PRE[v])))
                else:
                    toks.append((TAG_SUFFIX_POST, base.num_payload(_POST[v])))
            elif k == _K_SUFFIX_NO:
                toks.append((TAG_SUFFIX_NO, base.num_payload(v)))
            elif k == _K_REV:
                toks.append((TAG_REV, base.num_payload(v)))
        toks.append((TAG_END, b"\x00" * 7))
        return toks

    def _tokens_lossy(self, s: str):
        toks = []
        for k, v in self.parse(s).parts:
            try:
                if k == _K_NUM:
                    if v.startswith("0"):
                        toks.append((TAG_NUM_ZERO, base.str_payload(v[:6])))
                    else:
                        toks.append((TAG_NUM, base.num_payload(min(int(v), (1 << 56) - 1))))
                elif k == _K_LETTER:
                    toks.append((TAG_LETTER, base.str_payload(v)))
                elif k == _K_SUFFIX:
                    if v in _PRE:
                        toks.append((TAG_SUFFIX_PRE, base.num_payload(_PRE[v])))
                    else:
                        toks.append((TAG_SUFFIX_POST, base.num_payload(_POST[v])))
                elif k == _K_SUFFIX_NO:
                    toks.append((TAG_SUFFIX_NO, base.num_payload(min(v, (1 << 56) - 1))))
                elif k == _K_REV:
                    toks.append((TAG_REV, base.num_payload(min(v, (1 << 56) - 1))))
            except Inexact:
                break
        toks.append((TAG_END, b"\x00" * 7))
        return toks


SCHEME = ApkScheme()
