"""Maven ComparableVersion ordering (reference uses
aquasecurity/go-mvn-version, pkg/detector/library/compare/maven).

compare() implements the full org.apache.maven ComparableVersion algorithm
(ListItem/StringItem/IntegerItem with trailing-null normalization, qualifier
ranking alpha < beta < milestone < rc < snapshot < "" < sp < other, implicit
separators at digit<->letter transitions, string < list < int at a given
position).

tokens() flattens to the shared tagged stream for the common shapes
(dotted numerals + a simple qualifier chain). Shapes where flattening can
misorder against a differently-nested spelling (a '-' group followed by
further separators) raise Inexact -> exact host path.
"""

from __future__ import annotations

import re

from . import base
from .base import Inexact, ParseError, Scheme, cmp

_QUALIFIERS = ["alpha", "beta", "milestone", "rc", "snapshot", "", "sp"]
_ALIASES = {"ga": "", "final": "", "release": "", "cr": "rc"}
_SHORT = {"a": "alpha", "b": "beta", "m": "milestone"}

# ascending tag order == ascending version order at the qualifier position:
#   alpha..snapshot < release(end) < sp < unknown strings < numbers
TAG_Q_ALPHA = 0x08
TAG_Q_BETA = 0x09
TAG_Q_MILESTONE = 0x0a
TAG_Q_RC = 0x0b
TAG_Q_SNAPSHOT = 0x0c
TAG_END = 0x10
TAG_Q_SP = 0x14
TAG_Q_OTHER = 0x18
TAG_NUM = 0x30

_Q_TAG = {
    "alpha": TAG_Q_ALPHA,
    "beta": TAG_Q_BETA,
    "milestone": TAG_Q_MILESTONE,
    "rc": TAG_Q_RC,
    "snapshot": TAG_Q_SNAPSHOT,
    "sp": TAG_Q_SP,
}

NUM_SLOTS = 5


# ---------------------------------------------------------------- parsing

INT, STR, LIST = 0, 1, 2


def _parse_item(s: str, is_digit: bool, followed_by_digit: bool):
    if is_digit:
        return (INT, int(s))
    s = _ALIASES.get(s, s)
    if followed_by_digit and s in _SHORT:
        s = _SHORT[s]
    return (STR, s)


def _is_null(item) -> bool:
    kind, val = item
    if kind == INT:
        return val == 0
    if kind == STR:
        return val in ("", "final", "ga")
    return len(val) == 0


def _trim(lst: list) -> None:
    while lst and _is_null(lst[-1]):
        lst.pop()


def _normalize(lst: list) -> None:
    for kind, val in lst:
        if kind == LIST:
            _normalize(val)
    _trim(lst)


def parse_cv(version: str) -> tuple:
    """Parse into the nested (LIST, [...]) structure of ComparableVersion.

    '-' (and any digit<->letter transition, which the version-order spec
    treats as a hyphen) normalizes the current list (trims trailing nulls)
    and opens a sub-list; '.' appends to the current list.
    """
    version = version.lower()
    root: list = []
    cur = root
    start = 0
    is_digit = version[:1].isdigit()

    def open_sublist():
        nonlocal cur
        _trim(cur)
        new: list = []
        cur.append((LIST, new))
        cur = new

    i = 0
    for i, ch in enumerate(version):
        if ch == ".":
            cur.append(
                (INT, 0) if i == start
                else _parse_item(version[start:i], is_digit, False)
            )
            start = i + 1
            is_digit = version[i + 1: i + 2].isdigit()
        elif ch == "-":
            cur.append(
                (INT, 0) if i == start
                else _parse_item(version[start:i], is_digit,
                                 version[i + 1: i + 2].isdigit())
            )
            start = i + 1
            open_sublist()
            is_digit = version[i + 1: i + 2].isdigit()
        elif ch.isdigit() != is_digit:
            # digit<->letter transition == hyphen
            if i > start:
                cur.append(_parse_item(version[start:i], is_digit, ch.isdigit()))
            start = i
            open_sublist()
            is_digit = ch.isdigit()
    if len(version) > start:
        cur.append(_parse_item(version[start:], is_digit, False))
    elif version.endswith((".", "-")) or not version:
        cur.append((INT, 0))
    _normalize(root)
    return (LIST, root)


def _q_order(q: str) -> tuple:
    q = _ALIASES.get(q, q)
    if q in _QUALIFIERS:
        return (_QUALIFIERS.index(q), "")
    return (len(_QUALIFIERS), q)


def _cmp_items(a, b) -> int:
    if a is None and b is None:
        return 0
    if a is None:
        return -_cmp_items(b, None)
    ka, va = a
    if b is None:
        if ka == INT:
            return 0 if va == 0 else 1
        if ka == STR:
            return cmp(_q_order(va), _q_order(""))
        # LIST vs null: decided by the list's first item (maven quirk)
        return _cmp_items(va[0], None) if va else 0
    kb, vb = b
    if ka != kb:
        # string < list < int
        rank = {STR: 1, LIST: 2, INT: 3}
        return cmp(rank[ka], rank[kb])
    if ka == INT:
        return cmp(va, vb)
    if ka == STR:
        return cmp(_q_order(va), _q_order(vb))
    # both lists
    for i in range(max(len(va), len(vb))):
        xa = va[i] if i < len(va) else None
        xb = vb[i] if i < len(vb) else None
        d = _cmp_items(xa, xb)
        if d:
            return d
    return 0


# -------------------------------------------------------------- tokens

_SIMPLE = re.compile(r"^v?(?P<nums>\d+(\.\d+)*)(?P<rest>[.\-a-z0-9]*)$", re.I)
_CHAIN_EL = re.compile(r"[0-9]+|[a-z]+", re.I)


class MavenVersion:
    __slots__ = ("cv", "raw")

    def __init__(self, cv, raw: str):
        self.cv = cv
        self.raw = raw


class MavenScheme(Scheme):
    name = "maven"

    def parse(self, s: str) -> MavenVersion:
        s = s.strip()
        if not s:
            raise ParseError("empty maven version")
        return MavenVersion(parse_cv(s), s)

    def compare_parsed(self, a: MavenVersion, b: MavenVersion) -> int:
        return _cmp_items(a.cv, b.cv)

    def tokens(self, s: str):
        s0 = s.strip().lower()
        m = _SIMPLE.match(s0)
        if not m:
            raise Inexact(f"non-simple maven version: {s!r}")
        rest = m.group("rest")
        # '.'-separated suffix elements nest differently than '-'/transition
        # ones ([alpha,1] vs [alpha,[1]]), which a flat encoding cannot
        # distinguish -> host path. Pure release aliases are a no-op.
        if "." in rest and rest not in (".ga", ".final", ".release"):
            raise Inexact(f"dotted maven suffix: {s!r}")
        nums = [int(x) for x in m.group("nums").split(".")]
        while nums and nums[-1] == 0:
            nums.pop()
        if len(nums) > NUM_SLOTS:
            raise Inexact(f"too many numeric segments: {s!r}")
        toks = [
            (TAG_NUM, base.num_payload(nums[i] if i < len(nums) else 0))
            for i in range(NUM_SLOTS)
        ]
        # chain elements: alternating qualifiers / numbers
        els = _CHAIN_EL.findall(rest)
        # canonical: drop trailing null elements (0, release aliases)
        while els and (els[-1] in ("ga", "final", "release") or
                       (els[-1].isdigit() and int(els[-1]) == 0)):
            els.pop()
        for i, el in enumerate(els):
            if el.isdigit():
                toks.append((TAG_NUM, base.num_payload(int(el))))
                continue
            q = _ALIASES.get(el, el)
            nxt_digit = i + 1 < len(els) and els[i + 1].isdigit()
            if q in _SHORT and nxt_digit:
                q = _SHORT[q]
            if q in _Q_TAG:
                toks.append((_Q_TAG[q], b"\x00" * 7))
            elif q == "":
                # mid-chain release alias ("1.0-ga-1") nests as ['',[1]]
                # which a flat stream can't distinguish from [1] -> host path
                raise Inexact(f"mid-chain release alias: {s!r}")
            else:
                toks.append((TAG_Q_OTHER, base.str_payload(q)))
        toks.append((TAG_END, b"\x00" * 7))
        return toks

    def _tokens_lossy(self, s: str):
        s0 = s.strip().lower()
        m = _SIMPLE.match(s0)
        if not m:
            raise Inexact(f"unencodable maven version: {s!r}")
        cap = (1 << 56) - 1
        nums = [int(x) for x in m.group("nums").split(".")]
        while nums and nums[-1] == 0:
            nums.pop()
        toks = [
            (TAG_NUM, base.num_payload(min(nums[i] if i < len(nums) else 0, cap)))
            for i in range(NUM_SLOTS)
        ]
        for el in _CHAIN_EL.findall(m.group("rest"))[:4]:
            if el.isdigit():
                toks.append((TAG_NUM, base.num_payload(min(int(el), cap))))
            else:
                q = _ALIASES.get(el, el)
                if q in _Q_TAG:
                    toks.append((_Q_TAG[q], b"\x00" * 7))
                else:
                    toks.append((TAG_Q_OTHER, base.str_payload(q[:6])))
        toks.append((TAG_END, b"\x00" * 7))
        return toks


SCHEME = MavenScheme()
