"""Version-range constraints.

Grammar (covers the constraint strings stored in trivy-db, which the
reference evaluates via per-ecosystem Go libs — pkg/detector/library/compare):
  constraint  = group ("||" group)*          # OR
  group       = comparator ((","|space) comparator)*   # AND
  comparator  = [op] version | version " - " version   # npm hyphen range
  op          = = | == | != | > | < | >= | <= | ~> | ~ | ^
  version may contain x/X/* wildcard segments (npm/pep440 style)

Every constraint can also be compiled to a union of half-open intervals over
the scheme's total order (intervals()), which is what the DB tensor compiler
feeds the TPU kernel (SURVEY.md §7 step 2). The interval set is always a
SUPERSET of check() (equal except for the npm pre-release restriction), so
kernel candidates can never miss a true match.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from .base import ParseError, Scheme

_OPS = ("~=", "==", ">=", "<=", "!=", "~>", "=", ">", "<", "~", "^")

_COMP_RX = re.compile(
    r"\s*(?P<op>~=|==|>=|<=|!=|~>|=|>|<|~|\^)?\s*(?P<ver>[^\s,|]+)"
)


@dataclass(frozen=True)
class Interval:
    """lo/hi are parsed versions or None for unbounded."""

    lo: object = None
    lo_incl: bool = True
    hi: object = None
    hi_incl: bool = True

    def is_empty(self, scheme: Scheme) -> bool:
        if self.lo is None or self.hi is None:
            return False
        d = scheme.compare_parsed(self.lo, self.hi)
        return d > 0 or (d == 0 and not (self.lo_incl and self.hi_incl))

    def contains(self, v, scheme: Scheme) -> bool:
        if self.lo is not None:
            d = scheme.compare_parsed(v, self.lo)
            if d < 0 or (d == 0 and not self.lo_incl):
                return False
        if self.hi is not None:
            d = scheme.compare_parsed(v, self.hi)
            if d > 0 or (d == 0 and not self.hi_incl):
                return False
        return True


def _intersect(a: Interval, b: Interval, scheme: Scheme) -> Interval | None:
    lo, lo_incl = a.lo, a.lo_incl
    if b.lo is not None:
        if lo is None:
            lo, lo_incl = b.lo, b.lo_incl
        else:
            d = scheme.compare_parsed(b.lo, lo)
            if d > 0:
                lo, lo_incl = b.lo, b.lo_incl
            elif d == 0:
                lo_incl = lo_incl and b.lo_incl
    hi, hi_incl = a.hi, a.hi_incl
    if b.hi is not None:
        if hi is None:
            hi, hi_incl = b.hi, b.hi_incl
        else:
            d = scheme.compare_parsed(b.hi, hi)
            if d < 0:
                hi, hi_incl = b.hi, b.hi_incl
            elif d == 0:
                hi_incl = hi_incl and b.hi_incl
    out = Interval(lo, lo_incl, hi, hi_incl)
    return None if out.is_empty(scheme) else out


class Comparator:
    """One op+version term, expanded to a union of intervals plus metadata
    for the npm pre-release rule."""

    __slots__ = ("op", "ver_str", "intervals", "pre_core")

    def __init__(self, op: str, ver_str: str, intervals: list, pre_core):
        self.op = op
        self.ver_str = ver_str
        self.intervals = intervals  # list[Interval], ORed
        self.pre_core = pre_core  # (maj, min, patch) if version had a pre tag

    def check(self, v, scheme: Scheme) -> bool:
        return any(iv.contains(v, scheme) for iv in self.intervals)


_BRACKET_RX = re.compile(r"[\[\(][^\[\]\(\)]*[\]\)]")


def _maven_ranges(expr: str) -> str:
    """Maven bracket ranges -> operator syntax: "[2.9.0,2.9.10.7)" becomes
    ">=2.9.0, <2.9.10.7"; comma-separated bracket groups are a union
    (reference maven comparer via go-mvn-version). OR-groups without
    brackets pass through unchanged; a group mixing bracket and bare
    syntax is an error, never silently truncated."""
    out = []
    for group in expr.split("||"):
        g = group.strip()
        if "[" not in g and "(" not in g:
            out.append(g)
            continue
        brackets = _BRACKET_RX.findall(g)
        rest = _BRACKET_RX.sub("", g).strip(" ,")
        if rest or not brackets:
            raise ParseError(f"mixed/unbalanced maven range {group!r}")
        for b in brackets:
            open_b, close_b = b[0], b[-1]
            inner = b[1:-1].strip()
            if "," not in inner:
                if open_b == "[" and close_b == "]" and inner:
                    out.append(f"={inner}")
                else:
                    raise ParseError(f"invalid maven range {b!r}")
                continue
            lo, hi = (s.strip() for s in inner.split(",", 1))
            parts = []
            if lo:
                parts.append((">=" if open_b == "[" else ">") + lo)
            if hi:
                parts.append(("<=" if close_b == "]" else "<") + hi)
            if not parts:
                raise ParseError(f"unbounded maven range {b!r}")
            out.append(", ".join(parts))
    return " || ".join(out)


class Constraints:
    """Parsed constraint: OR of AND-groups of comparators."""

    def __init__(self, scheme: Scheme, expr: str, npm_mode: bool = False):
        self.scheme = scheme
        self.expr = expr
        self.npm_mode = npm_mode
        if scheme.name == "maven":
            expr = _maven_ranges(expr)
        self.groups: list[list[Comparator]] = []
        for group_expr in expr.split("||"):
            group_expr = group_expr.strip()
            self.groups.append(self._parse_group(group_expr))

    # -------------------------------------------------- parsing

    def _parse_group(self, expr: str) -> list[Comparator]:
        if expr == "*" and not self.npm_mode:
            # the reference's generic comparer rejects a bare '*' constraint
            # (aquasecurity/go-version errors -> not vulnerable)
            raise ParseError("invalid constraint '*'")
        if not expr or expr == "*":
            return [Comparator("", "*", [Interval()], None)]
        # npm hyphen range: "1.2.3 - 2.0.0"
        m = re.match(r"^\s*([^\s,|]+)\s+-\s+([^\s,|]+)\s*$", expr)
        if m and self.npm_mode:
            lo_str, hi_str = m.group(1), m.group(2)
            lo_wild = self._has_wildcard(lo_str) or self._is_partial(lo_str)
            lo = self._floor(lo_str) if lo_wild else self.scheme.parse(lo_str)
            if self._has_wildcard(hi_str) or self._is_partial(hi_str):
                hi_iv = self._wildcard_interval(hi_str)
                iv = Interval(lo, True, hi_iv.hi, hi_iv.hi_incl)
                hi_pre = None
            else:
                iv = Interval(lo, True, self.scheme.parse(hi_str), True)
                hi_pre = self._pre_core(hi_str)
            # desugared bounds keep their pre-release cores for the npm rule
            lo_pre = None if lo_wild else self._pre_core(lo_str)
            return [
                Comparator(">=", lo_str, [iv], lo_pre),
                Comparator("<=", hi_str, [Interval()], hi_pre),
            ]
        comps = []
        for part in re.split(r",", expr):
            part = part.strip()
            if not part:
                continue
            for cm in _COMP_RX.finditer(part):
                comps.append(self._parse_comparator(cm.group("op") or "", cm.group("ver")))
        if not comps:
            raise ParseError(f"empty constraint group {expr!r}")
        return comps

    def _has_wildcard(self, s: str) -> bool:
        return bool(re.search(r"(^|\.)[xX*](\.|$)", s)) or s in ("*", "x", "X")

    def _is_partial(self, s: str) -> bool:
        # "1" / "1.2" style (semver family only)
        return bool(re.match(r"^[vV]?\d+(\.\d+)?$", s)) and self.npm_mode

    def _nums_of(self, s: str) -> list[int]:
        s = s.lstrip("vV")
        out = []
        for seg in s.split("."):
            seg = seg.split("-")[0].split("+")[0]
            if seg in ("x", "X", "*", ""):
                break
            if not seg.isdigit():
                break
            out.append(int(seg))
        return out

    def _mk(self, nums: list[int]) -> object:
        return self.scheme.parse(".".join(str(n) for n in nums) or "0")

    def _floor(self, s: str) -> object:
        """Lowest concrete version matching a possibly-partial/wildcard one."""
        return self._mk(self._nums_of(s))

    def _block_floor(self, nums: list[int]) -> object:
        """Smallest version carrying the given release prefix. For PEP 440
        that includes pre-releases ("1.5.dev0" < "1.5a1" < "1.5"), matching
        the reference's prefix-match semantics for '==1.5.*'."""
        if self.scheme.name == "pep440" and nums:
            return self.scheme.parse(
                ".".join(str(n) for n in nums) + ".dev0"
            )
        return self._mk(nums)

    def _bump(self, nums: list[int]) -> object | None:
        """Smallest version above the wildcard block: bump last given seg."""
        if not nums:
            return None  # "*": unbounded
        return self._block_floor(nums[:-1] + [nums[-1] + 1])

    def _wildcard_interval(self, s: str) -> Interval:
        nums = self._nums_of(s)
        hi = self._bump(nums)
        return Interval(self._block_floor(nums), True, hi, False)

    def _pre_core(self, ver_str: str):
        v = None
        try:
            v = self.scheme.parse(ver_str)
        except ParseError:
            return None
        pre = getattr(v, "pre", ())
        if pre:
            return v.core() if hasattr(v, "core") else None
        return None

    def _parse_comparator(self, op: str, ver_str: str) -> Comparator:
        scheme = self.scheme
        wildcard = self._has_wildcard(ver_str) or self._is_partial(ver_str)
        pre_core = None if wildcard else self._pre_core(ver_str)

        if op in ("", "=", "=="):
            if ver_str in ("*", "x", "X"):
                if not self.npm_mode and self.scheme.name != "pep440":
                    raise ParseError("invalid constraint '*'")
                return Comparator(op, ver_str, [Interval()], None)
            if wildcard:
                return Comparator(op, ver_str, [self._wildcard_interval(ver_str)], None)
            v = scheme.parse(ver_str)
            return Comparator(op, ver_str, [Interval(v, True, v, True)], pre_core)
        if op == "!=":
            if wildcard:
                iv = self._wildcard_interval(ver_str)
                return Comparator(op, ver_str, [
                    Interval(None, True, iv.lo, False),
                    Interval(iv.hi, True, None, True),
                ], None)
            v = scheme.parse(ver_str)
            return Comparator(op, ver_str, [
                Interval(None, True, v, False),
                Interval(v, False, None, True),
            ], pre_core)
        if op == ">":
            if wildcard:
                # ">1.2.x" == ">=1.3.0"
                iv = self._wildcard_interval(ver_str)
                return Comparator(op, ver_str, [Interval(iv.hi, True, None, True)], None)
            return Comparator(op, ver_str,
                              [Interval(scheme.parse(ver_str), False, None, True)], pre_core)
        if op == ">=":
            v = self._floor(ver_str) if wildcard else scheme.parse(ver_str)
            return Comparator(op, ver_str, [Interval(v, True, None, True)], pre_core)
        if op == "<":
            v = self._floor(ver_str) if wildcard else scheme.parse(ver_str)
            return Comparator(op, ver_str, [Interval(None, True, v, False)], pre_core)
        if op == "<=":
            if wildcard:
                iv = self._wildcard_interval(ver_str)
                return Comparator(op, ver_str, [Interval(None, True, iv.hi, False)], None)
            return Comparator(op, ver_str,
                              [Interval(None, True, scheme.parse(ver_str), True)], pre_core)
        if op == "~=":
            # PEP 440 compatible release: ~=2.2 -> >=2.2,<3.0;
            # ~=1.4.5 -> >=1.4.5,<1.5.0 (bump second-to-last)
            return self._tilde("~>", ver_str, pre_core)
        if op in ("~", "~>"):
            return self._tilde(op, ver_str, pre_core)
        if op == "^":
            return self._caret(op, ver_str, pre_core)
        raise ParseError(f"unknown operator {op!r}")

    def _tilde(self, op: str, ver_str: str, pre_core) -> Comparator:
        """~1.2.3 / ~>1.2.3: >=1.2.3 <1.3.0; ~1.2 -> <1.3.0 (npm) but
        pessimistic ~>1.2 -> <2.0 (ruby/generic, bump second-to-last)."""
        nums = self._nums_of(ver_str)
        if self._has_wildcard(ver_str) or self._is_partial(ver_str):
            lo = self._mk(nums)  # "~1.x" / "~1.2" floors to "1.0.0" / "1.2.0"
        else:
            lo = self.scheme.parse(ver_str)
        if op == "~>" and not self.npm_mode:
            # ruby pessimistic: drop last segment, bump the new last
            bump_nums = nums[:-1] if len(nums) > 1 else nums
            hi = self._mk(bump_nums[:-1] + [bump_nums[-1] + 1])
        elif len(nums) >= 2:
            hi = self._mk([nums[0], nums[1] + 1])
        else:
            hi = self._mk([nums[0] + 1] if nums else [1])
        return Comparator(op, ver_str, [Interval(lo, True, hi, False)], pre_core)

    def _caret(self, op: str, ver_str: str, pre_core) -> Comparator:
        """^1.2.3: >=1.2.3 <2.0.0; ^0.2.3: <0.3.0; ^0.0.3: <0.0.4."""
        nums = self._nums_of(ver_str)
        if not nums:
            return Comparator(op, ver_str, [Interval()], None)  # "^*"
        if self._has_wildcard(ver_str) or self._is_partial(ver_str):
            lo = self._mk(nums)
        else:
            lo = self.scheme.parse(ver_str)
        idx = 0
        for i, n in enumerate(nums):
            if n != 0 or i == len(nums) - 1:
                idx = i
                break
        hi = self._mk(nums[: idx] + [nums[idx] + 1])
        return Comparator(op, ver_str, [Interval(lo, True, hi, False)], pre_core)

    # -------------------------------------------------- evaluation

    def check(self, v) -> bool:
        """Exact host-side satisfaction check (the oracle)."""
        for group in self.groups:
            if all(c.check(v, self.scheme) for c in group):
                if self.npm_mode and getattr(v, "pre", ()):
                    # npm rule: pre-release versions only satisfy if some
                    # comparator shares their [major,minor,patch] core and
                    # carries a pre-release tag itself
                    core = v.core()
                    if not any(c.pre_core == core for c in group):
                        continue
                return True
        return False

    def check_str(self, version: str) -> bool:
        return self.check(self.scheme.parse(version))

    # -------------------------------------------------- intervals

    def intervals(self) -> list[Interval]:
        """Union-of-intervals superset of check() over the total order.
        (Exactly equal except the npm pre-release restriction, which only
        removes matches and is re-applied in the host rescreen.)"""
        out: list[Interval] = []
        for group in self.groups:
            group_ivs = [Interval()]
            for comp in group:
                nxt = []
                for giv in group_ivs:
                    for civ in comp.intervals:
                        got = _intersect(giv, civ, self.scheme)
                        if got is not None:
                            nxt.append(got)
                group_ivs = nxt
                if not group_ivs:
                    break
            out.extend(group_ivs)
        return out
