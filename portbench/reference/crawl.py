"""Plain reference of trivy's detect loop over a trivy-db.

For one query (space, name, installed version, scheme) it walks every
advisory of that name in the matching buckets and keeps those the
installed version satisfies, as trivy's `pkg/detector/ospkg` and
`pkg/detector/library` loops do:

- an OS advisory (fixed version, optional affected version) matches
  when affected <= installed < fixed, and always when it has no fixed
  version; an installed version that does not parse matches none;
- a language advisory matches when the version lies in its vulnerable
  ranges and in none of its patched or unaffected ranges; an empty
  range value matches every version, parsed or not.

It reads the DB as the benchmark wrote it (advisory JSON objects), and
answers with advisory identities: (bucket, name, vulnerability ID).

`lossy=True` is the control: every version, installed or in an
advisory, is compared on its first three numeric fields alone. That is
the shortcut a faster comparison would tempt, and it breaks the exact
matching the configuration states.
"""

from __future__ import annotations

import re

from portbench.reference.versions import SCHEMES, Constraints, ParseError

_NUMERIC_HEAD = re.compile(r"\d+(?:\.\d+){0,2}")


class _LossyScheme:
    """A scheme that parses only a version's leading `a.b.c`."""

    def __init__(self, scheme):
        self._s = scheme
        self.name = scheme.name

    def parse(self, s: str):
        m = _NUMERIC_HEAD.match(s)
        return self._s.parse(m.group(0) if m else s)

    def compare_parsed(self, a, b) -> int:
        return self._s.compare_parsed(a, b)


class CrawlReference:
    def __init__(self, buckets: dict, lossy: bool = False):
        self.buckets = buckets
        self.lossy = lossy
        self._schemes = {n: _LossyScheme(s) if lossy else s
                         for n, s in SCHEMES.items()}
        # parsed versions and constraints, by (scheme, text): advisories
        # of a hot name are checked for many queries
        self._parsed: dict[tuple, object] = {}
        self._constraints: dict[tuple, object] = {}

    def _parse(self, scheme, text: str):
        """-> the parsed version, or None where it does not parse."""
        key = (scheme.name, text)
        if key not in self._parsed:
            try:
                self._parsed[key] = scheme.parse(text)
            except ParseError:
                self._parsed[key] = None
        return self._parsed[key]

    def _check(self, scheme, ranges: list[str], ver) -> bool:
        """Whether `ver` lies in the `||`-joined `ranges`; raises
        ParseError where they do not parse."""
        key = (scheme.name, " || ".join(ranges))
        c = self._constraints.get(key)
        if c is None:
            try:
                c = Constraints(scheme, key[1], scheme.name == "npm")
            except ParseError as exc:
                c = exc
            self._constraints[key] = c
        if isinstance(c, ParseError):
            raise c
        return c.check(ver)

    def _advisories(self, space: str, name: str):
        """-> [(bucket, advisory)] of `name` in the space's buckets: an OS
        space is its bucket; a language space "eco::" is every bucket
        whose name starts with it."""
        if space.endswith("::"):
            return [(b, a) for b, names in self.buckets.items()
                    if b.startswith(space) for a in names.get(name, ())]
        return [(space, a) for a in self.buckets.get(space, {}).get(name, ())]

    def _matches(self, adv: dict, ver, scheme) -> bool:
        vuln = adv.get("VulnerableVersions") or []
        patched = adv.get("PatchedVersions") or []
        unaffected = adv.get("UnaffectedVersions") or []
        if vuln or patched or unaffected:
            if "" in vuln or "" in patched:
                return True
            if ver is None:
                return False
            try:
                if vuln and not self._check(scheme, vuln, ver):
                    return False
                secure = patched + unaffected
                if secure:
                    return not self._check(scheme, secure, ver)
            except ParseError:
                return False
            return True
        if ver is None:
            return False
        if adv.get("AffectedVersion"):
            affected = self._parse(scheme, adv["AffectedVersion"])
            if affected is None or scheme.compare_parsed(affected, ver) > 0:
                return False
        if not adv.get("FixedVersion"):
            return True
        fixed = self._parse(scheme, adv["FixedVersion"])
        return fixed is not None and scheme.compare_parsed(ver, fixed) < 0

    def answer(self, key: tuple) -> list[tuple]:
        """-> sorted (bucket, name, vulnerability ID) of every advisory
        that query `key` = (space, name, version, scheme) matches."""
        space, name, version, scheme_name = key
        scheme = self._schemes[scheme_name]
        ver = self._parse(scheme, version)
        return sorted((b, name, a["VulnerabilityID"])
                      for b, a in self._advisories(space, name)
                      if self._matches(a, ver, scheme))
