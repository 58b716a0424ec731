"""node-semver ordering (reference uses aquasecurity/go-npm-version,
pkg/detector/library/compare/npm).

Ordering is standard semver (exactly three numeric components, loose parse
pads missing ones). Range semantics live in constraints.py
(x-ranges, hyphen ranges, ^/~, and the npm pre-release rule: a version with a
pre-release tag only satisfies a comparator set if some comparator with the
same [major, minor, patch] tuple also has a pre-release).
"""

from __future__ import annotations

from . import base  # noqa: F401  (tags re-exported)
from .base import ParseError, Scheme
from .semver import (
    SemVersion,
    cmp_semver,
    parse_semver,
    semver_tokens,
    semver_tokens_lossy,
)


class NpmScheme(Scheme):
    name = "npm"

    def parse(self, s: str) -> SemVersion:
        s = s.strip().lstrip("=vV ")
        v = parse_semver(s)
        if len(v.nums) > 3:
            raise ParseError(f"npm versions have 3 components: {s!r}")
        return SemVersion(
            (v.major, v.minor, v.patch), v.pre, v.build, v.raw
        )

    def compare_parsed(self, a: SemVersion, b: SemVersion) -> int:
        return cmp_semver(a, b)

    def tokens(self, s: str):
        return semver_tokens(self.parse(s))

    def _tokens_lossy(self, s: str):
        return semver_tokens_lossy(self.parse(s))


SCHEME = NpmScheme()
