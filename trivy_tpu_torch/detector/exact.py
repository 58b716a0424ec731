"""Exact per-advisory satisfaction checks — the single source of truth used
by BOTH the CPU oracle and the post-kernel host rescreen, so the two paths
cannot diverge.

Semantics mirror the reference:
- range-style (language) advisories: pkg matches vulnerable ranges and not
  patched/unaffected (reference pkg/detector/library/compare/compare.go:22-56)
- OS advisories: affected <= installed < fixed; no fixed version = always
  (reference pkg/detector/ospkg/alpine/alpine.go:123-156 et al.)
"""

from __future__ import annotations

from trivy_tpu_torch import versioning
from trivy_tpu_torch.db.model import Advisory
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.versioning.base import ParseError

_log = logger("detect")


class AdvisoryChecker:
    """Pre-compiled exact check for one advisory: constraints are parsed
    once (advisories are immutable), so the per-candidate rescreen is just
    interval containment on an already-parsed version."""

    __slots__ = ("adv", "scheme", "always", "invalid", "vuln_c", "secure_c")

    def __init__(self, adv: Advisory, scheme_name: str):
        self.adv = adv
        self.scheme = versioning.get_scheme(scheme_name)
        self.always = False
        self.invalid = False
        self.vuln_c = None
        self.secure_c = None
        if adv.is_range_style:
            for v in list(adv.vulnerable_versions) + list(adv.patched_versions):
                if v == "":
                    self.always = True
                    return
            npm_mode = self.scheme.name == "npm"
            try:
                if adv.vulnerable_versions:
                    self.vuln_c = versioning.Constraints(
                        self.scheme, " || ".join(adv.vulnerable_versions),
                        npm_mode,
                    )
                secure = list(adv.patched_versions) + list(adv.unaffected_versions)
                if secure:
                    self.secure_c = versioning.Constraints(
                        self.scheme, " || ".join(secure), npm_mode
                    )
            except ParseError as e:
                _log.warn("constraint error", err=str(e))
                self.invalid = True

    def check_parsed(self, ver) -> bool:
        adv = self.adv
        if adv.is_range_style:
            if self.always:
                return True
            if self.invalid:
                return False
            if self.vuln_c is not None and not self.vuln_c.check(ver):
                return False
            if self.secure_c is not None:
                return not self.secure_c.check(ver)
            # reachable only with non-empty vulnerable ranges that matched
            return True
        # OS-style
        if adv.affected_version:
            try:
                affected = self.scheme.parse(adv.affected_version)
            except ParseError:
                return False
            if self.scheme.compare_parsed(affected, ver) > 0:
                return False
        if not adv.fixed_version:
            return True
        try:
            fixed = self.scheme.parse(adv.fixed_version)
        except ParseError as e:
            _log.debug("failed to parse fixed version",
                       version=adv.fixed_version, err=str(e))
            return False
        return self.scheme.compare_parsed(ver, fixed) < 0

    def check(self, version: str) -> bool:
        try:
            ver = self.scheme.parse(version)
        except ParseError:
            return False
        return self.check_parsed(ver)


def advisory_matches(
    adv: Advisory, version: str, scheme_name: str, eco: str | None
) -> bool:
    scheme = versioning.get_scheme(scheme_name)
    if adv.is_range_style:
        for v in list(adv.vulnerable_versions) + list(adv.patched_versions):
            if v == "":
                return True
        npm_mode = scheme.name == "npm"
        try:
            ver = scheme.parse(version)
        except ParseError:
            return False
        matched = True
        if adv.vulnerable_versions:
            try:
                c = versioning.Constraints(
                    scheme, " || ".join(adv.vulnerable_versions), npm_mode
                )
                matched = c.check(ver)
            except ParseError as e:
                _log.warn("constraint error", err=str(e))
                return False
            if not matched:
                return False
        secure = list(adv.patched_versions) + list(adv.unaffected_versions)
        if not secure:
            return matched
        try:
            c = versioning.Constraints(scheme, " || ".join(secure), npm_mode)
            return not c.check(ver)
        except ParseError as e:
            _log.warn("constraint error", err=str(e))
            return False

    # OS-style advisory
    try:
        ver = scheme.parse(version)
    except ParseError as e:
        _log.debug("failed to parse installed version", version=version, err=str(e))
        return False
    if adv.affected_version:
        try:
            affected = scheme.parse(adv.affected_version)
        except ParseError:
            return False
        if scheme.compare_parsed(affected, ver) > 0:
            return False
    if not adv.fixed_version:
        return True  # unfixed vulnerability
    try:
        fixed = scheme.parse(adv.fixed_version)
    except ParseError as e:
        _log.debug("failed to parse fixed version",
                   version=adv.fixed_version, err=str(e))
        return False
    return scheme.compare_parsed(ver, fixed) < 0
