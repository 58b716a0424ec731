"""Version schemes, comparators and constraint matching.

Scheme registry + the ecosystem->scheme map used by the library detector
(reference pkg/detector/library/driver.go:25-97) and the per-distro OS
detectors (reference pkg/detector/ospkg/*).
"""

from __future__ import annotations

from trivy_tpu_torch.log import logger
from trivy_tpu_torch.versioning import (
    apk,
    base,
    bitnami,
    deb,
    maven,
    npm,
    pep440,
    rpm,
    rubygems,
    semver,
)
from trivy_tpu_torch.versioning.base import Inexact, ParseError, Scheme
from trivy_tpu_torch.versioning.constraints import Constraints, Interval

SCHEMES: dict[str, Scheme] = {
    s.name: s
    for s in (
        apk.SCHEME,
        deb.SCHEME,
        rpm.SCHEME,
        semver.SCHEME,  # "generic"
        npm.SCHEME,
        pep440.SCHEME,
        maven.SCHEME,
        rubygems.SCHEME,
        bitnami.SCHEME,
    )
}

# ecosystem (trivy-db bucket prefix) -> version scheme name
# (reference pkg/detector/library/driver.go:29-91)
ECOSYSTEM_SCHEME: dict[str, str] = {
    "rubygems": "rubygems",
    "cargo": "generic",
    "composer": "generic",
    "go": "generic",
    "maven": "maven",
    "npm": "npm",
    "nuget": "generic",
    "pip": "pep440",
    "pub": "generic",
    "erlang": "generic",
    "conan": "generic",
    "swift": "generic",
    "cocoapods": "rubygems",
    "bitnami": "bitnami",
    # trivy-db names the upstream Kubernetes CVE feed ecosystem "k8s"
    # (bucket "k8s::Official Kubernetes CVE Feed")
    "k8s": "generic",
    "kubernetes": "generic",
}

# OS family -> version scheme for package versions
OS_SCHEME: dict[str, str] = {
    "alpine": "apk",
    "chainguard": "apk",
    "wolfi": "apk",
    "minimos": "apk",
    "echo": "deb",
    "debian": "deb",
    "ubuntu": "deb",
    "alma": "rpm",
    "amazon": "rpm",
    "azurelinux": "rpm",
    "cbl-mariner": "rpm",
    "centos": "rpm",
    "fedora": "rpm",
    "oracle": "rpm",
    "photon": "rpm",
    "redhat": "rpm",
    "rocky": "rpm",
    "opensuse": "rpm",
    "opensuse-leap": "rpm",
    "opensuse-tumbleweed": "rpm",
    "suse linux enterprise micro": "rpm",
    "suse linux enterprise server": "rpm",
}

_log = logger("version")


def get_scheme(name: str) -> Scheme:
    return SCHEMES[name]


def scheme_for_ecosystem(eco: str) -> Scheme | None:
    name = ECOSYSTEM_SCHEME.get(eco)
    return SCHEMES[name] if name else None


def scheme_for_os(family: str) -> Scheme | None:
    name = OS_SCHEME.get(family)
    return SCHEMES[name] if name else None


def parse_constraints(eco: str, expr: str) -> Constraints:
    scheme = scheme_for_ecosystem(eco)
    if scheme is None:
        raise ParseError(f"no scheme for ecosystem {eco!r}")
    return Constraints(scheme, expr, npm_mode=(scheme.name == "npm"))


def is_vulnerable(
    eco: str,
    version: str,
    vulnerable_versions: list[str],
    patched_versions: list[str],
    unaffected_versions: list[str],
) -> bool:
    """Library-advisory satisfaction (reference
    pkg/detector/library/compare/compare.go:22-56): the version must match
    the vulnerable ranges and must NOT match patched/unaffected ranges.
    An empty-string range value means 'always vulnerable'."""
    for v in list(vulnerable_versions) + list(patched_versions):
        if v == "":
            return True
    scheme = scheme_for_ecosystem(eco)
    if scheme is None:
        return False
    npm_mode = scheme.name == "npm"
    try:
        ver = scheme.parse(version)
    except ParseError as e:
        _log.debug("failed to parse version", version=version, err=str(e))
        return False

    matched = False
    if vulnerable_versions:
        try:
            c = Constraints(scheme, " || ".join(vulnerable_versions), npm_mode)
            matched = c.check(ver)
        except ParseError as e:
            _log.warn("version constraint error", constraint=str(vulnerable_versions), err=str(e))
            return False
        if not matched:
            return False

    secure = list(patched_versions) + list(unaffected_versions)
    if not secure:
        return matched
    try:
        c = Constraints(scheme, " || ".join(secure), npm_mode)
        return not c.check(ver)
    except ParseError as e:
        _log.warn("version constraint error", constraint=str(secure), err=str(e))
        return False
