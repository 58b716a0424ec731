"""Language-package vulnerability detection (reference
pkg/detector/library/detect.go + driver.go, re-expressed over the batched
match engine).

Copy of trivy_tpu/detector/langpkg.py; `detect_app` queries the
port's MatchEngine.
"""

from __future__ import annotations

import re

from trivy_tpu_torch.db.model import Advisory
from trivy_tpu_torch.detector.engine import MatchEngine, PkgQuery
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.types.artifact import Application
from trivy_tpu_torch.types.report import DataSource, DetectedVulnerability
from trivy_tpu_torch.versioning import ECOSYSTEM_SCHEME

_log = logger("langpkg")

# LangType -> ecosystem (reference pkg/detector/library/driver.go:25-97)
LANG_ECOSYSTEM: dict[str, str] = {
    "bundler": "rubygems", "gemspec": "rubygems",
    "rustbinary": "cargo", "cargo": "cargo",
    "composer": "composer", "composer-vendor": "composer",
    "gobinary": "go", "gomod": "go",
    "jar": "maven", "pom": "maven", "gradle": "maven",
    "sbt": "maven",
    "npm": "npm", "yarn": "npm", "pnpm": "npm", "bun": "npm",
    "node-pkg": "npm", "javascript": "npm",
    "nuget": "nuget", "dotnet-core": "nuget", "packages-props": "nuget",
    "pipenv": "pip", "poetry": "pip", "pip": "pip", "python-pkg": "pip",
    "uv": "pip",
    "pub": "pub",
    "hex": "erlang",  # reference driver.go: ftypes.Hex -> vulnerability.Erlang
    "conan": "conan",
    "swift": "swift",
    "cocoapods": "cocoapods",
    "bitnami": "bitnami",
    # reference driver.go: ftypes.K8sUpstream -> vulnerability.Kubernetes
    # whose trivy-db bucket prefix is "k8s"
    "kubernetes": "k8s",
}

# app type -> human-readable target when no file path
# (reference pkg/scanner/langpkg/scan.go:17 PkgTargets)
PKG_TARGETS = {
    "gemspec": "Ruby",
    "python-pkg": "Python",
    "conda-pkg": "Conda",
    "node-pkg": "Node.js",
    "jar": "Java",
    "k8s": "Kubernetes",
    "kubernetes": "Kubernetes",
}

# types supported for SBOM only (reference driver.go:80-85)
SBOM_ONLY = {"conda-pkg", "conda-environment", "julia", "wordpress"}


def normalize_pkg_name(eco: str, name: str) -> str:
    """trivy-db vulnerability.NormalizePkgName: pip names are PEP 503
    normalized; others pass through."""
    if eco == "pip":
        return re.sub(r"[-_.]+", "-", name).lower()
    if eco == "bitnami":
        return name.lower()
    return name


def driver_for(app_type: str) -> tuple[str, str] | None:
    """-> (ecosystem, scheme name) or None if unsupported."""
    eco = LANG_ECOSYSTEM.get(app_type)
    if eco is None:
        if app_type not in SBOM_ONLY:
            _log.warn("library type is not supported for vulnerability scanning",
                      type=app_type)
        return None
    return eco, ECOSYSTEM_SCHEME[eco]


def detect_app(
    engine: MatchEngine, app: Application
) -> list[DetectedVulnerability]:
    drv = driver_for(app.type)
    if drv is None:
        return []
    eco, scheme = drv
    space = f"{eco}::"

    queries = []
    q_pkgs = []
    for pkg in app.packages:
        if pkg.empty:
            continue
        queries.append(PkgQuery(
            space, normalize_pkg_name(eco, pkg.name), pkg.version, scheme
        ))
        q_pkgs.append(pkg)

    results = engine.detect(queries)
    vulns = []
    for pkg, res in zip(q_pkgs, results):
        for idx in res.adv_indices:
            _bucket, _name, adv = engine.cdb.advisories[idx]
            vulns.append(DetectedVulnerability(
                vulnerability_id=adv.vulnerability_id,
                pkg_id=pkg.id,
                pkg_name=pkg.name,
                pkg_path=pkg.file_path,
                pkg_identifier=pkg.identifier,
                installed_version=pkg.version,
                fixed_version=created_fixed_versions(adv),
                layer=pkg.layer,
                data_source=DataSource(
                    id=adv.data_source.id, name=adv.data_source.name,
                    url=adv.data_source.url,
                ) if adv.data_source else None,
            ))
    return vulns


def created_fixed_versions(adv: Advisory) -> str:
    """reference driver.go:145-166 createFixedVersions: prefer
    PatchedVersions; else derive from '<x' bounds in vulnerable ranges."""
    if adv.patched_versions:
        # DB order preserved (reference joins PatchedVersions as stored)
        return ", ".join(dict.fromkeys(adv.patched_versions))
    fixed = []
    for vv in adv.vulnerable_versions:
        for s in vv.split(","):
            s = s.strip()
            if s.startswith("<") and not s.startswith("<="):
                fixed.append(s[1:].strip())
    return ", ".join(dict.fromkeys(fixed))
