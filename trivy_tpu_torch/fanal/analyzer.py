"""Analyzer framework (reference pkg/fanal/analyzer/analyzer.go).

- Analyzers register into a global registry (analyzer.go:26-27); an
  AnalyzerGroup is built per scan honoring disabled types (analyzer.go:321)
- per-file analyzers get (path, content); post-analyzers get a virtual
  filesystem of just their required files (analyzer.go:475-515)
- results merge into one AnalysisResult per blob (analyzer.go:251-301)
- analyzer versions feed cache keys (analyzer.go:385)

Host-side design difference from the reference: instead of a goroutine per
(file x analyzer), files are walked serially/thread-pooled and matching is
dispatched by path — the heavy parallelism belongs to the device batches,
not the host.

Copy of trivy_tpu/fanal/analyzer.py. Where the reference logs a failed analyzer and goes on,
the port does so only for a failure that is not the device's: a device
error (`device.is_device_error`, e.g. a secret screen that cannot build
or launch) passes up and ends the scan, so no blob is kept, cached or
reported without the findings of the analyzer that failed.
"""

from __future__ import annotations

import fnmatch
import os
from dataclasses import dataclass, field
from typing import Callable

from trivy_tpu_torch.device import is_device_error
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.types.artifact import (
    Application,
    BlobInfo,
    CustomResource,
    LicenseFile,
    OS,
    PackageInfo,
    Repository,
    Secret,
)

_log = logger("analyzer")


@dataclass
class AnalysisInput:
    """One file presented to an analyzer."""

    path: str  # path inside the artifact (no leading slash)
    content: bytes | None = None
    size: int = 0
    mode: int = 0
    # opener for lazy/large files
    open: Callable[[], bytes] | None = None

    def read(self) -> bytes:
        if self.content is None and self.open is not None:
            self.content = self.open()
        return self.content or b""


@dataclass
class AnalysisResult:
    os: OS = field(default_factory=OS)
    repository: Repository | None = None
    package_infos: list[PackageInfo] = field(default_factory=list)
    applications: list[Application] = field(default_factory=list)
    secrets: list[Secret] = field(default_factory=list)
    licenses: list[LicenseFile] = field(default_factory=list)
    system_installed_files: list[str] = field(default_factory=list)
    custom_resources: list[CustomResource] = field(default_factory=list)
    misconfigurations: list = field(default_factory=list)
    build_info: object | None = None
    digests: dict = field(default_factory=dict)

    def merge(self, other: "AnalysisResult | None") -> None:
        if other is None:
            return
        self.os = self.os.merge(other.os)
        if other.repository is not None:
            self.repository = other.repository
        self.package_infos.extend(other.package_infos)
        self.applications.extend(other.applications)
        self.secrets.extend(other.secrets)
        self.licenses.extend(other.licenses)
        self.system_installed_files.extend(other.system_installed_files)
        self.custom_resources.extend(other.custom_resources)
        self.misconfigurations.extend(other.misconfigurations)
        if other.build_info is not None:
            bi, obi = self.build_info, other.build_info
            if bi is None:
                self.build_info = obi
            else:  # merge fields (content manifest + dockerfile analyzers)
                bi.content_sets = bi.content_sets or obi.content_sets
                bi.nvr = bi.nvr or obi.nvr
                bi.arch = bi.arch or obi.arch
        self.digests.update(other.digests)

    def to_blob(self) -> BlobInfo:
        blob = BlobInfo()
        blob.os = self.os
        blob.repository = self.repository
        blob.package_infos = sorted(
            self.package_infos, key=lambda p: p.file_path
        )
        blob.applications = sorted(
            self.applications, key=lambda a: (a.type, a.file_path)
        )
        blob.secrets = sorted(self.secrets, key=lambda s: s.file_path)
        blob.licenses = sorted(self.licenses, key=lambda l: (l.file_path, l.package_name))
        blob.misconfigurations = self.misconfigurations
        blob.custom_resources = self.custom_resources
        blob.build_info = self.build_info
        blob.digests = dict(sorted(self.digests.items()))
        return blob


class Analyzer:
    """Base per-file analyzer."""

    type: str = ""
    version: int = 1

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        raise NotImplementedError

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        raise NotImplementedError


class PostAnalyzer(Analyzer):
    """Analyzer over a set of collected files (virtual FS): lockfile
    parsers that need sibling files, license classifiers, etc."""

    def post_analyze(self, files: dict[str, AnalysisInput]) -> AnalysisResult | None:
        raise NotImplementedError


_ANALYZERS: list[Analyzer] = []
_POST_ANALYZERS: list[PostAnalyzer] = []


def register(a) -> Analyzer:
    """Register an analyzer instance (or class, instantiated here)."""
    _ANALYZERS.append(a() if isinstance(a, type) else a)
    return a


def register_post(a) -> PostAnalyzer:
    _POST_ANALYZERS.append(a() if isinstance(a, type) else a)
    return a


def unregister(a) -> None:
    """Remove a dynamically registered analyzer (module system)."""
    for reg in (_ANALYZERS, _POST_ANALYZERS):
        if a in reg:
            reg.remove(a)



# analyzer type groups (reference pkg/fanal/analyzer/const.go:150-258)
TYPE_OSES = {
    "os-release", "alpine", "amazon", "debian", "photon", "redhat-base",
    "suse", "ubuntu", "ubuntu-esm", "apk", "dpkg", "dpkg-license", "rpm",
    "rpmqa", "apk-repo",
}
TYPE_INDIVIDUAL_PKGS = {
    "gemspec", "node-pkg", "python-pkg", "gobinary", "rustbinary", "jar",
    "conda-pkg", "composer-vendor",
}
# exactly the reference's TypeLockfiles (const.go:211-231): cargo,
# nuget, dotnet-core, packages-props, bun, and julia are NOT in it and
# stay enabled for rootfs/image scans
TYPE_LOCKFILES = {
    "bundler", "npm", "yarn", "pnpm", "pip", "pipenv", "poetry", "uv",
    "gomod", "composer", "pom", "gradle",
    "sbt", "conan", "pub",
    "hex", "swift", "cocoapods", "conda-environment",
}


def _pattern_required(a, path: str, size: int, mode: int) -> bool:
    """required() widened by --file-patterns regexes attached to the
    analyzer copy (reference analyzer.go:321-377 filePatterns)."""
    pats = getattr(a, "extra_patterns", None)
    if pats and any(p.search(path) for p in pats):
        return True
    return a.required(path, size, mode)


@dataclass
class AnalyzerGroup:
    """The set of analyzers active for one scan."""

    analyzers: list[Analyzer]
    post_analyzers: list[PostAnalyzer]

    @classmethod
    def build(
        cls,
        disabled_types: set[str] | None = None,
        enabled_types: set[str] | None = None,
        file_patterns: list[str] | None = None,
        helm_overrides: dict | None = None,
    ) -> "AnalyzerGroup":
        """file_patterns: `analyzer-type:regex` entries (reference
        analyzer.go:321-377 filePatterns) — a file whose path matches the
        regex is fed to that analyzer even if required() declines it."""
        import re as _re

        disabled = disabled_types or set()
        patterns: dict[str, list] = {}
        for entry in file_patterns or []:
            atype, _, pat = entry.partition(":")
            if not pat:
                raise ValueError(
                    f"invalid file pattern {entry!r} (want type:regex)")
            patterns.setdefault(atype, []).append(_re.compile(pat))

        def keep(a: Analyzer) -> bool:
            if a.type in disabled:
                return False
            if enabled_types is not None and a.type not in enabled_types:
                return False
            return True

        # --file-patterns may name an IaC FILE type (dockerfile:...,
        # kubernetes:...); those route to the config analyzer with a
        # detection override (reference: the dockerfile analyzer is its
        # own type, here one config analyzer owns all IaC types)
        iac_types = {"dockerfile", "kubernetes", "terraform",
                     "cloudformation", "terraformplan", "helm",
                     "azure-arm", "yaml", "json"}
        iac_type_pats = [(rx, atype) for atype, rxs in patterns.items()
                         if atype in iac_types for rx in rxs]

        def wrap(a):
            pats = list(patterns.get(a.type) or [])
            type_pats = iac_type_pats if a.type == "config" else []
            if type_pats:
                pats.extend(rx for rx, _t in type_pats)
            overrides = helm_overrides if a.type == "config" else None
            if not pats and not type_pats and not overrides:
                return a
            import copy

            a2 = copy.copy(a)
            if pats:
                a2.extra_patterns = pats
            if type_pats:
                a2.iac_type_patterns = type_pats
            if overrides:
                a2.helm_overrides = overrides
            return a2

        return cls(
            analyzers=[wrap(a) for a in _ANALYZERS if keep(a)],
            post_analyzers=[wrap(a) for a in _POST_ANALYZERS if keep(a)],
        )

    def versions(self) -> dict[str, int]:
        out = {}
        for a in self.analyzers + self.post_analyzers:
            out[a.type] = a.version
        return dict(sorted(out.items()))

    def analyze_file(self, result: AnalysisResult, inp: AnalysisInput,
                     post_files: dict) -> None:
        for a in self.analyzers:
            try:
                if not _pattern_required(a, inp.path, inp.size, inp.mode):
                    continue
                result.merge(a.analyze(inp))
            except Exception as e:  # analyzer bugs must not kill the scan
                if is_device_error(e):
                    raise
                _log.debug("analyzer failed", analyzer=a.type,
                           path=inp.path, err=str(e))
        for pa in self.post_analyzers:
            try:
                if _pattern_required(pa, inp.path, inp.size, inp.mode):
                    inp.read()
                    post_files.setdefault(pa.type, {})[inp.path] = inp
            except Exception as e:
                _log.debug("post-analyzer required() failed",
                           analyzer=pa.type, path=inp.path, err=str(e))

    def post_analyze(self, result: AnalysisResult, post_files: dict) -> None:
        for pa in self.post_analyzers:
            files = post_files.get(pa.type)
            if not files:
                continue
            try:
                result.merge(pa.post_analyze(files))
            except Exception as e:
                if is_device_error(e):
                    raise
                _log.warn("post-analyzer failed", analyzer=pa.type, err=str(e))


def matches_any(path: str, patterns: list[str]) -> bool:
    base = os.path.basename(path)
    for pat in patterns:
        if fnmatch.fnmatch(path, pat) or fnmatch.fnmatch(base, pat):
            return True
    return False
