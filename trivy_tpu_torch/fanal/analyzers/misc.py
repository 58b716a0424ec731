"""Remaining special-purpose analyzers (reference pkg/fanal/analyzer):

- rpmqa: CBL-Mariner distroless rpm manifest (pkg/rpm/rpmqa.go)
- buildinfo: Red Hat content manifests + buildinfo Dockerfiles
  (buildinfo/{content_manifest,dockerfile}.go)
- executable: sha256 digests of unpackaged binaries for rekor SBOM
  discovery (executable/executable.go)
- sbom: SBOM documents shipped inside images, e.g. Bitnami
  (sbom/sbom.go)

Copy of trivy_tpu/fanal/analyzers/misc.py.
"""

from __future__ import annotations

import json
import re
import stat

from trivy_tpu_torch.fanal.analyzer import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    register,
)
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.types.artifact import BuildInfo, Package, PackageInfo

_log = logger("analyzer")


@register
class RpmqaAnalyzer(Analyzer):
    """var/lib/rpmmanifest/container-manifest-2: `rpm -qa --qf` dump
    with 10 tab-separated fields (reference rpmqa.go:28-78)."""

    type = "rpmqa"
    version = 1

    _FILES = ("var/lib/rpmmanifest/container-manifest-2",)

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return path in self._FILES

    def analyze(self, inp: AnalysisInput):
        pkgs = []
        for line in inp.read().decode("utf-8", "replace").splitlines():
            fields = line.split("\t")
            if len(fields) != 10:
                continue
            name, ver_rel, arch, src_rpm = (
                fields[0], fields[1], fields[7], fields[9])
            version, _, release = ver_rel.partition("-")
            src_name, src_ver, src_rel = _parse_source_rpm(src_rpm)
            pkgs.append(Package(
                id=f"{name}@{ver_rel}",
                name=name, version=version, release=release, arch=arch,
                src_name=src_name or name,
                src_version=src_ver or version,
                src_release=src_rel or release,
            ))
        if not pkgs:
            return None
        res = AnalysisResult()
        res.package_infos = [PackageInfo(file_path=inp.path, packages=pkgs)]
        return res


def _parse_source_rpm(src: str) -> tuple[str, str, str]:
    """name-version-release.src.rpm -> (name, version, release)."""
    if not src or src == "(none)":
        return "", "", ""
    base = src.removesuffix(".src.rpm")
    m = re.match(r"(.+)-([^-]+)-([^-]+)$", base)
    if not m:
        return "", "", ""
    return m.group(1), m.group(2), m.group(3)


@register
class ContentManifestAnalyzer(Analyzer):
    """root/buildinfo/content_manifests/*.json -> BuildInfo.content_sets
    (reference buildinfo/content_manifest.go)."""

    type = "redhat-content-manifest"
    version = 1

    _DIRS = ("root/buildinfo/content_manifests/", "usr/share/buildinfo/")

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        d, _, f = path.rpartition("/")
        return (d + "/") in self._DIRS and f.endswith(".json")

    def analyze(self, inp: AnalysisInput):
        try:
            doc = json.loads(inp.read())
        except ValueError:
            return None
        sets = doc.get("content_sets") or []
        if not sets:
            return None
        res = AnalysisResult()
        res.build_info = BuildInfo(content_sets=list(sets))
        return res


_NVR_VERSION_RE = re.compile(r"-(\d[^-]*-\d[^-]*)$")


@register
class RedHatDockerfileAnalyzer(Analyzer):
    """root/buildinfo/Dockerfile-<name>-<version>-<release>: NVR from
    the filename + labels (reference buildinfo/dockerfile.go)."""

    type = "redhat-dockerfile"
    version = 1

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        d, _, f = path.rpartition("/")
        return d == "root/buildinfo" and f.startswith("Dockerfile")

    def analyze(self, inp: AnalysisInput):
        text = inp.read().decode("utf-8", "replace")
        component = arch = ""
        for m in re.finditer(
                r'^\s*LABEL\s+(.+?)(?<!\\)$',
                text, re.M | re.S):
            for key, value in re.findall(
                    r'([\w.\-]+)=("?[^"\s]+"?|"[^"]*")', m.group(1)):
                key = key.lower()
                value = value.strip('"')
                if key in ("com.redhat.component", "bzcomponent"):
                    component = value
                elif key == "architecture":
                    arch = value
        if not component or not arch:
            return None
        m = _NVR_VERSION_RE.search(inp.path.rpartition("/")[2])
        version = m.group(1) if m else ""
        res = AnalysisResult()
        res.build_info = BuildInfo(
            nvr=f"{component}-{version}" if version else component,
            arch=arch)
        return res


_ELF_MAGICS = (b"\x7fELF", b"MZ", b"\xcf\xfa\xed\xfe", b"\xfe\xed\xfa\xcf",
               b"\xca\xfe\xba\xbe")


@register
class ExecutableAnalyzer(Analyzer):
    """sha256 digests of executable binaries not managed by any package
    manager, so the unpackaged handler can look up SBOM attestations in
    rekor (reference executable/executable.go)."""

    type = "executable"
    version = 1

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        if size < 64 or size > 512 * 1024 * 1024:
            return False
        return bool(mode & (stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH))

    def analyze(self, inp: AnalysisInput):
        import hashlib

        content = inp.read()
        if content[:4][:2] not in (m[:2] for m in _ELF_MAGICS) and \
                not any(content.startswith(m) for m in _ELF_MAGICS):
            return None
        res = AnalysisResult()
        res.digests = {
            inp.path: "sha256:" + hashlib.sha256(content).hexdigest()}
        return res


@register
class SbomAnalyzer(Analyzer):
    """SBOM documents found inside artifacts (reference sbom/sbom.go):
    *.spdx(.json) / *.cdx(.json) decode into packages/applications;
    Bitnami app dirs get their file paths rewritten so components
    resolve to the shipped location."""

    type = "sbom"
    version = 1

    _SUFFIXES = (".spdx", ".spdx.json", ".cdx", ".cdx.json")

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        base = path.rpartition("/")[2]
        return base.endswith(self._SUFFIXES) or (
            base.startswith(".spdx-") and path.startswith("opt/bitnami/"))

    def analyze(self, inp: AnalysisInput):
        from trivy_tpu_torch.sbom.decode import decode_sbom_bytes

        try:
            blob, _meta = decode_sbom_bytes(inp.read())
        except ValueError as e:
            _log.debug("in-image SBOM decode failed", path=inp.path,
                       err=str(e))
            return None
        res = AnalysisResult()
        res.package_infos = blob.package_infos
        res.applications = blob.applications
        if inp.path.startswith("opt/bitnami/"):
            app_dir = inp.path.rpartition("/")[0]
            for app in res.applications:
                for pkg in app.packages:
                    if not pkg.file_path:
                        pkg.file_path = app_dir
        for app in res.applications:
            if not app.file_path:
                app.file_path = inp.path
        return res
