"""dpkg status DB analyzer (reference pkg/fanal/analyzer/pkg/dpkg/):
- var/lib/dpkg/status and var/lib/dpkg/status.d/* stanzas
- var/lib/dpkg/info/*.list -> per-package installed files
- dpkg copyright files -> package licenses (analyzer/pkg/dpkg/copyright)

Copy of trivy_tpu/fanal/analyzers/pkg_dpkg.py.
"""

from __future__ import annotations

import os
import re

from trivy_tpu_torch.fanal.analyzer import (
    AnalysisInput,
    AnalysisResult,
    PostAnalyzer,
    register_post,
)
from trivy_tpu_torch.types.artifact import (
    LicenseFile,
    LicenseFinding,
    Package,
    PackageInfo,
)

_SRC_RX = re.compile(r"^(?P<name>[^\s(]+)(?:\s+\((?P<ver>[^)]+)\))?$")


def _parse_version(pkg: Package, ver: str, into_src: bool) -> None:
    epoch = 0
    if ":" in ver:
        e, _, rest = ver.partition(":")
        if e.isdigit():
            epoch, ver = int(e), rest
    version, release = ver, ""
    if "-" in ver:
        version, _, release = ver.rpartition("-")
    if into_src:
        pkg.src_epoch, pkg.src_version, pkg.src_release = epoch, version, release
    else:
        pkg.epoch, pkg.version, pkg.release = epoch, version, release


def parse_dpkg_status(text: str) -> list[Package]:
    pkgs: list[Package] = []
    for stanza in re.split(r"\n\s*\n", text):
        fields: dict[str, str] = {}
        key = None
        for line in stanza.splitlines():
            if line[:1] in (" ", "\t"):
                if key:
                    fields[key] += "\n" + line.strip()
                continue
            if ":" not in line:
                continue
            key, _, val = line.partition(":")
            fields[key.strip()] = val.strip()
        name = fields.get("Package", "")
        version = fields.get("Version", "")
        if not name or not version:
            continue
        status = fields.get("Status", "")
        if status and "installed" not in status.split():
            continue
        pkg = Package(name=name, arch=fields.get("Architecture", ""),
                      maintainer=fields.get("Maintainer", ""))
        _parse_version(pkg, version, into_src=False)
        src = fields.get("Source", "")
        if src:
            m = _SRC_RX.match(src)
            if m:
                pkg.src_name = m.group("name")
                if m.group("ver"):
                    _parse_version(pkg, m.group("ver"), into_src=True)
        if not pkg.src_name:
            pkg.src_name = pkg.name
        if not pkg.src_version:
            pkg.src_epoch = pkg.epoch
            pkg.src_version = pkg.version
            pkg.src_release = pkg.release
        pkg.id = f"{pkg.name}@{pkg.full_version()}"
        dep = fields.get("Depends", "") + "," + fields.get("Pre-Depends", "")
        raw_deps = []
        for d in dep.split(","):
            d = d.strip().split(" ")[0].split(":")[0]
            if d:
                raw_deps.append(d)
        pkg.depends_on = raw_deps  # resolved to ids after all stanzas
        pkgs.append(pkg)
    # resolve dependency names to ids
    by_name = {p.name: p.id for p in pkgs}
    for p in pkgs:
        p.depends_on = sorted(
            {by_name[d] for d in p.depends_on if d in by_name and by_name[d] != p.id}
        )
    return pkgs


_COMMON_LICENSES = [
    "Apache-2.0", "Artistic-2.0", "BSD-2-Clause", "BSD-3-Clause",
    "BSD-4-Clause", "GFDL-1.2", "GFDL-1.3", "GPL-1.0", "GPL-2.0",
    "GPL-3.0", "LGPL-2.0", "LGPL-2.1", "LGPL-3.0", "MPL-1.1", "MPL-2.0",
    "CC0-1.0", "MIT", "ISC", "Zlib",
]


def parse_copyright(text: str) -> list[str]:
    """Extract license names from a Debian machine-readable copyright file
    (License: lines) or by common-license heuristics
    (reference analyzer/pkg/dpkg/copyright.go)."""
    out: list[str] = []
    for line in text.splitlines():
        if line.startswith("License:"):
            name = line.split(":", 1)[1].strip()
            if name and name not in out:
                out.append(name)
    if not out:
        for lic in _COMMON_LICENSES:
            token = lic.replace("-", " ").split(" ")[0].lower()
            if re.search(rf"/usr/share/common-licenses/{re.escape(lic)}", text) or (
                token in ("mit", "isc", "zlib")
                and re.search(rf"\b{token}\b license", text, re.I)
            ):
                if lic not in out:
                    out.append(lic)
    return out


@register_post
class DpkgAnalyzer(PostAnalyzer):
    type = "dpkg"
    version = 1

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        if path == "var/lib/dpkg/status":
            return True
        if path.startswith("var/lib/dpkg/status.d/") and not path.endswith(".md5sums"):
            return True
        if path.startswith("var/lib/dpkg/info/") and path.endswith(".list"):
            return True
        return False

    def post_analyze(self, files: dict[str, AnalysisInput]) -> AnalysisResult | None:
        res = AnalysisResult()
        # installed-files lists keyed by package name (info/<pkg>[:arch].list)
        listed: dict[str, list[str]] = {}
        for path, inp in files.items():
            if path.startswith("var/lib/dpkg/info/"):
                base = os.path.basename(path)[: -len(".list")]
                name = base.split(":")[0]
                file_list = [
                    l.strip() for l in inp.read().decode("utf-8", "replace").splitlines()
                    if l.strip() and l.strip() != "/."
                ]
                listed[name] = file_list
                res.system_installed_files.extend(file_list)
        for path, inp in sorted(files.items()):
            if path.startswith("var/lib/dpkg/info/"):
                continue
            pkgs = parse_dpkg_status(inp.read().decode("utf-8", "replace"))
            if not pkgs:
                continue
            for p in pkgs:
                if p.name in listed:
                    p.installed_files = listed[p.name]
            res.package_infos.append(PackageInfo(file_path=path, packages=pkgs))
        return res if res.package_infos or res.system_installed_files else None


@register_post
class DpkgLicenseAnalyzer(PostAnalyzer):
    type = "dpkg-license"
    version = 1

    _RX = re.compile(r"^usr/share/doc/(?P<pkg>[^/]+)/copyright$")

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return bool(self._RX.match(path))

    def post_analyze(self, files: dict[str, AnalysisInput]) -> AnalysisResult | None:
        res = AnalysisResult()
        for path, inp in sorted(files.items()):
            m = self._RX.match(path)
            licenses = parse_copyright(inp.read().decode("utf-8", "replace"))
            if not licenses:
                continue
            res.licenses.append(LicenseFile(
                type="dpkg",
                file_path=path,
                package_name=m.group("pkg"),
                findings=[LicenseFinding(name=n) for n in licenses],
            ))
        return res if res.licenses else None
