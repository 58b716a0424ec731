"""OS detection analyzers (reference pkg/fanal/analyzer/os/*):
/etc/os-release (+usr/lib), alpine-release, debian_version,
redhat/centos/oracle/rocky/alma release files, apk repositories.

Copy of trivy_tpu/fanal/analyzers/os_release.py.
"""

from __future__ import annotations

import re

from trivy_tpu_torch.fanal.analyzer import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    register,
)
from trivy_tpu_torch.types.artifact import OS, Repository

# os-release ID= -> family (reference analyzer/os/release/release.go)
_ID_FAMILY = {
    "alpine": "alpine",
    "opensuse-leap": "opensuse-leap",
    "opensuse-tumbleweed": "opensuse-tumbleweed",
    "opensuse": "opensuse",
    "sles": "suse linux enterprise server",
    "sle-micro": "suse linux enterprise micro",
    "amzn": "amazon",
    "ol": "oracle",
    "fedora": "fedora",
    "rhel": "redhat",
    "centos": "centos",
    "rocky": "rocky",
    "almalinux": "alma",
    "mariner": "cbl-mariner",
    "azurelinux": "azurelinux",
    "wolfi": "wolfi",
    "chainguard": "chainguard",
    "minimos": "minimos",
    "photon": "photon",
    "debian": "debian",
    "ubuntu": "ubuntu",
    "echo": "echo",
}


def _parse_os_release(text: str) -> dict[str, str]:
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        k, _, v = line.partition("=")
        out[k.strip()] = v.strip().strip('"').strip("'")
    return out


@register
class OSReleaseAnalyzer(Analyzer):
    type = "os-release"
    version = 1

    PATHS = ("etc/os-release", "usr/lib/os-release")

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return path in self.PATHS

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        kv = _parse_os_release(inp.read().decode("utf-8", "replace"))
        family = _ID_FAMILY.get(kv.get("ID", "").lower())
        if family is None:
            return None
        version = kv.get("VERSION_ID", "")
        if not version and family in ("wolfi", "chainguard", "minimos",
                                      "opensuse-tumbleweed", "echo"):
            version = kv.get("BUILD_ID", "")  # rolling
        res = AnalysisResult()
        res.os = OS(family=family, name=version)
        return res


@register
class AlpineReleaseAnalyzer(Analyzer):
    type = "alpine"
    version = 1

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return path == "etc/alpine-release"

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        version = inp.read().decode("utf-8", "replace").strip()
        if not version:
            return None
        res = AnalysisResult()
        res.os = OS(family="alpine", name=version)
        return res


@register
class DebianVersionAnalyzer(Analyzer):
    type = "debian"
    version = 1

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return path == "etc/debian_version"

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        version = inp.read().decode("utf-8", "replace").strip()
        if not version or "/" in version:  # "bookworm/sid" -> not a release
            return None
        res = AnalysisResult()
        res.os = OS(family="debian", name=version)
        return res


_RH_RELEASE = re.compile(r"(?P<name>.+) release (?P<ver>[\d.]+)")

_RH_FILES = {
    "etc/redhat-release": None,  # name decides
    "etc/centos-release": "centos",
    "etc/rocky-release": "rocky",
    "etc/almalinux-release": "alma",
    "etc/oracle-release": "oracle",
    "etc/fedora-release": "fedora",
    "etc/system-release": None,
    "usr/lib/fedora-release": "fedora",
}


@register
class RedHatBaseAnalyzer(Analyzer):
    type = "redhat-base"
    version = 1

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return path in _RH_FILES

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        text = inp.read().decode("utf-8", "replace").strip()
        m = _RH_RELEASE.match(text)
        if not m:
            return None
        family = _RH_FILES.get(inp.path)
        if family is None:
            name = m.group("name").lower()
            if "centos" in name:
                family = "centos"
            elif "rocky" in name:
                family = "rocky"
            elif "alma" in name:
                family = "alma"
            elif "oracle" in name:
                family = "oracle"
            elif "fedora" in name:
                family = "fedora"
            elif "amazon" in name:
                family = "amazon"
            else:
                family = "redhat"
        res = AnalysisResult()
        res.os = OS(family=family, name=m.group("ver"))
        return res


@register
class ApkRepoAnalyzer(Analyzer):
    """Alpine repository release detection from /etc/apk/repositories
    (reference analyzer/repo/apk.go): lets the detector use the repo
    stream (e.g. edge) over the os-release version."""

    type = "apk-repo"
    version = 1

    _RX = re.compile(
        r"https?://.*/alpine/(?P<ver>v\d+\.\d+|edge|latest-stable)/"
    )

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return path == "etc/apk/repositories"

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        newest = None
        for line in inp.read().decode("utf-8", "replace").splitlines():
            m = self._RX.search(line.strip())
            if not m:
                continue
            ver = m.group("ver").lstrip("v")
            if ver == "latest-stable":
                continue
            if newest is None or _repo_newer(ver, newest):
                newest = ver
        if newest is None:
            return None
        res = AnalysisResult()
        res.repository = Repository(family="alpine", release=newest)
        return res


def _repo_newer(a: str, b: str) -> bool:
    if a == "edge":
        return True
    if b == "edge":
        return False
    try:
        pa = tuple(int(x) for x in a.split("."))
        pb = tuple(int(x) for x in b.split("."))
        return pa > pb
    except ValueError:
        return False
