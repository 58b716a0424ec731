"""Package URL (purl) parsing and mapping to trivy types
(reference pkg/purl/purl.go).

Copy of trivy_tpu/utils/purl.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from urllib.parse import quote, unquote


@dataclass
class PackageURL:
    type: str = ""
    namespace: str = ""
    name: str = ""
    version: str = ""
    qualifiers: dict[str, str] = field(default_factory=dict)
    subpath: str = ""

    def __str__(self) -> str:
        out = f"pkg:{self.type}/"
        if self.namespace:
            out += quote(self.namespace, safe="/") + "/"
        out += quote(self.name, safe="")
        if self.version:
            out += "@" + quote(self.version, safe="")
        if self.qualifiers:
            q = "&".join(f"{k}={quote(str(v), safe='')}"
                         for k, v in sorted(self.qualifiers.items()))
            out += "?" + q
        if self.subpath:
            out += "#" + self.subpath
        return out

    @property
    def full_name(self) -> str:
        """Name as the detector expects (maven: group:artifact,
        golang/npm scoped: namespace/name; OS purls: the namespace is the
        distro, not part of the package name)."""
        if not self.namespace or self.type in ("apk", "deb", "rpm"):
            return self.name
        if self.type == "maven":
            return f"{self.namespace}:{self.name}"
        return f"{self.namespace}/{self.name}"


def parse_purl(s: str) -> PackageURL:
    if not s.startswith("pkg:"):
        raise ValueError(f"not a purl: {s!r}")
    rest = s[4:]
    subpath = ""
    if "#" in rest:
        rest, subpath = rest.split("#", 1)
    qualifiers: dict[str, str] = {}
    if "?" in rest:
        rest, q = rest.split("?", 1)
        for pair in q.split("&"):
            if "=" in pair:
                k, v = pair.split("=", 1)
                qualifiers[k] = unquote(v)
    version = ""
    if "@" in rest:
        rest, version = rest.rsplit("@", 1)
        version = unquote(version)
    parts = [unquote(p) for p in rest.strip("/").split("/")]
    ptype = parts[0].lower()
    if len(parts) < 2:
        raise ValueError(f"purl missing name: {s!r}")
    name = parts[-1]
    namespace = "/".join(parts[1:-1])
    return PackageURL(ptype, namespace, name, version, qualifiers, subpath)


# purl type -> (kind, type string) where kind is "os" | "lang"
# (reference pkg/purl/purl.go purlType/LangType mapping)
_PURL_LANG = {
    "npm": "node-pkg",
    "pypi": "python-pkg",
    "gem": "gemspec",
    "maven": "jar",
    "golang": "gobinary",
    "cargo": "rustbinary",
    "composer": "composer-vendor",
    "nuget": "nuget",
    "pub": "pub",
    "hex": "hex",
    "conan": "conan",
    "swift": "swift",
    "cocoapods": "cocoapods",
    "conda": "conda-pkg",
    "bitnami": "bitnami",
    "k8s": "kubernetes",
    "julia": "julia",
}
_PURL_OS = {"apk", "deb", "rpm"}


def purl_kind(p: PackageURL) -> tuple[str, str] | None:
    """-> ("os", family) or ("lang", lang_type) or None."""
    if p.type in _PURL_OS:
        distro = p.namespace or p.qualifiers.get("distro", "").split("-")[0]
        return ("os", distro)
    lt = _PURL_LANG.get(p.type)
    if lt:
        return ("lang", lt)
    return None


def purl_for_package(kind: str, type_str: str, name: str, version: str,
                     namespace_hint: str = "") -> str:
    """Best-effort purl construction for report output
    (reference pkg/purl/purl.go New)."""
    type_map = {
        "node-pkg": "npm", "npm": "npm", "yarn": "npm", "pnpm": "npm",
        "bun": "npm", "javascript": "npm",
        "python-pkg": "pypi", "pip": "pypi", "pipenv": "pypi",
        "poetry": "pypi", "uv": "pypi",
        "gemspec": "gem", "bundler": "gem",
        "jar": "maven", "pom": "maven", "gradle": "maven",
        "sbt": "maven",
        "gobinary": "golang", "gomod": "golang",
        "rustbinary": "cargo", "cargo": "cargo",
        "composer": "composer", "composer-vendor": "composer",
        "nuget": "nuget", "dotnet-core": "nuget", "packages-props": "nuget",
        "pub": "pub", "hex": "hex", "conan": "conan", "swift": "swift",
        "cocoapods": "cocoapods", "conda-pkg": "conda",
        "conda-environment": "conda", "bitnami": "bitnami",
        "kubernetes": "k8s", "julia": "julia",
    }
    if kind == "os":
        ptype = type_str  # apk/deb/rpm family passed through
        ns, nm = "", name
    else:
        ptype = type_map.get(type_str, type_str)
        ns, nm = "", name
        if ptype == "maven" and ":" in name:
            ns, nm = name.split(":", 1)
        elif ptype in ("npm", "golang") and "/" in name:
            ns, nm = name.rsplit("/", 1)
    return str(PackageURL(type=ptype, namespace=ns, name=nm, version=version))
