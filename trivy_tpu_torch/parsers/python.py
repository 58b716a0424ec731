"""Python parsers (reference pkg/dependency/parser/python/*):
requirements.txt, Pipfile.lock, poetry.lock, uv.lock, and installed
dist-info/egg-info METADATA.

Copy of trivy_tpu/parsers/python.py.
"""

from __future__ import annotations

import json
import re

from trivy_tpu_torch.types.artifact import Location, Package


def _mk(name: str, version: str, **kw) -> Package:
    return Package(id=f"{name}@{version}", name=name, version=version, **kw)


_REQ_RX = re.compile(
    r"^(?P<name>[A-Za-z0-9._-]+)\s*(?:\[[^\]]*\])?\s*==\s*(?P<ver>[^;#\s\\]+)"
)


def parse_requirements(content: bytes) -> list[Package]:
    """Only pinned (==) requirements are packages (reference
    parser/python/pip: non-pinned lines are skipped)."""
    out = []
    for i, line in enumerate(content.decode("utf-8", "replace").splitlines(), 1):
        line = line.strip()
        if not line or line.startswith(("#", "-")):
            continue
        m = _REQ_RX.match(line)
        if not m:
            continue
        ver = m.group("ver").strip()
        # skip environment-marker-only or wildcard pins
        if ver.endswith(".*"):
            continue
        pkg = _mk(m.group("name"), ver)
        pkg.locations = [Location(i, i)]
        out.append(pkg)
    return out


def parse_pipfile_lock(content: bytes) -> list[Package]:
    doc = json.loads(content)
    out = []
    for section, dev in (("default", False), ("develop", True)):
        for name, meta in (doc.get(section) or {}).items():
            version = (meta.get("version") or "").lstrip("=")
            if not version:
                continue
            out.append(_mk(name, version, dev=dev))
    return sorted(out, key=lambda p: p.id)


def parse_poetry_lock(content: bytes) -> list[Package]:
    try:
        import tomllib
    except ImportError:  # Python <= 3.10: stdlib tomllib is 3.11+
        from trivy_tpu_torch.parsers import toml_compat as tomllib

    doc = tomllib.loads(content.decode("utf-8", "replace"))
    out = []
    for meta in doc.get("package") or []:
        name, version = meta.get("name"), meta.get("version")
        if not name or not version:
            continue
        pkg = _mk(name, version)
        pkg.depends_on = sorted(
            f"{d}" for d in (meta.get("dependencies") or {})
        )
        if meta.get("category") == "dev":
            pkg.dev = True
        out.append(pkg)
    # resolve dependency names to ids
    by_name = {p.name.lower(): p.id for p in out}
    for p in out:
        p.depends_on = sorted(
            {by_name[d.lower()] for d in p.depends_on if d.lower() in by_name}
        )
    return sorted(out, key=lambda p: p.id)


def parse_uv_lock(content: bytes) -> list[Package]:
    try:
        import tomllib
    except ImportError:  # Python <= 3.10: stdlib tomllib is 3.11+
        from trivy_tpu_torch.parsers import toml_compat as tomllib

    doc = tomllib.loads(content.decode("utf-8", "replace"))
    out = []
    for meta in doc.get("package") or []:
        name, version = meta.get("name"), meta.get("version")
        if not name or not version:
            continue
        if meta.get("source", {}).get("virtual"):
            continue  # the project itself
        pkg = _mk(name, version)
        pkg.depends_on = sorted(
            d.get("name", "") for d in (meta.get("dependencies") or [])
            if isinstance(d, dict)
        )
        out.append(pkg)
    by_name = {p.name.lower(): p.id for p in out}
    for p in out:
        p.depends_on = sorted(
            {by_name[d.lower()] for d in p.depends_on if d.lower() in by_name}
        )
    return sorted(out, key=lambda p: p.id)


def _norm_name(name: str) -> str:
    """PEP 503 name normalization (reference parser/python NormalizePkgName)."""
    return re.sub(r"[-_.]+", "-", name).lower()


def parse_pyproject(content: bytes) -> dict:
    """pyproject.toml (PEP 518) -> {"dependencies": set of direct poetry
    dep names, "groups": {group: set}} (reference
    parser/python/pyproject/pyproject.go:14-45).  Used to mark
    direct/dev relationships on poetry.lock packages."""
    try:
        import tomllib
    except ImportError:  # Python <= 3.10: stdlib tomllib is 3.11+
        from trivy_tpu_torch.parsers import toml_compat as tomllib

    doc = tomllib.loads(content.decode("utf-8", "replace"))
    poetry = (doc.get("tool") or {}).get("poetry") or {}
    deps = {_norm_name(n) for n in (poetry.get("dependencies") or {})}
    groups = {
        gname: {_norm_name(n) for n in (g.get("dependencies") or {})}
        for gname, g in (poetry.get("group") or {}).items()
    }
    # PEP 621 project dependencies supplement the poetry table
    for spec in (doc.get("project") or {}).get("dependencies") or []:
        m = re.match(r"[A-Za-z0-9._-]+", spec)
        if m:
            deps.add(_norm_name(m.group(0)))
    return {"dependencies": deps, "groups": groups}


_META_NAME = re.compile(r"^Name: (.+)$", re.M)
_META_VERSION = re.compile(r"^Version: (.+)$", re.M)
_META_LICENSE = re.compile(r"^License: (.+)$", re.M)
_META_LICENSE_EXPR = re.compile(r"^License-Expression: (.+)$", re.M)


def parse_dist_metadata(content: bytes) -> Package | None:
    """dist-info/METADATA or egg-info/PKG-INFO -> python-pkg."""
    text = content.decode("utf-8", "replace")
    mn = _META_NAME.search(text)
    mv = _META_VERSION.search(text)
    if not mn or not mv:
        return None
    pkg = _mk(mn.group(1).strip(), mv.group(1).strip())
    ml = _META_LICENSE_EXPR.search(text) or _META_LICENSE.search(text)
    if ml:
        lic = ml.group(1).strip()
        if lic and lic != "UNKNOWN" and len(lic) < 200:
            pkg.licenses = [lic]
    return pkg
