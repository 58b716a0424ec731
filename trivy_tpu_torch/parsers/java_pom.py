"""Maven pom.xml parser (reference pkg/dependency/parser/java/pom):
property interpolation (${...} incl. project.* and parent-inherited
values), dependencyManagement version resolution, and dependency
extraction. Offline only — no remote-repository resolution; versions
that stay unresolved after interpolation are dropped, mirroring the
reference's offline mode.

Copy of trivy_tpu/parsers/java_pom.py.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET

from trivy_tpu_torch.types.artifact import Package

_PROP_RX = re.compile(r"\$\{([^}]+)\}")


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _to_dict(elem) -> dict:
    out = {}
    for child in elem:
        out.setdefault(_strip_ns(child.tag), []).append(child)
    return out


def _text(elem, name: str) -> str:
    for child in elem:
        if _strip_ns(child.tag) == name:
            return (child.text or "").strip()
    return ""


def _interpolate(value: str, props: dict[str, str], depth: int = 0) -> str:
    if not value or "${" not in value or depth > 8:
        return value

    def repl(m):
        return props.get(m.group(1), m.group(0))

    new = _PROP_RX.sub(repl, value)
    if new != value:
        return _interpolate(new, props, depth + 1)
    return new


def parse_pom(content: bytes) -> list[Package]:
    """-> [project artifact] + its dependencies (resolvable versions only)."""
    try:
        root = ET.fromstring(content)
    except ET.ParseError:
        return []
    if _strip_ns(root.tag) != "project":
        return []

    parent = None
    for child in root:
        if _strip_ns(child.tag) == "parent":
            parent = child
            break

    group = _text(root, "groupId") or (parent is not None and _text(parent, "groupId")) or ""
    artifact = _text(root, "artifactId")
    version = _text(root, "version") or (parent is not None and _text(parent, "version")) or ""

    # property table: <properties>, project.* built-ins, parent echoes
    props: dict[str, str] = {}
    for child in root:
        if _strip_ns(child.tag) == "properties":
            for p in child:
                props[_strip_ns(p.tag)] = (p.text or "").strip()
    props.setdefault("project.groupId", group or "")
    props.setdefault("project.version", version or "")
    props.setdefault("project.artifactId", artifact or "")
    props.setdefault("pom.groupId", group or "")
    props.setdefault("pom.version", version or "")
    if parent is not None:
        props.setdefault("project.parent.groupId", _text(parent, "groupId"))
        props.setdefault("project.parent.version", _text(parent, "version"))

    group = _interpolate(group, props)
    version = _interpolate(version, props)

    # dependencyManagement pins: (group:artifact) -> version
    managed: dict[str, str] = {}
    for dm in root.iter():
        if _strip_ns(dm.tag) != "dependencyManagement":
            continue
        for dep in dm.iter():
            if _strip_ns(dep.tag) != "dependency":
                continue
            g = _interpolate(_text(dep, "groupId"), props)
            a = _interpolate(_text(dep, "artifactId"), props)
            v = _interpolate(_text(dep, "version"), props)
            if g and a and v and "${" not in v:
                managed[f"{g}:{a}"] = v

    out: list[Package] = []
    if group and artifact and version and "${" not in version:
        out.append(Package(
            id=f"{group}:{artifact}@{version}",
            name=f"{group}:{artifact}", version=version,
        ))

    seen = set()
    deps_root = None
    for child in root:
        if _strip_ns(child.tag) == "dependencies":
            deps_root = child
            break
    if deps_root is None:
        return out
    for dep in deps_root:
        if _strip_ns(dep.tag) != "dependency":
            continue
        g = _interpolate(_text(dep, "groupId"), props)
        a = _interpolate(_text(dep, "artifactId"), props)
        v = _interpolate(_text(dep, "version"), props)
        scope = _text(dep, "scope")
        if scope in ("test", "provided", "system"):
            continue
        if not v:
            v = managed.get(f"{g}:{a}", "")
        if not (g and a and v) or "${" in v or "${" in g or "${" in a:
            continue
        name = f"{g}:{a}"
        if name in seen:
            continue
        seen.add(name)
        out.append(Package(id=f"{name}@{v}", name=name, version=v))
    return out
