"""Go parsers (reference pkg/dependency/parser/golang/{mod,binary}):
go.mod requires (honoring replace directives) and Go-binary embedded
build info.

Copy of trivy_tpu/parsers/golang.py.
"""

from __future__ import annotations

import re

from trivy_tpu_torch.types.artifact import Package


def _mk(name: str, version: str, **kw) -> Package:
    # go module versions keep their "v" prefix (reference
    # pkg/dependency/parser/golang/mod reports "v2.7.1+incompatible")
    return Package(id=f"{name}@{version}", name=name,
                   version=version, **kw)


_REQ_BLOCK = re.compile(r"require\s*\(([^)]*)\)", re.S)
_REQ_LINE = re.compile(r"require\s+([^\s(]+)\s+(\S+)")
_MOD_LINE = re.compile(r"^\s*([^\s]+)\s+(v[^\s/]+)(\s*//\s*indirect)?", re.M)
_REPLACE_BLOCK = re.compile(r"replace\s*\(([^)]*)\)", re.S)
_REPLACE_LINE = re.compile(
    r"(?:^|\n)\s*([^\s=]+)(?:\s+(v\S+))?\s*=>\s*([^\s]+)(?:\s+(v\S+))?"
)


def parse_go_mod(content: bytes) -> list[Package]:
    text = content.decode("utf-8", "replace")
    pkgs: dict[str, Package] = {}
    for block in _REQ_BLOCK.findall(text):
        for m in _MOD_LINE.finditer(block):
            name, ver, indirect = m.group(1), m.group(2), bool(m.group(3))
            pkgs[name] = _mk(name, ver, indirect=indirect,
                             relationship="indirect" if indirect else "direct")
    for m in _REQ_LINE.finditer(re.sub(_REQ_BLOCK, "", text)):
        name, ver = m.group(1), m.group(2)
        indirect = "// indirect" in text.split(name, 1)[-1].split("\n", 1)[0]
        pkgs[name] = _mk(name, ver, indirect=indirect,
                         relationship="indirect" if indirect else "direct")
    # replace directives override
    replaces = []
    for block in _REPLACE_BLOCK.findall(text):
        replaces.extend(_REPLACE_LINE.findall(block))
    replaces.extend(
        _REPLACE_LINE.findall(re.sub(_REPLACE_BLOCK, "", text))
    )
    for old, _old_v, new, new_v in replaces:
        if old in pkgs and new_v:
            prev = pkgs.pop(old)
            # the replacement inherits the replaced module's position in
            # the graph (a replaced direct dep is still a direct dep)
            pkgs[new] = _mk(new, new_v, indirect=prev.indirect,
                            relationship=prev.relationship)
    out = sorted(pkgs.values(), key=lambda p: p.id)
    # the main module is the graph ROOT (reference golang/mod parser):
    # VEX products name it (pkg:golang/<module>) with the vulnerable
    # dependency as subcomponent, so reachability needs the edge. Empty
    # version keeps it out of vulnerability matching (detect_app skips
    # empty packages).
    m = re.search(r"^module\s+(\S+)", text, re.M)
    if m:
        root = _mk(m.group(1), "", relationship="root")
        root.depends_on = [p.id for p in out
                           if p.relationship == "direct"]
        out.insert(0, root)
    return out


_BUILDINFO_MAGIC = b"\xff Go buildinf:"


def parse_go_binary(content: bytes) -> list[Package]:
    """Extract the embedded module list from a Go binary (buildinfo blob,
    go1.18+ inline format)."""
    idx = content.find(_BUILDINFO_MAGIC)
    if idx < 0:
        return []
    hdr = content[idx: idx + 32]
    if len(hdr) < 32:
        return []
    flags = hdr[15]
    if not flags & 0x2:
        # old pointer-based format: would need to follow pointers; skip
        return []
    # inline format: two varint-prefixed strings follow the 32-byte header
    p = idx + 32

    def read_string(pos):
        n = 0
        shift = 0
        while True:
            b = content[pos]
            pos += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return content[pos: pos + n].decode("utf-8", "replace"), pos + n

    try:
        go_version, p = read_string(p)
        modinfo, p = read_string(p)
    except (IndexError, UnicodeDecodeError):
        return []
    pkgs: list[Package] = []
    if go_version.startswith("go"):
        pkgs.append(_mk("stdlib", go_version[2:].split(" ")[0]))
    for line in modinfo.split("\n"):
        parts = line.split("\t")
        if len(parts) >= 3 and parts[0] in ("dep", "mod"):
            name, ver = parts[1], parts[2]
            if ver and ver != "(devel)":
                pkgs.append(_mk(name, ver))
    return pkgs


def parse_go_sum(content: bytes) -> list[Package]:
    """go.sum (reference pkg/dependency/parser/golang/sum): used as the
    dependency source when go.mod predates go 1.17 and lists no indirect
    deps. Lines: `module version[/go.mod] hash`."""
    pkgs: dict[str, Package] = {}
    for line in content.splitlines():
        parts = line.split()
        if len(parts) < 3:
            continue
        name, ver = parts[0].decode(), parts[1].decode()
        if ver.endswith("/go.mod"):
            ver = ver[: -len("/go.mod")]
        if name and ver:
            pkgs[name] = _mk(name, ver)
    return sorted(pkgs.values(), key=lambda p: p.id)
