"""Node.js parsers (reference pkg/dependency/parser/nodejs/{npm,yarn,pnpm,
packagejson}): package-lock.json v1/v2+, yarn.lock v1/berry,
pnpm-lock.yaml, and node_modules package.json.

Copy of trivy_tpu/parsers/nodejs.py. The yarn.lock tokenizer runs
numpy on the host; it is no kernel.
"""

from __future__ import annotations

import json
import os
import re

from trivy_tpu_torch.types.artifact import Location, Package


def _mk(name: str, version: str, dev: bool = False,
        indirect: bool = False) -> Package:
    return Package(
        id=f"{name}@{version}", name=name, version=version, dev=dev,
        relationship="indirect" if indirect else "direct",
        indirect=indirect,
    )


def parse_package_lock(content: bytes) -> list[Package]:
    doc = json.loads(content)
    out: dict[str, Package] = {}
    if "packages" in doc:  # lockfile v2/v3
        for path, meta in doc["packages"].items():
            if not path.startswith("node_modules/"):
                continue  # root/workspace entries
            name = meta.get("name") or path.split("node_modules/")[-1]
            version = meta.get("version", "")
            if not version:
                continue
            indirect = "node_modules/" in path[len("node_modules/"):]
            pkg = _mk(name, version, dev=bool(meta.get("dev")),
                      indirect=indirect)
            deps = list((meta.get("dependencies") or {}).keys())
            pkg.depends_on = deps
            out.setdefault(pkg.id, pkg)
    else:  # v1: nested dependencies tree
        def walk(deps: dict, depth: int):
            for name, meta in (deps or {}).items():
                version = meta.get("version", "")
                if not version:
                    continue
                pkg = _mk(name, version, dev=bool(meta.get("dev")),
                          indirect=depth > 0)
                pkg.depends_on = list((meta.get("requires") or {}).keys())
                out.setdefault(pkg.id, pkg)
                walk(meta.get("dependencies") or {}, depth + 1)

        walk(doc.get("dependencies") or {}, 0)
    pkgs = list(out.values())
    by_name = {p.name: p.id for p in pkgs}
    for p in pkgs:
        p.depends_on = sorted(
            {by_name[d] for d in p.depends_on if d in by_name}
        )
    return sorted(pkgs, key=lambda p: p.id)


_YARN_HEADER = re.compile(
    r'^"?(?P<name>(?:@[^/@"]+/)?[^/@"]+)@(?:npm:)?[^"]*"?(?:, *"?.*)?:$'
)
_YARN_VERSION = re.compile(r'^ {2}version:? "?(?P<v>[^"\s]+)"?$')


def _parse_yarn_lines(lines) -> list[Package]:
    """State machine over (line_no, text) pairs; lines that can't
    change the state (blank, comment, non-version body) may be
    pre-filtered out by the caller."""
    out: dict[str, Package] = {}
    cur_name = None
    cur_line = 0
    for i, line in lines:
        if not line or line.startswith("#"):
            continue
        if not line.startswith(" "):
            m = _YARN_HEADER.match(line.rstrip())
            cur_name = m.group("name") if m else None
            cur_line = i
            continue
        if cur_name:
            m = _YARN_VERSION.match(line.rstrip())
            if m:
                pkg = _mk(cur_name, m.group("v"))
                pkg.locations = [Location(cur_line, i)]
                out.setdefault(pkg.id, pkg)
                cur_name = None
    return sorted(out.values(), key=lambda p: p.id)


# ASCII control bytes that str.splitlines treats as line boundaries
# beyond \n / \r\n / \r — their presence routes a document to the
# scalar tokenizer so line numbering stays byte-for-byte equal
_EXOTIC_BREAKS = (b"\x0b", b"\x0c", b"\x1c", b"\x1d", b"\x1e")

_YARN_VECTOR_MIN = 4096


def _yarn_lines_vectorized(content: bytes):
    """Tokenize a yarn.lock with one numpy pass: find line boundaries
    from the raw bytes, then classify each line by its first byte so
    only header candidates and `  version` lines — the only lines that
    can move the parser's state — are sliced and regex-matched.
    ASCII-only (byte offsets == char offsets, and none of the unicode
    line separators can appear); returns None when the document needs
    the scalar path."""
    if not content.isascii() or any(b in content for b in _EXOTIC_BREAKS):
        return None
    import numpy as np

    buf = np.frombuffer(content, dtype=np.uint8)
    n = buf.size
    term = np.flatnonzero((buf == 0x0A) | (buf == 0x0D))
    # the \n of a \r\n pair terminates nothing on its own
    lone = ~((buf[term] == 0x0A) & (term > 0)
             & (buf[np.maximum(term - 1, 0)] == 0x0D))
    ends = term[lone]
    nxt = ends + 1 + ((buf[ends] == 0x0D)
                      & (ends + 1 < n)
                      & (buf[np.minimum(ends + 1, n - 1)] == 0x0A))
    starts = np.concatenate((np.zeros(1, dtype=ends.dtype), nxt))
    if starts.size and starts[-1] >= n:        # trailing terminator:
        starts = starts[:-1]                   # no final empty line
    else:
        ends = np.concatenate((ends, np.array([n], dtype=ends.dtype)))
    if not starts.size:
        return []

    lens = ends - starts
    first = buf[np.minimum(starts, n - 1)]
    headers = (lens > 0) & (first != 0x23) & (first != 0x20)
    versions = lens >= 9
    if versions.any():
        v = np.flatnonzero(versions)
        probe = np.frombuffer(b"  version", dtype=np.uint8)
        for k, ch in enumerate(probe):
            v = v[buf[starts[v] + k] == ch]
            if not v.size:
                break
        versions = np.zeros_like(versions)
        versions[v] = True
    keep = np.flatnonzero(headers | versions)
    # one whole-document decode + str slices with python ints: the
    # slice loop dominates once the boundary scan is vectorized
    text = content.decode("ascii")
    return [(i + 1, text[s:e])
            for i, s, e in zip(keep.tolist(), starts[keep].tolist(),
                               ends[keep].tolist())]


def parse_yarn_lock(content: bytes) -> list[Package]:
    if (len(content) >= _YARN_VECTOR_MIN
            and os.environ.get("TRIVY_TPU_VECTOR_ANALYZERS", "1") != "0"):
        lines = _yarn_lines_vectorized(content)
        if lines is not None:
            return _parse_yarn_lines(lines)
    return _parse_yarn_lines(
        enumerate(content.decode("utf-8", "replace").splitlines(), 1))


def parse_pnpm_lock(content: bytes) -> list[Package]:
    import yaml

    doc = yaml.safe_load(content) or {}
    out: dict[str, Package] = {}
    ver = str(doc.get("lockfileVersion", "5"))
    direct: set[str] = set()
    importers = doc.get("importers") or {".": doc}
    for imp in importers.values():
        for sec in ("dependencies", "devDependencies", "optionalDependencies"):
            for name, spec in (imp.get(sec) or {}).items():
                v = spec.get("version", "") if isinstance(spec, dict) else str(spec)
                direct.add(f"{name}@{v.split('(')[0]}")
    for key, meta in (doc.get("packages") or {}).items():
        # v5: "/name/1.0.0" or "/@scope/name/1.0.0"; v6+: "/name@1.0.0";
        # v9 keys live under "snapshots"/"packages" as "name@1.0.0"
        k = key.lstrip("/")
        name = version = ""
        if "@" in k and not k.startswith("@") and ver >= "6":
            name, _, version = k.rpartition("@")
        elif k.startswith("@") and k.count("@") >= 2 and ver >= "6":
            name, _, version = k.rpartition("@")
        else:
            parts = k.rsplit("/", 1)
            if len(parts) == 2:
                name, version = parts
        version = version.split("(")[0]
        if not name or not version:
            continue
        dev = bool(meta.get("dev")) if isinstance(meta, dict) else False
        pid = f"{name}@{version}"
        pkg = _mk(name, version, dev=dev, indirect=pid not in direct)
        out.setdefault(pkg.id, pkg)
    return sorted(out.values(), key=lambda p: p.id)


def parse_package_json(content: bytes) -> Package | None:
    """One installed node_modules/<pkg>/package.json -> node-pkg."""
    try:
        doc = json.loads(content)
    except json.JSONDecodeError:
        return None
    name, version = doc.get("name"), doc.get("version")
    if not name or not version:
        return None
    pkg = _mk(str(name), str(version))
    lic = doc.get("license")
    if isinstance(lic, dict):
        lic = lic.get("type")
    if isinstance(lic, str) and lic:
        pkg.licenses = [lic]
    return pkg
