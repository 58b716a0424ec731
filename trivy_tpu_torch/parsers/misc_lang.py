"""Parsers for cargo, composer, ruby, java, dotnet, dart, elixir, swift,
conan, conda and gradle/sbt lockfiles (reference pkg/dependency/parser/*).

Copy of trivy_tpu/parsers/misc_lang.py.
"""

from __future__ import annotations

import json
import re

from trivy_tpu_torch.types.artifact import Location, Package


def _mk(name: str, version: str, **kw) -> Package:
    return Package(id=f"{name}@{version}", name=name, version=version, **kw)


# ------------------------------------------------------------ rust


def parse_cargo_lock(content: bytes) -> list[Package]:
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
        deps = []
        for d in meta.get("dependencies") or []:
            deps.append(d.split(" ")[0])
        pkg.depends_on = deps
        out.append(pkg)
    by_name = {p.name: p.id for p in out}
    for p in out:
        p.depends_on = sorted(
            {by_name[d] for d in p.depends_on if d in by_name}
        )
    return sorted(out, key=lambda p: p.id)


# ------------------------------------------------------------ php


def parse_composer_lock(content: bytes) -> list[Package]:
    doc = json.loads(content)
    if isinstance(doc, list):
        # composer 1.x installed.json is a bare package array
        doc = {"packages": doc}
    if not isinstance(doc, dict):
        return []
    out = []
    for section, dev in (("packages", False), ("packages-dev", True)):
        for meta in doc.get(section) or []:
            name, version = meta.get("name"), meta.get("version", "")
            if not name or not version:
                continue
            pkg = _mk(name, version.lstrip("v"), dev=dev)
            lic = meta.get("license")
            if isinstance(lic, list):
                pkg.licenses = [str(x) for x in lic]
            pkg.depends_on = sorted(
                d for d in (meta.get("require") or {})
                if "/" in d  # real packages, not "php"/extensions
            )
            out.append(pkg)
    by_name = {p.name: p.id for p in out}
    for p in out:
        p.depends_on = sorted(
            {by_name[d] for d in p.depends_on if d in by_name}
        )
    return sorted(out, key=lambda p: p.id)


# ------------------------------------------------------------ ruby

_GEM_RX = re.compile(r"^ {4}(?P<name>\S+) \((?P<ver>[^)]+)\)$")


def parse_gemfile_lock(content: bytes) -> list[Package]:
    out = []
    in_gem = False
    for i, line in enumerate(content.decode("utf-8", "replace").splitlines(), 1):
        if line.strip() == "GEM":
            in_gem = True
            continue
        if line and not line.startswith(" "):
            in_gem = False
            continue
        if in_gem:
            m = _GEM_RX.match(line)
            if m:
                pkg = _mk(m.group("name"), m.group("ver"))
                pkg.locations = [Location(i, i)]
                out.append(pkg)
    return out


_GEMSPEC_NAME = re.compile(r"\.name\s*=\s*['\"]([^'\"]+)['\"]")
_GEMSPEC_VER = re.compile(r"\.version\s*=\s*['\"]([^'\"]+)['\"]")
_GEMSPEC_LIC = re.compile(r"\.licenses?\s*=\s*\[?\s*['\"]([^'\"]+)['\"]")


def parse_gemspec(content: bytes) -> Package | None:
    text = content.decode("utf-8", "replace")
    mn, mv = _GEMSPEC_NAME.search(text), _GEMSPEC_VER.search(text)
    if not mn or not mv:
        return None
    pkg = _mk(mn.group(1), mv.group(1))
    ml = _GEMSPEC_LIC.search(text)
    if ml:
        pkg.licenses = [ml.group(1)]
    return pkg


# ------------------------------------------------------------ java


_JAR_FILENAME_RX = re.compile(r"(?P<name>.+?)-(?P<ver>\d[\w.]*)\.[jwe]ar$")


def _parse_jar_filename(path: str) -> tuple[str, str]:
    """name-1.2.3.jar -> (artifactId, version)."""
    m = _JAR_FILENAME_RX.match(path.rsplit("/", 1)[-1])
    return (m.group("name"), m.group("ver")) if m else ("", "")


def parse_jar(content: bytes, path: str = "", client=None,
              _depth: int = 0) -> list[Package]:
    """JAR/WAR/EAR identification (reference
    pkg/dependency/parser/java/jar/parse.go:120-260):
    pom.properties preferred; inner jars recursed; then javadb sha1
    lookup; MANIFEST.MF Implementation-*; javadb artifactId->groupId
    heuristic; filename last.  `client` is a db.javadb.JavaDB (the
    process-wide one is used when None)."""
    import hashlib
    import io
    import zipfile

    if client is None:
        from trivy_tpu_torch.db.javadb import client as _javadb_client

        client = _javadb_client()

    out: list[Package] = []
    try:
        zf = zipfile.ZipFile(io.BytesIO(content))
    except zipfile.BadZipFile:
        return []
    file_aid, file_ver = _parse_jar_filename(path)
    found_own_pom = False
    manifest_fields: dict[str, str] = {}
    with zf:
        for name in zf.namelist():
            base = name.rsplit("/", 1)[-1]
            if base == "pom.properties":
                try:
                    props = dict(
                        line.split("=", 1)
                        for line in
                        zf.read(name).decode("utf-8", "replace").splitlines()
                        if "=" in line and not line.startswith("#")
                    )
                except Exception:
                    continue
                gid = props.get("groupId", "").strip()
                aid = props.get("artifactId", "").strip()
                ver = props.get("version", "").strip()
                if gid and aid and ver:
                    out.append(_mk(f"{gid}:{aid}", ver, file_path=path))
                    if aid == file_aid and ver == file_ver:
                        found_own_pom = True
            elif base == "MANIFEST.MF":
                text = zf.read(name).decode("utf-8", "replace")
                for line in text.splitlines():
                    if ":" in line:
                        k, _, v = line.partition(":")
                        manifest_fields[k.strip()] = v.strip()
            elif base.endswith((".jar", ".war", ".ear")) and _depth < 3:
                # fat jars bundle their dependencies (parse.go:184-196)
                try:
                    inner = zf.read(name)
                except Exception:
                    continue
                out.extend(parse_jar(inner, f"{path}/{name}" if path else name,
                                     client=client, _depth=_depth + 1))
    if found_own_pom or (out and not file_aid):
        return out

    # manifest identification (parse.go:100-118)
    if manifest_fields:
        gid = manifest_fields.get("Implementation-Vendor-Id") or \
            manifest_fields.get("Bundle-SymbolicName", "").split(";")[0]
        aid = manifest_fields.get("Implementation-Title") or ""
        ver = manifest_fields.get("Implementation-Version") or \
            manifest_fields.get("Bundle-Version", "")
        if aid and ver:
            name = f"{gid}:{aid}" if gid and ":" not in aid else aid
            out.append(_mk(name, ver, file_path=path))
            return out

    # sha1 lookup against the java DB (parse.go:123-127, :235-249)
    if client is not None:
        sha1 = hashlib.sha1(content).hexdigest()
        gav = client.search_by_sha1(sha1)
        if gav is not None:
            out.append(_mk(gav.name, gav.version, file_path=path))
            return out

    if file_aid and file_ver:
        # groupId via the (artifactId, version) heuristic (parse.go:139)
        name = file_aid
        if client is not None:
            gid = client.search_by_artifact_id(file_aid, file_ver)
            if gid:
                name = f"{gid}:{file_aid}"
        out.append(_mk(name, file_ver, file_path=path))
    return out


def parse_gradle_lockfile(content: bytes) -> list[Package]:
    out = []
    for i, line in enumerate(content.decode("utf-8", "replace").splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        coord = line.split("=")[0]
        parts = coord.split(":")
        if len(parts) == 3:
            pkg = _mk(f"{parts[0]}:{parts[1]}", parts[2])
            pkg.locations = [Location(i, i)]
            out.append(pkg)
    return out


def parse_sbt_lockfile(content: bytes) -> list[Package]:
    doc = json.loads(content)
    out = []
    for dep in doc.get("dependencies") or []:
        org, name, ver = dep.get("org"), dep.get("name"), dep.get("version")
        if org and name and ver:
            out.append(_mk(f"{org}:{name}", ver))
    return sorted(out, key=lambda p: p.id)


# ------------------------------------------------------------ dotnet


def parse_deps_json(content: bytes) -> list[Package]:
    """Reference pkg/dependency/parser/dotnet/core_deps: type=package
    entries from "libraries", filtered to runtime libraries when the
    runtimeTarget's target section is present (an entry that exists there
    but has no runtime/runtimeTargets/native content is compile-only)."""
    doc = json.loads(content)
    target_libs = (doc.get("targets") or {}).get(
        ((doc.get("runtimeTarget") or {}).get("name")) or "")
    out = {}
    for key, meta in (doc.get("libraries") or {}).items():
        if "/" not in key or str(meta.get("type", "")).lower() != "package":
            continue
        if target_libs is not None:
            lib = target_libs.get(key)
            if lib is not None and not lib:
                continue  # present but empty: compile-only
        name, version = key.split("/", 1)
        out.setdefault(f"{name}@{version}", _mk(name, version))
    return sorted(out.values(), key=lambda p: p.id)


def parse_nuget_lock(content: bytes) -> list[Package]:
    doc = json.loads(content)
    out = {}
    for _fw, deps in (doc.get("dependencies") or {}).items():
        for name, meta in (deps or {}).items():
            version = meta.get("resolved", "")
            if not version:
                continue
            indirect = meta.get("type") == "Transitive"
            out.setdefault(
                f"{name}@{version}",
                _mk(name, version, indirect=indirect,
                    relationship="indirect" if indirect else "direct"),
            )
    return sorted(out.values(), key=lambda p: p.id)


# ------------------------------------------------------------ dart / elixir / swift / conan / conda


def parse_pubspec_lock(content: bytes) -> list[Package]:
    import yaml

    doc = yaml.safe_load(content) or {}
    out = []
    for name, meta in (doc.get("packages") or {}).items():
        version = str(meta.get("version", ""))
        if not version:
            continue
        indirect = meta.get("dependency") == "transitive"
        out.append(_mk(name, version, indirect=indirect,
                       relationship="indirect" if indirect else "direct"))
    return sorted(out, key=lambda p: p.id)


_MIX_RX = re.compile(
    r'"(?P<name>[^"]+)":\s*\{:\w+,\s*:"?(?P=name)"?,\s*"(?P<ver>[^"]+)"'
)


def parse_mix_lock(content: bytes) -> list[Package]:
    out = []
    for i, line in enumerate(content.decode("utf-8", "replace").splitlines(), 1):
        m = _MIX_RX.search(line)
        if m:
            pkg = _mk(m.group("name"), m.group("ver"))
            pkg.locations = [Location(i, i)]
            out.append(pkg)
    return out


_PODFILE_RX = re.compile(r"^ {2}- (?P<name>\S+) \((?P<ver>[^)]+)\)$")


def parse_podfile_lock(content: bytes) -> list[Package]:
    import yaml

    doc = yaml.safe_load(content) or {}
    out = {}
    for entry in doc.get("PODS") or []:
        if isinstance(entry, dict):
            entry = next(iter(entry))
        m = re.match(r"(?P<name>\S+) \((?P<ver>[^)]+)\)", str(entry))
        if m:
            out.setdefault(m.group("name"),
                           _mk(m.group("name"), m.group("ver")))
    return sorted(out.values(), key=lambda p: p.id)


def parse_swift_resolved(content: bytes) -> list[Package]:
    doc = json.loads(content)
    out = []
    pins = (doc.get("pins") or
            (doc.get("object") or {}).get("pins") or [])
    for pin in pins:
        name = pin.get("location") or pin.get("repositoryURL") or pin.get("identity", "")
        name = name.removesuffix(".git")
        # reference trims the URL scheme: "github.com/apple/swift-nio"
        name = name.removeprefix("https://").removeprefix("http://")
        state = pin.get("state") or {}
        version = state.get("version") or ""
        if name and version:
            out.append(_mk(name, version))
    return sorted(out, key=lambda p: p.id)


def parse_conan_lock(content: bytes) -> list[Package]:
    doc = json.loads(content)
    out = []
    # v2: {"requires": ["name/1.0#rrev%ts", ...]}
    for req in doc.get("requires") or []:
        ref = req.split("#")[0].split("%")[0]
        if "/" in ref:
            name, version = ref.split("/", 1)
            out.append(_mk(name, version.split("@")[0]))
    # v1: graph_lock.nodes
    nodes = (doc.get("graph_lock") or {}).get("nodes") or {}
    for _id, node in nodes.items():
        ref = (node.get("ref") or "").split("#")[0]
        if "/" in ref:
            name, version = ref.split("/", 1)
            out.append(_mk(name, version.split("@")[0]))
    uniq = {p.id: p for p in out}
    return sorted(uniq.values(), key=lambda p: p.id)


def parse_conda_meta(content: bytes) -> Package | None:
    doc = json.loads(content)
    name, version = doc.get("name"), doc.get("version")
    if not name or not version:
        return None
    pkg = _mk(str(name), str(version))
    lic = doc.get("license")
    if lic:
        pkg.licenses = [str(lic)]
    return pkg


def parse_conda_environment(content: bytes) -> list[Package]:
    import yaml

    doc = yaml.safe_load(content) or {}
    out = []
    for dep in doc.get("dependencies") or []:
        if not isinstance(dep, str):
            continue
        # only exact "name=version(=build)" pins; range specs
        # (>=, <=, !=, name>...) are not concrete packages
        if any(c in dep for c in "<>!"):
            continue
        parts = dep.split("=")
        if len(parts) >= 2 and parts[0] and parts[1]:
            out.append(_mk(parts[0], parts[1]))
    return out


# ------------------------------------------------------------ julia


def parse_julia_manifest(content: bytes) -> list[Package]:
    """Manifest.toml (reference pkg/dependency/parser/julia/manifest):
    supports both the flat pre-1.7 layout and the 1.7+ [deps] table."""
    try:
        import tomllib
    except ImportError:  # Python <= 3.10: stdlib tomllib is 3.11+
        from trivy_tpu_torch.parsers import toml_compat as tomllib

    try:
        doc = tomllib.loads(content.decode("utf-8", "replace"))
    except tomllib.TOMLDecodeError:
        return []
    deps = doc.get("deps", doc)  # 1.7+ nests under [deps]
    # flat (pre-1.7) manifests carry no julia_version: stdlib entries
    # report version "unknown" (reference julia/manifest parse.go:52-57)
    julia_version = str(doc.get("julia_version") or "unknown")
    out = []
    for name, entries in deps.items():
        if not isinstance(entries, list):
            continue
        for e in entries:
            if not isinstance(e, dict):
                continue
            # stdlib entries carry no version: the julia runtime
            # provides them at the manifest's julia_version (reference
            # julia/manifest parse.go:24)
            version = str(e.get("version") or julia_version or "")
            uuid = e.get("uuid") or ""
            if not version:
                continue
            pkg = _mk(name, version)
            if uuid:
                pkg.id = uuid  # manifests distinguish same-name
                # packages by uuid (reference uses the uuid as pkg ID)
                pkg.identifier.purl = (
                    f"pkg:julia/{name}@{version}?uuid={uuid}")
            out.append(pkg)
    return sorted(out, key=lambda p: (p.name, p.version, p.id))


# ------------------------------------------------------------ wordpress


_WP_VERSION_RX = re.compile(
    rb"\$wp_version\s*=\s*['\"]([0-9][0-9a-zA-Z.\-]*)['\"]")


def parse_wordpress_version(content: bytes) -> Package | None:
    """wp-includes/version.php (reference
    pkg/dependency/parser/wordpress: reads $wp_version)."""
    m = _WP_VERSION_RX.search(content)
    if not m:
        return None
    return _mk("wordpress", m.group(1).decode())


# ------------------------------------------------------------ rust binary


def parse_rust_binary(content: bytes) -> list[Package]:
    """Rust binaries built with cargo-auditable embed a zlib-compressed
    JSON dependency list in a dedicated section named .dep-v0 (reference
    pkg/dependency/parser/rust/binary via rust-audit-info). Rather than
    fully parsing ELF/PE section tables, scan for zlib streams and accept
    the one that inflates to the audit JSON shape. The section *name*
    appearing in the binary's string table is the cheap gate; candidate
    streams are probed with a bounded 64-byte inflate before committing
    to a (size-capped) full decompression."""
    import zlib

    if b"dep-v0" not in content:
        return []
    view = memoryview(content)
    out: list[Package] = []
    pos = 0
    while True:
        idx = content.find(b"\x78", pos)
        if idx < 0 or idx + 2 > len(content):
            break
        pos = idx + 1
        if content[idx + 1] not in (0x01, 0x5E, 0x9C, 0xDA):
            continue
        window = view[idx: idx + 8 * 1024 * 1024]
        try:
            probe = zlib.decompressobj().decompress(window, 64)
        except zlib.error:
            continue
        if not probe.startswith(b'{"packages":'):
            continue
        try:  # bounded full inflate: audit JSON is small (< 16 MiB)
            blob = zlib.decompressobj().decompress(window, 16 * 1024 * 1024)
        except zlib.error:
            continue
        try:
            doc = json.loads(blob)
        except json.JSONDecodeError:
            continue
        pkgs = doc.get("packages") or []
        roots = {i for i, p in enumerate(pkgs) if p.get("root")}
        for i, p in enumerate(pkgs):
            name, version = p.get("name"), p.get("version")
            if not name or not version or i in roots:
                continue
            if p.get("kind", "runtime") != "runtime":
                continue
            out.append(_mk(name, version))
        break
    return sorted(out, key=lambda p: p.id)


# ------------------------------------------------------------ nuget config


def parse_nuget_packages_config(content: bytes) -> list[Package]:
    """packages.config (reference pkg/dependency/parser/nuget/config)."""
    import xml.etree.ElementTree as ET

    try:
        root = ET.fromstring(content)
    except ET.ParseError:
        return []
    out = []
    for pkg in root.iter("package"):
        name = pkg.get("id")
        version = pkg.get("version")
        if name and version:
            out.append(_mk(name, version,
                           dev=pkg.get("developmentDependency") == "true"))
    return sorted(out, key=lambda p: p.id)


def parse_nuget_packages_props(content: bytes) -> list[Package]:
    """Directory.Packages.props central package management (reference
    pkg/dependency/parser/nuget/packagesprops)."""
    import xml.etree.ElementTree as ET

    try:
        root = ET.fromstring(content)
    except ET.ParseError:
        return []
    out = []
    for tag in ("PackageVersion", "GlobalPackageReference"):
        for item in root.iter(tag):
            name = item.get("Include")
            version = item.get("Version") or ""
            # MSBuild variable versions can't be resolved offline
            if not name or not version or "$(" in version or "$(" in name:
                continue
            out.append(_mk(name, version))
    return sorted(out, key=lambda p: p.id)
