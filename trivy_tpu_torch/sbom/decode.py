"""SBOM decoding: CycloneDX / SPDX (JSON) -> BlobInfo.

Model: reference pkg/sbom/io/decode.go —
- the "operating-system" component becomes OS metadata
- packages with apk/deb/rpm purls attach to the OS package set
- language packages group into Applications: under their parent
  "application" component (lockfile) when referenced by the dependency
  graph, else aggregated per language type (decode.go addLangPkgs /
  addOrphanPkgs)

Copy of trivy_tpu/sbom/decode.py.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from trivy_tpu_torch.log import logger
from trivy_tpu_torch.types.artifact import (
    Application,
    BlobInfo,
    OS,
    Package,
    PackageInfo,
    PkgIdentifier,
)
from trivy_tpu_torch.utils.purl import parse_purl, purl_kind

_log = logger("sbom")


@dataclass
class SBOMMeta:
    artifact_name: str = ""
    image_id: str = ""
    repo_tags: list[str] = field(default_factory=list)
    repo_digests: list[str] = field(default_factory=list)
    diff_ids: list[str] = field(default_factory=list)
    artifact_type: str = "cyclonedx"


def _classify_doc(doc) -> str | None:
    if isinstance(doc, dict):
        if doc.get("bomFormat") == "CycloneDX":
            return "cyclonedx-json"
        if "spdxVersion" in doc:
            return "spdx-json"
    return None


def detect_sbom_format(path: str) -> str | None:
    """-> "cyclonedx-json" | "spdx-json" | "attest-*" | None
    (reference pkg/sbom/sbom.go format sniffing incl. in-toto
    attestations)."""
    try:
        with open(path, "rb") as f:
            head = f.read(8 * 1024 * 1024)
        doc = json.loads(head)
    except (json.JSONDecodeError, UnicodeDecodeError):
        if head.lstrip().startswith(b"SPDXVersion:"):
            return "spdx-tv"
        return None
    fmt = _classify_doc(doc)
    if fmt:
        return fmt
    from trivy_tpu_torch.attestation import is_attestation

    if is_attestation(doc):
        return "attestation"
    return None


def decode_sbom_bytes(content: bytes) -> tuple[BlobInfo, SBOMMeta]:
    """Decode an in-memory SBOM document (used by the in-image SBOM
    analyzer, reference pkg/fanal/analyzer/sbom)."""
    doc = json.loads(content)
    fmt = _classify_doc(doc)
    if fmt == "cyclonedx-json":
        return _decode_cyclonedx(doc)
    if fmt == "spdx-json":
        return _decode_spdx(doc)
    raise ValueError("unsupported SBOM document")


def decode_sbom_file(path: str) -> tuple[BlobInfo, SBOMMeta]:
    fmt = detect_sbom_format(path)
    if fmt == "spdx-tv":
        with open(path, encoding="utf-8", errors="replace") as f:
            return _decode_spdx(parse_spdx_tag_value(f.read()))
    with open(path) as f:
        doc = json.load(f)
    if fmt == "attestation":
        # cosign SBOM attestation: DSSE envelope -> in-toto statement ->
        # predicate(.Data) holds the actual SBOM (reference
        # pkg/attestation + sbom.go attestation decode)
        from trivy_tpu_torch.attestation import (
            parse_statement,
            unwrap_cosign_predicate,
        )

        inner = unwrap_cosign_predicate(parse_statement(doc))
        if isinstance(inner, str):
            inner = json.loads(inner)
        doc = inner
        fmt = _classify_doc(doc)
    if fmt == "cyclonedx-json":
        return _decode_cyclonedx(doc)
    if fmt == "spdx-json":
        return _decode_spdx(doc)
    raise ValueError(f"unsupported SBOM format: {path}")


# ------------------------------------------------------------ CycloneDX


def _decode_cyclonedx(doc: dict) -> tuple[BlobInfo, SBOMMeta]:
    meta = SBOMMeta(artifact_type="cyclonedx")
    blob = BlobInfo()
    root = (doc.get("metadata") or {}).get("component") or {}
    if root:
        meta.artifact_name = root.get("name", "")
        for prop in root.get("properties") or []:
            name, value = prop.get("name", ""), prop.get("value", "")
            if name == "aquasecurity:trivy:ImageID":
                meta.image_id = value
            elif name == "aquasecurity:trivy:RepoDigest":
                meta.repo_digests.append(value)
            elif name == "aquasecurity:trivy:RepoTag":
                meta.repo_tags.append(value)
            elif name == "aquasecurity:trivy:DiffID":
                meta.diff_ids.append(value)

    os_info = OS()
    os_pkgs: list[Package] = []
    # bom-ref -> lockfile application placeholder
    apps: dict[str, Application] = {}
    # bom-ref -> (lang_type, Package)
    lang_pkgs: dict[str, tuple[str, Package]] = {}
    counter = [0]

    components = list(doc.get("components") or [])
    for c in components:
        ctype = c.get("type", "")
        ref = c.get("bom-ref") or f"comp-{counter[0]}"
        counter[0] += 1
        if ctype == "operating-system":
            if not os_info.detected:
                os_info = OS(family=c.get("name", ""), name=c.get("version", ""))
            continue
        if ctype == "application":
            app_type, fpath = _cdx_app_props(c)
            if app_type:
                apps[ref] = Application(type=app_type, file_path=fpath)
                continue
        pkg, kind, type_str = _component_to_package(c)
        if pkg is None:
            continue
        if kind == "os":
            os_pkgs.append(pkg)
        else:
            lang_pkgs.setdefault(ref, (type_str, pkg))

    # dependency graph: lockfile app -> its packages
    deps = {
        d.get("ref"): d.get("dependsOn") or []
        for d in doc.get("dependencies") or []
    }
    placed: set[str] = set()
    for app_ref, app in apps.items():
        stack = list(deps.get(app_ref, []))
        seen = set()
        while stack:
            r = stack.pop()
            if r in seen:
                continue
            seen.add(r)
            if r in lang_pkgs:
                t, pkg = lang_pkgs[r]
                app.packages.append(pkg)
                placed.add(r)
                stack.extend(deps.get(r, []))

    # orphans aggregate per language type
    orphan_by_type: dict[str, Application] = {}
    for ref, (t, pkg) in lang_pkgs.items():
        if ref in placed:
            continue
        orphan_by_type.setdefault(t, Application(type=t)).packages.append(pkg)

    applications = [a for a in apps.values() if a.packages]
    applications += [orphan_by_type[t] for t in sorted(orphan_by_type)]
    applications.sort(key=lambda a: (a.type, a.file_path))

    blob.os = os_info
    if os_pkgs:
        blob.package_infos = [PackageInfo(packages=os_pkgs)]
    blob.applications = applications
    return blob, meta


def _cdx_app_props(c: dict) -> tuple[str, str]:
    app_type = fpath = ""
    for prop in c.get("properties") or []:
        if prop.get("name") == "aquasecurity:trivy:Type":
            app_type = prop.get("value", "")
        elif prop.get("name") == "aquasecurity:trivy:FilePath":
            fpath = prop.get("value", "")
    return app_type, fpath or c.get("name", "")


def _component_to_package(c: dict):
    purl_str = c.get("purl", "")
    if not purl_str:
        return None, None, None
    try:
        p = parse_purl(purl_str)
    except ValueError:
        _log.debug("unparseable purl", purl=purl_str)
        return None, None, None
    kind = purl_kind(p)
    if kind is None:
        return None, None, None
    pkg = Package(
        name=p.full_name,
        version=c.get("version", p.version),
        identifier=PkgIdentifier(purl=purl_str, bom_ref=c.get("bom-ref", "")),
    )
    if kind[0] == "os":
        pkg.arch = p.qualifiers.get("arch", "")
        epoch = p.qualifiers.get("epoch", "")
        if epoch.isdigit():
            pkg.epoch = int(epoch)
            pkg.src_epoch = int(epoch)
        ver = pkg.version
        if "-" in ver and p.type in ("deb", "rpm", "apk"):
            v, _, r = ver.rpartition("-")
            pkg.version, pkg.release = v, r
        for prop in c.get("properties") or []:
            pn, pv = prop.get("name", ""), prop.get("value", "")
            if pn == "aquasecurity:trivy:SrcName":
                pkg.src_name = pv
            elif pn == "aquasecurity:trivy:SrcVersion":
                pkg.src_version = pv
            elif pn == "aquasecurity:trivy:SrcRelease":
                pkg.src_release = pv
            elif pn == "aquasecurity:trivy:SrcEpoch" and pv.isdigit():
                pkg.src_epoch = int(pv)
            elif pn == "aquasecurity:trivy:LayerDiffID":
                pkg.layer.diff_id = pv
        if not pkg.src_name:
            pkg.src_name = pkg.name
        if not pkg.src_version:
            pkg.src_version = pkg.version
            pkg.src_release = pkg.release
    for prop in c.get("properties") or []:
        if prop.get("name") == "aquasecurity:trivy:PkgID":
            pkg.id = prop.get("value", "")
        elif prop.get("name") == "aquasecurity:trivy:FilePath":
            pkg.file_path = prop.get("value", "")
    for lic in c.get("licenses") or []:
        if not isinstance(lic, dict):
            continue
        inner = lic.get("license") or {}
        name = inner.get("name") or inner.get("id") or \
            lic.get("expression")
        if name:
            pkg.licenses.append(str(name))
    if not pkg.id:
        pkg.id = f"{pkg.name}@{c.get('version', p.version)}"
    return pkg, kind[0], (kind[1] if kind[0] == "lang" else p.type)


# ------------------------------------------------------------ SPDX


def parse_spdx_tag_value(text: str) -> dict:
    """SPDX tag-value -> the JSON-shaped document _decode_spdx consumes
    (reference supports both encodings; spdx/tvloader equivalent for the
    subset trivy emits)."""
    doc: dict = {"spdxVersion": "", "name": "", "packages": [],
                 "relationships": []}
    cur: dict | None = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        key, sep, val = line.partition(":")
        if not sep:
            continue
        key, val = key.strip(), val.strip()
        if key == "SPDXVersion":
            doc["spdxVersion"] = val
        elif key == "DocumentName":
            doc["name"] = val
        elif key == "PackageName":
            cur = {"name": val}
            doc["packages"].append(cur)
        elif key == "Relationship":
            parts = val.split()
            if len(parts) == 3:
                doc["relationships"].append({
                    "spdxElementId": parts[0],
                    "relationshipType": parts[1],
                    "relatedSpdxElement": parts[2],
                })
        elif cur is not None:
            if key == "SPDXID":
                cur["SPDXID"] = val
            elif key == "PackageVersion":
                cur["versionInfo"] = val
            elif key == "PackageSourceInfo":
                cur["sourceInfo"] = val
            elif key == "PrimaryPackagePurpose":
                cur["primaryPackagePurpose"] = val
            elif key == "PackageAttributionText":
                cur.setdefault("attributionTexts", []).append(val)
            elif key == "ExternalRef":
                parts = val.split(None, 2)
                if len(parts) == 3:
                    cur.setdefault("externalRefs", []).append({
                        "referenceCategory": parts[0],
                        "referenceType": parts[1],
                        "referenceLocator": parts[2],
                    })
    return doc


def _split_evr(evr: str) -> tuple[int, str, str]:
    """'[epoch:]ver[-rel]' -> (epoch, version, release)."""
    epoch = 0
    if ":" in evr:
        e, _, evr = evr.partition(":")
        if e.isdigit():
            epoch = int(e)
    ver, _, rel = evr.rpartition("-") if "-" in evr else (evr, "", "")
    return epoch, ver or evr, rel


def _decode_spdx(doc: dict) -> tuple[BlobInfo, SBOMMeta]:
    """SPDX document (reference pkg/sbom/spdx/unmarshal.go): element-ID
    prefixes classify packages (OperatingSystem / Application /
    Package); the PURL external ref is authoritative for identity,
    sourceInfo ('built package from: name evr') carries the source
    package, attributionTexts carry PkgID/layer info."""
    meta = SBOMMeta(artifact_type="spdx", artifact_name=doc.get("name", ""))
    blob = BlobInfo()
    os_info = OS()
    os_pkgs: list[Package] = []
    apps: dict[str, Application] = {}  # SPDXID -> Application
    lang_pkgs: dict[str, tuple[str, Package]] = {}
    orphan_by_type: dict[str, Application] = {}

    for sp in doc.get("packages") or []:
        spdx_id = str(sp.get("SPDXID", ""))
        purl_str = ""
        for ref in sp.get("externalRefs") or []:
            if ref.get("referenceType") == "purl":
                purl_str = ref.get("referenceLocator", "")
                break
        if spdx_id.startswith("SPDXRef-OperatingSystem") or \
                sp.get("primaryPackagePurpose") == "OPERATING-SYSTEM":
            os_info = OS(
                family=sp.get("name", ""), name=sp.get("versionInfo", "")
            )
            continue
        if spdx_id.startswith("SPDXRef-Application"):
            # two trivy encodings exist: older docs name the package
            # after the app TYPE with the lockfile path in sourceInfo;
            # current docs name it after the lockfile path (type is
            # inferred from member packages below)
            name = sp.get("name", "")
            src = str(sp.get("sourceInfo") or "")
            if src and not src.startswith(("application:",
                                           "package found in:")):
                apps[spdx_id] = Application(type=name, file_path=src)
            else:
                apps[spdx_id] = Application(type="", file_path=name)
            continue
        if not purl_str:
            continue
        # the purl is authoritative for version identity; versionInfo
        # renders the full EVR which may disagree with it
        c = {"purl": purl_str, "bom-ref": spdx_id}
        pkg, kind, type_str = _component_to_package(c)
        if pkg is None:
            continue
        src = str(sp.get("sourceInfo") or "")
        if src.startswith("built package from:"):
            parts = src[len("built package from:"):].strip().rsplit(" ", 1)
            if len(parts) == 2:
                pkg.src_name = parts[0]
                (pkg.src_epoch, pkg.src_version,
                 pkg.src_release) = _split_evr(parts[1])
        # current trivy emits PkgID/Layer info as SPDX annotations;
        # older releases used attributionTexts — read both (reference
        # unmarshal.go checks annotations first)
        texts = [str(a.get("comment", ""))
                 for a in sp.get("annotations") or []]
        texts += [str(t) for t in sp.get("attributionTexts") or []]
        for text in texts:
            key, _, val = text.partition(": ")
            if key == "PkgID":
                pkg.id = val
            elif key == "LayerDiffID":
                pkg.layer.diff_id = val
            elif key == "LayerDigest":
                pkg.layer.digest = val
        if kind == "os":
            os_pkgs.append(pkg)
        else:
            lang_pkgs[spdx_id] = (type_str, pkg)

    # relationships place language packages under their Application:
    # trivy links them with DEPENDS_ON (CONTAINS in older releases) —
    # any edge type counts as membership (reference unmarshal.go
    # parseRelationships)
    placed: set[str] = set()
    for rel in doc.get("relationships") or []:
        owner = str(rel.get("spdxElementId", ""))
        member = str(rel.get("relatedSpdxElement", ""))
        if owner in apps and member in lang_pkgs:
            app = apps[owner]
            t, pkg = lang_pkgs[member]
            if not app.type:
                app.type = t  # inferred from the member's purl ecosystem
            app.packages.append(pkg)
            placed.add(member)
    for ref, (t, pkg) in lang_pkgs.items():
        if ref not in placed:
            orphan_by_type.setdefault(
                t, Application(type=t)).packages.append(pkg)

    blob.os = os_info
    if os_pkgs:
        blob.package_infos = [PackageInfo(packages=os_pkgs)]
    applications = [a for a in apps.values() if a.packages]
    applications += [orphan_by_type[t] for t in sorted(orphan_by_type)]
    applications.sort(key=lambda a: (a.type, a.file_path))
    blob.applications = applications
    return blob, meta
