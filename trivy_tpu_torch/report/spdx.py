"""SPDX 2.3 JSON writer (reference pkg/sbom/spdx/marshal.go).

Document layout: one DESCRIBES root package (the artifact), one package
per OS / application holder, one package per installed package with
CONTAINS / DEPENDS_ON relationships, and one File entry per distinct
package file path.

Copy of trivy_tpu/report/spdx.py.
"""

from __future__ import annotations

import hashlib
import json
import re

import trivy_tpu_torch
from trivy_tpu_torch.types.report import Report
from trivy_tpu_torch.utils import clock

SPDX_VERSION = "SPDX-2.3"
DATA_LICENSE = "CC0-1.0"
_DOC_NS_BASE = "https://trivy-tpu.dev"


def _spdx_id(kind: str, *parts: str) -> str:
    h = hashlib.sha1((":".join(parts)).encode()).hexdigest()[:16]
    return f"SPDXRef-{kind}-{h}"


def _safe_license(expr_list) -> str:
    if not expr_list:
        return "NONE"
    # SPDX license expressions must be valid idstrings; non-conforming
    # names are wrapped as LicenseRef in the reference — approximate by
    # sanitizing
    out = []
    for e in expr_list:
        if re.fullmatch(r"[A-Za-z0-9.+\-]+", e):
            out.append(e)
        else:
            out.append("LicenseRef-" + re.sub(r"[^A-Za-z0-9.\-]", "-", e))
    return " AND ".join(out)


def render_spdx_json(report: Report) -> str:
    root_id = _spdx_id("Artifact", report.artifact_name or "artifact")
    root_pkg = {
        "SPDXID": root_id,
        "name": report.artifact_name or "artifact",
        "downloadLocation": "NONE",
        "copyrightText": "NOASSERTION",
        "licenseConcluded": "NOASSERTION",
        "licenseDeclared": "NOASSERTION",
        "primaryPackagePurpose": "CONTAINER"
        if report.artifact_type == "container_image" else "APPLICATION",
        "supplier": "NOASSERTION",
    }
    md = report.metadata
    attrs = []
    if md.image_id:
        attrs.append(f"ImageID: {md.image_id}")
    for d in md.repo_digests:
        attrs.append(f"RepoDigest: {d}")
    for d in md.diff_ids:
        attrs.append(f"DiffID: {d}")
    for t in md.repo_tags:
        attrs.append(f"RepoTag: {t}")
    if attrs:
        root_pkg["attributionTexts"] = attrs

    packages = [root_pkg]
    files = []
    relationships = [{
        "spdxElementId": "SPDXRef-DOCUMENT",
        "relatedSpdxElement": root_id,
        "relationshipType": "DESCRIBES",
    }]
    seen_files: dict[str, str] = {}

    if md.os is not None and md.os.detected:
        os_id = _spdx_id("OperatingSystem", md.os.family, md.os.name)
        packages.append({
            "SPDXID": os_id,
            "name": md.os.family,
            "versionInfo": md.os.name,
            "downloadLocation": "NONE",
            "copyrightText": "NOASSERTION",
            "licenseConcluded": "NOASSERTION",
            "licenseDeclared": "NOASSERTION",
            "primaryPackagePurpose": "OPERATING-SYSTEM",
            "supplier": "NOASSERTION",
        })
        relationships.append({
            "spdxElementId": root_id,
            "relatedSpdxElement": os_id,
            "relationshipType": "CONTAINS",
        })
        os_holder = os_id
    else:
        os_holder = None

    # language packages not tied to a lock file attach directly to the
    # root element (reference ftypes.AggregatingTypes)
    from trivy_tpu_torch.fanal.applier import AGGREGATE_TYPES as aggregating

    for res in report.results:
        cls = str(res.result_class)
        if not res.packages:
            continue
        if cls == "os-pkgs" and os_holder:
            holder = os_holder
        elif (res.type or "") in aggregating:
            holder = root_id
        else:
            holder = _spdx_id("Application", res.type or "", res.target)
            packages.append({
                "SPDXID": holder,
                # reference spdx marshal names application packages
                # after the lockfile path (the result Target)
                "name": res.target or res.type,
                "downloadLocation": "NONE",
                "copyrightText": "NOASSERTION",
                "licenseConcluded": "NOASSERTION",
                "licenseDeclared": "NOASSERTION",
                "primaryPackagePurpose": "APPLICATION",
                "supplier": "NOASSERTION",
            })
            relationships.append({
                "spdxElementId": root_id,
                "relatedSpdxElement": holder,
                "relationshipType": "CONTAINS",
            })

        id_by_pkgid: dict[str, str] = {}
        for pkg in res.packages:
            pid = _spdx_id("Package", res.target, pkg.name,
                           pkg.full_version())
            if pkg.id:
                id_by_pkgid[pkg.id] = pid
        for pkg in res.packages:
            pid = _spdx_id("Package", res.target, pkg.name,
                           pkg.full_version())
            entry = {
                "SPDXID": pid,
                "name": pkg.name,
                "versionInfo": pkg.full_version(),
                "downloadLocation": "NONE",
                "copyrightText": "NOASSERTION",
                "licenseConcluded": "NOASSERTION",
                "licenseDeclared": _safe_license(pkg.licenses),
                "primaryPackagePurpose": "LIBRARY",
                "supplier": "NOASSERTION",
            }
            if pkg.identifier.purl:
                entry["externalRefs"] = [{
                    "referenceCategory": "PACKAGE-MANAGER",
                    "referenceType": "purl",
                    "referenceLocator": pkg.identifier.purl,
                }]
            if pkg.src_name and pkg.src_name != pkg.name:
                entry["sourceInfo"] = (
                    f"built package from: {pkg.src_name} "
                    f"{pkg.full_src_version()}"
                )
            elif cls == "lang-pkgs" and res.target \
                    and (res.type or "") not in aggregating:
                # reference encode.go sets SrcFile only for lock-file
                # results, not aggregated types
                entry["sourceInfo"] = f"package found in: {res.target}"
            packages.append(entry)
            relationships.append({
                "spdxElementId": holder,
                "relatedSpdxElement": pid,
                "relationshipType": "CONTAINS",
            })
            for dep in getattr(pkg, "depends_on", None) or []:
                if dep in id_by_pkgid:
                    relationships.append({
                        "spdxElementId": pid,
                        "relatedSpdxElement": id_by_pkgid[dep],
                        "relationshipType": "DEPENDS_ON",
                    })
            fp = pkg.file_path
            if fp:
                if fp not in seen_files:
                    fid = _spdx_id("File", fp)
                    seen_files[fp] = fid
                    files.append({
                        "SPDXID": fid,
                        "fileName": fp,
                        "copyrightText": "NOASSERTION",
                        "licenseConcluded": "NOASSERTION",
                    })
                relationships.append({
                    "spdxElementId": pid,
                    "relatedSpdxElement": seen_files[fp],
                    "relationshipType": "CONTAINS",
                })

    doc = {
        "spdxVersion": SPDX_VERSION,
        "dataLicense": DATA_LICENSE,
        "SPDXID": "SPDXRef-DOCUMENT",
        "name": report.artifact_name or "artifact",
        "documentNamespace": (
            f"{_DOC_NS_BASE}/{report.artifact_type or 'artifact'}/"
            f"{_spdx_id('ns', report.artifact_name)[8:]}"
        ),
        "creationInfo": {
            "creators": [
                "Organization: trivy-tpu",
                f"Tool: trivy-tpu-{trivy_tpu_torch.__version__}",
            ],
            "created": clock.now_rfc3339(),
        },
        "packages": packages,
        "relationships": relationships,
    }
    if files:
        doc["files"] = files
    return json.dumps(doc, indent=2, ensure_ascii=False) + "\n"
