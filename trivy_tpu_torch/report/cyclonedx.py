"""CycloneDX 1.6 JSON writer (reference pkg/sbom/cyclonedx/marshal.go via
pkg/sbom/io/encode.go).

Structure: root metadata.component = the scanned artifact; one
"application" component per lockfile/app result; one "library" (or
"operating-system") component per package; dependency edges from the
package graph; vulnerabilities with affects[] referencing package
bom-refs.

Copy of trivy_tpu/report/cyclonedx.py.
"""

from __future__ import annotations

import json

import trivy_tpu_torch
from trivy_tpu_torch.types.report import Report, Result
from trivy_tpu_torch.utils import clock, uuid as uuidgen

SPEC_VERSION = "1.6"

_NS = "aquasecurity:trivy:"  # property namespace kept for ecosystem compat


def _prop(name: str, value) -> dict:
    return {"name": _NS + name, "value": str(value)}


def _pkg_ref(pkg) -> str:
    if pkg.identifier.bom_ref:
        return pkg.identifier.bom_ref
    if pkg.identifier.purl:
        return pkg.identifier.purl
    return uuidgen.new()


def _pkg_component(res: Result, pkg) -> dict:
    name = pkg.name
    group = ""
    purl = pkg.identifier.purl
    # maven GroupID and npm scopes render in the `group` field
    # (reference sbom/io/encode.go component)
    if purl and purl.startswith(("pkg:maven/", "pkg:npm/")):
        try:
            from trivy_tpu_torch.utils.purl import parse_purl

            p = parse_purl(purl)
            name = p.name
            group = p.namespace or ""
        except ValueError:
            pass
    comp: dict = {
        "bom-ref": _pkg_ref(pkg),
        "type": "library",
        "name": name,
        "version": pkg.full_version(),
    }
    if group:
        comp["group"] = group
    if pkg.identifier.purl:
        comp["purl"] = pkg.identifier.purl
    props = []
    if pkg.id:
        props.append(_prop("PkgID", pkg.id))
    props.append(_prop("PkgType", res.type or ""))
    if getattr(pkg, "src_name", ""):
        props.append(_prop("SrcName", pkg.src_name))
    if getattr(pkg, "src_version", ""):
        props.append(_prop("SrcVersion", pkg.src_version))
    if getattr(pkg, "file_path", ""):
        props.append(_prop("FilePath", pkg.file_path))
    if getattr(pkg, "layer", None) and pkg.layer.diff_id:
        props.append(_prop("LayerDiffID", pkg.layer.diff_id))
    comp["properties"] = [p for p in props if p["value"]]
    licenses = getattr(pkg, "licenses", None) or []
    if licenses:
        comp["licenses"] = [{"license": {"name": l}} for l in licenses]
    return comp


def _severity_cdx(sev: str) -> str:
    return {"CRITICAL": "critical", "HIGH": "high", "MEDIUM": "medium",
            "LOW": "low", "UNKNOWN": "unknown"}.get(sev, "unknown")


def render_cyclonedx(report: Report) -> str:
    root_type = {
        "container_image": "container",
        "vm_image": "container",
    }.get(report.artifact_type, "application")
    root_ref = uuidgen.new()
    root = {
        "bom-ref": root_ref,
        "type": root_type,
        "name": report.artifact_name,
        "properties": [_prop("SchemaVersion", report.schema_version)],
    }
    md = report.metadata
    if md.image_id:
        root["properties"].append(_prop("ImageID", md.image_id))
    for d in md.repo_digests:
        root["properties"].append(_prop("RepoDigest", d))
    for t in md.repo_tags:
        root["properties"].append(_prop("RepoTag", t))
    if md.diff_ids:
        for d in md.diff_ids:
            root["properties"].append(_prop("DiffID", d))

    components: list[dict] = []
    dependencies: list[dict] = []
    vulnerabilities: dict[str, dict] = {}
    root_deps: list[str] = []
    seen_refs: set[str] = set()
    dep_by_ref: dict[str, dict] = {}

    if md.os is not None and md.os.detected:
        os_ref = uuidgen.new()
        components.append({
            "bom-ref": os_ref,
            "type": "operating-system",
            "name": md.os.family,
            "version": md.os.name,
            "properties": [_prop("Type", md.os.family),
                           _prop("Class", "os-pkgs")],
        })
        root_deps.append(os_ref)
        os_holder = os_ref
    else:
        os_holder = None

    # language packages not tied to a lock file hang directly off the
    # root component (reference ftypes.AggregatingTypes + encode.go
    # encodeResult)
    from trivy_tpu_torch.fanal.applier import AGGREGATE_TYPES as aggregating

    for res in report.results:
        cls = str(res.result_class)
        if cls == "os-pkgs" and os_holder:
            holder_ref = os_holder
        elif res.packages and (res.type or "") in aggregating:
            holder_ref = "__root__"
        elif res.packages:
            holder_ref = uuidgen.new()
            components.append({
                "bom-ref": holder_ref,
                "type": "application",
                "name": res.target,
                "properties": [_prop("Type", res.type or ""),
                               _prop("Class", cls)],
            })
            root_deps.append(holder_ref)
        else:
            holder_ref = None

        ref_by_id: dict[str, str] = {}
        pkg_components = []
        for pkg in res.packages:
            comp = _pkg_component(res, pkg)
            pkg_components.append((pkg, comp))
            if pkg.id:
                ref_by_id[pkg.id] = comp["bom-ref"]
        holder_deps = []
        for pkg, comp in pkg_components:
            ref = comp["bom-ref"]
            holder_deps.append(ref)
            edges = sorted(
                ref_by_id[d] for d in (getattr(pkg, "depends_on", None) or [])
                if d in ref_by_id
            )
            # bom-ref must be unique document-wide: the same purl seen in
            # two results keeps the first component, edges are merged
            if ref in seen_refs:
                existing = dep_by_ref.get(ref)
                if existing is not None:
                    existing["dependsOn"] = sorted(
                        set(existing["dependsOn"]) | set(edges)
                    )
                continue
            seen_refs.add(ref)
            components.append(comp)
            entry = {"ref": ref, "dependsOn": edges}
            dep_by_ref[ref] = entry
            dependencies.append(entry)
        if holder_ref == "__root__":
            root_deps.extend(holder_deps)
        elif holder_ref:
            dependencies.append({"ref": holder_ref,
                                 "dependsOn": sorted(holder_deps)})

        for v in res.vulnerabilities:
            entry = vulnerabilities.setdefault(v.vulnerability_id, {
                "id": v.vulnerability_id,
                "source": (
                    {"name": v.data_source.name, "url": v.data_source.url}
                    if v.data_source else {}
                ),
                "ratings": [{
                    "severity": _severity_cdx(str(v.severity)),
                }],
                "description": (v.info.description if v.info else ""),
                "affects": [],
            })
            if v.info:
                if v.info.published_date:
                    entry["published"] = v.info.published_date
                if v.info.last_modified_date:
                    entry["updated"] = v.info.last_modified_date
                if v.info.references:
                    entry["advisories"] = [
                        {"url": u} for u in v.info.references
                    ]
                if v.info.cwe_ids:
                    entry["cwes"] = [
                        int(c.removeprefix("CWE-"))
                        for c in v.info.cwe_ids
                        if c.removeprefix("CWE-").isdigit()
                    ]
            ref = ref_by_id.get(v.pkg_id) or v.pkg_identifier.bom_ref \
                or v.pkg_identifier.purl
            if ref:
                affect = {
                    "ref": ref,
                    "versions": [{
                        "version": v.installed_version,
                        "status": "affected",
                    }],
                }
                if affect not in entry["affects"]:
                    entry["affects"].append(affect)

    dependencies.append({"ref": root_ref,
                         "dependsOn": sorted(set(root_deps))})
    doc = {
        "$schema": f"http://cyclonedx.org/schema/bom-{SPEC_VERSION}.schema.json",
        "bomFormat": "CycloneDX",
        "specVersion": SPEC_VERSION,
        "serialNumber": f"urn:uuid:{uuidgen.new()}",
        "version": 1,
        "metadata": {
            "timestamp": clock.now_rfc3339(),
            "tools": {
                "components": [{
                    "type": "application",
                    "group": "trivy-tpu",
                    "name": "trivy-tpu",
                    "version": trivy_tpu_torch.__version__,
                }],
            },
            "component": root,
        },
        "components": components,
        "dependencies": sorted(dependencies, key=lambda d: d["ref"]),
        "vulnerabilities": sorted(
            vulnerabilities.values(), key=lambda v: v["id"]
        ),
    }
    if not doc["vulnerabilities"]:
        del doc["vulnerabilities"]
    return json.dumps(doc, indent=2, ensure_ascii=False) + "\n"
