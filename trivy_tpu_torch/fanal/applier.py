"""Layer squashing: merge per-layer BlobInfos bottom-up into one
ArtifactDetail (reference pkg/fanal/applier/docker.go:95-256).

Semantics preserved:
- whiteouts/opaque dirs delete earlier layers' entries by path prefix
- per-(path, type) entries: the highest layer wins
- secrets merge per file across layers keeping layer attribution
  (docker.go:297-316)
- origin-layer attribution for packages found in lower layers
- dpkg license files merge into their packages
- "individual package" types (node-pkg, python-pkg, gemspec, jar) aggregate
  into one application per type (docker.go:268-293)

Copy of trivy_tpu/fanal/applier.py.
"""

from __future__ import annotations

import hashlib

from trivy_tpu_torch.types.artifact import (
    Application,
    ArtifactDetail,
    BlobInfo,
    Layer,
    OS,
    Secret,
)
from trivy_tpu_torch.utils.purl import purl_for_package

# aggregation targets (reference pkg/fanal/types TypeIndividualPkgs)
AGGREGATE_TYPES = {"node-pkg", "python-pkg", "gemspec", "jar", "conda-pkg"}


def pkg_uid(file_path: str, pkg) -> str:
    h = hashlib.blake2b(digest_size=8)
    h.update(
        f"{file_path}\x00{pkg.name}\x00{pkg.version}\x00{pkg.release}"
        f"\x00{pkg.epoch}\x00{pkg.arch}\x00{pkg.file_path}".encode()
    )
    return h.hexdigest()


class _PathMap:
    """Flat path->value map with prefix deletion (stands in for the
    reference's nested map; paths are keys, whiteouts delete by prefix)."""

    def __init__(self):
        self.entries: dict[tuple[str, ...], object] = {}

    def set(self, path: str, type_key: str, value) -> None:
        self.entries[tuple(path.split("/")) + (type_key,)] = value

    def delete_prefix(self, path: str) -> None:
        prefix = tuple(p for p in path.split("/") if p != "")
        for k in [k for k in self.entries if k[: len(prefix)] == prefix]:
            del self.entries[k]

    def walk(self):
        # insertion order is layer order; sort for stable output like the
        # reference's sorted nested-map walk
        for k in sorted(self.entries):
            yield self.entries[k]


def apply_layers(layers: list[BlobInfo]) -> ArtifactDetail:
    path_map = _PathMap()
    secrets: dict[str, Secret] = {}
    merged = ArtifactDetail()

    for layer in layers:
        for opq in layer.opaque_dirs:
            path_map.delete_prefix(opq.rstrip("/"))
        for wh in layer.whiteout_files:
            path_map.delete_prefix(wh)

        merged.os = merged.os.merge(layer.os)
        if layer.repository is not None:
            merged.repository = layer.repository
        if layer.build_info is not None:
            merged.build_info = layer.build_info  # last layer wins
        merged.digests.update(layer.digests)

        for pkg_info in layer.package_infos:
            path_map.set(pkg_info.file_path, "type:ospkg", pkg_info)
        for app in layer.applications:
            path_map.set(app.file_path, f"type:{app.type}", app)
        for misconf in layer.misconfigurations:
            path_map.set(misconf.file_path, "type:config", misconf)
        for secret in layer.secrets:
            _merge_secret(
                secrets, secret,
                Layer(layer.digest, layer.diff_id, layer.created_by),
            )
        for lic in layer.licenses:
            lic.layer = Layer(layer.digest, layer.diff_id)
            path_map.set(lic.file_path, f"type:license,{lic.type}", lic)
        for cr in layer.custom_resources:
            cr.layer = Layer(layer.digest, layer.diff_id)
            path_map.set(cr.file_path, f"custom:{cr.type}", cr)

    from trivy_tpu_torch.types.artifact import (
        CustomResource,
        LicenseFile,
        Misconfiguration,
        PackageInfo,
    )

    for value in path_map.walk():
        if isinstance(value, PackageInfo):
            merged.packages.extend(value.packages)
        elif isinstance(value, Application):
            merged.applications.append(value)
        elif isinstance(value, Misconfiguration):
            merged.misconfigurations.append(value)
        elif isinstance(value, LicenseFile):
            merged.licenses.append(value)
        elif isinstance(value, CustomResource):
            merged.custom_resources.append(value)

    merged.secrets = [secrets[k] for k in sorted(secrets)]

    # dpkg licenses merge into packages (docker.go:191-206)
    dpkg_licenses: dict[str, list[str]] = {}
    kept_licenses = []
    for lic in merged.licenses:
        if lic.type == "dpkg":
            dpkg_licenses[lic.package_name] = [f.name for f in lic.findings]
        else:
            kept_licenses.append(lic)
    merged.licenses = kept_licenses

    for pkg in merged.packages:
        if merged.build_info is not None:
            pkg.build_info = merged.build_info
        if not pkg.layer.digest and not pkg.layer.diff_id:
            origin = _lookup_origin_pkg(pkg, layers)
            if origin is not None:
                pkg.layer = Layer(origin[0], origin[1])
                if origin[2]:
                    pkg.installed_files = origin[2]
        if merged.os.family and not pkg.identifier.purl:
            pkg.identifier.purl = _os_purl(merged.os, pkg)
        pkg.identifier.uid = pkg_uid("", pkg)
        if pkg.name in dpkg_licenses:
            pkg.licenses = dpkg_licenses[pkg.name]

    for app in merged.applications:
        for pkg in app.packages:
            if not pkg.layer.digest and not pkg.layer.diff_id:
                origin = _lookup_origin_lib(app.file_path, pkg, layers)
                if origin is not None:
                    pkg.layer = Layer(origin[0], origin[1])
            if not pkg.identifier.purl:
                pkg.identifier.purl = purl_for_package(
                    "lang", app.type, pkg.name, pkg.version
                )
            pkg.identifier.uid = pkg_uid(app.file_path, pkg)

    _aggregate(merged)
    return merged


def _merge_secret(secrets: dict, secret: Secret, layer: Layer) -> None:
    """Secret merge keeps per-layer findings with attribution
    (reference docker.go:297-316)."""
    existing = secrets.get(secret.file_path)
    for f in secret.findings:
        f.layer = layer
    if existing is None:
        secrets[secret.file_path] = secret
    else:
        existing.findings = secret.findings  # upper layer wins per file


def _lookup_origin_pkg(pkg, layers):
    for layer in layers:
        for pi in layer.package_infos:
            for p in pi.packages:
                if (p.name, p.version, p.release) == (
                    pkg.name, pkg.version, pkg.release,
                ):
                    return layer.digest, layer.diff_id, p.installed_files
    return None


def _lookup_origin_lib(file_path, pkg, layers):
    for layer in layers:
        for app in layer.applications:
            if app.file_path != file_path:
                continue
            for p in app.packages:
                if (p.name, p.version) == (pkg.name, pkg.version):
                    return layer.digest, layer.diff_id
    return None


def _os_purl(os_info: OS, pkg) -> str:
    family_type = {
        "alpine": "apk", "chainguard": "apk", "wolfi": "apk",
        "minimos": "apk",
        "debian": "deb", "ubuntu": "deb", "echo": "deb",
    }.get(os_info.family, "rpm")
    from trivy_tpu_torch.utils.purl import PackageURL

    qualifiers = {}
    if pkg.arch:
        qualifiers["arch"] = pkg.arch
    if pkg.epoch:
        qualifiers["epoch"] = str(pkg.epoch)
    qualifiers["distro"] = f"{os_info.family}-{os_info.name}"
    version = pkg.version
    if pkg.release:
        version += f"-{pkg.release}"
    return str(PackageURL(
        type=family_type, namespace=os_info.family, name=pkg.name,
        version=version, qualifiers=qualifiers,
    ))


def _aggregate(merged: ArtifactDetail) -> None:
    """Aggregate individual-package apps into one per type
    (reference docker.go:268-293)."""
    aggregated: dict[str, Application] = {}
    kept = []
    for app in merged.applications:
        if app.type in AGGREGATE_TYPES:
            agg = aggregated.setdefault(app.type, Application(type=app.type))
            agg.packages.extend(app.packages)
        else:
            kept.append(app)
    merged.applications = kept + [aggregated[t] for t in sorted(aggregated)]
