"""OS-package vulnerability detection (reference pkg/detector/ospkg/
detect.go:66 + the 14 per-distro drivers, re-expressed as one table-driven
detector feeding the batched match engine).

Per-distro semantics preserved:
- osVer normalization (major vs minor vs full vs rolling)
- source name + source version are matched; binary version is reported
- arch filtering (rpm family, reference redhat.go:131-137)
- per-CVE dedup keeping the latest fixed version (redhat.go:139-147)
- EOSL flag from per-distro EOL tables

Copy of trivy_tpu/detector/ospkg.py; `detect` queries the port's
MatchEngine.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

from trivy_tpu_torch.db.model import Advisory
from trivy_tpu_torch.detector.engine import MatchEngine, PkgQuery
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.types.artifact import OS, Package, Repository
from trivy_tpu_torch.types.enums import Severity, Status
from trivy_tpu_torch.types.report import DataSource, DetectedVulnerability, VulnerabilityInfo

_log = logger("ospkg")

_SEVERITY_NAMES = {1: "LOW", 2: "MEDIUM", 3: "HIGH", 4: "CRITICAL"}


def _major(v: str) -> str:
    return v.split(".")[0]


def _minor(v: str) -> str:
    parts = v.split(".")
    return ".".join(parts[:2]) if len(parts) >= 2 else v


@dataclass(frozen=True)
class DistroConfig:
    scheme: str
    ver_mode: str  # "major" | "minor" | "full" | "none"
    source_id: str  # severity/data source id
    check_arches: bool = False
    dedup_latest: bool = False  # keep one advisory per CVE (latest fix)


# reference pkg/detector/ospkg/detect.go:32-51 driver map
DISTROS: dict[str, DistroConfig] = {
    "alpine": DistroConfig("apk", "minor", "alpine"),
    "chainguard": DistroConfig("apk", "none", "chainguard"),
    "wolfi": DistroConfig("apk", "none", "wolfi"),
    "minimos": DistroConfig("apk", "none", "minimos"),
    "debian": DistroConfig("deb", "major", "debian"),
    "ubuntu": DistroConfig("deb", "full", "ubuntu"),
    "echo": DistroConfig("deb", "none", "echo"),
    "alma": DistroConfig("rpm", "major", "alma", check_arches=True),
    "amazon": DistroConfig("rpm", "major", "amazon"),
    "azurelinux": DistroConfig("rpm", "minor", "azure"),
    "cbl-mariner": DistroConfig("rpm", "minor", "cbl-mariner"),
    "centos": DistroConfig("rpm", "major", "redhat", check_arches=True,
                           dedup_latest=True),
    "fedora": DistroConfig("rpm", "major", "fedora"),
    "oracle": DistroConfig("rpm", "major", "oracle-oval"),
    "photon": DistroConfig("rpm", "minor", "photon"),
    "redhat": DistroConfig("rpm", "major", "redhat", check_arches=True,
                           dedup_latest=True),
    "rocky": DistroConfig("rpm", "major", "rocky", check_arches=True),
    "opensuse": DistroConfig("rpm", "full", "suse-cvrf"),
    "opensuse-leap": DistroConfig("rpm", "full", "suse-cvrf"),
    "opensuse-tumbleweed": DistroConfig("rpm", "none", "suse-cvrf"),
    "suse linux enterprise micro": DistroConfig("rpm", "full", "suse-cvrf"),
    "suse linux enterprise server": DistroConfig("rpm", "full", "suse-cvrf"),
}

# redhat: skip packages from unsupported vendors (reference redhat.go:58-63)
_REDHAT_EXCLUDED_SUFFIXES = (".remi",)

# EOL tables for the majors (reference per-distro eolDates maps; dates are
# public distro lifecycle facts). Only families commonly scanned are listed;
# unknown families/releases -> no EOSL determination.
EOL_DATES: dict[str, dict[str, str]] = {
    "alpine": {
        "3.12": "2022-11-01", "3.13": "2022-11-01", "3.14": "2023-05-01",
        "3.15": "2023-11-01", "3.16": "2024-05-23", "3.17": "2024-11-22",
        "3.18": "2025-05-09", "3.19": "2025-11-01", "3.20": "2026-04-01",
        "3.21": "2026-11-01",
    },
    "debian": {
        "8": "2020-06-30", "9": "2022-06-30", "10": "2024-06-30",
        "11": "2026-08-14", "12": "2028-06-10", "13": "2030-06-10",
    },
    "ubuntu": {
        "14.04": "2024-04-25", "16.04": "2026-04-23", "18.04": "2028-04-26",
        "20.04": "2030-04-23", "20.10": "2021-07-22", "21.04": "2022-01-20",
        "22.04": "2032-04-21", "23.04": "2024-01-25", "23.10": "2024-07-11",
        "24.04": "2034-04-25", "24.10": "2025-07-11", "25.04": "2026-01-31",
    },
    "amazon": {
        "1": "2023-12-31", "2": "2026-06-30", "2022": "2026-06-30",
        "2023": "2028-03-15",
    },
    "centos": {"6": "2020-11-30", "7": "2024-06-30", "8": "2021-12-31"},
    "rocky": {"8": "2029-05-31", "9": "2032-05-31"},
    "alma": {"8": "2029-03-01", "9": "2032-05-31"},
}


def normalize_os_version(family: str, os_ver: str) -> str:
    cfg = DISTROS.get(family)
    if cfg is None:
        return os_ver
    if cfg.ver_mode == "major":
        return _major(os_ver)
    if cfg.ver_mode == "minor":
        return _minor(os_ver)
    if cfg.ver_mode == "none":
        return ""
    return os_ver


def bucket_for(family: str, os_ver: str) -> str:
    ver = normalize_os_version(family, os_ver)
    return f"{family} {ver}" if ver else family


def is_supported_version(family: str, os_ver: str, now=None) -> bool:
    """EOL check (reference pkg/detector/ospkg/version/version.go Supported)."""
    table = EOL_DATES.get(family)
    if not table:
        return True
    ver = normalize_os_version(family, os_ver)
    eol = table.get(ver)
    if eol is None:
        return True
    if now is None:
        from trivy_tpu_torch.utils import clock

        now = clock.now().date()
    return now <= datetime.date.fromisoformat(eol)


def detect(
    engine: MatchEngine,
    os_info: OS,
    repo: Repository | None,
    pkgs: list[Package],
    now=None,
) -> tuple[list[DetectedVulnerability], bool]:
    """-> (vulns, eosl). Mirrors ospkg.Detect (reference detect.go:66)."""
    family = os_info.family
    cfg = DISTROS.get(family)
    if cfg is None:
        _log.warn("unsupported os", family=family)
        return [], False

    os_ver = os_info.name
    if family == "alpine":
        # prefer the apk repository release over the os-release version
        # (reference alpine.go:70-84)
        if repo is not None and repo.release and repo.release != _minor(os_ver):
            os_ver = repo.release
        else:
            os_ver = _minor(os_ver)
        space = f"{family} {os_ver}"
    elif cfg.source_id == "redhat":
        # centos resolves against the Red Hat data (reference redhat.go);
        # the CPE-entry table expands into "redhat {major}" buckets at DB
        # load (trivy_tpu_torch.detector.redhat)
        space = f"redhat {normalize_os_version(family, os_ver)}"
    else:
        space = bucket_for(family, os_ver)

    _log.info("Detecting vulnerabilities...", os_family=family,
              os_version=normalize_os_version(family, os_info.name),
              pkg_num=len(pkgs))

    queries = []
    q_pkgs = []
    host_pairs: list[tuple[Package, list[Advisory]]] = []
    for pkg in pkgs:
        if cfg.source_id == "redhat":
            if any(pkg.release.endswith(s)
                   for s in _REDHAT_EXCLUDED_SUFFIXES):
                continue
            # Red Hat OVAL v2 is keyed by BINARY package name with the
            # modular stream prefixed (reference redhat.go:100,186-197)
            name = _modular_name(pkg.name, pkg.modularity_label)
            version = pkg.full_version()
            if pkg.build_info is not None:
                # build metadata (UBI) overrides the default content
                # sets: resolve CPE entries host-side per package
                # (reference redhat.go:102-110)
                from trivy_tpu_torch.detector import redhat as rh

                nvr = f"{pkg.build_info.nvr}-{pkg.build_info.arch}"
                host_pairs.append((pkg, rh.content_set_advisories(
                    engine.db, name,
                    pkg.build_info.content_sets, [nvr])))
                continue
        else:
            name = pkg.src_name or pkg.name
            version = pkg.full_src_version() or pkg.full_version()
        queries.append(PkgQuery(space, name, version, cfg.scheme))
        q_pkgs.append(pkg)

    results = engine.detect(queries)
    pairs: list[tuple[Package, list[Advisory]]] = [
        (pkg, [engine.cdb.advisories[i][2] for i in res.adv_indices])
        for pkg, res in zip(q_pkgs, results)
    ]
    if host_pairs:
        # build-metadata advisories bypass the device bucket, but still
        # need the exact version check the kernel would have applied
        from trivy_tpu_torch.detector.exact import AdvisoryChecker

        screened = []
        for pkg, advs in host_pairs:
            version = pkg.full_version()
            kept = [
                adv for adv in advs
                if AdvisoryChecker(adv, cfg.scheme).check(version)
            ]
            screened.append((pkg, kept))
        pairs.extend(screened)
    vulns: list[DetectedVulnerability] = []
    for pkg, advisories in pairs:
        per_cve: dict[str, tuple[Advisory, int]] = {}
        for idx, adv in enumerate(advisories):
            # arch filter (reference redhat.go:131-137)
            if cfg.check_arches and adv.arches and pkg.arch != "noarch":
                if pkg.arch not in adv.arches:
                    continue
            if cfg.dedup_latest:
                prev = per_cve.get(adv.vulnerability_id)
                if prev is not None and not _newer_fix(
                    engine, cfg.scheme, adv, prev[0]
                ):
                    continue
                per_cve[adv.vulnerability_id] = (adv, idx)
            else:
                per_cve[f"{adv.vulnerability_id}/{idx}"] = (adv, idx)
        for adv, _idx in per_cve.values():
            vulns.append(_to_vuln(pkg, adv, cfg))

    eosl = not is_supported_version(family, os_info.name, now)
    if eosl:
        _log.warn(
            "This OS version is no longer supported by the distribution",
            family=family, version=os_info.name,
        )
        _log.warn(
            "The vulnerability detection may be insufficient because security "
            "updates are not provided",
        )
    return vulns, eosl


def _modular_name(name: str, label: str) -> str:
    """"nodejs:12:<build>:<ctx>" + "npm" -> "nodejs:12::npm" (reference
    redhat.go:186-197 addModularNamespace: insert after the 2nd colon)."""
    count = 0
    for i, ch in enumerate(label):
        if ch == ":":
            count += 1
            if count == 2:
                return label[:i] + "::" + name
    return name


def _newer_fix(engine, scheme_name, a: Advisory, b: Advisory) -> bool:
    """True if a's fixed version is newer than b's."""
    from trivy_tpu_torch import versioning
    from trivy_tpu_torch.versioning.base import ParseError

    scheme = versioning.get_scheme(scheme_name)
    try:
        return scheme.compare(a.fixed_version or "0", b.fixed_version or "0") > 0
    except ParseError:
        return False


def _to_vuln(pkg: Package, adv: Advisory, cfg: DistroConfig) -> DetectedVulnerability:
    v = DetectedVulnerability(
        vulnerability_id=adv.vulnerability_id,
        vendor_ids=list(adv.vendor_ids),
        pkg_id=pkg.id,
        pkg_name=pkg.name,
        pkg_identifier=pkg.identifier,
        installed_version=pkg.full_version(),
        fixed_version=adv.fixed_version,
        status=Status.parse(adv.status) if adv.status else (
            Status.FIXED if adv.fixed_version else Status.AFFECTED
        ),
        layer=pkg.layer,
        data_source=DataSource(
            id=adv.data_source.id, name=adv.data_source.name,
            url=adv.data_source.url,
        ) if adv.data_source else None,
    )
    if adv.severity:
        # package-specific vendor severity (reference debian.go:83-89)
        v.severity_source = cfg.source_id
        v.info = VulnerabilityInfo(
            severity=str(Severity(adv.severity))
            if adv.severity in range(5) else "UNKNOWN",
        )
    return v
