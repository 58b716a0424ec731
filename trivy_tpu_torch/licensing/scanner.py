"""License category scanning (reference pkg/licensing/scanner.go):
classify package/file licenses into categories with severities.

Copy of trivy_tpu/licensing/scanner.py, whole, with its imports rewritten.
"""

from __future__ import annotations

from trivy_tpu_torch.detector.langpkg import PKG_TARGETS
from trivy_tpu_torch.types.enums import ResultClass
from trivy_tpu_torch.types.report import DetectedLicense, Result

# default category mapping (reference pkg/licensing/category.go defaults)
FORBIDDEN = {"AGPL-1.0", "AGPL-3.0", "CC-BY-NC-1.0", "CC-BY-NC-2.0",
             "CC-BY-NC-2.5", "CC-BY-NC-3.0", "CC-BY-NC-4.0", "FDL-1.0",
             "GFDL-1.0", "GFDL-1.1", "GFDL-1.2", "GFDL-1.3"}
RESTRICTED = {"BCL", "CC-BY-ND-1.0", "CC-BY-ND-2.0", "CC-BY-ND-2.5",
              "CC-BY-ND-3.0", "CC-BY-ND-4.0", "CC-BY-SA-1.0", "CC-BY-SA-2.0",
              "CC-BY-SA-2.5", "CC-BY-SA-3.0", "CC-BY-SA-4.0", "GPL-1.0",
              "GPL-2.0", "GPL-2.0-with-autoconf-exception",
              "GPL-2.0-with-bison-exception", "GPL-2.0-with-classpath-exception",
              "GPL-2.0-with-font-exception", "GPL-2.0-with-GCC-exception",
              "GPL-3.0", "GPL-3.0-with-autoconf-exception",
              "GPL-3.0-with-GCC-exception", "LGPL-2.0", "LGPL-2.1", "LGPL-3.0",
              "NPL-1.0", "NPL-1.1", "OSL-1.0", "OSL-1.1", "OSL-2.0",
              "OSL-2.1", "OSL-3.0", "QPL-1.0", "Sleepycat"}
RECIPROCAL = {"APSL-1.0", "APSL-1.1", "APSL-1.2", "APSL-2.0", "CDDL-1.0",
              "CDDL-1.1", "CPL-1.0", "EPL-1.0", "EPL-2.0", "EUPL-1.1",
              "IPL-1.0", "MPL-1.0", "MPL-1.1", "MPL-2.0", "Ruby"}
NOTICE = {"AFL-1.1", "AFL-1.2", "AFL-2.0", "AFL-2.1", "AFL-3.0", "Apache-1.0",
          "Apache-1.1", "Apache-2.0", "Artistic-1.0", "Artistic-2.0",
          "BSD-2-Clause", "BSD-3-Clause", "BSD-4-Clause", "BSL-1.0",
          "CC-BY-1.0", "CC-BY-2.0", "CC-BY-2.5", "CC-BY-3.0", "CC-BY-4.0",
          "ISC", "MIT", "MS-PL", "NCSA", "OpenSSL", "PHP-3.0", "PHP-3.01",
          "PostgreSQL", "Python-2.0", "Unicode-DFS-2015", "Unicode-DFS-2016",
          "W3C", "X11", "Zlib", "ZPL-1.1", "ZPL-2.0", "ZPL-2.1"}
UNENCUMBERED = {"CC0-1.0", "Unlicense", "0BSD"}
PERMISSIVE: set = set()

_CATEGORY_SEVERITY = {
    "forbidden": "CRITICAL",
    "restricted": "HIGH",
    "reciprocal": "MEDIUM",
    "notice": "LOW",
    "permissive": "LOW",
    "unencumbered": "LOW",
    "unknown": "UNKNOWN",
}


def categorize(license_name: str, custom: dict | None = None) -> tuple[str, str]:
    """-> (category, severity).  The name is normalized to its SPDX id
    first (reference pkg/licensing/scanner.go:24-40)."""
    from trivy_tpu_torch.licensing.normalize import normalize

    license_name = normalize(license_name)
    if custom:
        for cat, names in custom.items():
            if license_name in names:
                return cat, _CATEGORY_SEVERITY.get(cat, "UNKNOWN")
    base = license_name.removesuffix("-only").removesuffix("-or-later")
    for cat, names in (
        ("forbidden", FORBIDDEN), ("restricted", RESTRICTED),
        ("reciprocal", RECIPROCAL), ("notice", NOTICE),
        ("unencumbered", UNENCUMBERED), ("permissive", PERMISSIVE),
    ):
        if license_name in names or base in names:
            return cat, _CATEGORY_SEVERITY[cat]
    return "unknown", "UNKNOWN"


def scan_licenses(detail, options) -> list[Result]:
    results = []
    custom = getattr(options, "license_categories", None)

    os_licenses = []
    for pkg in detail.packages:
        for name in pkg.licenses:
            cat, sev = categorize(name, custom)
            os_licenses.append(DetectedLicense(
                severity=sev, category=cat, pkg_name=pkg.name, name=name,
                confidence=1.0,
            ))
    if os_licenses:
        results.append(Result(
            target="OS Packages", result_class=ResultClass.LICENSE,
            licenses=os_licenses,
        ))

    for app in detail.applications:
        app_licenses = []
        for pkg in app.packages:
            for name in pkg.licenses:
                cat, sev = categorize(name, custom)
                app_licenses.append(DetectedLicense(
                    severity=sev, category=cat, pkg_name=pkg.name,
                    file_path=app.file_path, name=name, confidence=1.0,
                ))
        if app_licenses:
            results.append(Result(
                target=app.file_path
                or PKG_TARGETS.get(app.type, app.type),
                result_class=ResultClass.LICENSE,
                licenses=app_licenses,
            ))

    file_licenses = []
    for lic in detail.licenses:
        for f in lic.findings:
            cat, sev = categorize(f.name, custom)
            file_licenses.append(DetectedLicense(
                severity=sev, category=cat, file_path=lic.file_path,
                name=f.name, confidence=f.confidence, link=f.link,
            ))
    if file_licenses:
        results.append(Result(
            target="Loose File License(s)",
            result_class=ResultClass.LICENSE_FILE,
            licenses=file_licenses,
        ))
    return results
