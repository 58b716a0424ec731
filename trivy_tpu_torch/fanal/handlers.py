"""Post-handlers mutating BlobInfo after analysis
(reference pkg/fanal/handler/sysfile/filter.go:54): drop language packages
whose files were installed by the OS package manager — they're already
covered by the OS package scan.

Copy of trivy_tpu/fanal/handlers.py.
"""

from __future__ import annotations

from trivy_tpu_torch.fanal.analyzer import AnalysisResult

# app types exempt from the system-file filter (reference filter.go:
# these are looked up per-file, not per-project)
_EXEMPT_TYPES = {"node-pkg", "python-pkg", "gemspec", "jar", "conda-pkg"}


def system_file_filter(result: AnalysisResult) -> None:
    installed = set(result.system_installed_files)
    if not installed:
        return
    kept = []
    for app in result.applications:
        path = app.file_path
        if app.type in _EXEMPT_TYPES and path:
            # filter individual packages by their own path
            app.packages = [
                p for p in app.packages
                if (p.file_path or path) not in installed
                and "/" + (p.file_path or path) not in installed
            ]
            if app.packages:
                kept.append(app)
            continue
        if path and (path in installed or "/" + path in installed):
            continue
        kept.append(app)
    result.applications = kept
