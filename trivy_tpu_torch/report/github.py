"""GitHub dependency snapshot writer (reference pkg/report/github/github.go).

The snapshot maps each result target (manifest path) to its resolved
package purls; intended for POST /repos/{owner}/{repo}/dependency-graph/
snapshots. Envelope field order, detector identity and per-package field
shapes match the reference writer so snapshot consumers are untouched.

Copy of trivy_tpu/report/github.py.
"""

from __future__ import annotations

import json
import os

import trivy_tpu_torch
from trivy_tpu_torch.types.report import Report
from trivy_tpu_torch.utils import clock


def render_github(report: Report) -> str:
    snapshot: dict = {
        "version": 0,
        "detector": {
            # detector identity mirrors the reference writer: snapshot
            # consumers (GitHub dependency graph) key on it
            "name": "trivy",
            "version": trivy_tpu_torch.__version__,
            "url": "https://github.com/aquasecurity/trivy",
        },
    }
    # Go marshals maps with sorted keys: RepoDigest sorts before RepoTag
    metadata = {}
    if report.metadata.repo_digests:
        metadata["aquasecurity:trivy:RepoDigest"] = \
            ", ".join(report.metadata.repo_digests)
    if report.metadata.repo_tags:
        metadata["aquasecurity:trivy:RepoTag"] = \
            ", ".join(report.metadata.repo_tags)
    if metadata:
        snapshot["metadata"] = metadata
    if ref := os.environ.get("GITHUB_REF", ""):
        snapshot["ref"] = ref
    if sha := os.environ.get("GITHUB_SHA", ""):
        snapshot["sha"] = sha
    snapshot["job"] = {
        "correlator": "_".join([
            os.environ.get("GITHUB_WORKFLOW", ""),
            os.environ.get("GITHUB_JOB", ""),
        ]),
        "id": os.environ.get("GITHUB_RUN_ID", ""),
    }
    snapshot["scanned"] = clock.now_rfc3339()

    manifests = {}
    for res in report.results:
        if not res.packages:
            continue
        manifest: dict = {"name": str(res.type)}
        # path shown for language-specific packages only
        if str(res.result_class) == "lang-pkgs":
            if str(report.artifact_type) == "container_image":
                src = ", ".join(report.metadata.repo_tags or [])
                with_hash = ", ".join(report.metadata.repo_digests or [])
                _, _, image_hash = with_hash.partition("@")
                if image_hash:
                    src += "@" + image_hash
                manifest["file"] = {"source_location": src}
            else:
                manifest["file"] = {"source_location": res.target}
        resolved = {}
        for pkg in res.packages:
            entry: dict = {}
            if pkg.identifier.purl:  # omitempty: no key for purl-less
                entry["package_url"] = pkg.identifier.purl
            entry["relationship"] = ("indirect"
                                     if pkg.relationship == "indirect"
                                     else "direct")
            if pkg.depends_on:
                entry["dependencies"] = list(pkg.depends_on)
            entry["scope"] = "runtime"
            if pkg.file_path:
                entry["metadata"] = {"source_location": pkg.file_path}
            resolved[pkg.name] = entry
        # map keys render sorted, as Go's encoding/json does
        manifest["resolved"] = dict(sorted(resolved.items()))
        manifests[res.target] = manifest
    snapshot["manifests"] = dict(sorted(manifests.items()))
    return json.dumps(snapshot, indent=2, ensure_ascii=False) + "\n"
