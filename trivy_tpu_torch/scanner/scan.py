"""Scan façade (reference pkg/scanner/scan.go).

Scanner{driver, artifact}.scan_artifact() is the top of the scan spine;
the Driver protocol (scan.go:141-144) is THE seam where local and remote
execution are swapped — LocalDriver runs the match engine in-process.

Copy of trivy_tpu/scanner/scan.py without the tracing spans and the
device profile hook. Each scan still draws its scan id from
`utils.uuid` (the reference's `obs.tracing.scan_scope` does), so the
uuid stream, and with it a filesystem artifact's blob id, stays the
reference's.
"""

from __future__ import annotations

from typing import Protocol

from trivy_tpu_torch.artifact.base import Artifact
from trivy_tpu_torch.types.artifact import OS
from trivy_tpu_torch.types.report import Metadata, Report, Result
from trivy_tpu_torch.types.scan import ScanOptions
from trivy_tpu_torch.utils import clock
from trivy_tpu_torch.utils import uuid as uuid_util

REPORT_SCHEMA_VERSION = 2


class Driver(Protocol):
    """reference pkg/scanner/scan.go:141-144"""

    def scan(
        self,
        target: str,
        artifact_key: str,
        blob_keys: list[str],
        options: ScanOptions,
    ) -> tuple[list[Result], OS]: ...


class Scanner:
    def __init__(self, driver: Driver, artifact: Artifact):
        self.driver = driver
        self.artifact = artifact

    def scan_artifact(self, options: ScanOptions) -> Report:
        # the reference's scan_scope draws a scan id here: drawn and
        # dropped, so fs blob ids take the same place in the uuid stream
        uuid_util.new()
        ref = self.artifact.inspect()
        try:
            results, os_found = self.driver.scan(
                ref.name, ref.id, ref.blob_ids, options
            )
        finally:
            self.artifact.clean(ref)

        metadata = Metadata(os=os_found if os_found.detected else None)
        if ref.image_metadata:
            metadata.image_id = ref.image_metadata.get("ImageID", "")
            metadata.diff_ids = ref.image_metadata.get("DiffIDs", [])
            metadata.repo_tags = ref.image_metadata.get("RepoTags", [])
            metadata.repo_digests = ref.image_metadata.get("RepoDigests", [])
            metadata.image_config = ref.image_metadata.get("ImageConfig", {})
            metadata.size = ref.image_metadata.get("Size", 0)
        if ref.sbom_meta is not None:
            sm = ref.sbom_meta
            metadata.image_id = sm.image_id
            metadata.diff_ids = sm.diff_ids
            metadata.repo_tags = sm.repo_tags
            metadata.repo_digests = sm.repo_digests

        return Report(
            schema_version=REPORT_SCHEMA_VERSION,
            created_at=clock.now_rfc3339(),
            artifact_name=ref.name,
            artifact_type=ref.type,
            metadata=metadata,
            results=results,
        )
