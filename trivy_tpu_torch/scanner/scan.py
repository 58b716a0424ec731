"""Scan façade (reference pkg/scanner/scan.go).

Scanner{driver, artifact}.scan_artifact() is the top of the scan spine;
the Driver protocol (scan.go:141-144) is THE seam where local and remote
execution are swapped — LocalDriver runs the match engine in-process.

Copy of trivy_tpu/scanner/scan.py. The driver call runs under
`obs.tracing.torch_profile`, the reference's `jax_profile`: a
torch.profiler capture when TRIVY_TPU_JAX_TRACE_DIR is set. The scan
scope draws its scan id from `utils.uuid` before the inspect, as the
reference's does, so a filesystem artifact's blob id takes the same
place in the uuid stream.
"""

from __future__ import annotations

from typing import Protocol

from trivy_tpu_torch.artifact.base import Artifact
from trivy_tpu_torch.types.artifact import OS
from trivy_tpu_torch.types.report import Metadata, Report, Result
from trivy_tpu_torch.types.scan import ScanOptions
from trivy_tpu_torch.utils import clock

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
        from trivy_tpu_torch import obs
        from trivy_tpu_torch.obs import tracing as trace

        # every scan gets an ambient scan id (kept when an outer scope
        # already set one) that log records carry next to trace ids
        with trace.scan_scope(), trace.span("scan_artifact"):
            with obs.phase("inspect"):
                ref = self.artifact.inspect()
                trace.add_meta(blobs=len(ref.blob_ids))
            try:
                with trace.span("driver.scan"), trace.torch_profile():
                    results, os_found = self.driver.scan(
                        ref.name, ref.id, ref.blob_ids, options
                    )
            finally:
                self.artifact.clean(ref)

        metadata = Metadata(
            os=os_found if os_found.detected else None,
            # a degrading driver (resilience.fallback.FallbackDriver)
            # records why it fell back; primary scans leave this empty
            degraded=getattr(self.driver, "degraded_reason", "") or "",
        )
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
