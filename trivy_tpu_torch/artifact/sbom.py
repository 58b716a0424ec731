"""SBOM-file artifact (reference pkg/fanal/artifact/sbom/sbom.go): decode
the BOM into one BlobInfo — no file walking at all, the purest matching
entry point (SURVEY.md §3.5).

Copy of trivy_tpu/artifact/sbom.py: the same blob key and content, so
the two packages' blob caches hold the same entry for one SBOM.
"""

from __future__ import annotations

import dataclasses
import hashlib

from trivy_tpu_torch.artifact.base import ArtifactReference
from trivy_tpu_torch.sbom.decode import decode_sbom_file

SBOM_ARTIFACT_VERSION = 1  # bump to invalidate cached SBOM blobs


class SBOMArtifact:
    def __init__(self, path: str, cache):
        self.path = path
        self.cache = cache

    def inspect(self) -> ArtifactReference:
        blob, meta = decode_sbom_file(self.path)
        with open(self.path, "rb") as f:
            content = f.read()
        h = hashlib.sha256()
        h.update(content)
        h.update(str(SBOM_ARTIFACT_VERSION).encode())
        blob_id = "sha256:" + h.hexdigest()
        self.cache.put_blob(blob_id, dataclasses.asdict(blob))
        return ArtifactReference(
            name=meta.artifact_name or self.path,
            type=meta.artifact_type,
            id=blob_id,
            blob_ids=[blob_id],
            sbom_meta=meta,
        )

    def clean(self, ref: ArtifactReference) -> None:
        pass
