"""Artifact interface (reference pkg/fanal/artifact/artifact.go:79):
inspect() analyzes the artifact, stores blobs in the cache, and returns a
reference {name, type, id, blob_ids} for the scanner driver.

Copy of trivy_tpu/artifact/base.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol


@dataclass
class ArtifactReference:
    name: str = ""
    type: str = ""
    id: str = ""
    blob_ids: list[str] = field(default_factory=list)
    image_metadata: dict = field(default_factory=dict)
    # SBOM short-circuit metadata
    sbom_meta: object = None


class Artifact(Protocol):
    def inspect(self) -> ArtifactReference: ...

    def clean(self, ref: ArtifactReference) -> None: ...
