from trivy_tpu_torch.artifact.base import Artifact, ArtifactReference

__all__ = ["Artifact", "ArtifactReference"]
