"""Artifacts: what a scan inspects into blobs (reference
pkg/fanal/artifact). image.py (tar / OCI archives, daemons,
registries, containerd), local_fs.py (a directory: `fs`, `rootfs`),
repo.py (a git repository, cloned at a branch, tag or commit when
asked), vm.py (a VM disk: raw, partitioned, sparse VMDK or an EBS
snapshot, with an ext4 or XFS guest) and sbom.py (an SBOM file).
"""

from trivy_tpu_torch.artifact.base import Artifact, ArtifactReference

__all__ = ["Artifact", "ArtifactReference"]
