"""OCI-attached VEX (reference pkg/vex/oci.go: openvex discovery over the
scanned image's package URL).

For a container-image report with repo digests, the registry is probed
for VEX attestations attached to the image digest:

1. the OCI 1.1 referrers API (`/v2/<repo>/referrers/<digest>`), filtered
   to OpenVEX artifact types
2. fallback: the cosign attachment tag (`sha256-<hex>.att`) used before
   referrers support

Attestation blobs may be raw OpenVEX JSON or DSSE envelopes wrapping an
in-toto statement whose predicate is the OpenVEX document; both decode
to the same VexDocument. Registry errors degrade to "no attestation" —
`--vex oci` must never fail a scan because a registry is unreachable.

Copy of trivy_tpu/vex/oci.py, on the port's own registry client
(artifact/image_source.py).
"""

from __future__ import annotations

import base64
import json

from trivy_tpu_torch.log import logger
from trivy_tpu_torch.vex.vex import VexDocument, _decode_openvex

_log = logger("vex")

_VEX_TYPES = (
    "application/openvex+json",
    "application/vnd.openvex+json",
)
_DSSE_TYPES = (
    "application/vnd.dsse.envelope+json",
    "application/vnd.in-toto+json",
)


def _decode_attestation(raw: bytes, source: str) -> VexDocument | None:
    try:
        doc = json.loads(raw)
    except ValueError:
        return None
    # DSSE envelope -> in-toto statement -> predicate
    if isinstance(doc, dict) and "payload" in doc:
        try:
            doc = json.loads(base64.b64decode(doc["payload"]))
        except (ValueError, TypeError):
            return None
    if isinstance(doc, dict) and "predicate" in doc:
        doc = doc["predicate"]
    if isinstance(doc, dict) and "statements" in doc:
        return _decode_openvex(doc, source)
    return None


def load_oci_vex(report) -> VexDocument | None:
    """-> the image's attached VEX document, or None (absent artifact
    type / digests / registry / attestation)."""
    md = getattr(report, "metadata", None)
    if getattr(report, "artifact_type", "") != "container_image" or \
            md is None or not getattr(md, "repo_digests", None):
        _log.warn("'--vex oci' only applies to registry container images")
        return None
    ref = md.repo_digests[0]
    try:
        return _fetch_for_digest(ref)
    except Exception as exc:
        _log.warn("VEX attestation lookup failed", ref=ref, err=str(exc))
        return None


def _fetch_for_digest(repo_digest: str) -> VexDocument | None:
    from trivy_tpu_torch.artifact.image_source import (
        RegistryClient,
        parse_reference,
    )

    name, digest = repo_digest.rsplit("@", 1)
    registry, repository, _tag, _d = parse_reference(name)
    client = RegistryClient(registry)
    source = f"VEX attestation in OCI registry ({repo_digest})"

    # OCI 1.1 referrers API
    for m in _referrers(client, repository, digest):
        if m.get("artifactType") in _VEX_TYPES or any(
            layer.get("mediaType") in _VEX_TYPES + _DSSE_TYPES
            for layer in m.get("layers", [])
        ):
            doc = _fetch_manifest_vex(client, repository,
                                      m.get("digest", ""), source)
            if doc is not None:
                return doc
    # cosign attachment tag fallback
    algo, _, hexd = digest.partition(":")
    att_tag = f"{algo}-{hexd}.att"
    try:
        manifest, _ = client.manifest(repository, att_tag)
    except Exception:
        _log.debug("no VEX attestation found", repo=repository)
        return None
    for layer in manifest.get("layers", []):
        raw = client.blob(repository, layer.get("digest", ""))
        doc = _decode_attestation(raw, source)
        if doc is not None:
            return doc
    return None


def _referrers(client, repository: str, digest: str) -> list[dict]:
    try:
        body, _headers = client._authed_get(
            f"/v2/{repository}/referrers/{digest}",
            "application/vnd.oci.image.index.v1+json",
            repository,
        )
        index = json.loads(body)
        return index.get("manifests", []) or []
    except Exception:
        return []


def _fetch_manifest_vex(client, repository: str, digest: str,
                        source: str) -> VexDocument | None:
    if not digest:
        return None
    try:
        manifest, _ = client.manifest(repository, digest)
    except Exception:
        return None
    for layer in manifest.get("layers", []):
        try:
            raw = client.blob(repository, layer.get("digest", ""))
        except Exception:
            continue
        doc = _decode_attestation(raw, source)
        if doc is not None:
            return doc
    return None
