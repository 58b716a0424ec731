"""Unpackaged-binary SBOM discovery (reference
pkg/fanal/handler/unpackaged/unpackaged.go): for executables not owned
by any package manager, look up their sha256 digest in rekor; when a
cosign SBOM attestation exists, decode it and attach the packages as an
application at the binary's path.  Enabled with `--sbom-sources rekor`.

Copy of trivy_tpu/fanal/unpackaged.py.
"""

from __future__ import annotations

from trivy_tpu_torch.attestation import parse_statement, unwrap_cosign_predicate
from trivy_tpu_torch.attestation.rekor import MAX_GET_ENTRIES, Client, RekorError
from trivy_tpu_torch.log import logger

_log = logger("unpackaged")


def discover_sboms(detail, rekor_url: str) -> int:
    """Mutates detail.applications with rekor-attested SBOMs for
    detail.digests entries.  Returns the number of binaries resolved."""
    import json

    from trivy_tpu_torch.sbom.decode import decode_sbom_bytes

    if not detail.digests:
        return 0
    client = Client(rekor_url)
    resolved = 0
    for path, digest in sorted(detail.digests.items()):
        hash_ = digest.removeprefix("sha256:")
        try:
            ids = client.search(f"sha256:{hash_}")
            if not ids:
                continue
            entries = client.get_entries(ids[:MAX_GET_ENTRIES])
        except RekorError as e:
            _log.debug("rekor lookup failed", path=path, err=str(e))
            continue
        for entry in entries:
            try:
                statement = parse_statement(entry.statement)
                inner = unwrap_cosign_predicate(statement)
                if isinstance(inner, str):
                    inner = json.loads(inner)
                blob, _meta = decode_sbom_bytes(
                    json.dumps(inner).encode())
            except (ValueError, TypeError) as e:
                _log.debug("attestation decode failed", path=path,
                           err=str(e))
                continue
            for app in blob.applications:
                app.file_path = app.file_path or path
                detail.applications.append(app)
            if blob.applications:
                resolved += 1
                _log.info("unpackaged binary resolved via rekor",
                          path=path,
                          apps=len(blob.applications))
                break
    return resolved
