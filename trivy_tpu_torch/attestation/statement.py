"""In-toto attestation parsing (reference pkg/attestation/attestation.go):
a DSSE envelope {payloadType, payload: base64, signatures} whose payload
is an in-toto statement {_type, predicateType, subject, predicate}.
Cosign SBOM attestations wrap the SBOM one level deeper in
predicate.Data (CosignPredicate, attestation.go:17-19).

Copy of trivy_tpu/attestation/statement.py.
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field

IN_TOTO_PAYLOAD_TYPE = "application/vnd.in-toto+json"

# well-known predicate types (cosign / in-toto)
PREDICATE_CYCLONEDX = "https://cyclonedx.org/bom"
PREDICATE_SPDX = "https://spdx.dev/Document"
PREDICATE_COSIGN_VULN = "https://cosign.sigstore.dev/attestation/vuln/v1"


class AttestationError(ValueError):
    pass


@dataclass
class Statement:
    type: str = ""
    predicate_type: str = ""
    subject: list[dict] = field(default_factory=list)
    predicate: dict | list | None = None


def parse_statement(data: bytes | str | dict) -> Statement:
    """Decode a DSSE envelope into its in-toto statement."""
    if isinstance(data, (bytes, str)):
        try:
            envelope = json.loads(data)
        except ValueError as e:
            raise AttestationError(f"not a JSON DSSE envelope: {e}") from e
    else:
        envelope = data
    if not isinstance(envelope, dict):
        raise AttestationError("DSSE envelope must be a JSON object")
    payload_type = envelope.get("payloadType", "")
    if payload_type != IN_TOTO_PAYLOAD_TYPE:
        raise AttestationError(
            f"invalid attestation payload type: {payload_type}")
    try:
        decoded = base64.b64decode(envelope.get("payload", ""))
        doc = json.loads(decoded)
    except ValueError as e:
        raise AttestationError(
            f"failed to decode attestation payload: {e}") from e
    return Statement(
        type=doc.get("_type", ""),
        predicate_type=doc.get("predicateType", ""),
        subject=doc.get("subject") or [],
        predicate=doc.get("predicate"),
    )


def unwrap_cosign_predicate(statement: Statement):
    """Cosign SBOM attestations store the document under
    predicate.Data (reference attestation.go:14-19 + sbom decode)."""
    pred = statement.predicate
    if isinstance(pred, dict) and "Data" in pred:
        return pred["Data"]
    return pred


def is_attestation(doc: dict) -> bool:
    return isinstance(doc, dict) and "payloadType" in doc and \
        "payload" in doc
