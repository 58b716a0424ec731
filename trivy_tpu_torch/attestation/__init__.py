from trivy_tpu_torch.attestation.statement import (  # noqa: F401
    AttestationError,
    Statement,
    is_attestation,
    parse_statement,
    unwrap_cosign_predicate,
)
