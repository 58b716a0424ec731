from trivy_tpu_torch.secret.scanner import SecretScanner

__all__ = ["SecretScanner"]
