from trivy_tpu_torch.scanner.local import LocalDriver
from trivy_tpu_torch.scanner.scan import Scanner

__all__ = ["LocalDriver", "Scanner"]
