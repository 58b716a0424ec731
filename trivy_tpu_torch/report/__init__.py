from trivy_tpu_torch.report.writer import write_report

__all__ = ["write_report"]
