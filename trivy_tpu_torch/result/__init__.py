from trivy_tpu_torch.result.filter import filter_report

__all__ = ["filter_report"]
