from trivy_tpu_torch.sbom.decode import decode_sbom_file, detect_sbom_format

__all__ = ["decode_sbom_file", "detect_sbom_format"]
