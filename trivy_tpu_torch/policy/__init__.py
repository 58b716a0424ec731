from trivy_tpu_torch.policy.bundle import bundle_check_paths, update_bundle

__all__ = ["bundle_check_paths", "update_bundle"]
