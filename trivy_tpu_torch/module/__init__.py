from trivy_tpu_torch.module.manager import ModuleManager  # noqa: F401
