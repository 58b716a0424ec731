from trivy_tpu_torch.plugin.manager import (  # noqa: F401
    Plugin,
    PluginError,
    PluginManager,
)
