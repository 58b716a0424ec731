"""Built-in analyzers. Importing this package registers everything
(reference pkg/fanal/analyzer/all).

Copy of trivy_tpu/fanal/analyzers/__init__.py.
"""

from trivy_tpu_torch.fanal.analyzers import (  # noqa: F401
    config_analyzer,
    lang,
    license_file,
    misc,
    os_release,
    pkg_apk,
    pkg_dpkg,
    pkg_rpm,
    secret_analyzer,
)
