"""IaC misconfiguration engine (reference pkg/iac, re-expressed as a
Python check engine over per-format parsers).

Copy of trivy_tpu/iac/ trimmed to what a kubernetes resource reaches:
the check model and registry (`check.py`), the 42 KSV checks
(`checks/kubernetes.py`), the line-annotated YAML parser
(`parsers/yamlconf.py`), `#trivy:ignore` comments (`ignore.py`), the
file-type name (`detection.py`) and the default check set
(`engine.py`). It runs entirely on the host.
"""
