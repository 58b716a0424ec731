"""Per-format IaC parsers producing line-annotated IRs
(reference pkg/iac/scanners/*/parser).

Copy of trivy_tpu/iac/parsers/, whole.
"""
