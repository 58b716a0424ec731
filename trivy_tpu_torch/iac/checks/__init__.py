"""Builtin checks (reference trivy-checks bundle embedded at
pkg/iac/rego/embed.go; IDs match the published DS/KSV/AVD-AWS rules).

Copy of trivy_tpu/iac/checks/, whole.
"""
