"""Builtin checks (reference trivy-checks bundle embedded at
pkg/iac/rego/embed.go; IDs match the published KSV rules).

Copy of trivy_tpu/iac/checks/ with its kubernetes module only."""
