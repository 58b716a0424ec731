"""Config file-type names (reference pkg/misconf/scanner.go:40-52 type
map).

Copy of the one constant of trivy_tpu/iac/detection.py that the
kubernetes path reads. Detection by file name and content (`detect`)
comes with the config command."""

from __future__ import annotations

KUBERNETES = "kubernetes"
