"""Kubernetes cluster scanning (reference pkg/k8s atop trivy-kubernetes):
resource enumeration, workload image extraction, misconfig + RBAC + infra
assessment, summary/json reporting.

Copy of trivy_tpu/k8s/. A workload image found as a local tar is scanned
on the match engine and the secret analyzer's device."""
