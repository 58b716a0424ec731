"""Concurrency analysis of the port: the opt-in lock-order witness
(`witness.py`, a copy of trivy_tpu/analysis/witness.py). The
reference's linter and static lock pass are not ported. Import-light
on purpose: modules import `witness` at load to name their locks."""
