"""IaC misconfiguration engine (reference pkg/iac, 41k LoC of Go+Rego,
re-expressed as a Python check engine over per-format parsers).

Pipeline (reference pkg/misconf/scanner.go): detect file type -> parse to
a typed IR -> evaluate builtin checks -> Misconfiguration with cause
line ranges and code snippets. Runs entirely host-side (the reference
keeps misconfig scanning client-side even in client/server mode,
docs/docs/references/modes/client-server.md:11-21).

Copy of trivy_tpu/iac/, whole: the builtins, and the user checks
(Python, YAML and Rego: `engine.py`, `rego.py`).
"""
