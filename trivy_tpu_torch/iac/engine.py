"""The scan-wide check set (reference pkg/iac/rego/scanner.go:92-314:
the embedded builtin bundle, gated by namespaces).

Copy of trivy_tpu/iac/engine.py trimmed to the default `CheckSet`: the
builtins alone, with no user checks. Loading Python, YAML and Rego
checks (`--config-check`, `--check-namespaces`, `--config-data`,
`--include-deprecated-checks`, bundles) is not ported yet; the CLI
refuses those options and a cached bundle.
"""

from __future__ import annotations

from trivy_tpu_torch.analysis.witness import make_lock
from trivy_tpu_torch.iac.check import Check


class CheckSet:
    """The resolved set of checks for a scan: the embedded builtins."""

    def checks_for(self, file_type: str) -> list[Check]:
        from trivy_tpu_torch.iac.check import checks_for as builtin_for

        return list(builtin_for(file_type))


_default = CheckSet()
_active: CheckSet = _default
_lock = make_lock("iac.engine._lock")


def configure() -> CheckSet:
    """Install the scan-wide CheckSet (called once from the CLI runner
    before analyzers fan out)."""
    global _active
    cs = CheckSet()
    with _lock:
        _active = cs
    return cs


def reset() -> None:
    global _active
    with _lock:
        _active = _default


def active() -> CheckSet:
    return _active
