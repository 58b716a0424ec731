"""--ignore-policy: a user policy deciding which findings to drop
(reference pkg/result/filter.go applyPolicy, which evaluates an OPA Rego
policy with `package trivy; ignore { ... }` per finding).

This framework's check-engine formats stand in for Rego (the same
substitution as custom misconfig checks, iac/engine.py):

- YAML policy: ``ignore:`` is a list of condition objects in the check
  DSL, evaluated over the finding's report-JSON document; any matching
  condition drops the finding::

      ignore:
        - path: VulnerabilityID
          equals: CVE-2022-1234
        - all:
            - path: Severity
              equals: LOW
            - path: PkgName
              starts_with: internal-

- Python policy: a module defining ``ignore(finding) -> bool`` (explicit
  opt-in to code execution, like Python checks).

Copy of trivy_tpu/result/policy.py, whole.
"""

from __future__ import annotations

from trivy_tpu_torch.log import logger

_log = logger("policy")


class PolicyError(Exception):
    pass


class IgnorePolicy:
    def __init__(self, fn):
        self._fn = fn

    def ignored(self, finding_doc: dict) -> bool:
        try:
            return bool(self._fn(finding_doc))
        except Exception as exc:
            _log.warn("ignore policy error", err=str(exc))
            return False


def load_ignore_policy(path: str) -> IgnorePolicy:
    if path.endswith(".rego"):
        return _load_rego(path)
    if path.endswith((".yaml", ".yml")):
        return _load_yaml(path)
    if path.endswith(".py"):
        return _load_python(path)
    raise PolicyError(
        f"unsupported ignore policy {path!r} (want .rego/.yaml/.py)")


def _load_rego(path: str) -> IgnorePolicy:
    """Reference-compatible Rego ignore policy: `package trivy` with
    `ignore` rules evaluated per finding (pkg/result/filter.go
    applyPolicy; examples/ignore-policies/*.rego run unmodified)."""
    from trivy_tpu_torch.iac.rego import Evaluator, RegoError, parse_module

    with open(path, encoding="utf-8") as f:
        src = f.read()
    try:
        module = parse_module(src)
    except RegoError as exc:
        raise PolicyError(f"{path}: {exc}")
    query = "data." + ".".join(module.package) + ".ignore"

    def fn(finding: dict) -> bool:
        return Evaluator([module], input=finding).query(query) is True

    return IgnorePolicy(fn)


def _load_yaml(path: str) -> IgnorePolicy:
    import yaml

    from trivy_tpu_torch.iac.engine import (
        CheckLoadError,
        _eval_condition,
        _validate_condition,
    )

    with open(path, encoding="utf-8") as f:
        doc = yaml.safe_load(f) or {}
    conds = doc.get("ignore")
    if not isinstance(conds, list) or not conds:
        raise PolicyError(f"{path}: 'ignore' must be a list of conditions")
    try:
        for c in conds:
            _validate_condition(c)
    except CheckLoadError as exc:
        raise PolicyError(f"{path}: {exc}")

    def fn(finding: dict) -> bool:
        return any(_eval_condition(c, finding) for c in conds)

    return IgnorePolicy(fn)


def _load_python(path: str) -> IgnorePolicy:
    import importlib.util

    spec = importlib.util.spec_from_file_location("trivy_ignore_policy",
                                                  path)
    if spec is None or spec.loader is None:
        raise PolicyError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn = getattr(mod, "ignore", None)
    if not callable(fn):
        raise PolicyError(f"{path} defines no ignore(finding) function")
    return IgnorePolicy(fn)
