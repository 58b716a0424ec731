"""Check model + registry (reference pkg/iac/rego metadata + rules
registry, pkg/iac/scan.Rule — Rego policies re-expressed as Python
predicates over the parsed IR).

Copy of trivy_tpu/iac/check.py, whole.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Cause:
    """One failing location."""

    message: str = ""
    resource: str = ""
    start_line: int = 0
    end_line: int = 0


@dataclass
class Check:
    id: str = ""            # DS002 / KSV001 / AVD-AWS-0086 ...
    avd_id: str = ""
    title: str = ""
    description: str = ""
    resolution: str = ""
    severity: str = "MEDIUM"
    file_types: tuple = ()  # detection types this check applies to
    provider: str = ""      # dockerfile/kubernetes/aws/...
    service: str = ""
    url: str = ""
    namespace: str = "builtin"  # top-level gates evaluation (engine.py)
    deprecated: bool = False
    # fn(ctx) -> list[Cause]; empty list = pass
    fn: object = None

    def run(self, ctx) -> list[Cause]:
        return self.fn(ctx) or []


_REGISTRY: dict[str, Check] = {}


def register(check: Check) -> Check:
    prev = _REGISTRY.get(check.id)
    if prev is not None and prev.fn is not check.fn:
        raise ValueError(
            f"duplicate check id {check.id!r}: already registered "
            f"as {prev.title!r}")
    _REGISTRY[check.id] = check
    return check


def checks_for(file_type: str) -> list[Check]:
    _load_builtins()
    return sorted(
        (c for c in _REGISTRY.values() if file_type in c.file_types),
        key=lambda c: c.id,
    )


def all_checks() -> list[Check]:
    _load_builtins()
    return sorted(_REGISTRY.values(), key=lambda c: c.id)


_loaded = False
_load_lock = __import__("threading").Lock()


def _load_builtins():
    global _loaded
    if _loaded:
        return
    with _load_lock:  # parallel scan workers race the first load
        if _loaded:
            return
        from trivy_tpu_torch.iac.checks import (  # noqa: F401
            aws_ext,
            azure,
            azure_ext,
            cloud,
            docker,
            gcp,
            gcp_ext,
            kubernetes,
            providers_misc,
        )
        _loaded = True


def check(id: str, title: str, *, severity="MEDIUM", file_types=(),
          avd_id="", description="", resolution="", provider="",
          service="", url=""):
    """Decorator: @check("DS002", "...") def f(ctx) -> list[Cause]."""

    def wrap(fn):
        register(Check(
            id=id, avd_id=avd_id or id, title=title,
            description=description or title, resolution=resolution,
            severity=severity, file_types=tuple(file_types),
            provider=provider, service=service,
            url=url or f"https://avd.aquasec.com/misconfig/{id.lower()}",
            fn=fn,
        ))
        return fn

    return wrap
