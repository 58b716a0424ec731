"""Shared helpers for the declarative (spec-table) check modules
(aws_ext / azure_ext / gcp_ext): unresolved-value tristate extraction
and the spec -> Check registration loop. One copy, so the
None-means-unknown semantics cannot drift between providers.

Copy of trivy_tpu/iac/checks/spec.py, whole.
"""

from __future__ import annotations

from trivy_tpu_torch.iac.check import Cause, check
from trivy_tpu_torch.iac.parsers.hcl import Block, Expr


def tf_value(x):
    """Resolved terraform value or None for unresolved expressions."""
    return None if isinstance(x, Expr) else x


def tri(b: Block | None, name: str, absent_default):
    """Attribute absent -> the provider default (a definite value);
    present but unresolved -> None = unknown (checks stay silent)."""
    if b is None or name not in b.attrs:
        return absent_default
    return tf_value(b.attrs[name].value)


def fail_if(attr, bad_values, message):
    def test(a):
        v = a.get(attr)
        if v is None:
            return None
        return message if v in bad_values else False
    return test


def fail_unless(attr, good_values, message):
    def test(a):
        v = a.get(attr)
        if v is None:
            return None
        return False if v in good_values else message
    return test


def lt(attr, minimum, message):
    """Fail when the numeric attr is below `minimum`. Tolerates
    string-typed numbers (CFN accepts quoted integers); a value that
    cannot be read as a number is unknown, not failing."""
    def test(a):
        v = a.get(attr)
        if v is None:
            return None
        if isinstance(v, bool):
            return None
        if isinstance(v, str):
            try:
                v = float(v)
            except ValueError:
                return None
        if not isinstance(v, (int, float)):
            return None
        return message if v < minimum else False
    return test


def register_specs(specs, *, provider: str, file_types) -> None:
    """(id, title, severity, rtype(s), service, test, resolution)
    entries -> registered Checks walking ctx.cloud_resources."""
    for cid, title, sev, rtype, service, test, resolution in specs:
        rtypes = rtype if isinstance(rtype, tuple) else (rtype,)

        def fn(ctx, _rtypes=rtypes, _test=test):
            causes = []
            for r in ctx.cloud_resources:
                if r.type not in _rtypes:
                    continue
                msg = _test(r.attrs)
                if msg:
                    causes.append(Cause(
                        message=msg, resource=r.name,
                        start_line=r.start_line, end_line=r.end_line))
            return causes

        check(cid, title, severity=sev, file_types=file_types,
              provider=provider, service=service,
              resolution=resolution)(fn)
