"""Misconfiguration scan façade (reference pkg/misconf/scanner.go):
parse -> check evaluation -> Misconfiguration with PASS/FAIL entries,
cause line ranges and code snippets.

Copy of trivy_tpu/misconf/scanner.py trimmed to kubernetes resources
(`K8sCtx` and the kubernetes branch of `_contexts`), `_run_checks` and
`scan_config`. The other file types, their detection and
`scan_terraform_modules` come with the config command.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch.iac import detection
from trivy_tpu_torch.iac.check import Cause, Check
from trivy_tpu_torch.iac.ignore import is_ignored, parse_ignores
from trivy_tpu_torch.types.artifact import Misconfiguration
from trivy_tpu_torch.types.report import (
    CauseMetadata,
    Code,
    DetectedMisconfiguration,
    Line,
)


@dataclass
class K8sCtx:
    path: str = ""
    resource: dict = field(default_factory=dict)

    @property
    def pod_spec(self):
        from trivy_tpu_torch.iac.parsers.yamlconf import k8s_pod_spec

        return k8s_pod_spec(self.resource)

    @property
    def containers(self):
        from trivy_tpu_torch.iac.parsers.yamlconf import k8s_containers

        return k8s_containers(self.resource)


def _contexts(file_type: str, path: str, content: bytes) -> list:
    if file_type == detection.KUBERNETES:
        from trivy_tpu_torch.iac.parsers.yamlconf import (
            k8s_resources,
            parse_config,
        )

        docs = parse_config(content)
        return [K8sCtx(path=path, resource=r)
                for r in k8s_resources(docs)]
    return []


def _snippet(content: bytes, start: int, end: int) -> Code:
    lines = content.decode("utf-8", "replace").splitlines()
    out = []
    end = min(max(end, start), len(lines))
    for n in range(max(start, 1), end + 1):
        if n > len(lines):
            break
        out.append(Line(
            number=n, content=lines[n - 1],
            is_cause=True,
            first_cause=(n == start), last_cause=(n == end),
        ))
    return Code(lines=out)


def _to_detected(chk: Check, file_type: str, cause: Cause | None,
                 content: bytes, status: str) -> DetectedMisconfiguration:
    md = CauseMetadata(provider=chk.provider, service=chk.service)
    message = chk.title
    if cause is not None:
        md.resource = cause.resource
        md.start_line = cause.start_line
        md.end_line = max(cause.end_line, cause.start_line)
        if cause.start_line:
            md.code = _snippet(content, cause.start_line, md.end_line)
        message = cause.message or chk.title
    ns = chk.namespace
    if ns == "builtin":
        ns = f"builtin.{chk.provider}.{chk.service}".rstrip(".")
    return DetectedMisconfiguration(
        type=file_type, id=chk.id, avd_id=chk.avd_id, title=chk.title,
        description=chk.description, message=message,
        namespace=ns,
        query=f"data.{ns}.deny", resolution=chk.resolution,
        severity=chk.severity, primary_url=chk.url,
        references=[chk.url] if chk.url else [], status=status,
        cause_metadata=md,
    )


def _run_checks(ftype: str, path: str, ctxs: list,
                content: bytes) -> Misconfiguration:
    """Run every active check for `ftype` over the contexts, apply
    `#trivy:ignore` / `#tfsec:ignore` comments, and collect FAIL/PASS
    findings. The reference binds above-block and parameterized ignores
    to the cloud resource a cause sits in; a kubernetes context has
    none, so that binding comes with the config command."""
    from trivy_tpu_torch.utils import clock

    ignores = parse_ignores(content)
    today = clock.now().date()
    misconf = Misconfiguration(file_type=ftype, file_path=path)
    from trivy_tpu_torch.iac.engine import active

    for chk in active().checks_for(ftype):
        causes: list[Cause] = []
        for ctx in ctxs:
            try:
                causes.extend(chk.run(ctx))
            except Exception:
                continue  # a broken check must not kill the scan
        kept = []
        seen: set[tuple] = set()
        for c in causes:
            # a file shared by several root modules is checked once per
            # instantiating root: identical causes collapse to one
            key = (c.message, c.resource, c.start_line, c.end_line)
            if key in seen:
                continue
            seen.add(key)
            if not is_ignored(ignores, chk.id, chk.avd_id,
                              c.start_line, c.end_line, today=today):
                kept.append(c)
        causes = kept
        if causes:
            for c in causes:
                misconf.failures.append(
                    _to_detected(chk, ftype, c, content, "FAIL"))
        else:
            misconf.successes.append(
                _to_detected(chk, ftype, None, content, "PASS"))
    return misconf


def scan_config(path: str, content: bytes,
                file_type: str) -> Misconfiguration | None:
    """-> Misconfiguration (successes + failures), or None when the
    content holds no resource of `file_type` (a type other than
    kubernetes holds none here)."""
    ctxs = _contexts(file_type, path, content)
    if not ctxs:
        return None
    return _run_checks(file_type, path, ctxs, content)
