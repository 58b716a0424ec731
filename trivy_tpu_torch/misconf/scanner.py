"""Misconfiguration scan façade (reference pkg/misconf/scanner.go):
file-type detection -> per-type parse -> check evaluation ->
Misconfiguration with PASS/FAIL entries, cause line ranges and code
snippets.

Copy of trivy_tpu/misconf/scanner.py, whole.
"""

from __future__ import annotations

import os
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
class DockerfileCtx:
    path: str = ""
    dockerfile: object = None


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


@dataclass
class CloudCtx:
    path: str = ""
    cloud_resources: list = field(default_factory=list)


def _contexts(file_type: str, path: str, content: bytes) -> list:
    if file_type == detection.DOCKERFILE:
        from trivy_tpu_torch.iac.parsers.dockerfile import parse_dockerfile

        return [DockerfileCtx(path=path,
                              dockerfile=parse_dockerfile(content))]
    if file_type in (detection.KUBERNETES, detection.HELM):
        from trivy_tpu_torch.iac.parsers.yamlconf import (
            k8s_resources,
            parse_config,
        )

        content = _strip_helm(content) if file_type == detection.HELM \
            else content
        docs = parse_config(content)
        return [K8sCtx(path=path, resource=r)
                for r in k8s_resources(docs)]
    if file_type == detection.TERRAFORM:
        # single-file entry: evaluate as a one-file module so expressions
        # (locals, functions, interpolations) still resolve
        from trivy_tpu_torch.iac.checks.cloud import adapt_terraform
        from trivy_tpu_torch.iac.terraform import ModuleLoader, evaluate_module

        dirname = os.path.dirname(path)
        loader = ModuleLoader({path: content})
        ev = evaluate_module({path: content}, dirname, loader)
        return [CloudCtx(path=path,
                         cloud_resources=adapt_terraform(ev.blocks))]
    if file_type == detection.CLOUDFORMATION:
        from trivy_tpu_torch.iac.checks.cloud import adapt_cloudformation
        from trivy_tpu_torch.iac.parsers.yamlconf import (
            cfn_resources,
            parse_config,
        )

        docs = parse_config(content)
        return [CloudCtx(path=path,
                         cloud_resources=adapt_cloudformation(
                             cfn_resources(docs)))]
    if file_type == detection.TERRAFORM_PLAN:
        import json as _json

        from trivy_tpu_torch.iac.checks.cloud import adapt_terraform_plan

        try:
            doc = _json.loads(content)
        except ValueError:
            return []
        return [CloudCtx(path=path,
                         cloud_resources=adapt_terraform_plan(doc))]
    if file_type == detection.AZURE_ARM:
        import json as _json

        from trivy_tpu_torch.iac.arm import evaluate_template
        from trivy_tpu_torch.iac.checks.azure import adapt_arm

        try:
            doc = _json.loads(content)
        except ValueError:
            return []
        # resolve [parameters()/variables()/...] expressions, expand
        # copy loops, flatten nested deployments before adapting
        # (reference pkg/iac/scanners/azure/arm + resolver)
        return [CloudCtx(path=path,
                         cloud_resources=adapt_arm(
                             evaluate_template(doc)))]
    return []


def _strip_helm(content: bytes) -> bytes:
    """Best-effort: drop {{ ... }} actions so the YAML parses
    (reference renders charts via helm engine; full render is out of
    scope for template-only scans)."""
    import re

    text = content.decode("utf-8", "replace")
    text = re.sub(r"\{\{.*?\}\}", "", text, flags=re.S)
    return text.encode()


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


def scan_terraform_modules(
        files: dict[str, bytes]) -> list[Misconfiguration]:
    """Directory-aware terraform scan: evaluate each ROOT module (child
    modules expand inline through their `source` dirs, reference
    pkg/iac/scanners/terraform), then run the checks over the evaluated
    resources, attributing findings to each resource's source file."""
    from trivy_tpu_torch.iac.checks.cloud import adapt_terraform
    from trivy_tpu_torch.iac.engine import active
    from trivy_tpu_torch.iac.terraform import (
        ModuleLoader,
        evaluate_module,
        module_dirs,
    )

    tf_files = {p: c for p, c in files.items()
                if p.endswith((".tf", ".tf.json"))}
    if not tf_files:
        return []
    loader = ModuleLoader(tf_files)
    # adapter context is scoped to the ROOT module tree that produced
    # each block (reference modules.GetResourcesByType spans one root +
    # its children, not sibling roots — an account default in stack A
    # must not suppress findings in unrelated stack B). A file shared
    # by several roots gets one context PER instantiating root, each
    # carrying only that root's blocks; _run_checks dedupes identical
    # causes across them.
    per_file_ctxs: dict[str, list] = {}
    for d in module_dirs(tf_files, loader=loader):
        ev = evaluate_module(loader.tf_files(d), d, loader)
        by_file: dict[str, list] = {}
        for blk in ev.blocks:
            by_file.setdefault(blk.src_path, []).append(blk)
        for path, blks in by_file.items():
            per_file_ctxs.setdefault(path, []).append(CloudCtx(
                path=path,
                cloud_resources=adapt_terraform(
                    blks, scan_blocks=ev.blocks)))
    out: list[Misconfiguration] = []
    for path in sorted(per_file_ctxs):
        content = files.get(path, b"")
        misconf = _run_checks(detection.TERRAFORM, path,
                              per_file_ctxs[path], content)
        if misconf.failures or misconf.successes:
            out.append(misconf)
    return out


def _run_checks(ftype: str, path: str, ctxs: list,
                content: bytes) -> Misconfiguration:
    """Run every active check for `ftype` over the contexts, apply
    `#trivy:ignore` / `#tfsec:ignore` comments (incl. parameterized and
    above-block forms), and collect FAIL/PASS findings."""
    from trivy_tpu_torch.utils import clock

    ignores = parse_ignores(content)
    today = clock.now().date()
    # line-range -> resolved attrs, so above-block and parameterized
    # ignores can bind to the resource a cause sits in
    spans = [(r.start_line, r.end_line, r.attrs)
             for ctx in ctxs
             for r in getattr(ctx, "cloud_resources", ())]

    def _enclosing(c: Cause):
        for s, e, attrs in spans:
            if s and s <= c.start_line <= max(e, s):
                return s, attrs
        return 0, None

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
            res_start, attrs = _enclosing(c)
            if not is_ignored(ignores, chk.id, chk.avd_id,
                              c.start_line, c.end_line,
                              resource_start=res_start, attrs=attrs,
                              today=today):
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
                file_type: str | None = None) -> Misconfiguration | None:
    """-> Misconfiguration (successes + failures) or None if the file is
    not a recognized config type."""
    ftype = file_type or detection.detect(path, content)
    if ftype is None or ftype in (detection.YAML, detection.JSON):
        return None  # plain data files: nothing to check (yet)
    ctxs = _contexts(ftype, path, content)
    if not ctxs:
        return None
    return _run_checks(ftype, path, ctxs, content)
