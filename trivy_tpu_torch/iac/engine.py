"""User-extensible check engine — the functional equivalent of the
reference's OPA/Rego scanner (pkg/iac/rego/scanner.go:92-314, load.go):
checks are *data*, loaded at scan time from the embedded builtin bundle
plus user-supplied paths (--config-check), gated by namespaces
(--check-namespaces), with optional data documents (--config-data).

Two user check formats (instead of Rego modules):

1. Python check module (``*.py``)::

       __check__ = {
           "id": "USR-001", "title": "...", "severity": "HIGH",
           "type": "kubernetes",          # or "selector": [..types..]
           "namespace": "user.something", # default "user"
       }

       def deny(input, data=None):
           # return [] to pass, or messages / dicts to fail
           return [{"message": "...", "resource": "...",
                    "start_line": 1, "end_line": 2}]

2. Declarative YAML check (``*.yaml``/``*.yml``) — a small condition
   DSL over the same input document::

       id: USR-002
       title: hostNetwork must not be used
       severity: HIGH
       type: kubernetes
       deny:
         - path: spec.hostNetwork
           equals: true
           message: hostNetwork is enabled

   Conditions support dotted paths with ``[*]`` list wildcards and the
   operators equals / not_equals / exists / contains / regex / in /
   gt / gte / lt / lte / starts_with / ends_with, composable with
   ``all:`` / ``any:`` lists.

The *input document* mirrors the reference's Rego ``input`` per source
type (dockerfile: Stages/Commands; kubernetes: the resource document;
terraform/cloudformation/arm: a canonical Resources list) — see
``input_doc``.

Copy of trivy_tpu/iac/engine.py, whole.
"""

from __future__ import annotations

import importlib.util
import os
import re
import threading

from trivy_tpu_torch.analysis.witness import make_lock

import yaml

from trivy_tpu_torch.iac.check import Cause, Check
from trivy_tpu_torch.log import logger

_log = logger("checkengine")

# reference pkg/iac/rego/load.go:18 — namespaces always evaluated
BUILTIN_NAMESPACES = frozenset({"builtin", "defsec", "appshield"})

_SOURCE_TYPES = frozenset({
    "dockerfile", "kubernetes", "terraform", "cloudformation",
    "terraformplan", "azure-arm", "helm", "yaml", "json", "cloud",
})


class CheckLoadError(Exception):
    pass


# --------------------------------------------------------------- inputs


def input_doc(ctx) -> dict:
    """Uniform JSON-like document a check's conditions/deny() run over,
    per source type (the Rego ``input`` equivalent)."""
    kind = type(ctx).__name__
    if kind == "DockerfileCtx":
        df = ctx.dockerfile
        return {
            "Stages": [
                {
                    "Name": st.name or st.base,
                    "Base": st.base,
                    "StartLine": st.start_line,
                    "Commands": [
                        _dockerfile_command(i, idx, ctx.path)
                        for i in st.instructions
                    ],
                }
                for idx, st in enumerate(df.stages)
            ],
        }
    if kind == "K8sCtx":
        return ctx.resource
    if kind == "CloudCtx":
        return {
            "Resources": [
                {
                    "Type": r.type,
                    "Name": r.name,
                    "Values": r.attrs,
                    "StartLine": r.start_line,
                    "EndLine": r.end_line,
                }
                for r in ctx.cloud_resources
            ],
        }
    return {}


def _dockerfile_command(i, stage_idx: int, path: str) -> dict:
    """One Command in the reference's Rego input schema
    (pkg/iac/providers/dockerfile/dockerfile.go:30-44 — Value is
    []string: exec-form args split, shell-form run/cmd/entrypoint kept
    as one string, other instructions whitespace-tokenized)."""
    cmd = i.cmd.lower()
    value_src = i.value
    sub = ""
    if cmd in ("healthcheck", "onbuild"):
        head, _, rest = i.value.strip().partition(" ")
        if head and head.upper() in (
                "CMD", "NONE", "RUN", "COPY", "ADD", "ENTRYPOINT"):
            sub, value_src = head.lower(), rest
    arr = i.json_array() if value_src is i.value else None
    if arr is None and value_src.strip().startswith("["):
        import json as _json

        try:
            parsed = _json.loads(value_src.strip())
            arr = [str(a) for a in parsed] if isinstance(parsed, list) \
                else None
        except ValueError:
            arr = None
    if arr is not None:
        value, is_json = arr, True
    elif cmd in ("run", "cmd", "entrypoint") or sub:
        value, is_json = ([value_src] if value_src else []), False
    else:
        value, is_json = value_src.split(), False
    return {
        "Cmd": cmd,
        "SubCmd": sub,
        "Value": value,
        "JSON": is_json,
        "Original": " ".join(
            [i.cmd] + list(i.flags) + ([i.value] if i.value else [])),
        "Flags": list(i.flags),
        "Stage": stage_idx,
        "Path": path,
        "StartLine": i.start_line,
        "EndLine": i.end_line,
    }


# ----------------------------------------------------------- path walk


def resolve_path(doc, path: str) -> list:
    """Resolve a dotted path against a nested dict/list document.
    ``[*]`` fans out over list elements; ``[N]`` indexes. Returns every
    value the path reaches (possibly empty)."""
    parts = [p for p in path.split(".") if p]
    current = [doc]
    for part in parts:
        m = re.match(r"^([^\[\]]*)((?:\[[^\]]*\])*)$", part)
        if not m:
            return []
        key, idxs = m.group(1), re.findall(r"\[([^\]]*)\]", m.group(2))
        nxt = []
        for node in current:
            vals = [node]
            if key:
                vals = [node[key]] if isinstance(node, dict) and key in node \
                    else []
            for ix in idxs:
                fanned = []
                for v in vals:
                    if not isinstance(v, list):
                        continue
                    if ix == "*":
                        fanned.extend(v)
                    else:
                        try:
                            fanned.append(v[int(ix)])
                        except (ValueError, IndexError):
                            pass
                vals = fanned
            nxt.extend(vals)
        current = nxt
        if not current:
            return []
    return current


# ------------------------------------------------------------- YAML DSL


_OPS = {
    "equals": lambda v, arg: v == arg,
    "not_equals": lambda v, arg: v != arg,
    "contains": lambda v, arg: (arg in v) if isinstance(
        v, (str, list, dict)) else False,
    "regex": lambda v, arg: isinstance(v, str)
    and re.search(arg, v) is not None,
    "in": lambda v, arg: v in (arg or []),
    "gt": lambda v, arg: _num(v) is not None and _num(v) > arg,
    "gte": lambda v, arg: _num(v) is not None and _num(v) >= arg,
    "lt": lambda v, arg: _num(v) is not None and _num(v) < arg,
    "lte": lambda v, arg: _num(v) is not None and _num(v) <= arg,
    "starts_with": lambda v, arg: isinstance(v, str) and v.startswith(arg),
    "ends_with": lambda v, arg: isinstance(v, str) and v.endswith(arg),
}


def _num(v):
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def _eval_condition(cond: dict, doc) -> bool:
    if "all" in cond:
        return all(_eval_condition(c, doc) for c in cond["all"])
    if "any" in cond:
        return any(_eval_condition(c, doc) for c in cond["any"])
    if "not" in cond:
        return not _eval_condition(cond["not"], doc)
    path = cond.get("path", "")
    values = resolve_path(doc, path)
    if "exists" in cond:
        return bool(values) == bool(cond["exists"])
    for op, fn in _OPS.items():
        if op in cond:
            return any(fn(v, cond[op]) for v in values)
    raise CheckLoadError(f"condition has no operator: {cond!r}")


def _dsl_fn(spec: dict):
    deny = spec.get("deny") or []
    if not isinstance(deny, list):
        raise CheckLoadError("deny: must be a list of conditions")
    for cond in deny:
        _validate_condition(cond)

    def fn(ctx) -> list[Cause]:
        doc = input_doc(ctx)
        causes: list[Cause] = []
        for cond in deny:
            if _eval_condition(cond, doc):
                causes.append(Cause(
                    message=cond.get("message", spec.get("title", "")),
                    resource=_doc_resource(doc),
                ))
        return causes

    return fn


def _validate_condition(cond) -> None:
    if not isinstance(cond, dict):
        raise CheckLoadError(f"condition must be a mapping: {cond!r}")
    for junction in ("all", "any"):
        if junction in cond:
            for sub in cond[junction]:
                _validate_condition(sub)
            return
    if "not" in cond:
        _validate_condition(cond["not"])
        return
    if "exists" in cond:
        return
    if not any(op in cond for op in _OPS):
        raise CheckLoadError(f"condition has no operator: {cond!r}")


def _doc_resource(doc) -> str:
    if isinstance(doc, dict):
        md = doc.get("metadata")
        if isinstance(md, dict) and md.get("name"):
            return str(md["name"])
    return ""


# --------------------------------------------------------------- loaders


def _selectors(meta: dict) -> tuple:
    sel = meta.get("selector") or meta.get("type") or ()
    if isinstance(sel, str):
        sel = (sel,)
    sel = tuple(sel)
    bad = [s for s in sel if s not in _SOURCE_TYPES]
    if bad:
        raise CheckLoadError(f"unknown source type(s) {bad}")
    # "cloud" fans out to every cloud-IR format
    if "cloud" in sel:
        sel = tuple(s for s in sel if s != "cloud") + (
            "terraform", "cloudformation", "terraformplan", "azure-arm")
    return sel


def _mk_check(meta: dict, fn, origin: str) -> Check:
    cid = meta.get("id")
    if not cid:
        raise CheckLoadError(f"{origin}: check has no id")
    if not meta.get("title"):
        raise CheckLoadError(f"{origin}: check {cid} has no title")
    sel = _selectors(meta)
    if not sel:
        raise CheckLoadError(
            f"{origin}: check {cid} declares no type/selector")
    sev = str(meta.get("severity", "MEDIUM")).upper()
    if sev not in ("CRITICAL", "HIGH", "MEDIUM", "LOW", "UNKNOWN"):
        raise CheckLoadError(f"{origin}: bad severity {sev!r}")
    return Check(
        id=cid, avd_id=meta.get("avd_id", cid), title=meta["title"],
        description=meta.get("description", meta["title"]),
        resolution=meta.get("resolution", ""), severity=sev,
        file_types=sel, provider=meta.get("provider", "user"),
        service=meta.get("service", ""), url=meta.get("url", ""),
        namespace=meta.get("namespace", "user"),
        deprecated=bool(meta.get("deprecated", False)),
        fn=fn,
    )


def load_python_check(path: str, data: dict | None = None) -> list[Check]:
    name = "trivy_tpu_user_check_" + re.sub(
        r"\W", "_", os.path.abspath(path))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise CheckLoadError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    meta = getattr(mod, "__check__", None)
    if not isinstance(meta, dict):
        raise CheckLoadError(f"{path}: missing __check__ metadata dict")
    deny = getattr(mod, "deny", None)
    if not callable(deny):
        raise CheckLoadError(f"{path}: missing deny(input) function")

    import inspect

    wants_data = "data" in inspect.signature(deny).parameters

    def fn(ctx) -> list[Cause]:
        doc = input_doc(ctx)
        raw = deny(doc, data=data) if wants_data else deny(doc)
        causes = []
        for r in raw or []:
            if isinstance(r, Cause):
                causes.append(r)
            elif isinstance(r, dict):
                causes.append(Cause(
                    message=r.get("message", ""),
                    resource=r.get("resource", _doc_resource(doc)),
                    start_line=int(r.get("start_line", 0)),
                    end_line=int(r.get("end_line", 0)),
                ))
            else:
                causes.append(Cause(message=str(r),
                                    resource=_doc_resource(doc)))
        return causes

    return [_mk_check(meta, fn, path)]


def load_yaml_check(path: str) -> list[Check]:
    with open(path, "rb") as f:
        docs = [d for d in yaml.safe_load_all(f) if d]
    out = []
    for spec in docs:
        if not isinstance(spec, dict):
            raise CheckLoadError(f"{path}: check document is not a mapping")
        # tolerate a wrapping `check:` key
        spec = spec.get("check", spec)
        out.append(_mk_check(spec, _dsl_fn(spec), path))
    return out


def load_check_path(path: str, data: dict | None = None,
                    allow_python: bool = True) -> list[Check]:
    """Load one file or recursively a directory of check files
    (reference rego load.go LoadPoliciesFromDirs).

    allow_python=False refuses ``*.py`` checks — used for downloaded
    bundles, which are data-only: executing fetched code would be far
    beyond what the reference's sandboxed Rego bundles can do."""
    if os.path.isdir(path):
        out = []
        rego_paths = []     # rego modules in one dir load together so
        for root, _dirs, names in os.walk(path):    # imports resolve
            for n in sorted(names):
                if n.startswith("."):
                    continue
                if n.endswith(".py") and not allow_python:
                    _log.warn("ignoring python check in data-only bundle",
                              path=os.path.join(root, n))
                    continue
                if n.endswith(".rego"):
                    if not n.endswith("_test.rego"):
                        rego_paths.append(os.path.join(root, n))
                    continue
                if n.endswith((".py", ".yaml", ".yml")):
                    out.extend(load_check_path(
                        os.path.join(root, n), data, allow_python))
        if rego_paths:
            out.extend(_load_rego(rego_paths, data))
        return out
    if path.endswith(".rego"):
        return _load_rego([path], data)
    if path.endswith(".py"):
        if not allow_python:
            raise CheckLoadError(
                f"python checks are not allowed from bundles: {path}")
        return load_python_check(path, data)
    if path.endswith((".yaml", ".yml")):
        return load_yaml_check(path)
    raise CheckLoadError(f"unsupported check file type: {path}")


def _load_rego(paths: list[str], data: dict | None) -> list[Check]:
    from trivy_tpu_torch.iac.rego import RegoError, load_rego_checks

    try:
        return load_rego_checks(paths, data)
    except RegoError as e:
        raise CheckLoadError(str(e))


def load_data_paths(paths: list[str]) -> dict:
    """--config-data: recursively merge YAML/JSON documents into one
    data dict available to Python checks (reference rego data loading)."""
    data: dict = {}
    for p in paths or []:
        files = []
        if os.path.isdir(p):
            for root, _d, names in os.walk(p):
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith((".yaml", ".yml", ".json")))
        else:
            files.append(p)
        for f in files:
            try:
                with open(f, "rb") as fh:
                    doc = yaml.safe_load(fh)
            except Exception as e:
                raise CheckLoadError(f"bad data file {f}: {e}")
            if isinstance(doc, dict):
                data.update(doc)
    return data


# --------------------------------------------------------------- engine


class CheckSet:
    """The resolved set of checks for a scan: embedded builtins plus
    user checks from --config-check paths, filtered by enabled
    namespaces (reference scanner.go:193-196 topLevel gate)."""

    def __init__(self, check_paths: list[str] | None = None,
                 namespaces: list[str] | None = None,
                 data_paths: list[str] | None = None,
                 include_deprecated: bool = False,
                 bundle_paths: list[str] | None = None):
        self.namespaces = BUILTIN_NAMESPACES | set(namespaces or ())
        self.include_deprecated = include_deprecated
        data = load_data_paths(data_paths or [])
        self.user_checks: list[Check] = []
        for p in check_paths or []:
            loaded = load_check_path(p, data)
            _log.info("loaded checks", path=p, count=len(loaded))
            self.user_checks.extend(loaded)
        for p in bundle_paths or []:
            loaded = load_check_path(p, data, allow_python=False)
            _log.info("loaded bundle checks", path=p, count=len(loaded))
            self.user_checks.extend(loaded)

    def _enabled(self, chk: Check) -> bool:
        if chk.namespace.split(".")[0] not in self.namespaces:
            return False
        if chk.deprecated and not self.include_deprecated:
            return False
        return True

    def checks_for(self, file_type: str) -> list[Check]:
        from trivy_tpu_torch.iac.check import checks_for as builtin_for

        out = list(builtin_for(file_type))
        out.extend(c for c in self.user_checks
                   if file_type in c.file_types and self._enabled(c))
        return out


_default = CheckSet()
_active: CheckSet = _default
_lock = make_lock("iac.engine._lock")


def configure(check_paths: list[str] | None = None,
              namespaces: list[str] | None = None,
              data_paths: list[str] | None = None,
              include_deprecated: bool = False,
              bundle_paths: list[str] | None = None) -> CheckSet:
    """Install the scan-wide CheckSet (called once from the CLI runner
    before analyzers fan out)."""
    global _active
    cs = CheckSet(check_paths, namespaces, data_paths, include_deprecated,
                  bundle_paths)
    with _lock:
        _active = cs
    return cs


def reset() -> None:
    global _active
    with _lock:
        _active = _default


def active() -> CheckSet:
    return _active
