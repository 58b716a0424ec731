"""Line-annotated YAML/JSON config parsing for kubernetes,
cloudformation, and generic yaml/json (reference
pkg/iac/scanners/{kubernetes,cloudformation,yaml,json}/parser).

Mappings carry hidden __line__/__end_line__ keys; CloudFormation
short-form intrinsics (!Ref, !Sub, !GetAtt, ...) are normalized to their
Fn:: long forms so checks see one shape.

Copy of trivy_tpu/iac/parsers/yamlconf.py, whole.
"""

from __future__ import annotations

import json
import re

import yaml

LINE_KEY = "__line__"
END_LINE_KEY = "__end_line__"


class _LineLoader(yaml.SafeLoader):
    pass


def _construct_mapping(loader, node, deep=False):
    mapping = yaml.SafeLoader.construct_mapping(loader, node, deep=deep)
    mapping[LINE_KEY] = node.start_mark.line + 1
    mapping[END_LINE_KEY] = node.end_mark.line + 1
    return mapping


_LineLoader.add_constructor(
    yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG, _construct_mapping
)


# CloudFormation short-form intrinsics -> long form
_INTRINSICS = (
    "Ref", "Sub", "GetAtt", "Join", "Select", "Split", "FindInMap",
    "Base64", "Cidr", "ImportValue", "GetAZs", "If", "Equals", "Not",
    "And", "Or", "Condition",
)


def _intrinsic(name):
    key = "Ref" if name == "Ref" else f"Fn::{name}"

    def construct(loader, node):
        if isinstance(node, yaml.ScalarNode):
            val = loader.construct_scalar(node)
            if name == "GetAtt" and isinstance(val, str):
                val = val.split(".", 1)
            return {key: val}
        if isinstance(node, yaml.SequenceNode):
            return {key: loader.construct_sequence(node, deep=True)}
        return {key: yaml.SafeLoader.construct_mapping(loader, node,
                                                       deep=True)}

    return construct


for _n in _INTRINSICS:
    _LineLoader.add_constructor(f"!{_n}", _intrinsic(_n))


def strip_lines(obj):
    """Deep-copy without the hidden line keys."""
    if isinstance(obj, dict):
        return {k: strip_lines(v) for k, v in obj.items()
                if k not in (LINE_KEY, END_LINE_KEY)}
    if isinstance(obj, list):
        return [strip_lines(v) for v in obj]
    return obj


def get_line(obj, default: int = 0) -> int:
    if isinstance(obj, dict):
        return obj.get(LINE_KEY, default)
    return default


def get_end_line(obj, default: int = 0) -> int:
    if isinstance(obj, dict):
        return obj.get(END_LINE_KEY, default)
    return default


def parse_yaml_docs(content: bytes) -> list[dict]:
    """Multi-document YAML -> list of line-annotated mappings."""
    text = content.decode("utf-8", "replace")
    docs = []
    try:
        for doc in yaml.load_all(text, Loader=_LineLoader):
            if isinstance(doc, dict):
                docs.append(doc)
    except yaml.YAMLError:
        return []
    return docs


def _annotate_json(obj, line: int = 1):
    # json.loads has no line info; approximate with the document start
    if isinstance(obj, dict):
        out = {k: _annotate_json(v, line) for k, v in obj.items()}
        out.setdefault(LINE_KEY, line)
        out.setdefault(END_LINE_KEY, line)
        return out
    if isinstance(obj, list):
        return [_annotate_json(v, line) for v in obj]
    return obj


def parse_config(content: bytes, file_type_hint: str = "yaml") -> list[dict]:
    """-> list of documents (k8s resources / CFN template / raw config)."""
    text = content.decode("utf-8", "replace").lstrip()
    if text.startswith("{") or file_type_hint == "json":
        try:
            doc = json.loads(text)
        except ValueError:
            return []
        if isinstance(doc, list):
            return [_annotate_json(d) for d in doc if isinstance(d, dict)]
        return [_annotate_json(doc)] if isinstance(doc, dict) else []
    return parse_yaml_docs(content)


# ------------------------------------------------------------ kubernetes


_K8S_WORKLOAD_KINDS = (
    "Pod", "Deployment", "StatefulSet", "DaemonSet", "ReplicaSet",
    "Job", "CronJob", "ReplicationController",
)


def k8s_resources(docs: list[dict]) -> list[dict]:
    out = []
    for doc in docs:
        if not isinstance(doc, dict):
            continue
        if "kind" in doc and "apiVersion" in doc:
            out.append(doc)
            # flatten List kinds
            if doc.get("kind") == "List":
                out.extend(i for i in doc.get("items") or []
                           if isinstance(i, dict))
    return out


def k8s_pod_spec(resource: dict) -> dict | None:
    """Extract the pod spec from any workload kind."""
    kind = resource.get("kind", "")
    if kind == "Pod":
        return resource.get("spec")
    if kind == "CronJob":
        return (((resource.get("spec") or {}).get("jobTemplate") or {})
                .get("spec") or {}).get("template", {}).get("spec")
    if kind in _K8S_WORKLOAD_KINDS:
        return ((resource.get("spec") or {}).get("template") or {}).get(
            "spec")
    return None


def k8s_containers(resource: dict) -> list[dict]:
    spec = k8s_pod_spec(resource) or {}
    out = []
    for key in ("initContainers", "containers", "ephemeralContainers"):
        out.extend(c for c in spec.get(key) or [] if isinstance(c, dict))
    return out


# ------------------------------------------------------------ cloudformation


def cfn_resources(docs: list[dict]) -> dict[str, dict]:
    """name -> resource mapping from a CloudFormation template."""
    for doc in docs:
        res = doc.get("Resources")
        if isinstance(res, dict):
            return {
                k: v for k, v in res.items()
                if isinstance(v, dict) and not k.startswith("__")
            }
    return {}


_SUB_VAR = re.compile(r"\$\{[^}]+\}")


def cfn_scalar(value, default=None):
    """Resolve a possibly-intrinsic scalar to a comparable value; keeps
    literal scalars, renders Fn::Sub templates with vars blanked."""
    if isinstance(value, dict):
        if "Fn::Sub" in value:
            t = value["Fn::Sub"]
            if isinstance(t, list):
                t = t[0] if t else ""
            return _SUB_VAR.sub("", str(t)) or default
        return default  # Ref / GetAtt etc. → unknown
    return value if value is not None else default
