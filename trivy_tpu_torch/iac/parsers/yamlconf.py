"""Line-annotated YAML/JSON config parsing for kubernetes (reference
pkg/iac/scanners/kubernetes/parser).

Mappings carry hidden __line__/__end_line__ keys.

Copy of trivy_tpu/iac/parsers/yamlconf.py trimmed to what the
kubernetes path calls. The CloudFormation short-form intrinsics and
`cfn_resources` / `cfn_scalar` come with the config command.
"""

from __future__ import annotations

import json

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
    """-> list of documents (k8s resources / raw config)."""
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
