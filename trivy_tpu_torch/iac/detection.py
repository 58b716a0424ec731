"""Config file-type detection (reference pkg/iac/detection/detect.go:
extension hints + content sniffing).

Copy of trivy_tpu/iac/detection.py, whole.
"""

from __future__ import annotations

import json
import os
import re

# file types (reference pkg/misconf/scanner.go:40-52 type map)
DOCKERFILE = "dockerfile"
KUBERNETES = "kubernetes"
CLOUDFORMATION = "cloudformation"
TERRAFORM = "terraform"
TERRAFORM_PLAN = "terraformplan"
HELM = "helm"
YAML = "yaml"
JSON = "json"
AZURE_ARM = "azure-arm"

_DOCKERFILE_NAME = re.compile(
    r"(^|\.)(dockerfile|containerfile)(\.|$)", re.I
)
_K8S_KINDS_HINT = ("apiVersion", "kind")
_DOCKER_INSTRUCTION = re.compile(
    r"^\s*(FROM|ARG)\s+\S", re.I | re.M
)


def detect(path: str, content: bytes) -> str | None:
    """-> file type or None if not a config file we scan."""
    name = os.path.basename(path)
    lower = name.lower()

    if _DOCKERFILE_NAME.search(lower):
        return DOCKERFILE
    if lower.endswith((".tf", ".tf.json")):
        return TERRAFORM
    if lower.endswith(".tfvars"):
        return None  # inputs, not resources
    if lower in ("chart.yaml",) or _is_helm_template(path):
        return HELM
    if lower.endswith((".yaml", ".yml")):
        return _detect_yaml(content)
    if lower.endswith(".json"):
        return _detect_json(content)
    return None


def _is_helm_template(path: str) -> bool:
    parts = path.replace("\\", "/").split("/")
    return "templates" in parts and path.lower().endswith(
        (".yaml", ".yml", ".tpl")
    )


def _detect_yaml(content: bytes) -> str | None:
    text = content.decode("utf-8", "replace")
    if "AWSTemplateFormatVersion" in text or (
        "Resources:" in text and re.search(r"^\s+Type:\s*['\"]?AWS::",
                                           text, re.M)
    ):
        return CLOUDFORMATION
    head = text[:4096]
    if all(re.search(rf"^{k}\s*:", head, re.M) for k in _K8S_KINDS_HINT):
        return KUBERNETES
    return YAML


def _detect_json(content: bytes) -> str | None:
    try:
        doc = json.loads(content)
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(doc, dict):
        return JSON
    if "AWSTemplateFormatVersion" in doc or _cfn_resources(doc):
        return CLOUDFORMATION
    if doc.get("$schema", "").find("deploymentTemplate.json") >= 0:
        return AZURE_ARM
    if "apiVersion" in doc and "kind" in doc:
        return KUBERNETES
    if "terraform_version" in doc and "planned_values" in doc:
        return TERRAFORM_PLAN
    return JSON


def _cfn_resources(doc: dict) -> bool:
    res = doc.get("Resources")
    if not isinstance(res, dict):
        return False
    return any(
        isinstance(r, dict) and str(r.get("Type", "")).startswith("AWS::")
        for r in res.values()
    )
