"""Cluster artifact enumeration (reference trivy-kubernetes
pkg/k8s + pkg/trivyk8s: lists cluster resources and derives scannable
artifacts). Two sources:

- a manifests directory / file (offline, deterministic — the test path)
- a live cluster via `kubectl get ... -o json` when kubectl + kubeconfig
  are available (network-gated, mirrors the reference's client-go use)

Copy of trivy_tpu/k8s/artifacts.py.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from dataclasses import dataclass, field

import yaml

from trivy_tpu_torch.log import logger

_log = logger("k8s")

# workload kinds whose pod specs carry images
WORKLOAD_KINDS = {
    "Pod", "Deployment", "StatefulSet", "DaemonSet", "ReplicaSet",
    "ReplicationController", "Job", "CronJob",
}
RBAC_KINDS = {"Role", "ClusterRole", "RoleBinding", "ClusterRoleBinding"}
# control-plane components assessed by the infra checks
INFRA_NAMES = ("kube-apiserver", "kube-controller-manager",
               "kube-scheduler", "etcd", "kubelet")


@dataclass
class KubeResource:
    kind: str = ""
    name: str = ""
    namespace: str = ""
    raw: dict = field(default_factory=dict)

    @property
    def fullname(self) -> str:
        ns = self.namespace or "default"
        return f"{ns}/{self.kind}/{self.name}"

    @property
    def images(self) -> list[str]:
        if self.kind not in WORKLOAD_KINDS:
            return []
        spec = _pod_spec(self.raw)
        out = []
        for key in ("initContainers", "containers", "ephemeralContainers"):
            for c in spec.get(key) or []:
                img = (c or {}).get("image")
                if img:
                    out.append(str(img))
        return out


def _pod_spec(doc: dict) -> dict:
    spec = doc.get("spec") or {}
    kind = doc.get("kind", "")
    if kind == "Pod":
        return spec
    if kind == "CronJob":
        return (((spec.get("jobTemplate") or {}).get("spec") or {})
                .get("template") or {}).get("spec") or {}
    return (spec.get("template") or {}).get("spec") or {}


def load_manifests(target: str) -> list[KubeResource]:
    """Parse a manifest file or directory tree into resources."""
    paths: list[str] = []
    if os.path.isdir(target):
        for root, _dirs, names in os.walk(target):
            for n in sorted(names):
                if n.endswith((".yaml", ".yml", ".json")):
                    paths.append(os.path.join(root, n))
    elif os.path.exists(target):
        paths = [target]
    else:
        raise RuntimeError(f"no such manifest file or directory: {target}")
    out: list[KubeResource] = []
    for p in paths:
        try:
            with open(p, "rb") as f:
                content = f.read()
        except OSError as e:
            _log.warn("cannot read manifest", path=p, err=str(e))
            continue
        out.extend(parse_manifest_docs(content))
    return out


def parse_manifest_docs(content: bytes) -> list[KubeResource]:
    docs: list[dict] = []
    text = content.decode("utf-8", "replace")
    if text.lstrip().startswith("{"):
        try:
            doc = json.loads(text)
            docs = doc.get("items", [doc]) if isinstance(doc, dict) else []
        except ValueError:
            return []
    else:
        try:
            for d in yaml.safe_load_all(text):
                if isinstance(d, dict):
                    docs.extend(d.get("items", [d])
                                if d.get("kind", "").endswith("List")
                                else [d])
        except yaml.YAMLError:
            return []
    out = []
    for d in docs:
        if not isinstance(d, dict) or not d.get("kind"):
            continue
        meta = d.get("metadata") or {}
        out.append(KubeResource(
            kind=str(d["kind"]), name=str(meta.get("name", "")),
            namespace=str(meta.get("namespace", "")), raw=d,
        ))
    return out


# ------------------------------------------------------------ live cluster


_KUBECTL_KINDS = (
    "pods", "deployments", "statefulsets", "daemonsets", "replicasets",
    "jobs", "cronjobs", "services", "configmaps",
    "roles", "clusterroles", "rolebindings", "clusterrolebindings",
    "networkpolicies", "ingresses",
)


def kubectl_available() -> bool:
    return shutil.which("kubectl") is not None


def load_cluster(context: str = "", namespace: str = "",
                 kinds: tuple = _KUBECTL_KINDS) -> list[KubeResource]:
    """Enumerate a live cluster: the API-server client first (kubeconfig
    or in-cluster service account, reference client-go), kubectl as a
    last-resort fallback."""
    try:
        return load_cluster_api(context, namespace, kinds)
    except Exception as e:
        _log.debug("api client unavailable, trying kubectl", err=str(e))
    if not kubectl_available():
        raise RuntimeError(
            "no kubeconfig/in-cluster credentials and no kubectl; "
            "scan a manifests directory instead")
    out: list[KubeResource] = []
    for kind in kinds:
        cmd = ["kubectl", "get", kind, "-o", "json"]
        cmd += ["--all-namespaces"] if not namespace else ["-n", namespace]
        if context:
            cmd += ["--context", context]
        try:
            proc = subprocess.run(cmd, capture_output=True, timeout=60)
        except (subprocess.TimeoutExpired, OSError) as e:
            _log.warn("kubectl failed", kind=kind, err=str(e))
            continue
        if proc.returncode != 0:
            _log.debug("kubectl get failed", kind=kind,
                       err=proc.stderr.decode("utf-8", "replace")[:200])
            continue
        out.extend(parse_manifest_docs(proc.stdout))
    return out


# kubectl plural -> API object Kind
_PLURAL_KIND = {
    "pods": "Pod", "deployments": "Deployment",
    "statefulsets": "StatefulSet", "daemonsets": "DaemonSet",
    "replicasets": "ReplicaSet", "jobs": "Job", "cronjobs": "CronJob",
    "services": "Service", "configmaps": "ConfigMap",
    "roles": "Role", "clusterroles": "ClusterRole",
    "rolebindings": "RoleBinding",
    "clusterrolebindings": "ClusterRoleBinding",
    "nodes": "Node",
}


def load_cluster_api(context: str = "", namespace: str = "",
                     kinds: tuple = _KUBECTL_KINDS) -> list[KubeResource]:
    """Enumerate a live cluster through the API server directly
    (trivy_tpu.k8s.client; no kubectl subprocess)."""
    from trivy_tpu_torch.k8s.client import API_PATHS, KubeClient

    client = KubeClient(context=context)
    out: list[KubeResource] = []
    errors = 0
    attempted = 0
    for plural in kinds:
        kind = _PLURAL_KIND.get(plural, plural)
        if kind not in API_PATHS:
            continue
        attempted += 1
        try:
            items = client.list(kind, namespace=namespace)
        except Exception as e:
            _log.debug("list failed", kind=kind, err=str(e))
            errors += 1
            continue
        for item in items:
            meta = item.get("metadata") or {}
            out.append(KubeResource(
                kind=item.get("kind", kind),
                name=meta.get("name", ""),
                namespace=meta.get("namespace", ""),
                raw=item,
            ))
    if not out and errors == attempted and attempted:
        # every list failed (e.g. exec-based kubeconfig auth this client
        # doesn't speak): surface the failure so load_cluster can fall
        # back to kubectl, which does support it
        raise RuntimeError("all API list calls failed (unsupported auth?)")
    return out
