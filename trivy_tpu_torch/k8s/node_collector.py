"""Node collector (reference trivy-kubernetes node-collector: a per-node
Job gathers kubelet configuration, file permissions/ownership, and node
metadata that the API server does not expose; its stdout is a NodeInfo
JSON document assessed against the KCV node checks).

Three pieces, mirroring the reference flow
(pkg/k8s/commands/cluster.go:39-87 ListArtifactAndNodeInfo):
  collector_job(node, …)      -> the Job manifest dispatched per node
  collect_node_info(client,…) -> run the job, read the pod log, clean up
  assess_node_info(doc)       -> InfraFindings from the NodeInfo document

Offline path: `kind: NodeInfo` documents found among scanned manifests
are assessed directly, so air-gapped clusters can run the collector
out-of-band and feed its output to `trivy-tpu k8s <dir>`.

Copy of trivy_tpu/k8s/node_collector.py.
"""

from __future__ import annotations

import hashlib
import json
import re
import time

from trivy_tpu_torch.k8s.infra import InfraFinding
from trivy_tpu_torch.log import logger

_log = logger("node-collector")

DEFAULT_IMAGE = "ghcr.io/aquasecurity/node-collector:0.3.1"
DEFAULT_NAMESPACE = "trivy-temp"
JOB_LABEL = "trivy-tpu.node-collector"


def _node_tag(node: str) -> str:
    """Node name -> a value safe as both a Job-name fragment and a label
    value (<= 63 chars, DNS-ish charset). Long names keep a hash suffix
    so distinct nodes never collide after truncation."""
    clean = re.sub(r"[^a-z0-9-]+", "-", node.lower()).strip("-") or "node"
    if len(clean) <= 40 and clean == node:
        return clean
    digest = hashlib.sha1(node.encode()).hexdigest()[:8]
    return f"{clean[:40].rstrip('-')}-{digest}"


def collector_job(node: str, namespace: str = DEFAULT_NAMESPACE,
                  image: str = DEFAULT_IMAGE,
                  tolerations: list[dict] | None = None) -> dict:
    """Job manifest pinned to `node`, with the host mounts the collector
    reads (kubelet config, PKI, service files)."""
    mounts = {
        "var-lib-kubelet": "/var/lib/kubelet",
        "etc-kubernetes": "/etc/kubernetes",
        "etc-systemd": "/etc/systemd",
        "lib-systemd": "/lib/systemd",
    }
    tag = _node_tag(node)  # label-safe; nodeName keeps the raw name
    name = f"node-collector-{tag}"[:63].rstrip("-")
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": {"app": JOB_LABEL, "node": tag},
        },
        "spec": {
            "ttlSecondsAfterFinished": 300,
            "backoffLimit": 1,
            "template": {
                "metadata": {"labels": {"app": JOB_LABEL, "node": tag}},
                "spec": {
                    "nodeName": node,
                    "restartPolicy": "Never",
                    "hostPID": True,
                    "tolerations": tolerations or [
                        {"operator": "Exists", "effect": "NoSchedule"},
                    ],
                    "containers": [{
                        "name": "node-collector",
                        "image": image,
                        "args": ["k8s-node-collector"],
                        "securityContext": {"readOnlyRootFilesystem": True},
                        "volumeMounts": [
                            {"name": k, "mountPath": v, "readOnly": True}
                            for k, v in mounts.items()
                        ],
                    }],
                    "volumes": [
                        {"name": k, "hostPath": {"path": v}}
                        for k, v in mounts.items()
                    ],
                },
            },
        },
    }


def collect_node_info(client, node: str,
                      namespace: str = DEFAULT_NAMESPACE,
                      image: str = DEFAULT_IMAGE,
                      timeout_s: float = 120.0,
                      poll_s: float = 2.0) -> dict | None:
    """Run the collector Job on `node` and return its NodeInfo document
    (None on timeout/failure — node assessment is best-effort, the rest
    of the cluster scan proceeds)."""
    job = collector_job(node, namespace=namespace, image=image)
    path = f"/apis/batch/v1/namespaces/{namespace}/jobs"
    try:
        # the scratch namespace may not exist yet; 409 (exists) is fine
        try:
            client.post("/api/v1/namespaces",
                        {"apiVersion": "v1", "kind": "Namespace",
                         "metadata": {"name": namespace}})
        except Exception:
            pass
        client.post(path, job)
    except Exception as e:
        _log.warn("node-collector job create failed", node=node,
                  err=str(e))
        return None
    name = job["metadata"]["name"]
    selector = f"app={JOB_LABEL},node={_node_tag(node)}"
    deadline = time.monotonic() + timeout_s
    doc = None
    try:
        while time.monotonic() < deadline:
            pods = client.list("Pod", namespace=namespace,
                               selector=selector)
            failed = 0
            for pod in pods:
                phase = (pod.get("status") or {}).get("phase")
                if phase == "Succeeded":
                    raw = client.pod_logs(
                        namespace, pod["metadata"]["name"])
                    doc = json.loads(raw)
                    break
                if phase == "Failed":
                    failed += 1
            if doc is not None:
                break
            # backoffLimit=1 -> two attempts; only give up when both
            # pods failed (a Failed first attempt may still be retried)
            if failed >= 2:
                _log.warn("node-collector pods failed", node=node)
                return None
            time.sleep(poll_s)
    except Exception as e:
        _log.warn("node-collector failed", node=node, err=str(e))
        return None
    finally:
        try:
            client.delete(f"{path}/{name}"
                          "?propagationPolicy=Background")
        except Exception:
            pass
    if doc is None:
        _log.warn("node-collector timed out", node=node,
                  timeout_s=timeout_s)
    return doc


# ------------------------------------------------------------ assessment

# Spec of one KCV node check over the collector "info" map:
# (id, title, severity, info key, kind, expectation)
#   kind "perm":         every collected octal permission must be <= expect
#   kind "owner":        every collected owner string must equal expect
#   kind "eq":           first value stringified must equal expect
#   kind "ne":           first value must differ from expect (exact)
#   kind "not_contains": first value must not contain expect
#   kind "set":          a value must be present (non-empty)
_NODE_CHECKS: list[tuple] = [
    ("KCV0069", "kubelet.conf permissions too open", "HIGH",
     "kubeletConfFilePermissions", "perm", 0o644),
    ("KCV0070", "kubelet.conf not owned by root:root", "HIGH",
     "kubeletConfFileOwnership", "owner", "root:root"),
    ("KCV0073", "kubelet config.yaml permissions too open", "HIGH",
     "kubeletConfigYamlConfigurationFilePermission", "perm", 0o644),
    ("KCV0074", "kubelet config.yaml not owned by root:root", "HIGH",
     "kubeletConfigYamlConfigurationFileOwnership", "owner", "root:root"),
    ("KCV0067", "kubelet service file permissions too open", "HIGH",
     "kubeletServiceFilePermissions", "perm", 0o644),
    ("KCV0068", "kubelet service file not owned by root:root", "HIGH",
     "kubeletServiceFileOwnership", "owner", "root:root"),
    ("KCV0075", "client CA file permissions too open", "CRITICAL",
     "certificateAuthoritiesFilePermissions", "perm", 0o644),
    ("KCV0077", "kubelet permits anonymous auth", "CRITICAL",
     "kubeletAnonymousAuthArgumentSet", "eq", "false"),
    ("KCV0078", "kubelet authorization mode is AlwaysAllow", "CRITICAL",
     "kubeletAuthorizationModeArgumentSet", "not_contains", "AlwaysAllow"),
    ("KCV0079", "kubelet client CA file not configured", "CRITICAL",
     "kubeletClientCaFileArgumentSet", "set", None),
    ("KCV0080", "kubelet read-only port is enabled", "HIGH",
     "kubeletReadOnlyPortArgumentSet", "eq", "0"),
    ("KCV0081", "kubelet streaming connection never times out", "HIGH",
     "kubeletStreamingConnectionIdleTimeoutArgumentSet", "ne", "0"),
    ("KCV0082", "kubelet does not protect kernel defaults", "HIGH",
     "kubeletProtectKernelDefaultsArgumentSet", "eq", "true"),
    ("KCV0083", "kubelet does not manage iptables util chains", "HIGH",
     "kubeletMakeIptablesUtilChainsArgumentSet", "eq", "true"),
    ("KCV0090", "kubelet client certificate rotation disabled", "HIGH",
     "kubeletRotateCertificatesArgumentSet", "eq", "true"),
    ("KCV0091", "kubelet server certificate rotation disabled", "HIGH",
     "kubeletRotateKubeletServerCertificateArgumentSet", "eq", "true"),
]


def _values(info: dict, key: str) -> list:
    entry = info.get(key)
    if isinstance(entry, dict):
        vals = entry.get("values")
        return vals if isinstance(vals, list) else []
    if isinstance(entry, list):
        return entry
    return []


def _parse_perm(v) -> int | None:
    try:
        return int(str(v), 8)
    except (TypeError, ValueError):
        return None


def assess_node_info(doc: dict) -> list[InfraFinding]:
    """NodeInfo document (collector stdout) -> node-level findings."""
    info = doc.get("info") or {}
    node = str(doc.get("nodeName") or
               (doc.get("metadata") or {}).get("name") or "node")
    out: list[InfraFinding] = []
    for check_id, title, severity, key, kind, expect in _NODE_CHECKS:
        vals = _values(info, key)
        if not vals:
            if kind == "set" and key in info:
                out.append(InfraFinding(
                    check_id, title, severity, f"{key} is empty",
                    f"Node/{node}"))
            continue  # not collected -> unknown, stay silent
        if kind == "perm":
            for v in vals:
                perm = _parse_perm(v)
                if perm is not None and perm & ~int(expect):
                    out.append(InfraFinding(
                        check_id, title, severity,
                        f"{key}={oct(perm)[2:]} (want <= "
                        f"{oct(int(expect))[2:]})", f"Node/{node}"))
                    break
        elif kind == "owner":
            for v in vals:
                if str(v) != expect:
                    out.append(InfraFinding(
                        check_id, title, severity, f"{key}={v}",
                        f"Node/{node}"))
                    break
        elif kind == "eq":
            if str(vals[0]).lower() != str(expect):
                out.append(InfraFinding(
                    check_id, title, severity, f"{key}={vals[0]}",
                    f"Node/{node}"))
        elif kind == "ne":
            if str(vals[0]).lower() == str(expect).lower():
                out.append(InfraFinding(
                    check_id, title, severity, f"{key}={vals[0]}",
                    f"Node/{node}"))
        elif kind == "not_contains":
            if str(expect).lower() in str(vals[0]).lower():
                out.append(InfraFinding(
                    check_id, title, severity, f"{key}={vals[0]}",
                    f"Node/{node}"))
        elif kind == "set":
            if not any(str(v).strip() for v in vals):
                out.append(InfraFinding(
                    check_id, title, severity, f"{key} is empty",
                    f"Node/{node}"))
    return out
