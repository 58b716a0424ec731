"""Kubernetes API-server client (reference trivy-kubernetes uses
client-go; this is a stdlib equivalent speaking the REST API directly,
so cluster scans need no kubectl binary).

Auth comes from kubeconfig ($KUBECONFIG or ~/.kube/config): bearer
tokens, client certificate/key data (inline base64 or file paths), CA
bundles, and insecure-skip-tls-verify. In-cluster service-account
credentials (/var/run/secrets/kubernetes.io/serviceaccount) are used
when no kubeconfig exists — the same resolution order as client-go.

Copy of trivy_tpu/k8s/client.py.
"""

from __future__ import annotations

import base64
import json
import os
import ssl
import tempfile
import urllib.error
import urllib.request

from trivy_tpu_torch.log import logger

_log = logger("k8s")

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# kind -> (api prefix, plural)
API_PATHS: dict[str, tuple[str, str]] = {
    "Pod": ("/api/v1", "pods"),
    "ReplicationController": ("/api/v1", "replicationcontrollers"),
    "Node": ("/api/v1", "nodes"),
    "Service": ("/api/v1", "services"),
    "ConfigMap": ("/api/v1", "configmaps"),
    "Deployment": ("/apis/apps/v1", "deployments"),
    "StatefulSet": ("/apis/apps/v1", "statefulsets"),
    "DaemonSet": ("/apis/apps/v1", "daemonsets"),
    "ReplicaSet": ("/apis/apps/v1", "replicasets"),
    "Job": ("/apis/batch/v1", "jobs"),
    "CronJob": ("/apis/batch/v1", "cronjobs"),
    "Role": ("/apis/rbac.authorization.k8s.io/v1", "roles"),
    "RoleBinding": ("/apis/rbac.authorization.k8s.io/v1", "rolebindings"),
    "ClusterRole": ("/apis/rbac.authorization.k8s.io/v1", "clusterroles"),
    "ClusterRoleBinding": (
        "/apis/rbac.authorization.k8s.io/v1", "clusterrolebindings"),
}


class KubeError(Exception):
    pass


def kubeconfig_path() -> str:
    return os.environ.get(
        "KUBECONFIG", os.path.join(os.path.expanduser("~"), ".kube",
                                   "config"))


def _b64_file(data: str, suffix: str, tmpdir: str) -> str:
    """Decode credential data into a file under a private (0700),
    process-lifetime temp dir — ssl wants paths, but decoded keys must
    not persist in /tmp after use."""
    fd, path = tempfile.mkstemp(suffix=suffix, dir=tmpdir)
    with os.fdopen(fd, "wb") as f:
        f.write(base64.b64decode(data))
    return path


class KubeClient:
    def __init__(self, context: str = "", config_path: str | None = None):
        self.server = ""
        self.token = ""
        self._ctx = ssl.create_default_context()
        path = config_path or kubeconfig_path()
        if os.path.exists(path):
            self._from_kubeconfig(path, context)
        elif os.path.exists(os.path.join(SA_DIR, "token")):
            self._from_service_account()
        else:
            raise KubeError(
                f"no kubeconfig at {path} and not running in-cluster")

    # ------------------------------------------------------------ auth

    def _from_kubeconfig(self, path: str, context: str) -> None:
        import yaml

        with open(path, encoding="utf-8") as f:
            cfg = yaml.safe_load(f) or {}
        by_name = lambda items: {i.get("name"): i for i in items or []}  # noqa: E731
        contexts = by_name(cfg.get("contexts"))
        clusters = by_name(cfg.get("clusters"))
        users = by_name(cfg.get("users"))
        ctx_name = context or cfg.get("current-context", "")
        ctx = (contexts.get(ctx_name) or {}).get("context") or {}
        cluster = (clusters.get(ctx.get("cluster")) or {}).get("cluster") \
            or {}
        user = (users.get(ctx.get("user")) or {}).get("user") or {}
        self.server = (cluster.get("server") or "").rstrip("/")
        if not self.server:
            raise KubeError(f"kubeconfig context {ctx_name!r} has no server")

        with tempfile.TemporaryDirectory(prefix="trivy-tpu-kube-") as tmp:
            os.chmod(tmp, 0o700)
            if cluster.get("insecure-skip-tls-verify"):
                self._ctx = ssl._create_unverified_context()
            elif cluster.get("certificate-authority-data"):
                ca = _b64_file(cluster["certificate-authority-data"],
                               ".crt", tmp)
                self._ctx = ssl.create_default_context(cafile=ca)
            elif cluster.get("certificate-authority"):
                self._ctx = ssl.create_default_context(
                    cafile=cluster["certificate-authority"])

            self.token = user.get("token", "")
            cert = user.get("client-certificate") or ""
            key = user.get("client-key") or ""
            if user.get("client-certificate-data"):
                cert = _b64_file(user["client-certificate-data"],
                                 ".crt", tmp)
            if user.get("client-key-data"):
                key = _b64_file(user["client-key-data"], ".key", tmp)
            if cert and key:
                self._ctx.load_cert_chain(cert, key)
            # ssl copies the cert/CA material into the context; the
            # decoded files are gone when this block exits

    def _from_service_account(self) -> None:
        with open(os.path.join(SA_DIR, "token"), encoding="utf-8") as f:
            self.token = f.read().strip()
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        self.server = f"https://{host}:{port}"
        ca = os.path.join(SA_DIR, "ca.crt")
        if os.path.exists(ca):
            self._ctx = ssl.create_default_context(cafile=ca)

    # ------------------------------------------------------------- api

    def _request(self, method: str, path: str, body: dict | None = None,
                 raw: bool = False):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self.server + path, data=data,
                                     method=method)
        if body is not None:
            req.add_header("Content-Type", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        ctx = self._ctx if self.server.startswith("https") else None
        try:
            with urllib.request.urlopen(req, timeout=30, context=ctx) as r:
                payload = r.read()
                return payload if raw else json.loads(payload)
        except urllib.error.HTTPError as e:
            raise KubeError(f"{method} {path}: HTTP {e.code}")
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise KubeError(f"{method} {path}: {e}")

    def get(self, path: str) -> dict:
        return self._request("GET", path)

    def post(self, path: str, body: dict) -> dict:
        return self._request("POST", path, body)

    def delete(self, path: str) -> dict:
        return self._request("DELETE", path)

    def pod_logs(self, namespace: str, pod: str) -> bytes:
        return self._request(
            "GET", f"/api/v1/namespaces/{namespace}/pods/{pod}/log",
            raw=True)

    def version(self) -> dict:
        return self.get("/version")

    def list(self, kind: str, namespace: str = "",
             selector: str = "") -> list[dict]:
        """All objects of `kind` (cluster-wide unless namespaced); each
        item gets apiVersion/kind filled in (list responses omit them)."""
        spec = API_PATHS.get(kind)
        if spec is None:
            raise KubeError(f"unsupported kind {kind!r}")
        prefix, plural = spec
        cluster_scoped = kind.startswith("Cluster") or kind == "Node"
        if namespace and not cluster_scoped:
            path = f"{prefix}/namespaces/{namespace}/{plural}"
        else:
            path = f"{prefix}/{plural}"
        if selector:
            from urllib.parse import quote

            path += f"?labelSelector={quote(selector)}"
        doc = self.get(path)
        api_version = prefix.rsplit("/", 1)[-1] if prefix == "/api/v1" \
            else prefix[len("/apis/"):]
        out = []
        for item in doc.get("items") or []:
            item.setdefault("kind", kind)
            item.setdefault("apiVersion",
                            "v1" if prefix == "/api/v1" else api_version)
            out.append(item)
        return out
