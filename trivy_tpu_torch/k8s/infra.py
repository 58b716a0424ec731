"""Infra (control-plane) assessment — the node-collector analog
(reference pkg/k8s infra-assessment: trivy-checks KCV policies against
kubelet/apiserver configuration gathered by the node collector). Here the
component command lines are read from the static-pod manifests present in
the enumerated resources.

Copy of trivy_tpu/k8s/infra.py."""

from __future__ import annotations

from dataclasses import dataclass

from trivy_tpu_torch.k8s.artifacts import INFRA_NAMES, KubeResource, _pod_spec


@dataclass
class InfraFinding:
    id: str
    title: str
    severity: str
    message: str
    resource: str


def _is_control_plane(res: KubeResource) -> bool:
    """Only pods that actually belong to the control plane are assessed —
    an application container that merely mentions "etcd" in its image
    must not trigger KCV checks.  Control-plane static pods live in
    kube-system and carry the kubeadm `component`/`tier` labels."""
    meta = res.raw.get("metadata") or {}
    if (meta.get("namespace") or res.namespace) == "kube-system":
        return True
    labels = meta.get("labels") or {}
    return labels.get("tier") == "control-plane" or \
        labels.get("component") in INFRA_NAMES


def _component_commands(res: KubeResource) -> list[tuple[str, list[str]]]:
    """-> [(component_name, full command argv)] for control-plane pods."""
    if not _is_control_plane(res):
        return []
    out = []
    spec = _pod_spec(res.raw)
    for c in spec.get("containers") or []:
        image = str((c or {}).get("image", ""))
        # component id = image basename sans tag, or exact container name
        image_base = image.rsplit("/", 1)[-1].split(":")[0].split("@")[0]
        name = str((c or {}).get("name", ""))
        for comp in INFRA_NAMES:
            if comp in (image_base, name):
                argv = [str(x) for x in (c.get("command") or [])]
                argv += [str(x) for x in (c.get("args") or [])]
                out.append((comp, argv))
                break
    return out


def _flag(argv: list[str], name: str) -> str | None:
    """--name=value or --name value; None when absent."""
    for i, a in enumerate(argv):
        if a.startswith(name + "="):
            return a.split("=", 1)[1]
        if a == name and i + 1 < len(argv):
            return argv[i + 1]
    return None


def assess_infra(resources: list[KubeResource]) -> list[InfraFinding]:
    out: list[InfraFinding] = []
    for res in resources:
        for comp, argv in _component_commands(res):
            if comp == "kube-apiserver":
                out.extend(_apiserver(argv, res.fullname))
            elif comp == "etcd":
                out.extend(_etcd(argv, res.fullname))
            elif comp == "kube-controller-manager":
                out.extend(_controller_manager(argv, res.fullname))
    return out


def _apiserver(argv, where) -> list[InfraFinding]:
    out = []
    if _flag(argv, "--anonymous-auth") == "true":
        out.append(InfraFinding(
            "KCV0001", "kube-apiserver permits anonymous auth", "HIGH",
            "--anonymous-auth=true", where))
    authz = _flag(argv, "--authorization-mode") or ""
    if authz and "RBAC" not in authz.split(","):
        out.append(InfraFinding(
            "KCV0009", "kube-apiserver authorization does not include "
                       "RBAC", "HIGH",
            f"--authorization-mode={authz}", where))
    if authz and "AlwaysAllow" in authz.split(","):
        out.append(InfraFinding(
            "KCV0007", "kube-apiserver authorizes all requests", "CRITICAL",
            "--authorization-mode includes AlwaysAllow", where))
    if _flag(argv, "--insecure-port") not in (None, "0"):
        out.append(InfraFinding(
            "KCV0016", "kube-apiserver serves on an insecure port", "HIGH",
            f"--insecure-port={_flag(argv, '--insecure-port')}", where))
    if _flag(argv, "--profiling") == "true":
        out.append(InfraFinding(
            "KCV0018", "kube-apiserver profiling enabled", "LOW",
            "--profiling=true", where))
    if _flag(argv, "--kubelet-certificate-authority") is None:
        out.append(InfraFinding(
            "KCV0005", "kube-apiserver does not verify kubelet "
                       "certificates", "MEDIUM",
            "--kubelet-certificate-authority not set", where))
    return out


def _etcd(argv, where) -> list[InfraFinding]:
    out = []
    if _flag(argv, "--client-cert-auth") != "true":
        out.append(InfraFinding(
            "KCV0042", "etcd does not require client certificates", "HIGH",
            "--client-cert-auth is not true", where))
    if _flag(argv, "--auto-tls") == "true":
        out.append(InfraFinding(
            "KCV0043", "etcd uses self-signed auto TLS", "MEDIUM",
            "--auto-tls=true", where))
    return out


def _controller_manager(argv, where) -> list[InfraFinding]:
    out = []
    if _flag(argv, "--use-service-account-credentials") != "true":
        out.append(InfraFinding(
            "KCV0027", "controller-manager does not use per-controller "
                       "service accounts", "MEDIUM",
            "--use-service-account-credentials is not true", where))
    if _flag(argv, "--profiling") == "true":
        out.append(InfraFinding(
            "KCV0028", "controller-manager profiling enabled", "LOW",
            "--profiling=true", where))
    return out
