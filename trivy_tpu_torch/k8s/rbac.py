"""RBAC assessment (reference pkg/k8s RBAC scanning via trivy-checks
ksv04x policies; the check identities mirror that set, the predicates are
authored against the Role/ClusterRole rule model).

Copy of trivy_tpu/k8s/rbac.py."""

from __future__ import annotations

from dataclasses import dataclass

from trivy_tpu_torch.k8s.artifacts import KubeResource

_SEV = {"CRITICAL": 4, "HIGH": 3, "MEDIUM": 2, "LOW": 1, "UNKNOWN": 0}


@dataclass
class RbacFinding:
    id: str
    title: str
    severity: str
    message: str
    resource: str


def _rules(res: KubeResource) -> list[dict]:
    return [r for r in res.raw.get("rules") or [] if isinstance(r, dict)]


def _has(rule: dict, field: str, *values: str) -> bool:
    have = {str(v) for v in rule.get(field) or []}
    return bool(have & set(values))


def assess_rbac(resources: list[KubeResource]) -> list[RbacFinding]:
    out: list[RbacFinding] = []
    for res in resources:
        if res.kind in ("Role", "ClusterRole"):
            out.extend(_assess_role(res))
        elif res.kind in ("RoleBinding", "ClusterRoleBinding"):
            out.extend(_assess_binding(res))
    out.sort(key=lambda f: (-_SEV.get(f.severity, 0), f.resource, f.id))
    return out


def _assess_role(res: KubeResource) -> list[RbacFinding]:
    out = []
    for rule in _rules(res):
        wild_verb = _has(rule, "verbs", "*")
        wild_res = _has(rule, "resources", "*")
        if wild_verb and wild_res:
            out.append(RbacFinding(
                "KSV046", "Role permits full control of cluster resources",
                "CRITICAL",
                "Role permits wildcard verb on wildcard resource",
                res.fullname))
        elif wild_verb:
            out.append(RbacFinding(
                "KSV045", "Role permits wildcard verbs", "CRITICAL",
                f"Role permits all verbs on "
                f"{sorted(set(rule.get('resources') or []))}",
                res.fullname))
        elif wild_res:
            out.append(RbacFinding(
                "KSV044", "Role permits access to any resource", "CRITICAL",
                f"Role permits {sorted(set(rule.get('verbs') or []))} "
                f"on all resources", res.fullname))
        if _has(rule, "resources", "secrets") and \
                _has(rule, "verbs", "get", "list", "watch", "*"):
            out.append(RbacFinding(
                "KSV041", "Role permits viewing secrets", "CRITICAL",
                "Role permits get/list/watch of secrets", res.fullname))
        if _has(rule, "verbs", "escalate", "bind", "impersonate"):
            out.append(RbacFinding(
                "KSV047", "Role permits privilege escalation verbs",
                "CRITICAL",
                "Role permits escalate/bind/impersonate", res.fullname))
        if _has(rule, "resources", "pods/exec") and \
                _has(rule, "verbs", "create", "*"):
            out.append(RbacFinding(
                "KSV053", "Role permits exec into pods", "HIGH",
                "Role permits creating pod exec sessions", res.fullname))
        if _has(rule, "resources", "roles", "clusterroles",
                "rolebindings", "clusterrolebindings") and \
                _has(rule, "verbs", "create", "update", "patch", "*"):
            out.append(RbacFinding(
                "KSV050", "Role permits managing RBAC resources",
                "CRITICAL",
                "Role permits mutation of RBAC objects", res.fullname))
        if _has(rule, "resources", "pods") and \
                _has(rule, "verbs", "delete", "*") and \
                res.kind == "ClusterRole":
            out.append(RbacFinding(
                "KSV042", "ClusterRole permits deleting pods", "HIGH",
                "ClusterRole permits pod deletion cluster-wide",
                res.fullname))
    return out


def _assess_binding(res: KubeResource) -> list[RbacFinding]:
    out = []
    role_ref = res.raw.get("roleRef") or {}
    subjects = res.raw.get("subjects") or []
    if str(role_ref.get("name")) == "cluster-admin":
        for sub in subjects:
            sname = str((sub or {}).get("name", ""))
            skind = str((sub or {}).get("kind", ""))
            if sname in ("system:authenticated",
                         "system:unauthenticated", "system:anonymous"):
                out.append(RbacFinding(
                    "KSV051",
                    "cluster-admin bound to a system-wide group",
                    "CRITICAL",
                    f"cluster-admin granted to {sname}", res.fullname))
            elif skind == "ServiceAccount" and sname == "default":
                out.append(RbacFinding(
                    "KSV052",
                    "cluster-admin bound to the default service account",
                    "CRITICAL",
                    "cluster-admin granted to a default ServiceAccount",
                    res.fullname))
    return out
