"""Kubernetes workload checks (reference trivy-checks
checks/kubernetes/*.rego; IDs match the published KSV rules).

Copy of trivy_tpu/iac/checks/kubernetes.py, whole: all 42 checks.
"""

from __future__ import annotations

from trivy_tpu_torch.iac.check import Cause, check
from trivy_tpu_torch.iac.parsers.yamlconf import get_end_line, get_line

_K = ("kubernetes", "helm")


def _name(res: dict) -> str:
    md = res.get("metadata") or {}
    return f"{res.get('kind', '')}/{md.get('name', '')}"


def _container_cause(ctx, c: dict, msg: str) -> Cause:
    return Cause(
        message=msg, resource=_name(ctx.resource),
        start_line=get_line(c) or get_line(ctx.resource),
        end_line=get_end_line(c) or get_line(c) or get_line(ctx.resource),
    )


def _sc(c: dict) -> dict:
    return c.get("securityContext") or {}


def _pod_sc(ctx) -> dict:
    return (ctx.pod_spec or {}).get("securityContext") or {}


@check("KSV001", "Process can elevate its own privileges",
       severity="MEDIUM", file_types=_K, avd_id="AVD-KSV-0001",
       provider="kubernetes", service="general",
       resolution="Set 'securityContext.allowPrivilegeEscalation' to "
                  "false")
def allow_priv_escalation(ctx):
    out = []
    for c in ctx.containers:
        if _sc(c).get("allowPrivilegeEscalation") is not False:
            out.append(_container_cause(
                ctx, c,
                f"Container '{c.get('name', '')}' of "
                f"{_name(ctx.resource)} should set "
                f"'securityContext.allowPrivilegeEscalation' to false"))
    return out


@check("KSV003", "Default capabilities not dropped", severity="LOW",
       file_types=_K, avd_id="AVD-KSV-0003", provider="kubernetes",
       service="general",
       resolution="Add 'ALL' to 'securityContext.capabilities.drop'")
def drop_capabilities(ctx):
    out = []
    for c in ctx.containers:
        drop = (_sc(c).get("capabilities") or {}).get("drop") or []
        if not any(str(d).upper() == "ALL" for d in drop):
            out.append(_container_cause(
                ctx, c,
                f"Container '{c.get('name', '')}' of "
                f"{_name(ctx.resource)} should add 'ALL' to "
                f"'securityContext.capabilities.drop'"))
    return out


@check("KSV005", "SYS_ADMIN capability added", severity="HIGH",
       file_types=_K, avd_id="AVD-KSV-0005", provider="kubernetes",
       service="general",
       resolution="Remove the SYS_ADMIN capability")
def sys_admin(ctx):
    out = []
    for c in ctx.containers:
        add = (_sc(c).get("capabilities") or {}).get("add") or []
        if any(str(a).upper() == "SYS_ADMIN" for a in add):
            out.append(_container_cause(
                ctx, c,
                f"Container '{c.get('name', '')}' of "
                f"{_name(ctx.resource)} should not include 'SYS_ADMIN' in "
                f"'securityContext.capabilities.add'"))
    return out


@check("KSV006", "hostPath volume mounts docker.sock", severity="HIGH",
       file_types=_K, avd_id="AVD-KSV-0006", provider="kubernetes",
       service="general",
       resolution="Do not mount /var/run/docker.sock")
def docker_sock(ctx):
    out = []
    for v in (ctx.pod_spec or {}).get("volumes") or []:
        hp = (v or {}).get("hostPath") or {}
        if hp.get("path") == "/var/run/docker.sock":
            out.append(Cause(
                message=f"{_name(ctx.resource)} should not mount "
                        f"'/var/run/docker.sock'",
                resource=_name(ctx.resource),
                start_line=get_line(v), end_line=get_end_line(v),
            ))
    return out


@check("KSV008", "Access to host IPC namespace", severity="HIGH",
       file_types=_K, avd_id="AVD-KSV-0008", provider="kubernetes",
       service="general", resolution="Set 'spec.hostIPC' to false")
def host_ipc(ctx):
    if (ctx.pod_spec or {}).get("hostIPC") is True:
        return [Cause(
            message=f"{_name(ctx.resource)} should not set "
                    f"'spec.template.spec.hostIPC' to true",
            resource=_name(ctx.resource),
            start_line=get_line(ctx.pod_spec),
            end_line=get_line(ctx.pod_spec),
        )]
    return []


@check("KSV009", "Access to host network", severity="HIGH",
       file_types=_K, avd_id="AVD-KSV-0009", provider="kubernetes",
       service="general", resolution="Set 'spec.hostNetwork' to false")
def host_network(ctx):
    if (ctx.pod_spec or {}).get("hostNetwork") is True:
        return [Cause(
            message=f"{_name(ctx.resource)} should not set "
                    f"'spec.template.spec.hostNetwork' to true",
            resource=_name(ctx.resource),
            start_line=get_line(ctx.pod_spec),
            end_line=get_line(ctx.pod_spec),
        )]
    return []


@check("KSV010", "Access to host PID", severity="HIGH", file_types=_K,
       avd_id="AVD-KSV-0010", provider="kubernetes", service="general",
       resolution="Set 'spec.hostPID' to false")
def host_pid(ctx):
    if (ctx.pod_spec or {}).get("hostPID") is True:
        return [Cause(
            message=f"{_name(ctx.resource)} should not set "
                    f"'spec.template.spec.hostPID' to true",
            resource=_name(ctx.resource),
            start_line=get_line(ctx.pod_spec),
            end_line=get_line(ctx.pod_spec),
        )]
    return []


@check("KSV011", "CPU not limited", severity="LOW", file_types=_K,
       avd_id="AVD-KSV-0011", provider="kubernetes", service="general",
       resolution="Set 'resources.limits.cpu'")
def cpu_limit(ctx):
    out = []
    for c in ctx.containers:
        limits = (c.get("resources") or {}).get("limits") or {}
        if "cpu" not in limits:
            out.append(_container_cause(
                ctx, c,
                f"Container '{c.get('name', '')}' of "
                f"{_name(ctx.resource)} should set "
                f"'resources.limits.cpu'"))
    return out


@check("KSV012", "Runs as root user", severity="MEDIUM", file_types=_K,
       avd_id="AVD-KSV-0012", provider="kubernetes", service="general",
       resolution="Set 'securityContext.runAsNonRoot' to true")
def run_as_non_root(ctx):
    out = []
    pod_nonroot = _pod_sc(ctx).get("runAsNonRoot") is True
    for c in ctx.containers:
        own = _sc(c).get("runAsNonRoot")
        # container-level setting overrides pod-level; only an unset
        # container inherits the pod default
        if own is True or (own is None and pod_nonroot):
            continue
        out.append(_container_cause(
            ctx, c,
            f"Container '{c.get('name', '')}' of {_name(ctx.resource)} "
            f"should set 'securityContext.runAsNonRoot' to true"))
    return out


@check("KSV013", "Image tag ':latest' used", severity="MEDIUM",
       file_types=_K, avd_id="AVD-KSV-0013", provider="kubernetes",
       service="general",
       resolution="Use a specific container image tag")
def image_tag(ctx):
    out = []
    for c in ctx.containers:
        image = str(c.get("image", ""))
        if not image or "@" in image:
            continue
        tail = image.split("/")[-1]
        tag = tail.rsplit(":", 1)[1] if ":" in tail else ""
        if not tag or tag == "latest":
            out.append(_container_cause(
                ctx, c,
                f"Container '{c.get('name', '')}' of "
                f"{_name(ctx.resource)} should specify an image tag"))
    return out


@check("KSV014", "Root file system is not read-only", severity="HIGH",
       file_types=_K, avd_id="AVD-KSV-0014", provider="kubernetes",
       service="general",
       resolution="Set 'securityContext.readOnlyRootFilesystem' to true")
def read_only_rootfs(ctx):
    out = []
    for c in ctx.containers:
        if _sc(c).get("readOnlyRootFilesystem") is not True:
            out.append(_container_cause(
                ctx, c,
                f"Container '{c.get('name', '')}' of "
                f"{_name(ctx.resource)} should set "
                f"'securityContext.readOnlyRootFilesystem' to true"))
    return out


@check("KSV015", "CPU requests not specified", severity="LOW",
       file_types=_K, avd_id="AVD-KSV-0015", provider="kubernetes",
       service="general", resolution="Set 'resources.requests.cpu'")
def cpu_request(ctx):
    out = []
    for c in ctx.containers:
        req = (c.get("resources") or {}).get("requests") or {}
        if "cpu" not in req:
            out.append(_container_cause(
                ctx, c,
                f"Container '{c.get('name', '')}' of "
                f"{_name(ctx.resource)} should set "
                f"'resources.requests.cpu'"))
    return out


@check("KSV016", "Memory requests not specified", severity="LOW",
       file_types=_K, avd_id="AVD-KSV-0016", provider="kubernetes",
       service="general", resolution="Set 'resources.requests.memory'")
def memory_request(ctx):
    out = []
    for c in ctx.containers:
        req = (c.get("resources") or {}).get("requests") or {}
        if "memory" not in req:
            out.append(_container_cause(
                ctx, c,
                f"Container '{c.get('name', '')}' of "
                f"{_name(ctx.resource)} should set "
                f"'resources.requests.memory'"))
    return out


@check("KSV017", "Privileged container", severity="HIGH", file_types=_K,
       avd_id="AVD-KSV-0017", provider="kubernetes", service="general",
       resolution="Set 'securityContext.privileged' to false")
def privileged(ctx):
    out = []
    for c in ctx.containers:
        if _sc(c).get("privileged") is True:
            out.append(_container_cause(
                ctx, c,
                f"Container '{c.get('name', '')}' of "
                f"{_name(ctx.resource)} should set "
                f"'securityContext.privileged' to false"))
    return out


@check("KSV018", "Memory not limited", severity="LOW", file_types=_K,
       avd_id="AVD-KSV-0018", provider="kubernetes", service="general",
       resolution="Set 'resources.limits.memory'")
def memory_limit(ctx):
    out = []
    for c in ctx.containers:
        limits = (c.get("resources") or {}).get("limits") or {}
        if "memory" not in limits:
            out.append(_container_cause(
                ctx, c,
                f"Container '{c.get('name', '')}' of "
                f"{_name(ctx.resource)} should set "
                f"'resources.limits.memory'"))
    return out


@check("KSV023", "hostPath volumes mounted", severity="MEDIUM",
       file_types=_K, avd_id="AVD-KSV-0023", provider="kubernetes",
       service="general", resolution="Do not set 'spec.volumes.hostPath'")
def host_path(ctx):
    out = []
    for v in (ctx.pod_spec or {}).get("volumes") or []:
        if (v or {}).get("hostPath"):
            out.append(Cause(
                message=f"{_name(ctx.resource)} should not set "
                        f"'spec.template.volumes.hostPath'",
                resource=_name(ctx.resource),
                start_line=get_line(v), end_line=get_end_line(v),
            ))
    return out

@check("KSV002", "Default AppArmor profile not set", severity="MEDIUM",
       file_types=_K, avd_id="AVD-KSV-0002", provider="kubernetes",
       service="general",
       resolution="Remove 'container.apparmor.security.beta.kubernetes.io' "
                  "annotations or set them to 'runtime/default'")
def apparmor_profile(ctx):
    out = []
    annotations = (ctx.resource.get("metadata") or {}).get("annotations") or {}
    tmpl_md = {}
    spec = ctx.resource.get("spec") or {}
    if isinstance(spec.get("template"), dict):
        tmpl_md = (spec["template"].get("metadata") or {})
    tmpl_ann = tmpl_md.get("annotations") or {}
    for ann in ({**annotations, **tmpl_ann}).items():
        key, value = ann
        if key.startswith("container.apparmor.security.beta.kubernetes.io/") \
                and value not in ("runtime/default", "localhost/default"):
            out.append(Cause(
                message=f"{_name(ctx.resource)} should specify an AppArmor "
                        f"profile of 'runtime/default'",
                resource=_name(ctx.resource),
                start_line=get_line(ctx.resource),
                end_line=get_line(ctx.resource),
            ))
    return out


@check("KSV024", "Access to host ports", severity="HIGH", file_types=_K,
       avd_id="AVD-KSV-0024", provider="kubernetes", service="general",
       resolution="Do not set 'spec.containers.ports.hostPort'")
def host_ports(ctx):
    out = []
    for c in ctx.containers:
        for p in c.get("ports") or []:
            if (p or {}).get("hostPort"):
                out.append(_container_cause(
                    ctx, c,
                    f"Container '{c.get('name', '')}' of "
                    f"{_name(ctx.resource)} should not set "
                    f"'ports.hostPort'"))
    return out


@check("KSV029", "A root primary or supplementary GID set", severity="LOW",
       file_types=_K, avd_id="AVD-KSV-0029", provider="kubernetes",
       service="general",
       resolution="Set 'securityContext.runAsGroup' to a non-zero integer "
                  "and do not include group 0 in 'supplementalGroups'")
def root_group(ctx):
    out = []
    pod_sc = _pod_sc(ctx)
    if pod_sc.get("runAsGroup") == 0 or pod_sc.get("fsGroup") == 0 or \
            0 in (pod_sc.get("supplementalGroups") or []):
        out.append(Cause(
            message=f"{_name(ctx.resource)} should not set a root group "
                    f"(runAsGroup/fsGroup/supplementalGroups of 0)",
            resource=_name(ctx.resource),
            start_line=get_line(ctx.pod_spec),
            end_line=get_line(ctx.pod_spec),
        ))
    for c in ctx.containers:
        if _sc(c).get("runAsGroup") == 0:
            out.append(_container_cause(
                ctx, c,
                f"Container '{c.get('name', '')}' of {_name(ctx.resource)} "
                f"should not set 'securityContext.runAsGroup' to 0"))
    return out


@check("KSV030", "Runtime/Default Seccomp profile not set", severity="LOW",
       file_types=_K, avd_id="AVD-KSV-0030", provider="kubernetes",
       service="general",
       resolution="Set 'securityContext.seccompProfile.type' to "
                  "'RuntimeDefault'")
def seccomp_profile(ctx):
    allowed = ("RuntimeDefault", "Localhost")
    pod_type = (_pod_sc(ctx).get("seccompProfile") or {}).get("type")
    out = []
    for c in ctx.containers:
        own = (_sc(c).get("seccompProfile") or {}).get("type")
        effective = own if own is not None else pod_type
        if effective not in allowed:
            out.append(_container_cause(
                ctx, c,
                f"Container '{c.get('name', '')}' of {_name(ctx.resource)} "
                f"should set 'securityContext.seccompProfile.type' to "
                f"'RuntimeDefault'"))
    return out


@check("KSV036", "Service account token mounted automatically",
       severity="MEDIUM", file_types=_K, avd_id="AVD-KSV-0036",
       provider="kubernetes", service="general",
       resolution="Set 'automountServiceAccountToken' to false or mount "
                  "the token only where needed")
def automount_token(ctx):
    """Fails on explicit opt-in only: automountServiceAccountToken=true
    or an explicit token volumeMount (upstream rego semantics — a bare
    pod with the field unset passes, per the reference helm goldens)."""
    spec = ctx.pod_spec or {}
    if spec.get("automountServiceAccountToken") is False:
        return []
    token_path = "/var/run/secrets/kubernetes.io/serviceaccount"
    mounted = any(
        str((vm or {}).get("mountPath", "")).rstrip("/") == token_path
        for c in ctx.containers
        for vm in c.get("volumeMounts") or []
    )
    if spec.get("automountServiceAccountToken") is True or mounted:
        return [Cause(
            message=f"{_name(ctx.resource)} should set "
                    f"'automountServiceAccountToken' to false",
            resource=_name(ctx.resource),
            start_line=get_line(ctx.pod_spec),
            end_line=get_line(ctx.pod_spec),
        )]
    return []


@check("KSV037", "User Pods should not be placed in kube-system namespace",
       severity="MEDIUM", file_types=_K, avd_id="AVD-KSV-0037",
       provider="kubernetes", service="general",
       resolution="Deploy user workloads outside the kube-system namespace")
def kube_system_namespace(ctx):
    md = ctx.resource.get("metadata") or {}
    if md.get("namespace") != "kube-system":
        return []
    labels = md.get("labels") or {}
    # control-plane components themselves are exempt
    if labels.get("tier") == "control-plane" or "component" in labels:
        return []
    return [Cause(
        message=f"{_name(ctx.resource)} should not be deployed in the "
                f"'kube-system' namespace",
        resource=_name(ctx.resource),
        start_line=get_line(ctx.resource),
        end_line=get_line(ctx.resource),
    )]


@check("KSV103", "HostProcess container defined", severity="HIGH",
       file_types=_K, avd_id="AVD-KSV-0103", provider="kubernetes",
       service="general",
       resolution="Do not enable 'windowsOptions.hostProcess'")
def host_process(ctx):
    out = []
    pod_wo = _pod_sc(ctx).get("windowsOptions") or {}
    if pod_wo.get("hostProcess") is True:
        out.append(Cause(
            message=f"{_name(ctx.resource)} should not set "
                    f"'securityContext.windowsOptions.hostProcess' to true",
            resource=_name(ctx.resource),
            start_line=get_line(ctx.pod_spec),
            end_line=get_line(ctx.pod_spec),
        ))
    for c in ctx.containers:
        wo = _sc(c).get("windowsOptions") or {}
        if wo.get("hostProcess") is True:
            out.append(_container_cause(
                ctx, c,
                f"Container '{c.get('name', '')}' of {_name(ctx.resource)} "
                f"should not enable 'windowsOptions.hostProcess'"))
    return out


@check("KSV025", "SELinux custom options set", severity="MEDIUM",
       file_types=_K, avd_id="AVD-KSV-0025", provider="kubernetes",
       service="general",
       resolution="Do not set 'securityContext.seLinuxOptions' custom "
                  "type/user/role")
def selinux_options(ctx):
    out = []

    def bad(opts: dict) -> bool:
        return bool(opts.get("user") or opts.get("role") or
                    (opts.get("type") and opts["type"] not in
                     ("container_t", "container_init_t", "container_kvm_t")))

    if bad(_pod_sc(ctx).get("seLinuxOptions") or {}):
        out.append(Cause(
            message=f"{_name(ctx.resource)} should not set custom "
                    f"'securityContext.seLinuxOptions'",
            resource=_name(ctx.resource),
            start_line=get_line(ctx.pod_spec),
            end_line=get_line(ctx.pod_spec),
        ))
    for c in ctx.containers:
        if bad(_sc(c).get("seLinuxOptions") or {}):
            out.append(_container_cause(
                ctx, c,
                f"Container '{c.get('name', '')}' of {_name(ctx.resource)} "
                f"should not set custom 'securityContext.seLinuxOptions'"))
    return out


@check("KSV020", "Runs with a low user ID", severity="LOW",
       file_types=_K, avd_id="AVD-KSV-0020", provider="kubernetes",
       service="general",
       resolution="Set 'securityContext.runAsUser' above 10000")
def low_user_id(ctx):
    out = []
    pod_uid = _pod_sc(ctx).get("runAsUser")
    for c in ctx.containers:
        uid = _sc(c).get("runAsUser", pod_uid)
        try:
            ok = uid is not None and int(uid) > 10000
        except (TypeError, ValueError):
            ok = False
        if not ok:
            out.append(_container_cause(
                ctx, c,
                f"Container '{c.get('name', '')}' of "
                f"{_name(ctx.resource)} should set "
                f"'securityContext.runAsUser' > 10000"))
    return out


@check("KSV021", "Runs with a low group ID", severity="LOW",
       file_types=_K, avd_id="AVD-KSV-0021", provider="kubernetes",
       service="general",
       resolution="Set 'securityContext.runAsGroup' above 10000")
def low_group_id(ctx):
    out = []
    pod_gid = _pod_sc(ctx).get("runAsGroup")
    for c in ctx.containers:
        gid = _sc(c).get("runAsGroup", pod_gid)
        try:
            ok = gid is not None and int(gid) > 10000
        except (TypeError, ValueError):
            ok = False
        if not ok:
            out.append(_container_cause(
                ctx, c,
                f"Container '{c.get('name', '')}' of "
                f"{_name(ctx.resource)} should set "
                f"'securityContext.runAsGroup' > 10000"))
    return out


def _pod_annotations(ctx) -> dict:
    """Pod-template annotations: spec.template.metadata for workloads,
    the object's own metadata for bare Pods."""
    res = ctx.resource or {}
    tmpl_meta = (((res.get("spec") or {}).get("template") or {})
                 .get("metadata") or {})
    meta = tmpl_meta or res.get("metadata") or {}
    return meta.get("annotations") or {}


@check("KSV104", "Seccomp profile not configured", severity="MEDIUM",
       file_types=_K, avd_id="AVD-KSV-0104", provider="kubernetes",
       service="general",
       resolution="Set 'securityContext.seccompProfile.type'")
def seccomp_unset(ctx):
    out = []
    pod_prof = (_pod_sc(ctx).get("seccompProfile") or {}).get("type")
    annotated = any(
        str(k).startswith("seccomp.security.alpha.kubernetes.io")
        for k in _pod_annotations(ctx))
    for c in ctx.containers:
        prof = (_sc(c).get("seccompProfile") or {}).get("type", pod_prof)
        if not prof and not annotated:
            out.append(_container_cause(
                ctx, c,
                f"Container '{c.get('name', '')}' of "
                f"{_name(ctx.resource)} should specify a seccomp "
                f"profile"))
    return out


@check("KSV105", "Container runs as root user (UID 0)", severity="LOW",
       file_types=_K, avd_id="AVD-KSV-0105", provider="kubernetes",
       service="general",
       resolution="Do not set 'securityContext.runAsUser' to 0")
def run_as_root_uid(ctx):
    out = []
    pod_uid = _pod_sc(ctx).get("runAsUser")
    for c in ctx.containers:
        uid = _sc(c).get("runAsUser", pod_uid)
        try:
            is_root = uid is not None and int(uid) == 0
        except (TypeError, ValueError):
            is_root = False
        if is_root:
            out.append(_container_cause(
                ctx, c,
                f"Container '{c.get('name', '')}' of "
                f"{_name(ctx.resource)} runs with runAsUser 0"))
    return out


@check("KSV106", "Container capabilities beyond NET_BIND_SERVICE",
       severity="LOW", file_types=_K, avd_id="AVD-KSV-0106",
       provider="kubernetes", service="general",
       resolution="Drop ALL capabilities; add only NET_BIND_SERVICE "
                  "when needed")
def restricted_capabilities(ctx):
    out = []
    for c in ctx.containers:
        caps = _sc(c).get("capabilities") or {}
        drop = [str(d).upper() for d in caps.get("drop") or []]
        add = [str(a).upper() for a in caps.get("add") or []]
        ok = "ALL" in drop and all(a == "NET_BIND_SERVICE" for a in add)
        if not ok:
            out.append(_container_cause(
                ctx, c,
                f"Container '{c.get('name', '')}' of "
                f"{_name(ctx.resource)} should drop ALL capabilities "
                f"and add only NET_BIND_SERVICE"))
    return out


@check("KSV117", "Container binds to a privileged port", severity="LOW",
       file_types=_K, avd_id="AVD-KSV-0117", provider="kubernetes",
       service="general",
       resolution="Use container ports above 1024")
def privileged_port(ctx):
    out = []
    for c in ctx.containers:
        for port in c.get("ports") or []:
            if not isinstance(port, dict):
                continue
            for key in ("containerPort", "hostPort"):
                v = port.get(key)
                try:
                    low = v is not None and int(v) < 1024
                except (TypeError, ValueError):
                    low = False
                if low:
                    out.append(_container_cause(
                        ctx, c,
                        f"Container '{c.get('name', '')}' of "
                        f"{_name(ctx.resource)} binds privileged port "
                        f"{v}"))
                    break
            else:
                continue
            break
    return out


# --------------------------------------------- breadth wave (r5): more
# published KSV workload + RBAC rules (reference trivy-checks
# checks/kubernetes/{workload,rbac})


@check("KSV007", "hostAliases is set", severity="LOW", file_types=_K,
       avd_id="AVD-KSV-0007", provider="kubernetes", service="general",
       resolution="Do not set spec.hostAliases")
def host_aliases(ctx):
    spec = ctx.pod_spec or {}
    if spec.get("hostAliases"):
        return [Cause(message=f"{_name(ctx.resource)} should not set "
                              f"spec.template.spec.hostAliases",
                      resource=_name(ctx.resource),
                      start_line=get_line(ctx.resource))]
    return []


@check("KSV022", "Non-default capabilities added", severity="MEDIUM",
       file_types=_K, avd_id="AVD-KSV-0022", provider="kubernetes",
       service="general",
       resolution="Remove capabilities.add entries")
def added_capabilities(ctx):
    out = []
    for c in ctx.containers:
        add = (_sc(c).get("capabilities") or {}).get("add") or []
        extra = [a for a in add
                 if str(a).upper() not in ("NET_BIND_SERVICE",)]
        if extra:
            out.append(_container_cause(
                ctx, c, f"Container '{c.get('name', '')}' adds "
                        f"capabilities {sorted(map(str, extra))}"))
    return out


@check("KSV026", "Unsafe sysctls set", severity="MEDIUM",
       file_types=_K, avd_id="AVD-KSV-0026", provider="kubernetes",
       service="general",
       resolution="Remove sysctls outside the safe set")
def unsafe_sysctls(ctx):
    safe = {"kernel.shm_rmid_forced", "net.ipv4.ip_local_port_range",
            "net.ipv4.ip_unprivileged_port_start",
            "net.ipv4.tcp_syncookies", "net.ipv4.ping_group_range"}
    spec = ctx.pod_spec or {}
    sysctls = (spec.get("securityContext") or {}).get("sysctls") or []
    out = []
    for s in sysctls:
        nm = s.get("name") if isinstance(s, dict) else None
        if nm and nm not in safe:
            out.append(Cause(
                message=f"{_name(ctx.resource)} sets unsafe sysctl "
                        f"'{nm}'",
                resource=_name(ctx.resource),
                start_line=get_line(ctx.resource)))
    return out


@check("KSV027", "Non-default /proc mount", severity="MEDIUM",
       file_types=_K, avd_id="AVD-KSV-0027", provider="kubernetes",
       service="general", resolution="Remove procMount")
def proc_mount(ctx):
    out = []
    for c in ctx.containers:
        pm = _sc(c).get("procMount")
        if pm and str(pm) != "Default":
            out.append(_container_cause(
                ctx, c, f"Container '{c.get('name', '')}' uses a "
                        f"non-default procMount '{pm}'"))
    return out


@check("KSV028", "Non-ephemeral volume types used", severity="LOW",
       file_types=_K, avd_id="AVD-KSV-0028", provider="kubernetes",
       service="general",
       resolution="Use only configMap/secret/emptyDir/projected/"
                  "downwardAPI/csi/ephemeral/pvc volumes")
def volume_types(ctx):
    allowed = {"configMap", "secret", "emptyDir", "projected",
               "downwardAPI", "csi", "ephemeral",
               "persistentVolumeClaim", "name"}
    spec = ctx.pod_spec or {}
    out = []
    for v in spec.get("volumes") or []:
        if not isinstance(v, dict):
            continue
        bad = [k for k in v
               if k not in allowed and not k.startswith("__")]
        if bad:
            out.append(Cause(
                message=f"{_name(ctx.resource)} uses restricted volume "
                        f"type(s) {sorted(bad)}",
                resource=_name(ctx.resource),
                start_line=get_line(v) or get_line(ctx.resource)))
    return out


@check("KSV102", "Helm Tiller is deployed", severity="CRITICAL",
       file_types=_K, avd_id="AVD-KSV-0102", provider="kubernetes",
       service="general", resolution="Migrate to Helm v3")
def tiller_deployed(ctx):
    out = []
    for c in ctx.containers:
        img = str(c.get("image", ""))
        repo = img.split("/")[-1].split(":")[0].split("@")[0]
        if repo == "tiller":
            out.append(_container_cause(
                ctx, c, f"Container '{c.get('name', '')}' runs the "
                        f"Tiller image '{img}'"))
    return out


def _role_rules(ctx):
    if ctx.resource.get("kind") not in ("Role", "ClusterRole"):
        return []
    return [r for r in ctx.resource.get("rules") or []
            if isinstance(r, dict)]


def _rbac_cause(ctx, msg):
    return Cause(message=msg, resource=_name(ctx.resource),
                 start_line=get_line(ctx.resource))


@check("KSV041", "Role permits managing secrets", severity="CRITICAL",
       file_types=_K, avd_id="AVD-KSV-0041", provider="kubernetes",
       service="rbac", resolution="Remove secrets write verbs")
def rbac_manage_secrets(ctx):
    out = []
    for r in _role_rules(ctx):
        if "secrets" in (r.get("resources") or []) and \
                any(v in (r.get("verbs") or [])
                    for v in ("create", "update", "patch", "delete",
                              "deletecollection", "impersonate", "*")):
            out.append(_rbac_cause(
                ctx, f"{_name(ctx.resource)} permits managing secrets"))
    return out


@check("KSV042", "Role permits deleting pod logs", severity="MEDIUM",
       file_types=_K, avd_id="AVD-KSV-0042", provider="kubernetes",
       service="rbac", resolution="Remove pods/log delete verbs")
def rbac_delete_pod_logs(ctx):
    out = []
    for r in _role_rules(ctx):
        if "pods/log" in (r.get("resources") or []) and \
                any(v in (r.get("verbs") or [])
                    for v in ("delete", "deletecollection", "*")):
            out.append(_rbac_cause(
                ctx,
                f"{_name(ctx.resource)} permits deleting pod logs"))
    return out


@check("KSV045", "Role uses wildcard verbs", severity="CRITICAL",
       file_types=_K, avd_id="AVD-KSV-0045", provider="kubernetes",
       service="rbac", resolution="Enumerate the needed verbs")
def rbac_wildcard_verbs(ctx):
    out = []
    for r in _role_rules(ctx):
        if "*" in (r.get("verbs") or []) and \
                (r.get("resources") or []) != ["*"]:
            out.append(_rbac_cause(
                ctx, f"{_name(ctx.resource)} uses a wildcard verb"))
    return out


@check("KSV046", "Role permits managing all resources",
       severity="CRITICAL", file_types=_K, avd_id="AVD-KSV-0046",
       provider="kubernetes", service="rbac",
       resolution="Scope the role to specific resources")
def rbac_all_resources(ctx):
    out = []
    for r in _role_rules(ctx):
        if "*" in (r.get("resources") or []) and \
                "*" in (r.get("verbs") or []):
            out.append(_rbac_cause(
                ctx, f"{_name(ctx.resource)} permits managing all "
                     f"resources"))
    return out


@check("KSV049", "Role permits managing configmaps",
       severity="MEDIUM", file_types=_K, avd_id="AVD-KSV-0049",
       provider="kubernetes", service="rbac",
       resolution="Limit configmap write access")
def rbac_manage_configmaps(ctx):
    out = []
    for r in _role_rules(ctx):
        if "configmaps" in (r.get("resources") or []) and \
                any(v in (r.get("verbs") or [])
                    for v in ("create", "update", "patch", "delete",
                              "deletecollection", "*")):
            out.append(_rbac_cause(
                ctx,
                f"{_name(ctx.resource)} permits managing configmaps"))
    return out


@check("KSV050", "Role permits managing RBAC resources",
       severity="CRITICAL", file_types=_K, avd_id="AVD-KSV-0050",
       provider="kubernetes", service="rbac",
       resolution="Restrict RBAC management permissions")
def rbac_manage_rbac(ctx):
    rbac_resources = {"roles", "clusterroles", "rolebindings",
                      "clusterrolebindings"}
    out = []
    for r in _role_rules(ctx):
        if rbac_resources & set(r.get("resources") or []) and \
                any(v in (r.get("verbs") or [])
                    for v in ("create", "update", "patch", "delete",
                              "deletecollection", "bind", "escalate",
                              "*")):
            out.append(_rbac_cause(
                ctx, f"{_name(ctx.resource)} permits managing RBAC "
                     f"resources"))
    return out
