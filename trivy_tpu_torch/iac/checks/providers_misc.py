"""Terraform checks for the reference's smaller cloud providers:
github, digitalocean, openstack, oracle, cloudstack, nifcloud
(reference pkg/iac/providers/{github,digitalocean,openstack,oracle,
cloudstack,nifcloud} + pkg/iac/adapters/terraform/*). Check IDs follow
the reference AVD naming; severities are best-effort matches to the
upstream rule metadata.

Terraform-only (these providers have no CloudFormation/ARM surface);
unknown-stays-silent conventions follow iac/checks/cloud.py: an
attribute present but unresolved reads as unknown, never as a failing
value.

Copy of trivy_tpu/iac/checks/providers_misc.py, whole.
"""

from __future__ import annotations

from trivy_tpu_torch.iac.check import check
from trivy_tpu_torch.iac.checks.cloud import (
    _ANYWHERE,
    CloudResource,
    _of_type,
    _tf_tristate,
    _tf_value,
)
from trivy_tpu_torch.iac.parsers.hcl import Block, Expr

_TF = ("terraform",)


def _str_list(v) -> list[str]:
    if isinstance(v, Expr) or v is None:
        return []
    if isinstance(v, str):
        return [v]
    return [x for x in v if isinstance(x, str)]


def adapt_terraform_misc(blocks: list[Block]) -> list[CloudResource]:
    out: list[CloudResource] = []
    for b in blocks:
        if b.type != "resource" or len(b.labels) < 2:
            continue
        t = b.labels[0]
        cr = CloudResource(name=f"{t}.{b.labels[1]}",
                           start_line=b.start_line, end_line=b.end_line)
        if t == "github_repository":
            # reference adapters/terraform/github/repositories/adapt.go:
            # visibility overrides private; default is public
            public: bool | None = True
            private = _tf_tristate(b, "private", None)
            if private is True:
                public = False
            elif private is None and "private" in b.attrs:
                public = None  # unresolved
            vis = b.get("visibility")
            if vis is not None:
                v = _tf_value(vis)
                if v in ("private", "internal"):
                    public = False
                elif v == "public":
                    public = True
                else:
                    public = None  # unresolved expression
            cr.type = "github_repository"
            cr.attrs = {
                "public": public,
                "vulnerability_alerts": _tf_tristate(
                    b, "vulnerability_alerts", False),
                "archived": _tf_tristate(b, "archived", False),
            }
        elif t in ("github_branch_protection",
                   "github_branch_protection_v3"):
            cr.type = "github_branch_protection"
            cr.attrs = {
                "require_signed_commits": _tf_tristate(
                    b, "require_signed_commits", False),
            }
        elif t == "github_actions_environment_secret":
            cr.type = "github_env_secret"
            cr.attrs = {
                "plaintext": bool(_tf_value(b.get("plaintext_value"))),
            }
        elif t == "digitalocean_firewall":
            inbound, outbound = [], []
            for rule in b.children("inbound_rule"):
                inbound.extend(_str_list(rule.get("source_addresses")))
            for rule in b.children("outbound_rule"):
                outbound.extend(
                    _str_list(rule.get("destination_addresses")))
            cr.type = "do_firewall"
            cr.attrs = {"inbound": inbound, "outbound": outbound}
        elif t == "digitalocean_loadbalancer":
            protos = [
                _tf_value(r.get("entry_protocol"))
                for r in b.children("forwarding_rule")
            ]
            cr.type = "do_loadbalancer"
            cr.attrs = {
                "entry_protocols": protos,
                "redirect_http": _tf_tristate(
                    b, "redirect_http_to_https", False),
            }
        elif t == "digitalocean_droplet":
            keys = b.get("ssh_keys")
            cr.type = "do_droplet"
            cr.attrs = {
                # unresolved list -> unknown (not "no keys")
                "has_ssh_keys": None if isinstance(keys, Expr)
                else bool(keys),
            }
        elif t == "digitalocean_kubernetes_cluster":
            cr.type = "do_kubernetes"
            cr.attrs = {
                "auto_upgrade": _tf_tristate(b, "auto_upgrade", False),
                "surge_upgrade": _tf_tristate(b, "surge_upgrade", False),
            }
        elif t == "digitalocean_spaces_bucket":
            vers = b.child("versioning")
            cr.type = "do_spaces_bucket"
            cr.attrs = {
                "acl": _tf_value(b.get("acl")),
                "versioning": _tf_tristate(vers, "enabled", False)
                if vers else False,
            }
        elif t == "openstack_networking_secgroup_rule_v2":
            cr.type = "openstack_secgroup_rule"
            cr.attrs = {
                "direction": _tf_value(b.get("direction")),
                "cidr": _tf_value(b.get("remote_ip_prefix")),
            }
        elif t == "openstack_compute_instance_v2":
            cr.type = "openstack_instance"
            cr.attrs = {
                "admin_pass": bool(_tf_value(b.get("admin_pass"))),
            }
        elif t == "opc_compute_ip_address_reservation":
            cr.type = "oracle_ip_reservation"
            cr.attrs = {"pool": _tf_value(b.get("pool"))}
        elif t == "cloudstack_instance":
            ud = _tf_value(b.get("user_data"))
            if isinstance(ud, str):
                # CloudStack user_data is conventionally base64; decode
                # when decodable so markers inside are still found
                # (reference adapters/terraform/cloudstack)
                import base64 as _b64

                try:
                    decoded = _b64.b64decode(ud, validate=True)
                    ud = decoded.decode("utf-8", "replace")
                except (ValueError, UnicodeDecodeError):
                    pass
            cr.type = "cloudstack_instance"
            cr.attrs = {"user_data": ud if isinstance(ud, str) else ""}
        elif t in ("nifcloud_security_group_rule",):
            cr.type = "nifcloud_sg_rule"
            cr.attrs = {
                # absent -> provider default IN; unresolved -> None
                "type": _tf_tristate(b, "type", "IN"),
                "cidr": _tf_value(b.get("cidr_ip")),
            }
        elif t == "nifcloud_load_balancer":
            cr.type = "nifcloud_lb"
            cr.attrs = {
                "protocol": _tf_value(b.get("load_balancer_protocol")),
            }
        else:
            continue
        out.append(cr)
    return out


# ------------------------------------------------------------- github


@check("AVD-GIT-0001", "GitHub repository is public", severity="MEDIUM",
       file_types=_TF, provider="github", service="repositories",
       resolution="Set visibility = private (or internal)")
def github_repo_public(ctx):
    out = []
    for r in _of_type(ctx, "github_repository"):
        if r.attrs.get("public") is True:
            out.append(r.cause("Repository is public"))
    return out


@check("AVD-GIT-0004", "GitHub branch protection does not require signed "
                       "commits", severity="HIGH", file_types=_TF,
       provider="github", service="branch_protections",
       resolution="Set require_signed_commits = true")
def github_signed_commits(ctx):
    out = []
    for r in _of_type(ctx, "github_branch_protection"):
        if r.attrs.get("require_signed_commits") is False:
            out.append(r.cause(
                "Branch protection does not require signed commits"))
    return out


@check("AVD-GIT-0003", "GitHub repository has vulnerability alerts "
                       "disabled", severity="HIGH", file_types=_TF,
       provider="github", service="repositories",
       resolution="Set vulnerability_alerts = true")
def github_vuln_alerts(ctx):
    out = []
    for r in _of_type(ctx, "github_repository"):
        if r.attrs.get("vulnerability_alerts") is False \
                and r.attrs.get("archived") is not True:
            out.append(r.cause("Vulnerability alerts are not enabled"))
    return out


@check("AVD-GIT-0002", "GitHub Actions environment secret has a "
                       "plaintext value", severity="HIGH", file_types=_TF,
       provider="github", service="actions",
       resolution="Use encrypted_value instead of plaintext_value")
def github_plaintext_secret(ctx):
    out = []
    for r in _of_type(ctx, "github_env_secret"):
        if r.attrs.get("plaintext"):
            out.append(r.cause(
                "Environment secret is set from a plaintext value"))
    return out


# ------------------------------------------------------- digitalocean


@check("AVD-DIG-0001", "DigitalOcean firewall allows unrestricted "
                       "ingress", severity="CRITICAL", file_types=_TF,
       provider="digitalocean", service="compute",
       resolution="Restrict inbound source addresses")
def do_firewall_open_inbound(ctx):
    out = []
    for r in _of_type(ctx, "do_firewall"):
        if any(a in _ANYWHERE for a in r.attrs.get("inbound") or []):
            out.append(r.cause(
                "Firewall rule allows ingress from anywhere"))
    return out


@check("AVD-DIG-0002", "DigitalOcean firewall allows unrestricted "
                       "egress", severity="CRITICAL", file_types=_TF,
       provider="digitalocean", service="compute",
       resolution="Restrict outbound destination addresses")
def do_firewall_open_outbound(ctx):
    out = []
    for r in _of_type(ctx, "do_firewall"):
        if any(a in _ANYWHERE for a in r.attrs.get("outbound") or []):
            out.append(r.cause(
                "Firewall rule allows egress to anywhere"))
    return out


@check("AVD-DIG-0003", "DigitalOcean load balancer accepts plain HTTP",
       severity="HIGH", file_types=_TF, provider="digitalocean",
       service="compute",
       resolution="Use https/http2 entry protocols or redirect HTTP")
def do_lb_plain_http(ctx):
    out = []
    for r in _of_type(ctx, "do_loadbalancer"):
        if r.attrs.get("redirect_http") is not False:
            continue  # True = exempt; None = unresolved = unknown
        if any(str(p or "").lower() == "http"
               for p in r.attrs.get("entry_protocols") or []):
            out.append(r.cause(
                "Load balancer forwarding rule uses plain HTTP"))
    return out


@check("AVD-DIG-0004", "DigitalOcean droplet has no SSH keys",
       severity="CRITICAL", file_types=_TF, provider="digitalocean",
       service="compute",
       resolution="Provision droplets with ssh_keys (password logins "
                  "are emailed in plaintext)")
def do_droplet_no_keys(ctx):
    out = []
    for r in _of_type(ctx, "do_droplet"):
        if r.attrs.get("has_ssh_keys") is False:
            out.append(r.cause("Droplet created without SSH keys"))
    return out


@check("AVD-DIG-0005", "DigitalOcean kubernetes cluster does not "
                       "auto-upgrade", severity="MEDIUM", file_types=_TF,
       provider="digitalocean", service="compute",
       resolution="Set auto_upgrade = true")
def do_k8s_auto_upgrade(ctx):
    out = []
    for r in _of_type(ctx, "do_kubernetes"):
        if r.attrs.get("auto_upgrade") is False:
            out.append(r.cause("Cluster does not auto-upgrade"))
    return out


@check("AVD-DIG-0008", "DigitalOcean kubernetes cluster has surge "
                       "upgrades disabled", severity="MEDIUM",
       file_types=_TF, provider="digitalocean", service="compute",
       resolution="Set surge_upgrade = true")
def do_k8s_surge_upgrade(ctx):
    out = []
    for r in _of_type(ctx, "do_kubernetes"):
        if r.attrs.get("surge_upgrade") is False:
            out.append(r.cause("Cluster has surge upgrades disabled"))
    return out


@check("AVD-DIG-0006", "DigitalOcean Spaces bucket has a public ACL",
       severity="CRITICAL", file_types=_TF, provider="digitalocean",
       service="spaces",
       resolution="Set acl = private")
def do_spaces_public(ctx):
    out = []
    for r in _of_type(ctx, "do_spaces_bucket"):
        if str(r.attrs.get("acl") or "") == "public-read":
            out.append(r.cause("Spaces bucket ACL is public-read"))
    return out


@check("AVD-DIG-0007", "DigitalOcean Spaces bucket versioning disabled",
       severity="MEDIUM", file_types=_TF, provider="digitalocean",
       service="spaces",
       resolution="Enable versioning")
def do_spaces_versioning(ctx):
    out = []
    for r in _of_type(ctx, "do_spaces_bucket"):
        if r.attrs.get("versioning") is False:
            out.append(r.cause("Spaces bucket has versioning disabled"))
    return out


# --------------------------------------------------------- openstack


@check("AVD-OPNSTK-0001", "OpenStack instance sets a plaintext admin "
                          "password", severity="MEDIUM", file_types=_TF,
       provider="openstack", service="compute",
       resolution="Avoid admin_pass; use key pairs")
def openstack_admin_pass(ctx):
    out = []
    for r in _of_type(ctx, "openstack_instance"):
        if r.attrs.get("admin_pass"):
            out.append(r.cause("Instance sets admin_pass in plaintext"))
    return out


@check("AVD-OPNSTK-0002", "OpenStack security group rule allows ingress "
                          "from anywhere", severity="MEDIUM",
       file_types=_TF, provider="openstack", service="networking",
       resolution="Restrict remote_ip_prefix")
def openstack_open_ingress(ctx):
    out = []
    for r in _of_type(ctx, "openstack_secgroup_rule"):
        if str(r.attrs.get("direction") or "") == "ingress" and \
                str(r.attrs.get("cidr") or "") in _ANYWHERE:
            out.append(r.cause(
                "Security group rule allows ingress from anywhere"))
    return out


# ------------------------------------------------------------- oracle


@check("AVD-OCI-0001", "OCI compute IP reservation from a public pool",
       severity="CRITICAL", file_types=_TF, provider="oracle",
       service="compute",
       resolution="Reserve addresses from a private pool")
def oracle_public_ip_pool(ctx):
    out = []
    for r in _of_type(ctx, "oracle_ip_reservation"):
        if str(r.attrs.get("pool") or "") == "public-ippool":
            out.append(r.cause(
                "IP reservation draws from the public pool"))
    return out


# --------------------------------------------------------- cloudstack


_SENSITIVE_MARKERS = ("password", "secret", "token", "aws_access_key",
                      "private_key")


@check("AVD-CLDSTK-0001", "CloudStack instance user data contains "
                          "sensitive material", severity="HIGH",
       file_types=_TF, provider="cloudstack", service="compute",
       resolution="Keep credentials out of user_data")
def cloudstack_userdata_secrets(ctx):
    out = []
    for r in _of_type(ctx, "cloudstack_instance"):
        ud = str(r.attrs.get("user_data") or "").lower()
        if any(marker in ud for marker in _SENSITIVE_MARKERS):
            out.append(r.cause(
                "Instance user_data embeds sensitive values"))
    return out


# ----------------------------------------------------------- nifcloud


@check("AVD-NIF-0001", "NIFCLOUD security group rule allows ingress "
                       "from anywhere", severity="CRITICAL",
       file_types=_TF, provider="nifcloud", service="network",
       resolution="Restrict cidr_ip")
def nifcloud_open_ingress(ctx):
    out = []
    for r in _of_type(ctx, "nifcloud_sg_rule"):
        kind = r.attrs.get("type")
        if kind is None:
            continue  # unresolved direction = unknown, stay silent
        if str(kind).upper() != "OUT" and \
                str(r.attrs.get("cidr") or "") in _ANYWHERE:
            out.append(r.cause(
                "Security group rule allows ingress from anywhere"))
    return out


@check("AVD-NIF-0002", "NIFCLOUD load balancer uses plain HTTP",
       severity="HIGH", file_types=_TF, provider="nifcloud",
       service="network",
       resolution="Use HTTPS for the load balancer listener")
def nifcloud_lb_http(ctx):
    out = []
    for r in _of_type(ctx, "nifcloud_lb"):
        if str(r.attrs.get("protocol") or "").upper() == "HTTP":
            out.append(r.cause("Load balancer listener uses plain HTTP"))
    return out
