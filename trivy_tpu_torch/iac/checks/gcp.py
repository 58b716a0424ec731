"""Google Cloud terraform checks (reference pkg/iac/adapters/terraform/
google + pkg/iac/providers/google rule set, re-expressed over the
CloudResource layer).

Copy of trivy_tpu/iac/checks/gcp.py, whole.
"""

from __future__ import annotations

from trivy_tpu_torch.iac.check import check
from trivy_tpu_torch.iac.parsers.hcl import Expr
from trivy_tpu_torch.iac.checks.cloud import (
    CloudResource,
    _tf_tristate,
    _tf_value as _tf_val,
)

_C = ("terraform", "terraformplan")


def adapt_terraform_gcp(blocks) -> list[CloudResource]:
    """google_* terraform resources -> typed CloudResources."""
    out: list[CloudResource] = []
    for b in blocks:
        if b.type != "resource" or len(b.labels) < 2:
            continue
        t = b.labels[0]
        if not t.startswith("google_"):
            continue
        cr = CloudResource(
            name=f"{t}.{b.labels[1]}",
            start_line=b.start_line, end_line=b.end_line)
        if t == "google_storage_bucket":
            cr.type = "gcs_bucket"
            # absent -> provider default; unresolved -> None = unknown,
            # and unknowns never fail a check (cloud.py _tf_tristate)
            cr.attrs = {
                "uniform_access": _tf_tristate(
                    b, "uniform_bucket_level_access", False),
                "public_prevention": _tf_val(
                    b.get("public_access_prevention")),
            }
        elif t == "google_storage_bucket_iam_member":
            cr.type = "gcs_iam_member"
            cr.attrs = {"member": _tf_val(b.get("member"))}
        elif t == "google_compute_firewall":
            allows = []
            for a in b.children("allow"):
                allows.append({
                    "protocol": _tf_val(a.get("protocol")),
                    "ports": _tf_val(a.get("ports")) or [],
                })
            cr.type = "gcp_firewall"
            cr.attrs = {
                "source_ranges": _tf_val(b.get("source_ranges")) or [],
                "allows": allows,
            }
        elif t == "google_sql_database_instance":
            settings = b.child("settings")
            ip_cfg = settings.child("ip_configuration") if settings \
                else None
            cr.type = "gcp_sql"
            cr.attrs = {
                "public_ip": _tf_tristate(ip_cfg, "ipv4_enabled", True)
                if ip_cfg else True,  # provider default is enabled
                "require_ssl": _tf_tristate(ip_cfg, "require_ssl", False)
                if ip_cfg else False,
            }
        elif t == "google_container_cluster":
            cr.type = "gke_cluster"
            private = b.child("private_cluster_config")
            np_block = b.child("network_policy")
            cr.attrs = {
                "legacy_abac": _tf_tristate(
                    b, "enable_legacy_abac", False),
                "private_nodes": _tf_tristate(
                    private, "enable_private_nodes", False)
                if private else False,
                # the provider defaults network_policy.enabled to FALSE
                # even when the block is present (reference gke adapt.go)
                "network_policy": _tf_tristate(np_block, "enabled", False)
                if np_block else False,
                "datapath": _tf_val(b.get("datapath_provider")),
                "datapath_unresolved": isinstance(
                    b.get("datapath_provider"), Expr),
            }
        elif t == "google_compute_instance":
            cr.type = "gcp_instance"
            shielded = b.child("shielded_instance_config")
            cr.attrs = {
                "serial_port": any(
                    str(_tf_val(m.get("key"))) == "serial-port-enable"
                    for m in b.children("metadata")
                ) or (isinstance(_tf_val(b.get("metadata")), dict)
                      and str(_tf_val(b.get("metadata")).get(
                          "serial-port-enable", "")).lower()
                      in ("true", "1")),
                "shielded_vm": shielded is not None,
            }
        else:
            continue
        out.append(cr)
    return out


def _of_type(ctx, t):
    return [r for r in ctx.cloud_resources if r.type == t]


@check("AVD-GCP-0001", "Storage bucket is publicly accessible",
       severity="HIGH", file_types=_C, provider="google", service="storage",
       resolution="Restrict public access to the bucket")
def gcs_public_member(ctx):
    out = []
    for r in _of_type(ctx, "gcs_iam_member"):
        if str(r.attrs.get("member")) in ("allUsers",
                                          "allAuthenticatedUsers"):
            out.append(r.cause(
                f"Bucket is granted to '{r.attrs['member']}'"))
    return out


@check("AVD-GCP-0002", "Storage bucket does not use uniform bucket-level "
                       "access", severity="MEDIUM", file_types=_C,
       provider="google", service="storage",
       resolution="Enable uniform_bucket_level_access")
def gcs_uniform_access(ctx):
    out = []
    for r in _of_type(ctx, "gcs_bucket"):
        if r.attrs.get("uniform_access") is False:
            out.append(r.cause(
                "Bucket has uniform bucket level access disabled"))
    return out


@check("AVD-GCP-0027", "Compute firewall allows ingress from the public "
                       "internet", severity="CRITICAL", file_types=_C,
       provider="google", service="compute",
       resolution="Restrict source ranges")
def gcp_firewall_open(ctx):
    out = []
    for r in _of_type(ctx, "gcp_firewall"):
        for cidr in r.attrs.get("source_ranges") or []:
            if str(cidr) in ("0.0.0.0/0", "::/0"):
                out.append(r.cause(
                    f"Firewall allows ingress from '{cidr}'"))
    return out


@check("AVD-GCP-0017", "Cloud SQL instance has a public IP address",
       severity="HIGH", file_types=_C, provider="google", service="sql",
       resolution="Disable ipv4_enabled or restrict authorized networks")
def gcp_sql_public_ip(ctx):
    out = []
    for r in _of_type(ctx, "gcp_sql"):
        if r.attrs.get("public_ip") is True:
            out.append(r.cause("Database instance is granted a public IP"))
    return out


@check("AVD-GCP-0015", "Cloud SQL instance does not require TLS",
       severity="HIGH", file_types=_C, provider="google", service="sql",
       resolution="Set ip_configuration.require_ssl")
def gcp_sql_tls(ctx):
    out = []
    for r in _of_type(ctx, "gcp_sql"):
        if r.attrs.get("require_ssl") is False:
            out.append(r.cause(
                "Database instance does not require TLS for connections"))
    return out


@check("AVD-GCP-0064", "GKE cluster uses legacy ABAC authorization",
       severity="HIGH", file_types=_C, provider="google", service="gke",
       resolution="Disable enable_legacy_abac")
def gke_legacy_abac(ctx):
    out = []
    for r in _of_type(ctx, "gke_cluster"):
        if r.attrs.get("legacy_abac") in (True, "true"):
            out.append(r.cause("Cluster has legacy ABAC enabled"))
    return out


@check("AVD-GCP-0059", "GKE cluster nodes are not private",
       severity="MEDIUM", file_types=_C, provider="google", service="gke",
       resolution="Enable private_cluster_config.enable_private_nodes")
def gke_private_nodes(ctx):
    out = []
    for r in _of_type(ctx, "gke_cluster"):
        if r.attrs.get("private_nodes") is False:
            out.append(r.cause("Cluster does not have private nodes"))
    return out


@check("AVD-GCP-0061", "GKE cluster has no network policy", severity="MEDIUM",
       file_types=_C, provider="google", service="gke",
       resolution="Enable a network policy (or dataplane v2)")
def gke_network_policy(ctx):
    out = []
    for r in _of_type(ctx, "gke_cluster"):
        # dataplane v2 enforces network policy without the block; an
        # unresolved datapath_provider stays silent (unknown)
        if str(r.attrs.get("datapath") or "") == "ADVANCED_DATAPATH":
            continue
        if r.attrs.get("datapath_unresolved"):
            continue
        if r.attrs.get("network_policy") is False:
            out.append(r.cause("Cluster does not have a network policy"))
    return out


@check("AVD-GCP-0032", "Compute instance has serial port enabled",
       severity="MEDIUM", file_types=_C, provider="google",
       service="compute", resolution="Disable serial-port-enable metadata")
def gcp_serial_port(ctx):
    out = []
    for r in _of_type(ctx, "gcp_instance"):
        if r.attrs.get("serial_port"):
            out.append(r.cause("Instance has serial port enabled"))
    return out
