"""GCP check breadth: additional google_* service families (reference
pkg/iac/providers/google/{bigquery,compute,dns,gke,iam,kms,sql}/ and
pkg/iac/adapters/terraform/google/*/adapt.go). Declarative layout as in
aws_ext; IDs/severities follow the public AVD registry
(avd.aquasec.com/misconfig/google).

Copy of trivy_tpu/iac/checks/gcp_ext.py, whole.
"""

from __future__ import annotations

from trivy_tpu_torch.iac.checks.spec import (
    fail_if as _fail_if,
    register_specs,
    tf_value as _v,
    tri as _tri,
)
from trivy_tpu_torch.iac.parsers.hcl import Block

_C = ("terraform", "terraformplan")


def adapt_terraform_gcp_ext(blocks: list[Block]) -> list:
    from trivy_tpu_torch.iac.checks.cloud import CloudResource

    out = []
    for b in blocks:
        if b.type != "resource" or len(b.labels) < 2:
            continue
        fn = _TF.get(b.labels[0])
        if fn is None:
            continue
        rtype, attrs = fn(b)
        out.append(CloudResource(
            type=rtype, name=f"{b.labels[0]}.{b.labels[1]}",
            attrs=attrs, start_line=b.start_line, end_line=b.end_line))
    return out


def _tf_bq_dataset(b):
    members = []
    for a in b.children("access"):
        members.append(_v(a.get("special_group")))
    return "bq_dataset", {"special_groups": members}


def _tf_compute_disk(b):
    enc = b.child("disk_encryption_key")
    has_key = False
    if enc is not None:
        has_key = bool(_v(enc.get("raw_key")) or
                       _v(enc.get("kms_key_self_link")) or
                       _v(enc.get("rsa_encrypted_key")))
    return "gcp_disk", {"cmk": has_key}


def _tf_instance_ext(b):
    sa = b.child("service_account")
    email = _v(sa.get("email")) if sa is not None else None
    return "gcp_instance_ext", {
        "default_sa": (email is None or str(email).endswith(
            "-compute@developer.gserviceaccount.com"))
        if not (sa is not None and "email" in sa.attrs and
                email is None) else None,
        "ip_forwarding": _tri(b, "can_ip_forward", False),
    }


def _tf_firewall_ext(b):
    return "gcp_firewall_ext", {
        "direction": _v(b.get("direction")) or "INGRESS",
        "destination_ranges": _v(b.get("destination_ranges")) or [],
        "has_deny": len(b.children("deny")) > 0,
        "has_allow": len(b.children("allow")) > 0,
    }


def _tf_dns_zone(b):
    dnssec = b.child("dnssec_config")
    state = _tri(dnssec, "state", "off") if dnssec else "off"
    keys = []
    if dnssec is not None:
        for spec in dnssec.children("default_key_specs"):
            keys.append(_v(spec.get("algorithm")))
    return "dns_zone", {
        "dnssec": str(state).lower() == "on",
        "key_algorithms": keys,
        "visibility": _tri(b, "visibility", "public"),
    }


def _tf_gke_ext(b):
    meta = None
    legacy = None
    nc = b.child("node_config")
    if nc is not None:
        wm = nc.child("workload_metadata_config")
        meta = _tri(wm, "node_metadata",
                    _tri(wm, "mode", None)) if wm else None
        md = _v(nc.get("metadata"))
        if isinstance(md, dict):
            legacy = str(md.get(
                "disable-legacy-endpoints", "")).lower() \
                not in ("true", "1")
    auth = b.child("master_auth")
    basic_auth = False
    if auth is not None:
        basic_auth = bool(_v(auth.get("username")) or
                          _v(auth.get("password")))
    return "gke_cluster_ext", {
        "shielded_nodes": _tri(b, "enable_shielded_nodes", False),
        "legacy_metadata": legacy,
        "node_metadata_mode": meta,
        "basic_auth": basic_auth,
        "resource_labels": bool(_v(b.get("resource_labels"))),
    }


def _tf_project_iam(b):
    return "gcp_project_iam", {
        "role": _v(b.get("role")),
        "member": _v(b.get("member")),
    }


def _tf_kms_key(b):
    raw = b.get("rotation_period")
    if raw is None:
        seconds = 0                 # absent -> never rotated (fails)
    elif _v(raw) is None:
        seconds = None              # unresolved expression -> unknown
    else:
        seconds = None
        period = _v(raw)
        if isinstance(period, str) and period.endswith("s"):
            try:
                seconds = int(float(period[:-1]))
            except ValueError:
                seconds = None
    return "gcp_kms_key", {"rotation_seconds": seconds}


def _tf_sql_ext(b):
    settings = b.child("settings")
    backups = settings.child("backup_configuration") if settings \
        else None
    flags = {}
    if settings is not None:
        for f in settings.children("database_flags"):
            flags[_v(f.get("name"))] = _v(f.get("value"))
    return "gcp_sql_ext", {
        "backups": _tri(backups, "enabled", False)
        if backups else False,
        "flags": flags,
        "version": _v(b.get("database_version")),
    }


_TF = {
    "google_bigquery_dataset": _tf_bq_dataset,
    "google_compute_disk": _tf_compute_disk,
    "google_compute_instance": _tf_instance_ext,
    "google_compute_firewall": _tf_firewall_ext,
    "google_dns_managed_zone": _tf_dns_zone,
    "google_container_cluster": _tf_gke_ext,
    "google_project_iam_member": _tf_project_iam,
    "google_project_iam_binding": _tf_project_iam,
    "google_kms_crypto_key": _tf_kms_key,
    "google_sql_database_instance": _tf_sql_ext,
}

_MAX_ROTATION_S = 90 * 24 * 3600   # published AVD rule: 90 days

SPECS = [
    ("AVD-GCP-0046", "BigQuery dataset is publicly accessible",
     "CRITICAL", "bq_dataset", "bigquery",
     lambda a: None if a.get("special_groups") is None else (
         "Dataset grants access to allAuthenticatedUsers"
         if "allAuthenticatedUsers" in a["special_groups"] else False),
     "Remove allAuthenticatedUsers access grants"),
    ("AVD-GCP-0037", "Compute disk is not encrypted with a customer "
     "key", "LOW", "gcp_disk", "compute",
     _fail_if("cmk", (False,),
              "Disk has no customer-managed encryption key"),
     "Set disk_encryption_key"),
    ("AVD-GCP-0044", "Instance uses the default service account",
     "HIGH", "gcp_instance_ext", "compute",
     _fail_if("default_sa", (True,),
              "Compute default service account is used"),
     "Attach a dedicated service account"),
    ("AVD-GCP-0043", "Instance allows IP forwarding", "HIGH",
     "gcp_instance_ext", "compute",
     _fail_if("ip_forwarding", (True,), "can_ip_forward is enabled"),
     "Disable can_ip_forward"),
    ("AVD-GCP-0028", "Firewall allows egress to the public internet",
     "CRITICAL", "gcp_firewall_ext", "compute",
     lambda a: None if a.get("destination_ranges") is None else (
         "Egress rule allows 0.0.0.0/0"
         if str(a.get("direction", "")).upper() == "EGRESS" and
         a.get("has_allow") and
         "0.0.0.0/0" in a["destination_ranges"] else False),
     "Restrict egress destination ranges"),
    ("AVD-GCP-0013", "DNS zone DNSSEC is disabled", "MEDIUM",
     "dns_zone", "dns",
     lambda a: None if a.get("dnssec") is None else (
         "DNSSEC is not enabled on a public zone"
         if a["dnssec"] is False and
         a.get("visibility") == "public" else False),
     "Enable dnssec_config state = on"),
    ("AVD-GCP-0012", "DNS zone DNSSEC uses RSASHA1", "MEDIUM",
     "dns_zone", "dns",
     lambda a: None if a.get("key_algorithms") is None else (
         "DNSSEC key uses RSASHA1"
         if "rsasha1" in [str(x).lower()
                          for x in a["key_algorithms"]] else False),
     "Use a stronger signing algorithm"),
    ("AVD-GCP-0055", "GKE shielded nodes are disabled", "HIGH",
     "gke_cluster_ext", "gke",
     _fail_if("shielded_nodes", (False,),
              "enable_shielded_nodes is not set"),
     "Set enable_shielded_nodes = true"),
    ("AVD-GCP-0048", "GKE legacy metadata endpoints are enabled",
     "HIGH", "gke_cluster_ext", "gke",
     _fail_if("legacy_metadata", (True,),
              "disable-legacy-endpoints is not true"),
     "Set node metadata disable-legacy-endpoints = true"),
    ("AVD-GCP-0053", "GKE basic authentication is enabled", "HIGH",
     "gke_cluster_ext", "gke",
     _fail_if("basic_auth", (True,),
              "master_auth sets a static username/password"),
     "Remove master_auth basic credentials"),
    ("AVD-GCP-0063", "GKE cluster has no resource labels", "LOW",
     "gke_cluster_ext", "gke",
     _fail_if("resource_labels", (False,),
              "No resource labels are set"),
     "Set resource_labels"),
    ("AVD-GCP-0007", "Project IAM grants a primitive role", "MEDIUM",
     "gcp_project_iam", "iam",
     lambda a: None if a.get("role") is None else (
         f"Primitive role {a['role']} is granted"
         if a["role"] in ("roles/owner", "roles/editor",
                          "roles/viewer") else False),
     "Use fine-grained predefined or custom roles"),
    ("AVD-GCP-0065", "KMS key is not rotated every 90 days", "HIGH",
     "gcp_kms_key", "kms",
     lambda a: None if a.get("rotation_seconds") is None else (
         "Rotation period exceeds 90 days (or is unset)"
         if a["rotation_seconds"] == 0 or
         a["rotation_seconds"] > _MAX_ROTATION_S else False),
     "Set rotation_period <= 90 days (7776000s)"),
    ("AVD-GCP-0024", "Cloud SQL has no automated backups", "MEDIUM",
     "gcp_sql_ext", "sql",
     _fail_if("backups", (False,),
              "Automated backups are not enabled"),
     "Enable settings.backup_configuration"),
    ("AVD-GCP-0026", "Cloud SQL allows local infile", "MEDIUM",
     "gcp_sql_ext", "sql",
     lambda a: None if a.get("flags") is None else (
         "local_infile flag is on"
         if str(a["flags"].get("local_infile", "off")).lower() == "on"
         else False),
     "Set database flag local_infile = off"),
    ("AVD-GCP-0025", "Cloud SQL postgres does not log connections",
     "MEDIUM", "gcp_sql_ext", "sql",
     lambda a: None if a.get("flags") is None else (
         "log_connections flag is off"
         if str(a.get("version", "")).startswith("POSTGRES") and
         str(a["flags"].get("log_connections", "off")).lower()
         == "off" else False),
     "Set database flag log_connections = on"),
]


register_specs(SPECS, provider="google", file_types=_C)
