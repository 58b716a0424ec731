"""Azure check breadth: the azurerm terraform surface plus new service
families (reference pkg/iac/providers/azure/{appservice,container,
database,keyvault,monitor,network,securitycenter,storage,synapse,
datafactory}/ and pkg/iac/adapters/terraform/azure/*/adapt.go).

Same declarative layout as aws_ext: terraform adapters normalize
azurerm_* blocks into CloudResource attrs (None = unknown -> silent),
one Check per AVD rule, IDs/severities following the public AVD
registry (avd.aquasec.com/misconfig/azure). The ARM adapter
(checks/azure.py adapt_arm) emits the same resource types for the
storage/sql/vm shapes it covers, so these checks run on both inputs.

Copy of trivy_tpu/iac/checks/azure_ext.py, whole.
"""

from __future__ import annotations

from trivy_tpu_torch.iac.checks.spec import (
    fail_if as _fail_if,
    lt as _lt,
    register_specs,
    tf_value as _v,
    tri as _tri,
)
from trivy_tpu_torch.iac.parsers.hcl import Block

_C = ("terraform", "terraformplan", "azure-arm")


def adapt_terraform_azure(blocks: list[Block]) -> list:
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


def _tf_storage_account(b):
    rules = b.child("network_rules")
    queue_logging = False
    qp = b.child("queue_properties")
    if qp is not None:
        lg = qp.child("logging")
        if lg is not None:
            queue_logging = all(
                _tri(lg, k, False) is True
                for k in ("delete", "read", "write"))
    return "storage_account", {
        "https_only": _tri(b, "enable_https_traffic_only",
                           _tri(b, "https_traffic_only_enabled", True)),
        "min_tls": _tri(b, "min_tls_version", "TLS1_2"),
        "public_blob_access": _tri(b, "allow_blob_public_access",
                                   _tri(b,
                                        "allow_nested_items_to_be_public",
                                        True)),
        "network_default_deny": (_tri(rules, "default_action", None)
                                 in ("Deny", "deny"))
        if rules is not None else False,
        "queue_logging": queue_logging,
    }


def _tf_app_service(b):
    site = b.child("site_config")
    auth = b.child("auth_settings")
    identity = b.child("identity")
    return "app_service", {
        "https_only": _tri(b, "https_only", False),
        "min_tls": _tri(site, "min_tls_version", "1.2")
        if site else "1.2",
        "http2": _tri(site, "http2_enabled", False) if site else False,
        "client_cert": _tri(b, "client_cert_enabled", False),
        "auth_enabled": _tri(auth, "enabled", False)
        if auth else False,
        "identity": identity is not None,
    }


def _tf_aks(b):
    rbac = b.child("role_based_access_control")
    np = _v(b.get("network_profile.network_policy")) \
        if "network_profile.network_policy" in b.attrs else None
    net = b.child("network_profile")
    oms = None
    addons = b.child("addon_profile")
    if addons is not None:
        agent = addons.child("oms_agent")
        oms = _tri(agent, "enabled", False) if agent else False
    if oms is None:
        oms = b.child("oms_agent") is not None
    api = b.child("api_server_access_profile")
    ranges = _v(b.get("api_server_authorized_ip_ranges"))
    if ranges is None and api is not None:
        ranges = _v(api.get("authorized_ip_ranges"))
    return "aks_cluster", {
        "rbac": _tri(rbac, "enabled", False) if rbac is not None
        else _tri(b, "role_based_access_control_enabled", True),
        "network_policy": bool(_tri(net, "network_policy", None))
        if net is not None else (bool(np) if np else False),
        "logging": bool(oms),
        "authorized_ranges": bool(ranges),
    }


def _tf_postgresql_server(b):
    return "pg_server", {
        "ssl": _tri(b, "ssl_enforcement_enabled", False),
        "min_tls": _tri(b, "ssl_minimal_tls_version_enforced",
                        "TLSEnforcementDisabled"),
        "public": _tri(b, "public_network_access_enabled", True),
    }


def _tf_pg_config(b):
    return "pg_config", {
        "name": _v(b.get("name")),
        "value": _v(b.get("value")),
    }


def _tf_mysql_server(b):
    return "mysql_server", {
        "ssl": _tri(b, "ssl_enforcement_enabled", False),
        "min_tls": _tri(b, "ssl_minimal_tls_version_enforced",
                        "TLSEnforcementDisabled"),
        "public": _tri(b, "public_network_access_enabled", True),
    }


def _tf_mssql_server(b):
    return "mssql_server", {
        "min_tls": _tri(b, "minimum_tls_version", None),
        "public": _tri(b, "public_network_access_enabled", True),
    }


def _tf_mssql_auditing(b):
    return "mssql_auditing", {
        "retention": _tri(b, "retention_in_days", 0),
    }


def _tf_mssql_alert(b):
    return "mssql_alert", {
        "disabled_alerts": _v(b.get("disabled_alerts")) or [],
        "email_account_admins": _tri(b, "email_account_admins", False),
    }


def _tf_keyvault(b):
    acls = b.child("network_acls")
    return "key_vault", {
        "purge_protection": _tri(b, "purge_protection_enabled", False),
        "network_default_deny": (_tri(acls, "default_action", None)
                                 in ("Deny", "deny"))
        if acls is not None else False,
    }


def _tf_keyvault_secret(b):
    return "key_vault_secret", {
        "expiry": bool(_v(b.get("expiration_date"))),
        "content_type": bool(_v(b.get("content_type"))),
    }


def _tf_keyvault_key(b):
    return "key_vault_key", {
        "expiry": bool(_v(b.get("expiration_date"))),
    }


def _tf_monitor_log_profile(b):
    ret = b.child("retention_policy")
    return "monitor_log_profile", {
        "retention_enabled": _tri(ret, "enabled", False)
        if ret else False,
        "retention_days": _tri(ret, "days", 0) if ret else 0,
        "categories": _v(b.get("categories")) or [],
        "locations": _v(b.get("locations")) or [],
    }


def _tf_nsg_rule(b):
    return "nsg_rule", {
        "direction": _v(b.get("direction")),
        "access": _v(b.get("access")),
        "port_range": str(_v(b.get("destination_port_range")) or ""),
        "source": _v(b.get("source_address_prefix")),
    }


def _tf_security_contact(b):
    return "security_center_contact", {
        "phone": bool(_v(b.get("phone"))),
    }


def _tf_security_pricing(b):
    return "security_center_pricing", {
        "tier": _v(b.get("tier")),
    }


def _tf_synapse(b):
    return "synapse_workspace", {
        "managed_vnet": _tri(b, "managed_virtual_network_enabled",
                             False),
    }


def _tf_data_factory(b):
    return "data_factory", {
        "public": _tri(b, "public_network_enabled", True),
    }


def _tf_managed_disk(b):
    enc = b.child("encryption_settings")
    return "managed_disk", {
        "encryption_disabled": (_tri(enc, "enabled", True) is False)
        if enc is not None else False,
    }


def _tf_redis_cache(b):
    return "redis_cache", {
        "non_ssl_port": _tri(b, "enable_non_ssl_port", False),
    }


def _tf_datalake_store(b):
    return "data_lake_store", {
        "encrypted": _tri(b, "encryption_state", "Enabled"),
    }


_TF = {
    "azurerm_storage_account": _tf_storage_account,
    "azurerm_app_service": _tf_app_service,
    "azurerm_linux_web_app": _tf_app_service,
    "azurerm_windows_web_app": _tf_app_service,
    "azurerm_kubernetes_cluster": _tf_aks,
    "azurerm_postgresql_server": _tf_postgresql_server,
    "azurerm_postgresql_configuration": _tf_pg_config,
    "azurerm_mysql_server": _tf_mysql_server,
    "azurerm_mssql_server": _tf_mssql_server,
    "azurerm_mssql_server_extended_auditing_policy": _tf_mssql_auditing,
    "azurerm_mssql_server_security_alert_policy": _tf_mssql_alert,
    "azurerm_key_vault": _tf_keyvault,
    "azurerm_key_vault_secret": _tf_keyvault_secret,
    "azurerm_key_vault_key": _tf_keyvault_key,
    "azurerm_monitor_log_profile": _tf_monitor_log_profile,
    "azurerm_network_security_rule": _tf_nsg_rule,
    "azurerm_security_center_contact": _tf_security_contact,
    "azurerm_security_center_subscription_pricing":
        _tf_security_pricing,
    "azurerm_synapse_workspace": _tf_synapse,
    "azurerm_data_factory": _tf_data_factory,
    "azurerm_data_lake_store": _tf_datalake_store,
    "azurerm_managed_disk": _tf_managed_disk,
    "azurerm_redis_cache": _tf_redis_cache,
}


def _nsg_internet_rule(port):
    def test(a):
        if a.get("direction") is None or a.get("access") is None:
            return None
        if str(a["direction"]).lower() != "inbound" or \
                str(a["access"]).lower() != "allow":
            return False
        src = a.get("source")
        if src is None:
            return None
        if str(src) not in ("*", "0.0.0.0/0", "Internet", "any",
                            "::/0"):
            return False
        pr = a.get("port_range")
        if pr == "*" or pr == str(port):
            return f"Port {port} is exposed to the internet"
        if "-" in pr:
            try:
                lo, hi = pr.split("-")
                if int(lo) <= port <= int(hi):
                    return f"Port {port} is exposed to the internet"
            except ValueError:
                return False
        return False
    return test


SPECS = [
    # --- storage
    ("AVD-AZU-0012", "Storage account network rules do not deny by "
     "default", "MEDIUM", "storage_account", "storage",
     _fail_if("network_default_deny", (False,),
              "Default network action is not Deny"),
     "Set network_rules default_action = Deny"),
    ("AVD-AZU-0009", "Storage queue services logging is disabled",
     "MEDIUM", "storage_account", "storage",
     _fail_if("queue_logging", (False,),
              "Queue logging is not enabled for read/write/delete"),
     "Enable queue_properties logging"),
    # --- app service
    ("AVD-AZU-0001", "App Service does not enforce HTTPS", "HIGH",
     "app_service", "appservice",
     _fail_if("https_only", (False,), "https_only is not enabled"),
     "Set https_only = true"),
    ("AVD-AZU-0005", "App Service uses an outdated minimum TLS",
     "HIGH", "app_service", "appservice",
     _fail_if("min_tls", ("1.0", "1.1"),
              "Minimum TLS version is below 1.2"),
     "Set site_config min_tls_version = 1.2"),
    ("AVD-AZU-0003", "App Service HTTP/2 is disabled", "LOW",
     "app_service", "appservice",
     _fail_if("http2", (False,), "HTTP/2 is not enabled"),
     "Set site_config http2_enabled = true"),
    ("AVD-AZU-0004", "App Service does not require client "
     "certificates", "LOW", "app_service", "appservice",
     _fail_if("client_cert", (False,),
              "Client certificates are not required"),
     "Set client_cert_enabled = true"),
    ("AVD-AZU-0002", "App Service authentication is disabled",
     "MEDIUM", "app_service", "appservice",
     _fail_if("auth_enabled", (False,),
              "Built-in authentication is not enabled"),
     "Enable auth_settings"),
    ("AVD-AZU-0006", "App Service has no managed identity", "LOW",
     "app_service", "appservice",
     _fail_if("identity", (False,),
              "No managed identity is registered"),
     "Add an identity block"),
    # --- AKS
    ("AVD-AZU-0042", "AKS cluster RBAC is disabled", "HIGH",
     "aks_cluster", "container",
     _fail_if("rbac", (False,), "RBAC is not enabled"),
     "Enable role_based_access_control"),
    ("AVD-AZU-0043", "AKS cluster has no network policy", "MEDIUM",
     "aks_cluster", "container",
     _fail_if("network_policy", (False,),
              "No network policy is configured"),
     "Set network_profile.network_policy"),
    ("AVD-AZU-0040", "AKS cluster monitoring is disabled", "MEDIUM",
     "aks_cluster", "container",
     _fail_if("logging", (False,),
              "The OMS agent addon is not enabled"),
     "Enable the oms_agent addon"),
    ("AVD-AZU-0041", "AKS API server allows all networks", "CRITICAL",
     "aks_cluster", "container",
     _fail_if("authorized_ranges", (False,),
              "No authorized IP ranges are configured"),
     "Set api_server_authorized_ip_ranges"),
    # --- databases
    ("AVD-AZU-0018", "PostgreSQL server does not enforce SSL", "HIGH",
     "pg_server", "database",
     _fail_if("ssl", (False,), "SSL enforcement is disabled"),
     "Set ssl_enforcement_enabled = true"),
    ("AVD-AZU-0028", "Database server allows pre-TLS1.2 connections",
     "HIGH", ("pg_server", "mysql_server", "mssql_server"), "database",
     _fail_if("min_tls", ("TLS1_0", "TLS1_1", "1.0", "1.1",
                          "TLSEnforcementDisabled"),
              "Minimum TLS version allows outdated protocols"),
     "Enforce TLS1_2"),
    ("AVD-AZU-0020", "PostgreSQL connection throttling is disabled",
     "MEDIUM", "pg_config", "database",
     lambda a: None if a.get("name") is None else (
         "connection_throttling is off"
         if a["name"] == "connection_throttling" and
         str(a.get("value")).lower() == "off" else False),
     "Set connection_throttling = on"),
    ("AVD-AZU-0021", "PostgreSQL checkpoint logging is disabled",
     "MEDIUM", "pg_config", "database",
     lambda a: None if a.get("name") is None else (
         "log_checkpoints is off"
         if a["name"] == "log_checkpoints" and
         str(a.get("value")).lower() == "off" else False),
     "Set log_checkpoints = on"),
    ("AVD-AZU-0027", "MSSQL auditing retention is under 90 days",
     "MEDIUM", "mssql_auditing", "database",
     _lt("retention", 90, "Audit retention is below 90 days"),
     "Set retention_in_days >= 90"),
    ("AVD-AZU-0026", "MSSQL security alerts do not notify admins",
     "MEDIUM", "mssql_alert", "database",
     _fail_if("email_account_admins", (False,),
              "Account admins are not emailed on alerts"),
     "Set email_account_admins = true"),
    # --- key vault
    ("AVD-AZU-0013", "Key vault network ACLs do not deny by default",
     "CRITICAL", "key_vault", "keyvault",
     _fail_if("network_default_deny", (False,),
              "Default network action is not Deny"),
     "Set network_acls default_action = Deny"),
    ("AVD-AZU-0014", "Key vault secret has no expiration", "LOW",
     "key_vault_secret", "keyvault",
     _fail_if("expiry", (False,), "Secret has no expiration_date"),
     "Set expiration_date"),
    ("AVD-AZU-0017", "Key vault secret has no content type", "LOW",
     "key_vault_secret", "keyvault",
     _fail_if("content_type", (False,),
              "Secret has no content_type"),
     "Set content_type"),
    ("AVD-AZU-0015", "Key vault key has no expiration", "MEDIUM",
     "key_vault_key", "keyvault",
     _fail_if("expiry", (False,), "Key has no expiration_date"),
     "Set expiration_date"),
    # --- monitor
    ("AVD-AZU-0031", "Log profile retention is under a year", "MEDIUM",
     "monitor_log_profile", "monitor",
     lambda a: None if a.get("retention_enabled") is None else (
         "Retention is not enabled for 365 days"
         if a["retention_enabled"] is False or
         (isinstance(a.get("retention_days"), int) and
          0 < a["retention_days"] < 365) else False),
     "Enable retention for >= 365 days"),
    ("AVD-AZU-0033", "Log profile does not capture all activities",
     "MEDIUM", "monitor_log_profile", "monitor",
     lambda a: None if a.get("categories") is None else (
         "Write/Delete/Action categories are not all captured"
         if not {"Write", "Delete", "Action"} <= set(
             a["categories"]) else False),
     "Capture Write, Delete and Action categories"),
    # --- network
    ("AVD-AZU-0048", "NSG rule exposes RDP to the internet",
     "CRITICAL", "nsg_rule", "network",
     _nsg_internet_rule(3389),
     "Restrict RDP (3389) source addresses"),
    ("AVD-AZU-0050", "NSG rule exposes SSH to the internet",
     "CRITICAL", "nsg_rule", "network",
     _nsg_internet_rule(22),
     "Restrict SSH (22) source addresses"),
    # --- security center
    ("AVD-AZU-0044", "Security center contact has no phone", "LOW",
     "security_center_contact", "securitycenter",
     _fail_if("phone", (False,), "No contact phone is set"),
     "Set a contact phone number"),
    ("AVD-AZU-0045", "Security center uses the free tier", "LOW",
     "security_center_pricing", "securitycenter",
     _fail_if("tier", ("Free",), "Defender pricing tier is Free"),
     "Use the Standard tier"),
    # --- synapse / data factory / data lake
    ("AVD-AZU-0034", "Synapse workspace has no managed VNet", "MEDIUM",
     "synapse_workspace", "synapse",
     _fail_if("managed_vnet", (False,),
              "Managed virtual network is not enabled"),
     "Set managed_virtual_network_enabled = true"),
    ("AVD-AZU-0035", "Data factory is publicly accessible", "CRITICAL",
     "data_factory", "datafactory",
     _fail_if("public", (True,),
              "Public network access is enabled"),
     "Set public_network_enabled = false"),
    ("AVD-AZU-0038", "Managed disk encryption is disabled", "HIGH",
     "managed_disk", "compute",
     _fail_if("encryption_disabled", (True,),
              "encryption_settings disables encryption"),
     "Leave managed disk encryption enabled"),
    ("AVD-AZU-0023", "Redis cache enables the non-SSL port", "HIGH",
     "redis_cache", "database",
     _fail_if("non_ssl_port", (True,),
              "enable_non_ssl_port is true"),
     "Disable the non-SSL port"),
    ("AVD-AZU-0036", "Data lake store is unencrypted", "HIGH",
     "data_lake_store", "datalake",
     _fail_if("encrypted", ("Disabled",),
              "Encryption state is Disabled"),
     "Leave encryption_state Enabled"),
]


register_specs(SPECS, provider="azure", file_types=_C)
