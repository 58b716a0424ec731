"""Azure ARM deployment-template checks (reference
pkg/iac/scanners/azure/arm + pkg/iac/adapters/arm: ARM JSON adapted into
typed azure provider structs, evaluated by the azure rule set).

Copy of trivy_tpu/iac/checks/azure.py, whole.
"""

from __future__ import annotations

from trivy_tpu_torch.iac.check import check
from trivy_tpu_torch.iac.checks.cloud import CloudResource

# azurerm terraform blocks adapt into the same resource types
# (azure_ext.adapt_terraform_azure), so these checks cover both inputs
_ARM = ("azure-arm", "terraform", "terraformplan")


def adapt_arm(doc: dict) -> list[CloudResource]:
    out: list[CloudResource] = []
    for res in doc.get("resources") or []:
        if not isinstance(res, dict):
            continue
        rtype = str(res.get("type", ""))
        name = str(res.get("name", ""))
        props = res.get("properties") or {}
        cr = CloudResource(name=f"{rtype}/{name}" if name else rtype)
        if rtype == "Microsoft.Storage/storageAccounts":
            cr.type = "storage_account"
            cr.attrs = {
                "https_only": props.get("supportsHttpsTrafficOnly"),
                "min_tls": props.get("minimumTlsVersion"),
                "public_blob_access": props.get("allowBlobPublicAccess"),
            }
        elif rtype == "Microsoft.Network/networkSecurityGroups":
            cr.type = "nsg"
            rules = []
            for rule in props.get("securityRules") or []:
                rp = (rule or {}).get("properties") or {}
                rules.append({
                    "direction": str(rp.get("direction", "")),
                    "access": str(rp.get("access", "")),
                    "source": str(rp.get("sourceAddressPrefix", "")),
                    "port": str(rp.get("destinationPortRange", "")),
                })
            cr.attrs = {"rules": rules}
        elif rtype == "Microsoft.Sql/servers":
            cr.type = "sql_server"
            cr.attrs = {
                "public_network_access":
                    props.get("publicNetworkAccess"),
                "min_tls": props.get("minimalTlsVersion"),
            }
        elif rtype == "Microsoft.Compute/virtualMachines":
            os_profile = props.get("osProfile") or {}
            linux = os_profile.get("linuxConfiguration") or {}
            cr.type = "virtual_machine"
            cr.attrs = {
                "password_auth":
                    not linux.get("disablePasswordAuthentication", False)
                    if linux else None,
            }
        elif rtype == "Microsoft.KeyVault/vaults":
            cr.type = "key_vault"
            cr.attrs = {
                # absent -> the Azure default (disabled), a definite
                # failing value; ARM expressions resolve to None=unknown
                "purge_protection": props.get("enablePurgeProtection",
                                              False),
                "soft_delete_days":
                    props.get("softDeleteRetentionInDays"),
            }
        else:
            continue
        out.append(cr)
    return out


def _of_type(ctx, t):
    return [r for r in ctx.cloud_resources if r.type == t]


@check("AVD-AZU-0008", "Storage account allows insecure (HTTP) transfer",
       severity="HIGH", file_types=_ARM, provider="azure", service="storage",
       resolution="Set supportsHttpsTrafficOnly to true")
def storage_https_only(ctx):
    out = []
    for r in _of_type(ctx, "storage_account"):
        if r.attrs.get("https_only") is False:
            out.append(r.cause(
                "Storage account allows non-HTTPS traffic"))
    return out


@check("AVD-AZU-0011", "Storage account uses an outdated minimum TLS "
                       "version", severity="MEDIUM", file_types=_ARM,
       provider="azure", service="storage",
       resolution="Set minimumTlsVersion to TLS1_2")
def storage_min_tls(ctx):
    out = []
    for r in _of_type(ctx, "storage_account"):
        tls = r.attrs.get("min_tls")
        if tls is not None and str(tls) in ("TLS1_0", "TLS1_1"):
            out.append(r.cause(
                f"Storage account minimum TLS version is '{tls}'"))
    return out


@check("AVD-AZU-0007", "Storage container allows public blob access",
       severity="HIGH", file_types=_ARM, provider="azure",
       service="storage",
       resolution="Set allowBlobPublicAccess to false")
def storage_public_blob(ctx):
    out = []
    for r in _of_type(ctx, "storage_account"):
        if r.attrs.get("public_blob_access") is True:
            out.append(r.cause(
                "Storage account permits public blob access"))
    return out


@check("AVD-AZU-0047", "Network security group rule allows unrestricted "
                       "ingress", severity="CRITICAL", file_types=_ARM,
       provider="azure", service="network",
       resolution="Restrict sourceAddressPrefix to known networks")
def nsg_open_ingress(ctx):
    out = []
    for r in _of_type(ctx, "nsg"):
        for rule in r.attrs.get("rules") or []:
            if (rule["direction"].lower() == "inbound"
                    and rule["access"].lower() == "allow"
                    and rule["source"] in ("*", "0.0.0.0/0", "Internet",
                                           "any")):
                out.append(r.cause(
                    f"NSG rule allows inbound access from "
                    f"'{rule['source']}' on port '{rule['port']}'"))
    return out


@check("AVD-AZU-0022", "SQL server allows public network access",
       severity="HIGH", file_types=_ARM, provider="azure", service="sql",
       resolution="Set publicNetworkAccess to Disabled")
def sql_public_access(ctx):
    out = []
    for r in _of_type(ctx, "sql_server"):
        if str(r.attrs.get("public_network_access", "")) == "Enabled":
            out.append(r.cause("SQL server public network access enabled"))
    return out


@check("AVD-AZU-0039", "Virtual machine allows password authentication",
       severity="MEDIUM", file_types=_ARM, provider="azure",
       service="compute",
       resolution="Set disablePasswordAuthentication to true and use SSH "
                  "keys")
def vm_password_auth(ctx):
    out = []
    for r in _of_type(ctx, "virtual_machine"):
        if r.attrs.get("password_auth") is True:
            out.append(r.cause(
                "Linux VM allows password authentication"))
    return out


@check("AVD-AZU-0016", "Key vault purge protection is disabled",
       severity="MEDIUM", file_types=_ARM, provider="azure",
       service="keyvault",
       resolution="Enable purge protection on the key vault")
def kv_purge_protection(ctx):
    out = []
    for r in _of_type(ctx, "key_vault"):
        if r.attrs.get("purge_protection") is False:
            out.append(r.cause("Key vault purge protection not enabled"))
    return out
