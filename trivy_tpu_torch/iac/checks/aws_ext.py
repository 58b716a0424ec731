"""AWS check breadth wave: the service families the reference covers
through its typed provider schema + adapters (reference
pkg/iac/providers/aws/{apigateway,athena,cloudfront,cloudwatch,codebuild,
config,documentdb,dynamodb,ec2,ecr,ecs,eks,elasticache,elasticsearch,
elb,emr,iam,kinesis,kms,lambda,mq,msk,neptune,rds,redshift,ssm,
workspaces}/ and pkg/iac/adapters/{terraform,cloudformation}/aws/*).

Declarative layout: per-resource adapters normalize terraform blocks /
CloudFormation properties into CloudResource attrs with the reference's
unresolved-value semantics (None = unknown -> checks stay silent,
_tf_tristate / cfn_scalar), and a SPECS table registers one Check per
AVD rule. IDs/titles/severities follow the public AVD registry
(avd.aquasec.com/misconfig/aws).

Copy of trivy_tpu/iac/checks/aws_ext.py, whole.
"""

from __future__ import annotations

from trivy_tpu_torch.iac.checks.spec import (
    fail_if as _fail_if,
    lt as _lt,
    register_specs,
    tf_value as _v,
    tri as _tri,
)
from trivy_tpu_torch.iac.parsers.hcl import Block, Expr
from trivy_tpu_torch.iac.parsers.yamlconf import (
    cfn_scalar,
    get_end_line,
    get_line,
)

_C = ("terraform", "cloudformation", "terraformplan")


def _cfn_tri(props: dict, key: str, default):
    v = props.get(key)
    if v is None:
        return default
    if isinstance(v, dict):
        v = cfn_scalar(v)
        if v is None:
            return None
    if v in (True, "true", "True"):
        return True
    if v in (False, "false", "False"):
        return False
    return v


# ------------------------------------------------------------- terraform


def adapt_terraform_aws_ext(blocks: list[Block],
                            scan_blocks: list[Block] | None = None) -> list:
    from trivy_tpu_torch.iac.checks.cloud import CloudResource

    import os as _os

    res = [b for b in blocks if b.type == "resource" and
           len(b.labels) >= 2]
    # account-level default EBS encryption overrides every instance /
    # launch-config block device to encrypted (reference adapters/
    # terraform/aws/ec2/{adapt,autoscaling}.go: `enabled` NotEqual(false)
    # — so unset or unresolved counts as enabled). Scoping differs by
    # resource kind, mirroring the reference exactly:
    # - ec2_instance_ext: the lookup spans ALL modules of the scan
    #   (adapt.go modules.GetResourcesByType), so the flag is computed
    #   over scan_blocks when the caller has wider context;
    # - launch_config: autoscaling.go runs module.GetResourcesByType
    #   inside its per-module loop — a default declared in the root
    #   module must NOT suppress launch-config findings in a child
    #   module. A module INSTANCE is identified by its module_id path
    #   (stamped by the terraform evaluator; two instantiations of the
    #   same source dir stay distinct) plus its source directory.
    def _module_key(b):
        return (getattr(b, "module_id", ""),
                _os.path.dirname(b.src_path))

    wide = scan_blocks if scan_blocks is not None else blocks
    ebs_defaults = [b for b in wide if b.type == "resource"
                    and b.labels[:1] == ["aws_ebs_encryption_by_default"]]
    ebs_default_enc = any(
        _tri(b, "enabled", True) is not False for b in ebs_defaults)
    ebs_default_dirs = {
        _module_key(b) for b in ebs_defaults
        if _tri(b, "enabled", True) is not False}
    out = []
    for b in res:
        t, name = b.labels[0], b.labels[1]
        fn = _TF.get(t)
        if fn is None:
            continue
        rtype, attrs = fn(b)
        if rtype == "ec2_instance_ext" and ebs_default_enc:
            attrs["unencrypted_block_device"] = False
        elif rtype == "launch_config" and \
                _module_key(b) in ebs_default_dirs:
            attrs["unencrypted_block_device"] = False
        out.append(CloudResource(
            type=rtype, name=f"{t}.{name}", attrs=attrs,
            start_line=b.start_line, end_line=b.end_line))
    return out


def _tf_apigw_stage(b):
    access_log = b.child("access_log_settings")
    settings = b.child("settings")  # method settings on api_gateway
    return "apigateway_stage", {
        "access_logging": access_log is not None,
        "xray": _tri(b, "xray_tracing_enabled", False),
        "cache_encrypted": _tri(settings, "cache_data_encrypted", False)
        if settings else None,
    }


def _tf_apigw_v2_stage(b):
    access_log = b.child("access_log_settings")
    return "apigateway_stage", {
        "access_logging": access_log is not None,
        "xray": None,       # X-Ray tracing is a REST (v1) stage knob
        "cache_encrypted": None,
    }


def _tf_apigw_method_settings(b):
    s = b.child("settings")
    return "apigateway_method_settings", {
        "cache_encrypted": _tri(s, "cache_data_encrypted", False),
    }


def _tf_apigw_domain(b):
    return "apigateway_domain", {
        "security_policy": _tri(b, "security_policy", None),
    }


def _tf_athena_workgroup(b):
    cfg = b.child("configuration")
    rc = cfg.child("result_configuration") if cfg else None
    enc = rc.child("encryption_configuration") if rc else None
    return "athena_workgroup", {
        "encrypted": enc is not None,
        "enforce": _tri(cfg, "enforce_workgroup_configuration", True)
        if cfg else True,
    }


def _tf_athena_database(b):
    enc = b.child("encryption_configuration")
    return "athena_database", {"encrypted": enc is not None}


def _tf_cloudfront(b):
    logging = b.child("logging_config")
    viewer = b.child("viewer_certificate")
    return "cloudfront_ext", {
        "logging": logging is not None,
        "waf": bool(_v(b.get("web_acl_id"))) or
        isinstance(b.get("web_acl_id"), Expr) or None
        if b.get("web_acl_id") is not None else False,
        "minimum_protocol_version": _tri(
            viewer, "minimum_protocol_version", "TLSv1")
        if viewer else "TLSv1",
    }


def _tf_cw_log_group(b):
    return "cloudwatch_log_group", {
        "kms": bool(_v(b.get("kms_key_id"))) if not isinstance(
            b.get("kms_key_id"), Expr) else None,
    }


def _tf_codebuild(b):
    arts = b.children("artifacts") + b.children("secondary_artifacts")
    disabled = [
        _tri(a, "encryption_disabled", False) for a in arts
    ]
    return "codebuild_project", {
        "encryption_disabled": True if any(d is True for d in disabled)
        else (None if any(d is None for d in disabled) else False),
    }


def _tf_config_aggregator(b):
    src = b.child("account_aggregation_source") or \
        b.child("organization_aggregation_source")
    return "config_aggregator", {
        "all_regions": _tri(src, "all_regions", False)
        if src else False,
    }


def _tf_docdb(b):
    exports = _v(b.get("enabled_cloudwatch_logs_exports"))
    return "docdb_cluster", {
        "log_exports": exports if isinstance(exports, list) else (
            None if isinstance(
                b.get("enabled_cloudwatch_logs_exports"), Expr) else []),
        "encrypted": _tri(b, "storage_encrypted", False),
        "kms": bool(_v(b.get("kms_key_id"))) if not isinstance(
            b.get("kms_key_id"), Expr) else None,
    }


def _tf_dax(b):
    sse = b.child("server_side_encryption")
    return "dax_cluster", {
        "encrypted": _tri(sse, "enabled", False) if sse else False,
    }


def _tf_dynamodb(b):
    sse = b.child("server_side_encryption")
    pitr = b.child("point_in_time_recovery")
    return "dynamodb_table", {
        "pitr": _tri(pitr, "enabled", False) if pitr else False,
        "cmk": bool(_v(sse.get("kms_key_arn"))) if sse is not None
        and not isinstance(sse.get("kms_key_arn"), Expr) else
        (None if sse is not None else False),
    }


def _block_device_attrs(b) -> dict:
    """Shared aws_instance / aws_launch_configuration block-device
    adaptation: the reference materializes a root device with
    encrypted=false even when the block is absent (adapters/terraform/
    aws/ec2/{adapt,autoscaling}.go) — a bare resource counts as
    unencrypted."""
    roots = b.children("root_block_device")
    devs = roots + b.children("ebs_block_device")
    encs = [_tri(d, "encrypted", False) for d in devs]
    if not roots:
        encs.append(False)
    return {
        "unencrypted_block_device": True if any(e is False for e in encs)
        else (None if any(e is None for e in encs) else False),
        "user_data": _v(b.get("user_data")),
    }


def _tf_launch_config(b):
    return "launch_config", _block_device_attrs(b)


def _tf_launch_template(b):
    encs = []
    for bd in b.children("block_device_mappings"):
        ebs = bd.child("ebs")
        if ebs is not None:
            encs.append(_tri(ebs, "encrypted", False))
    return "launch_template", {
        "unencrypted_block_device": True if any(
            e in (False, "false") for e in encs)
        else (None if any(e is None for e in encs) else False),
    }


def _tf_instance_ext(b):
    return "ec2_instance_ext", _block_device_attrs(b)


def _tf_nacl_rule(b):
    action = _v(b.get("rule_action"))
    proto = _v(b.get("protocol"))
    egress = _tri(b, "egress", False)
    return "network_acl_rule", {
        "action": str(action).lower() if action is not None else None,
        "protocol": str(proto) if proto is not None else None,
        "egress": egress,
        "cidr": _v(b.get("cidr_block")) or _v(
            b.get("ipv6_cidr_block")),
    }


def _tf_ecr(b):
    scan = b.child("image_scanning_configuration")
    enc = b.child("encryption_configuration")
    return "ecr_repository", {
        "scan_on_push": _tri(scan, "scan_on_push", False)
        if scan else False,
        "immutable": _v(b.get("image_tag_mutability")) == "IMMUTABLE"
        if not isinstance(b.get("image_tag_mutability"), Expr)
        else None,
        "cmk": (_tri(enc, "encryption_type", "AES256") == "KMS")
        if enc else False,
    }


def _tf_ecr_policy(b):
    from trivy_tpu_torch.iac.checks.cloud import _policy_doc

    return "ecr_policy", {
        "document": _policy_doc(_v(b.get("policy"))),
    }


def _tf_ecs_cluster(b):
    insights = None
    for s in b.children("setting"):
        if _v(s.get("name")) == "containerInsights":
            insights = _v(s.get("value"))
    return "ecs_cluster", {
        "container_insights": str(insights).lower() == "enabled"
        if insights is not None else False,
    }


def _tf_ecs_task(b):
    import json as _json

    raw = _v(b.get("container_definitions"))
    defs = None
    if isinstance(raw, str):
        try:
            defs = _json.loads(raw)
        except ValueError:
            defs = None
    elif isinstance(raw, list):
        defs = raw
    plaintext = False
    if isinstance(defs, list):
        for d in defs:
            for env in (d.get("environment") or []) \
                    if isinstance(d, dict) else []:
                nm = str(env.get("name", "")).upper()
                if any(k in nm for k in ("SECRET", "PASSWORD", "TOKEN",
                                         "API_KEY", "ACCESS_KEY")):
                    plaintext = True
    transit = []
    for vol in b.children("volume"):
        e = vol.child("efs_volume_configuration")
        if e is not None:
            transit.append(_tri(e, "transit_encryption", "DISABLED"))
    return "ecs_task", {
        "plaintext_secret": plaintext if defs is not None else None,
        "efs_unencrypted_transit": True if any(
            str(t).upper() == "DISABLED" for t in transit)
        else (None if any(t is None for t in transit) else False),
    }


def _tf_eks_ext(b):
    enabled = _v(b.get("enabled_cluster_log_types"))
    enc = b.child("encryption_config")
    return "eks_cluster_ext", {
        "logging": bool(enabled) if not isinstance(
            b.get("enabled_cluster_log_types"), Expr) else None,
        "secrets_encrypted": enc is not None,
    }


def _tf_elasticache_redis(b):
    # encryption flags only: the reference adapts snapshot retention
    # for clusters, not replication groups (adapters/terraform/aws/
    # elasticache/adapt.go adaptReplicationGroup)
    return "elasticache_group", {
        "at_rest": _tri(b, "at_rest_encryption_enabled", False),
        "in_transit": _tri(b, "transit_encryption_enabled", False),
    }


def _tf_elasticache_cluster(b):
    engine = _v(b.get("engine"))
    return "elasticache_cluster", {
        "engine": engine,
        "backup_retention": _tri(b, "snapshot_retention_limit", 0),
    }


def _tf_es_domain(b):
    enc = b.child("encrypt_at_rest")
    n2n = b.child("node_to_node_encryption")
    ep = b.child("domain_endpoint_options")
    logs = b.children("log_publishing_options")
    audit = any(_v(l.get("log_type")) == "AUDIT_LOGS" for l in logs)
    return "elasticsearch_domain", {
        "at_rest": _tri(enc, "enabled", False) if enc else False,
        "in_transit": _tri(n2n, "enabled", False) if n2n else False,
        "enforce_https": _tri(ep, "enforce_https", False)
        if ep else False,
        "tls_policy": _tri(ep, "tls_security_policy",
                           "Policy-Min-TLS-1-0-2019-07")
        if ep else "Policy-Min-TLS-1-0-2019-07",
        "audit_logging": audit,
    }


def _tf_lb(b):
    internal = _tri(b, "internal", False)
    # absent -> provider default "application"; unresolved -> None
    lb_type = _tri(b, "load_balancer_type", "application")
    return "lb", {
        "internal": internal,
        # drop_invalid_header_fields only exists on ALBs; other (or
        # unknown) LB kinds must stay silent on AVD-AWS-0052
        "drop_invalid_headers": _tri(
            b, "drop_invalid_header_fields", False)
        if lb_type == "application" else None,
        "lb_type": lb_type,
    }


def _tf_classic_elb(b):
    return "lb", {
        "internal": _tri(b, "internal", False),
        "drop_invalid_headers": None,   # not a classic-ELB setting
        "lb_type": "classic",
    }


def _tf_lb_listener_ext(b):
    return "lb_listener_ext", {
        "protocol": _v(b.get("protocol")),
        "ssl_policy": _v(b.get("ssl_policy")),
    }


def _tf_emr_security_config(b):
    import json as _json

    raw = _v(b.get("configuration"))
    doc = None
    if isinstance(raw, str):
        try:
            doc = _json.loads(raw)
        except ValueError:
            doc = None
    at_rest = in_transit = local_disk = None
    if isinstance(doc, dict):
        enc = doc.get("EncryptionConfiguration") or {}
        at_rest = bool(enc.get("EnableAtRestEncryption"))
        in_transit = bool(enc.get("EnableInTransitEncryption"))
        local_disk = bool(
            (enc.get("AtRestEncryptionConfiguration") or {})
            .get("LocalDiskEncryptionConfiguration"))
    return "emr_security_config", {
        "at_rest": at_rest, "in_transit": in_transit,
        "local_disk": local_disk,
    }


def _tf_iam_password_policy(b):
    return "iam_password_policy", {
        "reuse_prevention": _tri(b, "password_reuse_prevention", 0),
        "require_lowercase": _tri(b, "require_lowercase_characters",
                                  False),
        "require_numbers": _tri(b, "require_numbers", False),
        "require_symbols": _tri(b, "require_symbols", False),
        "require_uppercase": _tri(b, "require_uppercase_characters",
                                  False),
        "max_age": _tri(b, "max_password_age", 0),
        "min_length": _tri(b, "minimum_password_length", 6),
    }


def _tf_kinesis(b):
    return "kinesis_stream", {
        "encrypted": _v(b.get("encryption_type")) == "KMS"
        if not isinstance(b.get("encryption_type"), Expr) else None,
    }


def _tf_kms(b):
    return "kms_key", {
        "rotation": _tri(b, "enable_key_rotation", False),
        "usage": _v(b.get("key_usage")) or "ENCRYPT_DECRYPT",
    }


def _tf_lambda(b):
    tracing = b.child("tracing_config")
    return "lambda_function", {
        "tracing": _tri(tracing, "mode", "PassThrough")
        if tracing else "PassThrough",
    }


def _tf_lambda_permission(b):
    return "lambda_permission", {
        "has_source_arn": b.get("source_arn") is not None,
        "principal": _v(b.get("principal")),
    }


def _tf_mq(b):
    logs = b.child("logs")
    return "mq_broker", {
        "general_logging": _tri(logs, "general", False)
        if logs else False,
        "audit_logging": _tri(logs, "audit", False) if logs else False,
        "public": _tri(b, "publicly_accessible", False),
    }


def _tf_msk(b):
    info = b.child("broker_node_group_info")  # noqa: F841
    enc = b.child("encryption_info")
    tls = None
    at_rest_kms = None
    if enc is not None:
        eit = enc.child("encryption_in_transit")
        tls = _tri(eit, "client_broker", "TLS") if eit else "TLS"
        at_rest_kms = bool(_v(enc.get(
            "encryption_at_rest_kms_key_arn"))) if not isinstance(
            enc.get("encryption_at_rest_kms_key_arn"), Expr) else None
    logging = False
    li = b.child("logging_info")
    if li is not None:
        bl = li.child("broker_logs")
        if bl is not None:
            for kind in ("cloudwatch_logs", "firehose", "s3"):
                c = bl.child(kind)
                if c is not None and _tri(c, "enabled", False) is True:
                    logging = True
    return "msk_cluster", {
        "client_broker": tls if enc is not None else "TLS_PLAINTEXT",
        "at_rest_cmk": at_rest_kms if enc is not None else False,
        "logging": logging,
    }


def _tf_neptune(b):
    exports = _v(b.get("enable_cloudwatch_logs_exports"))
    return "neptune_cluster", {
        "audit_logging": ("audit" in exports) if isinstance(
            exports, list) else (None if isinstance(
                b.get("enable_cloudwatch_logs_exports"), Expr)
                else False),
        "encrypted": _tri(b, "storage_encrypted", False),
    }


def _tf_rds_cluster(b):
    return "rds_cluster", {
        "encrypted": _tri(b, "storage_encrypted", False),
        "backup_retention": _tri(b, "backup_retention_period", 1),
    }


def _tf_rds_instance_ext(b):
    return "rds_instance_ext", {
        "backup_retention": _tri(b, "backup_retention_period", 0),
        "perf_insights": _tri(b, "performance_insights_enabled", False),
        "perf_insights_kms": bool(_v(b.get(
            "performance_insights_kms_key_id"))) if not isinstance(
            b.get("performance_insights_kms_key_id"), Expr) else None,
        "iam_auth": _tri(
            b, "iam_database_authentication_enabled", False),
        "deletion_protection": _tri(b, "deletion_protection", False),
    }


def _tf_redshift(b):
    return "redshift_cluster", {
        "encrypted": _tri(b, "encrypted", False),
        "cmk": bool(_v(b.get("kms_key_id"))) if not isinstance(
            b.get("kms_key_id"), Expr) else None,
        "public": _tri(b, "publicly_accessible", True),
        "in_vpc": b.get("cluster_subnet_group_name") is not None,
        "logging": _tri(b.child("logging"), "enable", False)
        if b.child("logging") else False,
    }


def _tf_ssm_secret(b):
    return "ssm_secret", {
        "cmk": bool(_v(b.get("kms_key_id"))) if not isinstance(
            b.get("kms_key_id"), Expr) else None,
    }


def _tf_workspaces(b):
    root = b.child("workspace_properties")  # noqa: F841
    return "workspaces_workspace", {
        "root_encrypted": _tri(b, "root_volume_encryption_enabled",
                               False),
        "user_encrypted": _tri(b, "user_volume_encryption_enabled",
                               False),
    }


_TF = {
    "aws_api_gateway_stage": _tf_apigw_stage,
    "aws_apigatewayv2_stage": _tf_apigw_v2_stage,
    "aws_api_gateway_method_settings": _tf_apigw_method_settings,
    "aws_api_gateway_domain_name": _tf_apigw_domain,
    "aws_athena_workgroup": _tf_athena_workgroup,
    "aws_athena_database": _tf_athena_database,
    "aws_cloudfront_distribution": _tf_cloudfront,
    "aws_cloudwatch_log_group": _tf_cw_log_group,
    "aws_codebuild_project": _tf_codebuild,
    "aws_config_configuration_aggregator": _tf_config_aggregator,
    "aws_docdb_cluster": _tf_docdb,
    "aws_dax_cluster": _tf_dax,
    "aws_dynamodb_table": _tf_dynamodb,
    "aws_launch_configuration": _tf_launch_config,
    "aws_launch_template": _tf_launch_template,
    "aws_instance": _tf_instance_ext,
    "aws_network_acl_rule": _tf_nacl_rule,
    "aws_ecr_repository": _tf_ecr,
    "aws_ecr_repository_policy": _tf_ecr_policy,
    "aws_ecs_cluster": _tf_ecs_cluster,
    "aws_ecs_task_definition": _tf_ecs_task,
    "aws_eks_cluster": _tf_eks_ext,
    "aws_elasticache_replication_group": _tf_elasticache_redis,
    "aws_elasticache_cluster": _tf_elasticache_cluster,
    "aws_elasticsearch_domain": _tf_es_domain,
    "aws_opensearch_domain": _tf_es_domain,
    "aws_lb": _tf_lb,
    "aws_alb": _tf_lb,
    "aws_elb": _tf_classic_elb,
    "aws_lb_listener": _tf_lb_listener_ext,
    "aws_alb_listener": _tf_lb_listener_ext,
    "aws_emr_security_configuration": _tf_emr_security_config,
    "aws_iam_account_password_policy": _tf_iam_password_policy,
    "aws_kinesis_stream": _tf_kinesis,
    "aws_kms_key": _tf_kms,
    "aws_lambda_function": _tf_lambda,
    "aws_lambda_permission": _tf_lambda_permission,
    "aws_mq_broker": _tf_mq,
    "aws_msk_cluster": _tf_msk,
    "aws_neptune_cluster": _tf_neptune,
    "aws_rds_cluster": _tf_rds_cluster,
    "aws_db_instance": _tf_rds_instance_ext,
    "aws_redshift_cluster": _tf_redshift,
    "aws_secretsmanager_secret": _tf_ssm_secret,
    "aws_workspaces_workspace": _tf_workspaces,
}


# -------------------------------------------------------- cloudformation


def adapt_cloudformation_aws_ext(resources: dict[str, dict]) -> list:
    from trivy_tpu_torch.iac.checks.cloud import CloudResource

    out = []
    for name, res in resources.items():
        rtype = str(res.get("Type", ""))
        fn = _CFN.get(rtype)
        ctx_fn = _CFN_CTX.get(rtype)
        if fn is None and ctx_fn is None:
            continue
        props = res.get("Properties") or {}
        if ctx_fn is not None:
            # context adapters also see the full resource map (e.g. to
            # resolve launch-template references)
            adapted = ctx_fn(props, resources)
        else:
            adapted = fn(props)
        # an adapter may emit one (rtype, attrs) pair or several
        if isinstance(adapted, tuple):
            adapted = [adapted]
        for ct, attrs in adapted:
            out.append(CloudResource(
                type=ct, name=name, attrs=attrs,
                start_line=get_line(res), end_line=get_end_line(res)))
    return out


def _cfn_apigw_stage(p):
    return "apigateway_stage", {
        "access_logging": bool(p.get("AccessLogSetting")
                               or p.get("AccessLogSettings")),
        "xray": _cfn_tri(p, "TracingEnabled", False),
        "cache_encrypted": None,
    }


def _cfn_apigw_v2_stage(p):
    return "apigateway_stage", {
        "access_logging": bool(p.get("AccessLogSettings")),
        "xray": None,       # not a v2 property
        "cache_encrypted": None,
    }


def _cfn_cloudfront(p):
    cfg = p.get("DistributionConfig") or {}
    viewer = cfg.get("ViewerCertificate") or {}
    return "cloudfront_ext", {
        "logging": bool(cfg.get("Logging")),
        "waf": bool(cfg.get("WebACLId")),
        "minimum_protocol_version": cfn_scalar(
            viewer.get("MinimumProtocolVersion")) or "TLSv1",
    }


def _cfn_cw_log_group(p):
    return "cloudwatch_log_group", {
        "kms": bool(p.get("KmsKeyId")),
    }


def _cfn_codebuild(p):
    arts = [p.get("Artifacts") or {}] + list(
        p.get("SecondaryArtifacts") or [])
    disabled = [_cfn_tri(a, "EncryptionDisabled", False)
                for a in arts if isinstance(a, dict)]
    return "codebuild_project", {
        "encryption_disabled": True if any(d is True for d in disabled)
        else (None if any(d is None for d in disabled) else False),
    }


def _cfn_config_aggregator(p):
    srcs = list(p.get("AccountAggregationSources") or [])
    org = p.get("OrganizationAggregationSource")
    if isinstance(org, dict):
        srcs.append(org)
    all_regions = any(_cfn_tri(s, "AllAwsRegions", False) is True
                     for s in srcs if isinstance(s, dict))
    return "config_aggregator", {"all_regions": all_regions}


def _cfn_docdb(p):
    exports = p.get("EnableCloudwatchLogsExports")
    return "docdb_cluster", {
        "log_exports": exports if isinstance(exports, list) else [],
        "encrypted": _cfn_tri(p, "StorageEncrypted", False),
        "kms": bool(p.get("KmsKeyId")),
    }


def _cfn_dynamodb(p):
    sse = p.get("SSESpecification") or {}
    pitr = p.get("PointInTimeRecoverySpecification") or {}
    return "dynamodb_table", {
        "pitr": _cfn_tri(pitr, "PointInTimeRecoveryEnabled", False),
        "cmk": bool(sse.get("KMSMasterKeyId")),
    }


def _cfn_ecr(p):
    scan = p.get("ImageScanningConfiguration") or {}
    enc = p.get("EncryptionConfiguration") or {}
    return "ecr_repository", {
        "scan_on_push": _cfn_tri(scan, "ScanOnPush", False),
        "immutable": cfn_scalar(p.get("ImageTagMutability"))
        == "IMMUTABLE",
        "cmk": cfn_scalar(enc.get("EncryptionType")) == "KMS",
    }


def _cfn_ecs_cluster(p):
    insights = False
    for s in p.get("ClusterSettings") or []:
        if isinstance(s, dict) and \
                cfn_scalar(s.get("Name")) == "containerInsights":
            insights = cfn_scalar(s.get("Value")) == "enabled"
    return "ecs_cluster", {"container_insights": insights}


def _cfn_eks(p):
    enc = p.get("EncryptionConfig")
    logging = p.get("Logging") or {}
    enabled = []
    for t in ((logging.get("ClusterLogging") or {})
              .get("EnabledTypes") or []):
        if isinstance(t, dict):
            enabled.append(t.get("Type"))
    return "eks_cluster_ext", {
        "logging": bool(enabled),
        "secrets_encrypted": bool(enc),
    }


def _cfn_es(p):
    enc = p.get("EncryptionAtRestOptions") or {}
    n2n = p.get("NodeToNodeEncryptionOptions") or {}
    ep = p.get("DomainEndpointOptions") or {}
    return "elasticsearch_domain", {
        "at_rest": _cfn_tri(enc, "Enabled", False),
        "in_transit": _cfn_tri(n2n, "Enabled", False),
        "enforce_https": _cfn_tri(ep, "EnforceHTTPS", False),
        "tls_policy": cfn_scalar(ep.get("TLSSecurityPolicy"))
        or "Policy-Min-TLS-1-0-2019-07",
        "audit_logging": "AUDIT_LOGS" in (
            p.get("LogPublishingOptions") or {}),
    }


def _cfn_lb(p):
    # CFN default Scheme for ELBv2 is internet-facing
    scheme = cfn_scalar(p.get("Scheme")) or "internet-facing"
    attrs = {cfn_scalar(a.get("Key")): cfn_scalar(a.get("Value"))
             for a in p.get("LoadBalancerAttributes") or []
             if isinstance(a, dict)}
    return "lb", {
        "internal": scheme != "internet-facing",
        "drop_invalid_headers": attrs.get(
            "routing.http.drop_invalid_header_fields.enabled")
        in ("true", True),
        "lb_type": cfn_scalar(p.get("Type")) or "application",
    }


def _cfn_kinesis(p):
    enc = p.get("StreamEncryption") or {}
    return "kinesis_stream", {
        "encrypted": cfn_scalar(enc.get("EncryptionType")) == "KMS",
    }


def _cfn_kms(p):
    return "kms_key", {
        "rotation": _cfn_tri(p, "EnableKeyRotation", False),
        "usage": cfn_scalar(p.get("KeyUsage")) or "ENCRYPT_DECRYPT",
    }


def _cfn_lambda(p):
    tracing = p.get("TracingConfig") or {}
    return "lambda_function", {
        "tracing": cfn_scalar(tracing.get("Mode")) or "PassThrough",
    }


def _cfn_lambda_permission(p):
    return "lambda_permission", {
        "has_source_arn": p.get("SourceArn") is not None,
        "principal": cfn_scalar(p.get("Principal")),
    }


def _cfn_mq(p):
    logs = p.get("Logs") or {}
    return "mq_broker", {
        "general_logging": _cfn_tri(logs, "General", False),
        "audit_logging": _cfn_tri(logs, "Audit", False),
        "public": _cfn_tri(p, "PubliclyAccessible", False),
    }


def _cfn_msk(p):
    enc = p.get("EncryptionInfo") or {}
    transit = enc.get("EncryptionInTransit") or {}
    at_rest = enc.get("EncryptionAtRest") or {}
    logging = False
    li = ((p.get("LoggingInfo") or {}).get("BrokerLogs") or {})
    for kind in ("CloudWatchLogs", "Firehose", "S3"):
        if _cfn_tri(li.get(kind) or {}, "Enabled", False) is True:
            logging = True
    return "msk_cluster", {
        "client_broker": cfn_scalar(transit.get("ClientBroker"))
        or "TLS",
        "at_rest_cmk": bool(at_rest.get("DataVolumeKMSKeyId")),
        "logging": logging,
    }


def _cfn_neptune(p):
    return "neptune_cluster", {
        "audit_logging": "audit" in (
            p.get("EnableCloudwatchLogsExports") or []),
        "encrypted": _cfn_tri(p, "StorageEncrypted", False),
    }


def _cfn_rds_cluster(p):
    return "rds_cluster", {
        "encrypted": _cfn_tri(p, "StorageEncrypted", False),
        "backup_retention": _cfn_tri(p, "BackupRetentionPeriod", 1),
    }


def _cfn_rds_instance_ext(p):
    return "rds_instance_ext", {
        "backup_retention": _cfn_tri(p, "BackupRetentionPeriod", 0),
        "perf_insights": _cfn_tri(p, "EnablePerformanceInsights",
                                  False),
        "perf_insights_kms": bool(p.get("PerformanceInsightsKMSKeyId")),
        "iam_auth": _cfn_tri(
            p, "EnableIAMDatabaseAuthentication", False),
        "deletion_protection": _cfn_tri(p, "DeletionProtection", False),
    }


def _cfn_redshift(p):
    return "redshift_cluster", {
        "encrypted": _cfn_tri(p, "Encrypted", False),
        "cmk": bool(p.get("KmsKeyId")),
        "public": _cfn_tri(p, "PubliclyAccessible", True),
        "in_vpc": p.get("ClusterSubnetGroupName") is not None,
        "logging": bool(p.get("LoggingProperties")),
    }


def _cfn_ssm_secret(p):
    return "ssm_secret", {"cmk": bool(p.get("KmsKeyId"))}


def _cfn_workspaces(p):
    return "workspaces_workspace", {
        "root_encrypted": _cfn_tri(p, "RootVolumeEncryptionEnabled",
                                   False),
        "user_encrypted": _cfn_tri(p, "UserVolumeEncryptionEnabled",
                                   False),
    }


def _cfn_device_encs(devs) -> list:
    encs = []
    if isinstance(devs, list):
        for d in devs:
            if isinstance(d, dict):
                ebs = d.get("Ebs") or {}
                encs.append(_cfn_tri(ebs if isinstance(ebs, dict) else {},
                                     "Encrypted", False))
    return encs


def _cfn_find_launch_template(lt: dict, resources: dict) -> dict | None:
    """Resolve Properties.LaunchTemplate -> the referenced
    AWS::EC2::LaunchTemplate's LaunchTemplateData (reference
    findRelatedLaunchTemplate: by LaunchTemplateName string match, else
    by LaunchTemplateId as a logical id; unresolvable refs fall
    through)."""
    name = lt.get("LaunchTemplateName")
    if isinstance(name, str):
        for res in resources.values():
            if str(res.get("Type", "")) != "AWS::EC2::LaunchTemplate":
                continue
            props = res.get("Properties") or {}
            if props.get("LaunchTemplateName") == name:
                data = props.get("LaunchTemplateData")
                return data if isinstance(data, dict) else {}
    ltid = lt.get("LaunchTemplateId")
    if isinstance(ltid, dict):
        # canonical same-template reference: {"Ref": "LogicalId"}
        ref = ltid.get("Ref")
        ltid = ref if isinstance(ref, str) else None
    if isinstance(ltid, str) and ltid in resources:
        res = resources[ltid]
        if str(res.get("Type", "")) == "AWS::EC2::LaunchTemplate":
            props = res.get("Properties") or {}
            data = props.get("LaunchTemplateData")
            return data if isinstance(data, dict) else {}
    return None


def _cfn_ec2_instance(p, resources=None):
    """AWS::EC2::Instance (reference adapters/cloudformation/aws/ec2/
    instance.go): an instance config comes from its launch template
    when one resolves; otherwise CloudFormation cannot express metadata
    options, so IMDS stays at the provider default (optional tokens —
    the check fires), and the first BlockDeviceMappings entry is the
    root device with a missing list materializing an unencrypted
    root.

    After a template resolve the reference OVERLAYS the instance's own
    BlockDeviceMappings on top of the replacement (the first entry
    overrides the root device) — and its adaptLaunchTemplate reads
    BlockDeviceMappings from top-level Properties, not
    LaunchTemplateData, so a template effectively contributes only
    MetadataOptions: an instance with no mappings of its own still
    materializes an unencrypted root."""
    tokens = None  # None = not configured -> IMDS check fires
    lt = p.get("LaunchTemplate")
    data = None
    if isinstance(lt, dict) and resources:
        data = _cfn_find_launch_template(lt, resources)
    if data is not None:
        # the reference replaces the instance wholesale with the
        # template's adaptation (instance = launchTemplate.Instance)...
        opts = data.get("MetadataOptions")
        if isinstance(opts, dict):
            tokens = _cfn_tri(opts, "HttpTokens", "optional")
        else:
            tokens = "optional"
    # ...then always applies the instance's own BlockDeviceMappings
    # (instance.go overlay loop) — the template side carries none (see
    # docstring), so the instance's list is the only block-device source
    encs = _cfn_device_encs(p.get("BlockDeviceMappings"))
    if not encs:
        encs.append(False)  # materialized unencrypted root
    unenc = (True if any(e is False for e in encs)
             else (None if any(e is None for e in encs) else False))
    return [
        ("ec2_instance_ext", {"unencrypted_block_device": unenc}),
        ("ec2_instance", {"http_tokens": tokens}),
    ]


def _cfn_num(p: dict, key: str, default):
    """Numeric CFN property: absent -> default, unresolved -> None —
    without _cfn_tri's bool coercion (0 must stay 0, not become False
    and slip past numeric checks' bool guards)."""
    v = p.get(key)
    if v is None:
        return default
    if isinstance(v, dict):
        v = cfn_scalar(v)
        if v is None:
            return None
    if isinstance(v, bool):
        return None
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return None
    return v if isinstance(v, (int, float)) else None


def _cfn_elasticache_group(p):
    # the reference adapts only the two encryption flags for
    # replication groups (adapters/cloudformation/aws/elasticache/
    # replication_group.go); snapshot retention is a CLUSTER concern
    return "elasticache_group", {
        "at_rest": _cfn_tri(p, "AtRestEncryptionEnabled", False),
        "in_transit": _cfn_tri(p, "TransitEncryptionEnabled", False),
    }


def _cfn_elasticache_cluster(p):
    """AWS::ElastiCache::CacheCluster (reference adapters/
    cloudformation/aws/elasticache/cluster.go)."""
    return "elasticache_cluster", {
        "engine": cfn_scalar(p.get("Engine")),
        "backup_retention": _cfn_num(p, "SnapshotRetentionLimit", 0),
    }


# adapters that need the whole resource map (cross-resource resolution)
_CFN_CTX = {
    "AWS::EC2::Instance": _cfn_ec2_instance,
}

_CFN = {
    "AWS::ElastiCache::ReplicationGroup": _cfn_elasticache_group,
    "AWS::ElastiCache::CacheCluster": _cfn_elasticache_cluster,
    "AWS::ApiGateway::Stage": _cfn_apigw_stage,
    "AWS::ApiGatewayV2::Stage": _cfn_apigw_v2_stage,
    "AWS::CloudFront::Distribution": _cfn_cloudfront,
    "AWS::Logs::LogGroup": _cfn_cw_log_group,
    "AWS::CodeBuild::Project": _cfn_codebuild,
    "AWS::Config::ConfigurationAggregator": _cfn_config_aggregator,
    "AWS::DocDB::DBCluster": _cfn_docdb,
    "AWS::DynamoDB::Table": _cfn_dynamodb,
    "AWS::ECR::Repository": _cfn_ecr,
    "AWS::ECS::Cluster": _cfn_ecs_cluster,
    "AWS::EKS::Cluster": _cfn_eks,
    "AWS::Elasticsearch::Domain": _cfn_es,
    "AWS::OpenSearchService::Domain": _cfn_es,
    "AWS::ElasticLoadBalancingV2::LoadBalancer": _cfn_lb,
    "AWS::Kinesis::Stream": _cfn_kinesis,
    "AWS::KMS::Key": _cfn_kms,
    "AWS::Lambda::Function": _cfn_lambda,
    "AWS::Lambda::Permission": _cfn_lambda_permission,
    "AWS::AmazonMQ::Broker": _cfn_mq,
    "AWS::MSK::Cluster": _cfn_msk,
    "AWS::Neptune::DBCluster": _cfn_neptune,
    "AWS::RDS::DBCluster": _cfn_rds_cluster,
    "AWS::RDS::DBInstance": _cfn_rds_instance_ext,
    "AWS::Redshift::Cluster": _cfn_redshift,
    "AWS::SecretsManager::Secret": _cfn_ssm_secret,
    "AWS::WorkSpaces::Workspace": _cfn_workspaces,
}


# ----------------------------------------------------------------- checks


# (id, title, severity, rtype, service, test, resolution)
SPECS = [
    # --- API Gateway (providers/aws/apigateway)
    ("AVD-AWS-0001", "API Gateway stage has no access logging", "MEDIUM",
     "apigateway_stage", "api-gateway",
     _fail_if("access_logging", (False,),
              "Access logging is not configured"),
     "Enable access logging on the stage"),
    ("AVD-AWS-0002", "API Gateway stage cache is unencrypted", "MEDIUM",
     "apigateway_method_settings", "api-gateway",
     _fail_if("cache_encrypted", (False,),
              "Cache data is not encrypted"),
     "Enable cache encryption"),
    ("AVD-AWS-0003", "API Gateway stage X-Ray tracing is disabled",
     "LOW", "apigateway_stage", "api-gateway",
     _fail_if("xray", (False,), "X-Ray tracing is not enabled"),
     "Enable X-Ray tracing"),
    ("AVD-AWS-0004", "API Gateway domain uses an outdated TLS policy",
     "HIGH", "apigateway_domain", "api-gateway",
     _fail_if("security_policy", ("TLS_1_0",),
              "Domain name uses TLS 1.0"),
     "Use TLS_1_2 as the security policy"),
    # --- Athena
    ("AVD-AWS-0006", "Athena database/workgroup is unencrypted", "HIGH",
     ("athena_workgroup", "athena_database"), "athena",
     _fail_if("encrypted", (False,),
              "Results/database encryption is not configured"),
     "Configure encryption for the workgroup and database"),
    ("AVD-AWS-0007", "Athena workgroup does not enforce its "
     "configuration", "HIGH", "athena_workgroup", "athena",
     _fail_if("enforce", (False,),
              "Workgroup configuration can be overridden by clients"),
     "Set enforce_workgroup_configuration = true"),
    # --- CloudFront
    ("AVD-AWS-0010", "CloudFront distribution has no access logging",
     "MEDIUM", "cloudfront_ext", "cloudfront",
     _fail_if("logging", (False,), "Access logging is not configured"),
     "Add a logging_config block"),
    ("AVD-AWS-0011", "CloudFront distribution has no WAF", "HIGH",
     "cloudfront_ext", "cloudfront",
     _fail_if("waf", (False,), "No Web ACL is associated"),
     "Associate a WAF web ACL"),
    ("AVD-AWS-0013", "CloudFront uses an outdated SSL/TLS protocol",
     "HIGH", "cloudfront_ext", "cloudfront",
     _fail_if("minimum_protocol_version",
              ("TLSv1", "TLSv1_2016", "TLSv1.1_2016", "SSLv3"),
              "Viewer certificate allows pre-TLS1.2 protocols"),
     "Set minimum_protocol_version to TLSv1.2_2021"),
    # --- CloudWatch
    ("AVD-AWS-0017", "CloudWatch log group is not CMK-encrypted", "LOW",
     "cloudwatch_log_group", "cloudwatch",
     _fail_if("kms", (False,),
              "Log group is not encrypted with a customer key"),
     "Set kms_key_id on the log group"),
    # --- CodeBuild
    ("AVD-AWS-0018", "CodeBuild project artifacts are unencrypted",
     "HIGH", "codebuild_project", "codebuild",
     _fail_if("encryption_disabled", (True,),
              "Artifact encryption is disabled"),
     "Do not set encryption_disabled"),
    # --- Config
    ("AVD-AWS-0019", "Config aggregator does not cover all regions",
     "HIGH", "config_aggregator", "config",
     _fail_if("all_regions", (False,),
              "Aggregator does not aggregate all regions"),
     "Set all_regions = true on the aggregation source"),
    # --- DocumentDB
    ("AVD-AWS-0020", "DocumentDB cluster does not export logs",
     "MEDIUM", "docdb_cluster", "documentdb",
     lambda a: None if a.get("log_exports") is None else (
         "Neither audit nor profiler log export is enabled"
         if not any(x in ("audit", "profiler")
                    for x in a["log_exports"]) else False),
     "Enable audit/profiler CloudWatch log exports"),
    ("AVD-AWS-0021", "DocumentDB cluster storage is unencrypted",
     "HIGH", "docdb_cluster", "documentdb",
     _fail_if("encrypted", (False,), "Storage is not encrypted"),
     "Set storage_encrypted = true"),
    ("AVD-AWS-0022", "DocumentDB cluster is not CMK-encrypted", "LOW",
     "docdb_cluster", "documentdb",
     _fail_if("kms", (False,),
              "Cluster is not encrypted with a customer key"),
     "Set kms_key_id"),
    # --- DynamoDB
    ("AVD-AWS-0023", "DAX cluster is unencrypted", "HIGH",
     "dax_cluster", "dynamodb",
     _fail_if("encrypted", (False,),
              "Server-side encryption is not enabled"),
     "Enable server_side_encryption"),
    ("AVD-AWS-0024", "DynamoDB table has no point-in-time recovery",
     "MEDIUM", "dynamodb_table", "dynamodb",
     _fail_if("pitr", (False,),
              "Point-in-time recovery is not enabled"),
     "Enable point_in_time_recovery"),
    ("AVD-AWS-0025", "DynamoDB table is not CMK-encrypted", "LOW",
     "dynamodb_table", "dynamodb",
     _fail_if("cmk", (False,),
              "Server-side encryption does not use a customer key"),
     "Set server_side_encryption.kms_key_arn"),
    # --- EC2
    ("AVD-AWS-0008", "Launch configuration has an unencrypted block "
     "device", "HIGH", "launch_config", "ec2",
     _fail_if("unencrypted_block_device", (True,),
              "Block device is not encrypted"),
     "Encrypt every block device"),
    ("AVD-AWS-0009", "Launch template has an unencrypted block device",
     "HIGH", "launch_template", "ec2",
     _fail_if("unencrypted_block_device", (True,),
              "Block device is not encrypted"),
     "Encrypt every block device mapping"),
    ("AVD-AWS-0131", "EC2 instance has an unencrypted block device",
     "HIGH", "ec2_instance_ext", "ec2",
     _fail_if("unencrypted_block_device", (True,),
              "Root or EBS block device is not encrypted"),
     "Set encrypted = true on block devices"),
    ("AVD-AWS-0102", "Network ACL rule allows all protocols",
     "CRITICAL", "network_acl_rule", "ec2",
     lambda a: None if a.get("protocol") is None or
     a.get("action") is None else (
         "Rule allows every protocol"
         if a["action"] == "allow" and a["protocol"] in ("-1", "all")
         else False),
     "Restrict the rule to required protocols"),
    ("AVD-AWS-0105", "Network ACL rule allows ingress from the public "
     "internet", "CRITICAL", "network_acl_rule", "ec2",
     lambda a: None if a.get("cidr") is None or a.get("action") is None
     else ("Rule allows public ingress"
           if a["action"] == "allow" and not a.get("egress")
           and a["cidr"] in ("0.0.0.0/0", "::/0") else False),
     "Restrict ingress CIDR ranges"),
    # --- ECR
    ("AVD-AWS-0030", "ECR repository does not scan images on push",
     "HIGH", "ecr_repository", "ecr",
     _fail_if("scan_on_push", (False,),
              "Image scanning on push is disabled"),
     "Enable image_scanning_configuration.scan_on_push"),
    ("AVD-AWS-0031", "ECR repository allows mutable tags", "HIGH",
     "ecr_repository", "ecr",
     _fail_if("immutable", (False,), "Image tags are mutable"),
     "Set image_tag_mutability = IMMUTABLE"),
    ("AVD-AWS-0032", "ECR repository policy is public", "HIGH",
     "ecr_policy", "ecr",
     lambda a: None if a.get("document") is None else (
         "Repository policy allows any principal" if any(
             s.get("Effect") == "Allow" and
             (s.get("Principal") == "*" or (
                 isinstance(s.get("Principal"), dict) and
                 s["Principal"].get("AWS") == "*"))
             for s in (a["document"].get("Statement") or [])
             if isinstance(s, dict)) else False),
     "Scope the repository policy to known principals"),
    ("AVD-AWS-0033", "ECR repository is not CMK-encrypted", "LOW",
     "ecr_repository", "ecr",
     _fail_if("cmk", (False,),
              "Repository is not encrypted with a customer key"),
     "Use encryption_configuration with KMS"),
    # --- ECS
    ("AVD-AWS-0034", "ECS cluster has no container insights", "LOW",
     "ecs_cluster", "ecs",
     _fail_if("container_insights", (False,),
              "Container insights are not enabled"),
     "Enable the containerInsights setting"),
    ("AVD-AWS-0035", "ECS task EFS volume disables in-transit "
     "encryption", "HIGH", "ecs_task", "ecs",
     _fail_if("efs_unencrypted_transit", (True,),
              "EFS volume transit encryption is disabled"),
     "Enable transit_encryption"),
    ("AVD-AWS-0036", "ECS task definition holds a plaintext secret",
     "CRITICAL", "ecs_task", "ecs",
     _fail_if("plaintext_secret", (True,),
              "Environment variable looks like a hardcoded secret"),
     "Use SSM/Secrets Manager references"),
    # --- EKS
    ("AVD-AWS-0038", "EKS control plane logging is disabled", "MEDIUM",
     "eks_cluster_ext", "eks",
     _fail_if("logging", (False,),
              "No control-plane log types are enabled"),
     "Enable enabled_cluster_log_types"),
    ("AVD-AWS-0039", "EKS secrets are not encrypted", "HIGH",
     "eks_cluster_ext", "eks",
     _fail_if("secrets_encrypted", (False,),
              "No encryption_config for cluster secrets"),
     "Add an encryption_config with a KMS key"),
    # --- ElastiCache
    ("AVD-AWS-0045", "ElastiCache group disables at-rest encryption",
     "HIGH", "elasticache_group", "elasticache",
     _fail_if("at_rest", (False,),
              "At-rest encryption is not enabled"),
     "Set at_rest_encryption_enabled = true"),
    ("AVD-AWS-0051", "ElastiCache group disables in-transit "
     "encryption", "HIGH", "elasticache_group", "elasticache",
     _fail_if("in_transit", (False,),
              "In-transit encryption is not enabled"),
     "Set transit_encryption_enabled = true"),
    ("AVD-AWS-0050", "ElastiCache group has no backup retention",
     "MEDIUM", ("elasticache_group", "elasticache_cluster"),
     "elasticache",
     lambda a: None if a.get("backup_retention") is None else (
         False if str(a.get("engine", "redis")) == "memcached"
         else "Snapshot retention is 0"
         if isinstance(a["backup_retention"], (int, float)) and
         not isinstance(a["backup_retention"], bool) and
         a["backup_retention"] < 1 else False),
     "Set snapshot_retention_limit"),
    # --- Elasticsearch / OpenSearch
    ("AVD-AWS-0048", "ES domain is not encrypted at rest", "HIGH",
     "elasticsearch_domain", "elastic-search",
     _fail_if("at_rest", (False,),
              "Encryption at rest is not enabled"),
     "Enable encrypt_at_rest"),
    ("AVD-AWS-0043", "ES domain has no node-to-node encryption", "HIGH",
     "elasticsearch_domain", "elastic-search",
     _fail_if("in_transit", (False,),
              "Node-to-node encryption is not enabled"),
     "Enable node_to_node_encryption"),
    ("AVD-AWS-0046", "ES domain does not enforce HTTPS", "CRITICAL",
     "elasticsearch_domain", "elastic-search",
     _fail_if("enforce_https", (False,),
              "Unencrypted HTTP access is allowed"),
     "Set enforce_https = true"),
    ("AVD-AWS-0126", "ES domain uses an outdated TLS policy", "HIGH",
     "elasticsearch_domain", "elastic-search",
     _fail_if("tls_policy", ("Policy-Min-TLS-1-0-2019-07",),
              "TLS policy allows TLS 1.0"),
     "Use Policy-Min-TLS-1-2-2019-07"),
    ("AVD-AWS-0042", "ES domain audit logging is disabled", "MEDIUM",
     "elasticsearch_domain", "elastic-search",
     _fail_if("audit_logging", (False,),
              "AUDIT_LOGS publishing is not enabled"),
     "Enable AUDIT_LOGS log publishing"),
    # --- ELB
    ("AVD-AWS-0053", "Load balancer is internet-facing", "HIGH",
     "lb", "elb",
     lambda a: None if a.get("internal") is None else (
         "Load balancer is exposed to the internet"
         if a["internal"] is False else False),
     "Set internal = true unless public exposure is required"),
    ("AVD-AWS-0052", "ALB does not drop invalid headers", "HIGH",
     "lb", "elb",
     lambda a: None if a.get("drop_invalid_headers") is None else (
         "Invalid HTTP headers are not dropped"
         if a["drop_invalid_headers"] is False
         and a.get("lb_type") == "application" else False),
     "Set drop_invalid_header_fields = true"),
    ("AVD-AWS-0047", "Load balancer listener uses an outdated SSL "
     "policy", "HIGH", "lb_listener_ext", "elb",
     _fail_if("ssl_policy",
              ("ELBSecurityPolicy-2015-05",
               "ELBSecurityPolicy-TLS-1-0-2015-04",
               "ELBSecurityPolicy-2016-08"),
              "Listener allows outdated TLS versions"),
     "Use ELBSecurityPolicy-TLS-1-2-2017-01 or newer"),
    # --- EMR
    ("AVD-AWS-0137", "EMR security configuration disables local-disk "
     "encryption", "HIGH", "emr_security_config", "emr",
     _fail_if("local_disk", (False,),
              "Local disk encryption is not configured"),
     "Configure LocalDiskEncryptionConfiguration"),
    ("AVD-AWS-0138", "EMR security configuration disables in-transit "
     "encryption", "HIGH", "emr_security_config", "emr",
     _fail_if("in_transit", (False,),
              "In-transit encryption is disabled"),
     "Set EnableInTransitEncryption"),
    ("AVD-AWS-0139", "EMR security configuration disables at-rest "
     "encryption", "HIGH", "emr_security_config", "emr",
     _fail_if("at_rest", (False,),
              "At-rest encryption is disabled"),
     "Set EnableAtRestEncryption"),
    # --- IAM password policy
    ("AVD-AWS-0056", "Password policy does not prevent reuse", "MEDIUM",
     "iam_password_policy", "iam",
     _lt("reuse_prevention", 5,
         "Fewer than 5 previous passwords are remembered"),
     "Set password_reuse_prevention >= 5"),
    ("AVD-AWS-0058", "Password policy does not require lowercase",
     "MEDIUM", "iam_password_policy", "iam",
     _fail_if("require_lowercase", (False,),
              "Lowercase characters are not required"),
     "Set require_lowercase_characters = true"),
    ("AVD-AWS-0059", "Password policy does not require numbers",
     "MEDIUM", "iam_password_policy", "iam",
     _fail_if("require_numbers", (False,),
              "Numbers are not required"),
     "Set require_numbers = true"),
    ("AVD-AWS-0060", "Password policy does not require symbols",
     "MEDIUM", "iam_password_policy", "iam",
     _fail_if("require_symbols", (False,),
              "Symbols are not required"),
     "Set require_symbols = true"),
    ("AVD-AWS-0061", "Password policy does not require uppercase",
     "MEDIUM", "iam_password_policy", "iam",
     _fail_if("require_uppercase", (False,),
              "Uppercase characters are not required"),
     "Set require_uppercase_characters = true"),
    ("AVD-AWS-0062", "Password policy has no maximum age", "MEDIUM",
     "iam_password_policy", "iam",
     _lt("max_age", 1, "Passwords never expire"),
     "Set max_password_age (e.g. 90 days)"),
    ("AVD-AWS-0063", "Password policy minimum length is too short",
     "MEDIUM", "iam_password_policy", "iam",
     _lt("min_length", 14, "Minimum length is below 14 characters"),
     "Set minimum_password_length >= 14"),
    # --- Kinesis
    ("AVD-AWS-0064", "Kinesis stream is unencrypted", "HIGH",
     "kinesis_stream", "kinesis",
     _fail_if("encrypted", (False,),
              "Stream encryption is not KMS"),
     "Set encryption_type = KMS"),
    # --- KMS
    ("AVD-AWS-0065", "KMS key rotation is disabled", "MEDIUM",
     "kms_key", "kms",
     lambda a: None if a.get("rotation") is None else (
         "Automatic key rotation is not enabled"
         if a["rotation"] is False and
         a.get("usage") != "SIGN_VERIFY" else False),
     "Set enable_key_rotation = true"),
    # --- Lambda
    ("AVD-AWS-0066", "Lambda function has no X-Ray tracing", "LOW",
     "lambda_function", "lambda",
     _fail_if("tracing", ("PassThrough",),
              "Tracing mode is PassThrough"),
     "Set tracing_config mode = Active"),
    ("AVD-AWS-0067", "Lambda permission has no source ARN", "CRITICAL",
     "lambda_permission", "lambda",
     lambda a: None if a.get("principal") is None else (
         "Service principal permission without source_arn"
         if not a["has_source_arn"] and
         str(a["principal"]).endswith(".amazonaws.com") else False),
     "Restrict the permission with source_arn"),
    # --- MQ
    ("AVD-AWS-0070", "MQ broker general logging is disabled", "LOW",
     "mq_broker", "mq",
     _fail_if("general_logging", (False,),
              "General logging is not enabled"),
     "Enable logs.general"),
    ("AVD-AWS-0071", "MQ broker audit logging is disabled", "MEDIUM",
     "mq_broker", "mq",
     _fail_if("audit_logging", (False,),
              "Audit logging is not enabled"),
     "Enable logs.audit"),
    ("AVD-AWS-0072", "MQ broker is publicly accessible", "HIGH",
     "mq_broker", "mq",
     _fail_if("public", (True,), "Broker is publicly accessible"),
     "Set publicly_accessible = false"),
    # --- MSK
    ("AVD-AWS-0073", "MSK cluster broker logging is disabled", "LOW",
     "msk_cluster", "msk",
     _fail_if("logging", (False,),
              "No broker log destination is enabled"),
     "Enable logging_info broker logs"),
    ("AVD-AWS-0074", "MSK cluster allows plaintext client traffic",
     "HIGH", "msk_cluster", "msk",
     _fail_if("client_broker", ("PLAINTEXT", "TLS_PLAINTEXT"),
              "Client-broker encryption allows plaintext"),
     "Set encryption_in_transit client_broker = TLS"),
    ("AVD-AWS-0179", "MSK cluster is not CMK-encrypted at rest", "LOW",
     "msk_cluster", "msk",
     _fail_if("at_rest_cmk", (False,),
              "At-rest encryption does not use a customer key"),
     "Set encryption_at_rest_kms_key_arn"),
    # --- Neptune
    ("AVD-AWS-0075", "Neptune cluster audit logging is disabled",
     "MEDIUM", "neptune_cluster", "neptune",
     _fail_if("audit_logging", (False,),
              "Audit log export is not enabled"),
     "Add audit to enable_cloudwatch_logs_exports"),
    ("AVD-AWS-0076", "Neptune cluster storage is unencrypted", "HIGH",
     "neptune_cluster", "neptune",
     _fail_if("encrypted", (False,), "Storage is not encrypted"),
     "Set storage_encrypted = true"),
    # --- RDS
    ("AVD-AWS-0079", "RDS cluster storage is unencrypted", "HIGH",
     "rds_cluster", "rds",
     _fail_if("encrypted", (False,),
              "Cluster storage is not encrypted"),
     "Set storage_encrypted = true"),
    ("AVD-AWS-0077", "RDS has insufficient backup retention", "MEDIUM",
     "rds_instance_ext", "rds",
     _lt("backup_retention", 1, "Automated backups are disabled"),
     "Set backup_retention_period >= 1"),
    ("AVD-AWS-0078", "RDS performance insights are not CMK-encrypted",
     "LOW", "rds_instance_ext", "rds",
     lambda a: None if a.get("perf_insights") is None else (
         "Performance insights use the default key"
         if a["perf_insights"] is True and
         a.get("perf_insights_kms") is False else False),
     "Set performance_insights_kms_key_id"),
    ("AVD-AWS-0176", "RDS IAM database authentication is disabled",
     "MEDIUM", "rds_instance_ext", "rds",
     _fail_if("iam_auth", (False,),
              "IAM database authentication is not enabled"),
     "Set iam_database_authentication_enabled = true"),
    ("AVD-AWS-0177", "RDS deletion protection is disabled", "MEDIUM",
     "rds_instance_ext", "rds",
     _fail_if("deletion_protection", (False,),
              "Deletion protection is not enabled"),
     "Set deletion_protection = true"),
    # --- Redshift
    ("AVD-AWS-0084", "Redshift cluster is unencrypted", "HIGH",
     "redshift_cluster", "redshift",
     _fail_if("encrypted", (False,),
              "Cluster storage is not encrypted"),
     "Set encrypted = true"),
    ("AVD-AWS-0127", "Redshift cluster is not CMK-encrypted", "HIGH",
     "redshift_cluster", "redshift",
     lambda a: None if a.get("encrypted") is None else (
         "Encryption does not use a customer key"
         if a["encrypted"] is True and a.get("cmk") is False
         else False),
     "Set kms_key_id"),
    ("AVD-AWS-0085", "Redshift cluster is not deployed in a VPC",
     "HIGH", "redshift_cluster", "redshift",
     _fail_if("in_vpc", (False,),
              "No cluster subnet group is configured"),
     "Set cluster_subnet_group_name"),
    ("AVD-AWS-0083", "Redshift cluster is publicly accessible",
     "CRITICAL", "redshift_cluster", "redshift",
     _fail_if("public", (True,), "Cluster is publicly accessible"),
     "Set publicly_accessible = false"),
    # --- Secrets Manager / SSM
    ("AVD-AWS-0098", "Secrets Manager secret is not CMK-encrypted",
     "LOW", "ssm_secret", "ssm",
     _fail_if("cmk", (False,),
              "Secret is not encrypted with a customer key"),
     "Set kms_key_id on the secret"),
    # --- WorkSpaces
    ("AVD-AWS-0109", "WorkSpaces root volume is unencrypted", "HIGH",
     "workspaces_workspace", "workspaces",
     _fail_if("root_encrypted", (False,),
              "Root volume encryption is not enabled"),
     "Set root_volume_encryption_enabled = true"),
    ("AVD-AWS-0110", "WorkSpaces user volume is unencrypted", "HIGH",
     "workspaces_workspace", "workspaces",
     _fail_if("user_encrypted", (False,),
              "User volume encryption is not enabled"),
     "Set user_volume_encryption_enabled = true"),
]


register_specs(SPECS, provider="aws", file_types=_C)
