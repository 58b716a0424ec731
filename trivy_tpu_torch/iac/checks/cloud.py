"""AWS cloud checks shared by terraform + cloudformation (reference
pkg/iac/adapters map both formats into typed provider structs at
pkg/iac/providers/aws; same idea here with a light canonical schema).

Canonical resource view: CloudResource{type, name, attrs, lines} where
type is e.g. "s3_bucket", "security_group", and attrs hold normalized
fields (None = unknown/unresolved -> checks stay silent, matching the
reference's unresolvable-value semantics).

Copy of trivy_tpu/iac/checks/cloud.py, whole.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from trivy_tpu_torch.iac.check import Cause, check
from trivy_tpu_torch.iac.parsers.hcl import Block, Expr
from trivy_tpu_torch.iac.parsers.yamlconf import (
    cfn_scalar,
    get_end_line,
    get_line,
    strip_lines,
)

_C = ("terraform", "cloudformation", "terraformplan")


@dataclass
class CloudResource:
    type: str = ""
    name: str = ""
    attrs: dict = field(default_factory=dict)
    start_line: int = 0
    end_line: int = 0

    def cause(self, message: str) -> Cause:
        return Cause(message=message, resource=self.name,
                     start_line=self.start_line, end_line=self.end_line)


# ------------------------------------------------------------ terraform


# single source of truth for unresolved-value semantics: spec.py
from trivy_tpu_torch.iac.checks.spec import (  # noqa: E402
    tf_value as _tf_value,
    tri as _tf_tristate,
)


def adapt_terraform(blocks: list[Block],
                    scan_blocks: list[Block] | None = None
                    ) -> list[CloudResource]:
    """scan_blocks: every evaluated block of the scan (all files, all
    modules) for adapters whose reference counterpart reads scan-wide
    context (e.g. aws_ebs_encryption_by_default); defaults to
    `blocks`."""
    out: list[CloudResource] = []
    from trivy_tpu_torch.iac.checks.aws_ext import adapt_terraform_aws_ext
    from trivy_tpu_torch.iac.checks.azure_ext import adapt_terraform_azure
    from trivy_tpu_torch.iac.checks.gcp import adapt_terraform_gcp
    from trivy_tpu_torch.iac.checks.gcp_ext import adapt_terraform_gcp_ext
    from trivy_tpu_torch.iac.checks.providers_misc import adapt_terraform_misc

    out.extend(adapt_terraform_aws_ext(blocks, scan_blocks))
    out.extend(adapt_terraform_azure(blocks))
    out.extend(adapt_terraform_gcp(blocks))
    out.extend(adapt_terraform_gcp_ext(blocks))
    out.extend(adapt_terraform_misc(blocks))
    res_blocks = [b for b in blocks if b.type == "resource" and
                  len(b.labels) >= 2]
    # companion resources referenced by bucket: aws_s3_bucket_* attach
    # settings to buckets declared separately (tf >= 4 style)
    sse_for: set[str] = set()
    pab_true_for: set[str] = set()
    pab_flags_for: dict[str, dict] = {}
    for b in res_blocks:
        t = b.labels[0]
        if t == "aws_s3_bucket_server_side_encryption_configuration":
            ref = b.get("bucket")
            if isinstance(ref, Expr):
                sse_for.add(ref.text.split(".")[-2] if "." in ref.text
                            else ref.text)
            elif isinstance(ref, str):
                sse_for.add(ref)
        if t == "aws_s3_bucket_public_access_block":
            # absent flag -> the provider default false (a definite
            # failing value); present-but-unresolved -> None = unknown
            flags = {k: _tf_tristate(b, k, False) for k in (
                "block_public_acls", "block_public_policy",
                "ignore_public_acls", "restrict_public_buckets")}
            ref = b.get("bucket")
            key = (ref.text.split(".")[-2] if isinstance(ref, Expr)
                   and "." in ref.text else str(ref))
            pab_flags_for[key] = flags
            if all(v is True for v in flags.values()):
                pab_true_for.add(key)

    for b in res_blocks:
        t, name = b.labels[0], b.labels[1]
        full = f"{t}.{name}"
        cr = CloudResource(name=full, start_line=b.start_line,
                           end_line=b.end_line)
        if t == "aws_s3_bucket":
            cr.type = "s3_bucket"
            enc = b.child("server_side_encryption_configuration")
            cr.attrs = {
                "acl": _tf_value(b.get("acl")),
                "encrypted": True if enc is not None
                else (True if name in sse_for or b.get("bucket") in sse_for
                      else False),
                "public_access_block": name in pab_true_for
                or str(_tf_value(b.get("bucket"))) in pab_true_for,
                "pab_flags": pab_flags_for.get(
                    name, pab_flags_for.get(
                        str(_tf_value(b.get("bucket"))))),
                "logging": b.child("logging") is not None,
                "versioning": _bool_attr(b.child("versioning"), "enabled"),
            }
        elif t in ("aws_security_group", "aws_security_group_rule",
                   "aws_vpc_security_group_ingress_rule"):
            cr.type = "security_group"
            ingress_cidrs, egress_cidrs = [], []
            if t == "aws_security_group":
                for rule in b.children("ingress"):
                    ingress_cidrs.extend(_cidrs(rule))
                for rule in b.children("egress"):
                    egress_cidrs.extend(_cidrs(rule))
            elif t == "aws_security_group_rule":
                kind = _tf_value(b.get("type"))
                cidrs = _cidrs(b)
                (ingress_cidrs if kind == "ingress"
                 else egress_cidrs).extend(cidrs)
            else:
                v = _tf_value(b.get("cidr_ipv4"))
                if v:
                    ingress_cidrs.append(v)
            cr.attrs = {
                "ingress_cidrs": ingress_cidrs,
                "egress_cidrs": egress_cidrs,
                "description": _tf_value(b.get("description")),
            }
        elif t == "aws_ebs_volume":
            cr.type = "ebs_volume"
            cr.attrs = {"encrypted": _tf_tristate(b, "encrypted", False)}
        elif t == "aws_db_instance":
            cr.type = "rds_instance"
            cr.attrs = {
                "encrypted": _tf_tristate(b, "storage_encrypted", False),
                "public": _tf_tristate(b, "publicly_accessible", False),
            }
        elif t == "aws_instance":
            cr.type = "ec2_instance"
            mo = b.child("metadata_options")
            cr.attrs = {
                "http_tokens": _tf_value(mo.get("http_tokens"))
                if mo else None,
            }
        elif t in ("aws_iam_policy", "aws_iam_role_policy",
                   "aws_iam_user_policy", "aws_iam_group_policy"):
            cr.type = "iam_policy"
            cr.attrs = {"document": _policy_doc(_tf_value(b.get("policy")))}
        elif t == "aws_cloudtrail":
            cr.type = "cloudtrail"
            cr.attrs = {
                "multi_region": _tf_tristate(
                    b, "is_multi_region_trail", False),
                "kms_key": _tf_value(b.get("kms_key_id")),
                "kms_unknown": isinstance(b.get("kms_key_id"), Expr),
                "log_validation": _tf_tristate(
                    b, "enable_log_file_validation", False),
            }
        elif t == "aws_efs_file_system":
            cr.type = "efs"
            cr.attrs = {"encrypted": _tf_tristate(b, "encrypted", False)}
        elif t == "aws_eks_cluster":
            vpc = b.child("vpc_config")
            cr.type = "eks_cluster"
            # absent cidrs -> AWS default 0.0.0.0/0; present but
            # unresolved (variable/expression) -> _tf_value gives None =
            # unknown, so the check stays silent instead of false-positive
            raw_cidrs = vpc.get("public_access_cidrs") if vpc else None
            cidrs = ["0.0.0.0/0"] if raw_cidrs is None \
                else _tf_value(raw_cidrs)
            cr.attrs = {
                "public_access": _tf_tristate(
                    vpc, "endpoint_public_access", True)
                if vpc else True,
                "public_cidrs": cidrs,
            }
        elif t == "aws_sqs_queue":
            cr.type = "sqs_queue"
            cr.attrs = {
                "encrypted": bool(_tf_value(b.get("kms_master_key_id")))
                or _tf_tristate(b, "sqs_managed_sse_enabled", False)
                is True,
                "unknown_enc": isinstance(
                    b.get("kms_master_key_id"), Expr)
                or isinstance(b.get("sqs_managed_sse_enabled"), Expr),
            }
        elif t == "aws_sns_topic":
            cr.type = "sns_topic"
            cr.attrs = {
                "encrypted": bool(_tf_value(b.get("kms_master_key_id"))),
                "unknown_enc": isinstance(
                    b.get("kms_master_key_id"), Expr),
            }
        elif t in ("aws_lb_listener", "aws_alb_listener"):
            cr.type = "lb_listener"
            # an HTTP listener whose default action redirects to HTTPS is
            # the idiomatic force-HTTPS setup and is exempt (reference
            # avd-aws-0054 checks default action redirect protocol)
            redirect_https = False
            for act in b.children("default_action"):
                if _tf_value(act.get("type")) != "redirect":
                    continue
                red = act.child("redirect")
                raw_proto = red.get("protocol") if red else None
                if raw_proto is None:
                    # redirect.protocol defaults to #{protocol}: an HTTP
                    # listener redirecting keeps HTTP — not exempt
                    continue
                proto = _tf_value(raw_proto)
                if proto is None or str(proto).upper() == "HTTPS":
                    redirect_https = True  # unresolved expr = unknown
            cr.attrs = {"protocol": _tf_value(b.get("protocol")),
                        "redirect_https": redirect_https}
        elif t == "aws_cloudfront_distribution":
            # every cache behavior counts (reference adapts
            # ordered_cache_behavior blocks too)
            policies = []
            for cb in (b.children("default_cache_behavior")
                       + b.children("ordered_cache_behavior")):
                policies.append(_tf_value(
                    cb.get("viewer_protocol_policy")))
            cr.type = "cloudfront"
            cr.attrs = {"viewer_protocols": policies}
        else:
            continue
        out.append(cr)
    return out


def _bool_attr(block: Block | None, name: str):
    if block is None:
        return None
    return _tf_value(block.get(name))


def _cidrs(b: Block) -> list[str]:
    vals = b.get("cidr_blocks") or []
    if isinstance(vals, Expr):
        return []
    single = b.get("cidr_block")
    out = [v for v in vals if isinstance(v, str)]
    if isinstance(single, str):
        out.append(single)
    return out


def _policy_doc(policy) -> dict | None:
    if isinstance(policy, str):
        try:
            return json.loads(policy)
        except ValueError:
            return None
    if isinstance(policy, dict):
        return policy
    return None


# ------------------------------------------------------------ cloudformation


def _cfn_tristate(props: dict, key: str, default):
    """CFN boolean attr -> True / False / None(=unknown, stay silent).
    Mirrors _tf_tristate: an unresolved intrinsic must not read as a
    definite failing value."""
    v = props.get(key)
    if v is None:
        return default
    if isinstance(v, dict):
        v = cfn_scalar(v)
        if v is None:
            return None  # Ref / Fn::If etc. → unknown
    if v in (True, "true", "True"):
        return True
    if v in (False, "false", "False"):
        return False
    return None


def adapt_cloudformation(resources: dict[str, dict]) -> list[CloudResource]:
    from trivy_tpu_torch.iac.checks.aws_ext import adapt_cloudformation_aws_ext

    out: list[CloudResource] = []
    out.extend(adapt_cloudformation_aws_ext(resources))
    for name, res in resources.items():
        rtype = str(res.get("Type", ""))
        props = res.get("Properties") or {}
        cr = CloudResource(name=name, start_line=get_line(res),
                           end_line=get_end_line(res))
        if rtype == "AWS::S3::Bucket":
            cr.type = "s3_bucket"
            pab = props.get("PublicAccessBlockConfiguration") or {}
            pab_vals = [cfn_scalar(pab.get(k)) for k in (
                "BlockPublicAcls", "BlockPublicPolicy",
                "IgnorePublicAcls", "RestrictPublicBuckets")]
            pab_flags = {
                snake: cfn_scalar(pab.get(camel)) in (True, "true",
                                                      "True")
                for snake, camel in (
                    ("block_public_acls", "BlockPublicAcls"),
                    ("block_public_policy", "BlockPublicPolicy"),
                    ("ignore_public_acls", "IgnorePublicAcls"),
                    ("restrict_public_buckets",
                     "RestrictPublicBuckets"))
            } if pab else None
            cr.attrs = {
                "acl": cfn_scalar(props.get("AccessControl")),
                "encrypted": bool(props.get("BucketEncryption")),
                "public_access_block": all(
                    v in (True, "true", "True") for v in pab_vals
                ) and bool(pab),
                "pab_flags": pab_flags,
                "logging": bool(props.get("LoggingConfiguration")),
                "versioning": cfn_scalar(
                    (props.get("VersioningConfiguration") or {})
                    .get("Status")) == "Enabled",
            }
        elif rtype == "AWS::EC2::SecurityGroup":
            cr.type = "security_group"
            ingress = props.get("SecurityGroupIngress") or []
            egress = props.get("SecurityGroupEgress") or []
            cr.attrs = {
                "ingress_cidrs": [
                    cfn_scalar(r.get("CidrIp")) for r in ingress
                    if isinstance(r, dict) and cfn_scalar(r.get("CidrIp"))
                ],
                "egress_cidrs": [
                    cfn_scalar(r.get("CidrIp")) for r in egress
                    if isinstance(r, dict) and cfn_scalar(r.get("CidrIp"))
                ],
                "description": cfn_scalar(props.get("GroupDescription")),
            }
        elif rtype == "AWS::EC2::Volume":
            cr.type = "ebs_volume"
            cr.attrs = {
                "encrypted": cfn_scalar(props.get("Encrypted"))
                in (True, "true", "True"),
            }
        elif rtype == "AWS::RDS::DBInstance":
            cr.type = "rds_instance"
            cr.attrs = {
                "encrypted": cfn_scalar(props.get("StorageEncrypted"))
                in (True, "true", "True"),
                "public": cfn_scalar(props.get("PubliclyAccessible"))
                in (True, "true", "True"),
            }
        elif rtype in ("AWS::IAM::Policy", "AWS::IAM::ManagedPolicy"):
            cr.type = "iam_policy"
            cr.attrs = {
                "document": strip_lines(props.get("PolicyDocument"))
                if isinstance(props.get("PolicyDocument"), dict) else None,
            }
        elif rtype == "AWS::CloudTrail::Trail":
            cr.type = "cloudtrail"
            cr.attrs = {
                "multi_region": _cfn_tristate(
                    props, "IsMultiRegionTrail", False),
                "kms_key": cfn_scalar(props.get("KMSKeyId")),
                "kms_unknown": isinstance(props.get("KMSKeyId"), dict),
                "log_validation": _cfn_tristate(
                    props, "EnableLogFileValidation", False),
            }
        elif rtype == "AWS::EFS::FileSystem":
            cr.type = "efs"
            cr.attrs = {
                "encrypted": _cfn_tristate(props, "Encrypted", False),
            }
        elif rtype == "AWS::EKS::Cluster":
            cr.type = "eks_cluster"
            rvc = props.get("ResourcesVpcConfig") or {}
            cidrs_raw = rvc.get("PublicAccessCidrs")
            if cidrs_raw is None:
                cidrs: list | None = ["0.0.0.0/0"]
            elif isinstance(cidrs_raw, dict):
                cidrs = None  # intrinsic → unknown, stay silent
            else:
                cidrs = [cfn_scalar(c) for c in cidrs_raw if cfn_scalar(c)]
            cr.attrs = {
                "public_access": _cfn_tristate(
                    rvc, "EndpointPublicAccess", True),
                "public_cidrs": cidrs,
            }
        elif rtype == "AWS::SQS::Queue":
            cr.type = "sqs_queue"
            cr.attrs = {
                "encrypted": bool(cfn_scalar(props.get("KmsMasterKeyId")))
                or _cfn_tristate(props, "SqsManagedSseEnabled", False)
                is True,
                "unknown_enc": isinstance(props.get("KmsMasterKeyId"), dict)
                or isinstance(props.get("SqsManagedSseEnabled"), dict),
            }
        elif rtype == "AWS::SNS::Topic":
            cr.type = "sns_topic"
            cr.attrs = {
                "encrypted": bool(cfn_scalar(props.get("KmsMasterKeyId"))),
                "unknown_enc": isinstance(props.get("KmsMasterKeyId"),
                                          dict),
            }
        elif rtype == "AWS::ElasticLoadBalancingV2::Listener":
            cr.type = "lb_listener"
            redirect_https = False
            for act in props.get("DefaultActions") or []:
                if not isinstance(act, dict):
                    continue
                if str(cfn_scalar(act.get("Type")) or "").lower() != \
                        "redirect":
                    continue
                raw_proto = (act.get("RedirectConfig") or {}).get(
                    "Protocol")
                if raw_proto is None:
                    continue  # defaults to #{protocol}: not exempt
                proto = cfn_scalar(raw_proto)
                if proto is None or str(proto).upper() == "HTTPS":
                    redirect_https = True  # intrinsic = unknown
            cr.attrs = {"protocol": cfn_scalar(props.get("Protocol")),
                        "redirect_https": redirect_https}
        elif rtype == "AWS::CloudFront::Distribution":
            cr.type = "cloudfront"
            dc = props.get("DistributionConfig") or {}
            policies = []
            dcb = dc.get("DefaultCacheBehavior")
            if isinstance(dcb, dict):
                policies.append(cfn_scalar(dcb.get("ViewerProtocolPolicy")))
            for cb in dc.get("CacheBehaviors") or []:
                if isinstance(cb, dict):
                    policies.append(
                        cfn_scalar(cb.get("ViewerProtocolPolicy")))
            cr.attrs = {"viewer_protocols": policies}
        else:
            continue
        out.append(cr)
    return out


# ------------------------------------------------------------ checks


def _of_type(ctx, t: str) -> list[CloudResource]:
    return [r for r in ctx.cloud_resources if r.type == t]


@check("AVD-AWS-0086", "S3 bucket does not block public ACLs",
       severity="HIGH", file_types=_C, provider="aws", service="s3",
       resolution="Enable blocking any PUT calls with a public ACL")
def s3_public_access(ctx):
    out = []
    for r in _of_type(ctx, "s3_bucket"):
        if not r.attrs.get("public_access_block"):
            out.append(r.cause(
                "No public access block so not blocking public acls"))
    return out


def _s3_pab_flag_check(flag: str, label: str):
    def fn(ctx):
        out = []
        for r in _of_type(ctx, "s3_bucket"):
            flags = r.attrs.get("pab_flags")
            if flags is None:       # no PAB at all -> 0094's finding
                continue
            v = flags.get(flag)
            if v is False:
                out.append(r.cause(
                    f"Public access block does not {label}"))
        return out
    return fn


check("AVD-AWS-0087", "S3 bucket does not block public policies",
      severity="HIGH", file_types=_C, provider="aws", service="s3",
      resolution="Set block_public_policy = true")(
    _s3_pab_flag_check("block_public_policy",
                       "block public bucket policies"))
check("AVD-AWS-0091", "S3 bucket does not ignore public ACLs",
      severity="HIGH", file_types=_C, provider="aws", service="s3",
      resolution="Set ignore_public_acls = true")(
    _s3_pab_flag_check("ignore_public_acls", "ignore public ACLs"))
check("AVD-AWS-0093", "S3 bucket does not restrict public buckets",
      severity="HIGH", file_types=_C, provider="aws", service="s3",
      resolution="Set restrict_public_buckets = true")(
    _s3_pab_flag_check("restrict_public_buckets",
                       "restrict public bucket policies"))


@check("AVD-AWS-0094", "S3 bucket has no public access block",
       severity="LOW", file_types=_C, provider="aws", service="s3",
       resolution="Define an aws_s3_bucket_public_access_block")
def s3_no_pab(ctx):
    out = []
    for r in _of_type(ctx, "s3_bucket"):
        if r.attrs.get("pab_flags") is None \
                and not r.attrs.get("public_access_block"):
            out.append(r.cause(
                "Bucket does not have a public access block"))
    return out


@check("AVD-AWS-0088", "S3 bucket is unencrypted", severity="HIGH",
       file_types=_C, provider="aws", service="s3",
       resolution="Configure bucket encryption")
def s3_encryption(ctx):
    out = []
    for r in _of_type(ctx, "s3_bucket"):
        if not r.attrs.get("encrypted"):
            out.append(r.cause("Bucket does not have encryption enabled"))
    return out


@check("AVD-AWS-0089", "S3 bucket logging is disabled", severity="LOW",
       file_types=_C, provider="aws", service="s3",
       resolution="Add a logging block to the resource")
def s3_logging(ctx):
    out = []
    for r in _of_type(ctx, "s3_bucket"):
        if not r.attrs.get("logging"):
            out.append(r.cause("Bucket does not have logging enabled"))
    return out


@check("AVD-AWS-0090", "S3 bucket versioning is disabled", severity="MEDIUM",
       file_types=_C, provider="aws", service="s3",
       resolution="Enable versioning to protect against accidental "
                  "deletions and overwrites")
def s3_versioning(ctx):
    out = []
    for r in _of_type(ctx, "s3_bucket"):
        if r.attrs.get("versioning") is not True:
            out.append(r.cause("Bucket does not have versioning enabled"))
    return out


@check("AVD-AWS-0092", "S3 bucket uses a public ACL", severity="HIGH",
       file_types=_C, provider="aws", service="s3",
       resolution="Don't use canned ACLs or switch to private acl")
def s3_public_acl(ctx):
    out = []
    for r in _of_type(ctx, "s3_bucket"):
        acl = str(r.attrs.get("acl") or "")
        if acl.lower().replace("_", "-") in (
            "public-read", "public-read-write", "publicread",
            "publicreadwrite", "website",
        ):
            out.append(r.cause(f"Bucket has a public ACL: '{acl}'"))
    return out


_ANYWHERE = ("0.0.0.0/0", "::/0")


@check("AVD-AWS-0107", "Security group rule allows ingress from public "
                       "internet", severity="CRITICAL", file_types=_C,
       provider="aws", service="ec2",
       resolution="Set a more restrictive CIDR range")
def sg_open_ingress(ctx):
    out = []
    for r in _of_type(ctx, "security_group"):
        for cidr in r.attrs.get("ingress_cidrs") or []:
            if cidr in _ANYWHERE:
                out.append(r.cause(
                    f"Security group rule allows ingress from public "
                    f"internet: '{cidr}'"))
    return out


@check("AVD-AWS-0104", "Security group rule allows egress to multiple "
                       "public internet addresses", severity="CRITICAL",
       file_types=_C, provider="aws", service="ec2",
       resolution="Set a more restrictive CIDR range")
def sg_open_egress(ctx):
    out = []
    for r in _of_type(ctx, "security_group"):
        for cidr in r.attrs.get("egress_cidrs") or []:
            if cidr in _ANYWHERE:
                out.append(r.cause(
                    f"Security group rule allows egress to public "
                    f"internet: '{cidr}'"))
    return out


@check("AVD-AWS-0124", "Security group rule does not have a description",
       severity="LOW", file_types=_C, provider="aws", service="ec2",
       resolution="Add descriptions for all security groups rules")
def sg_no_description(ctx):
    out = []
    for r in _of_type(ctx, "security_group"):
        if not r.attrs.get("description"):
            out.append(r.cause(
                "Security group rule does not have a description"))
    return out


@check("AVD-AWS-0026", "EBS volume is unencrypted", severity="HIGH",
       file_types=_C, provider="aws", service="ebs",
       resolution="Enable encryption of EBS volume")
def ebs_encryption(ctx):
    out = []
    for r in _of_type(ctx, "ebs_volume"):
        if r.attrs.get("encrypted") is False:  # None = unknown, stay silent
            out.append(r.cause("EBS volume is not encrypted"))
    return out


@check("AVD-AWS-0080", "RDS instance is unencrypted", severity="HIGH",
       file_types=_C, provider="aws", service="rds",
       resolution="Enable encryption for RDS instance")
def rds_encryption(ctx):
    out = []
    for r in _of_type(ctx, "rds_instance"):
        if r.attrs.get("encrypted") is False:  # None = unknown
            out.append(r.cause(
                "Instance does not have storage encryption enabled"))
    return out


@check("AVD-AWS-0082", "RDS instance is publicly accessible",
       severity="HIGH", file_types=_C, provider="aws", service="rds",
       resolution="Set 'publicly_accessible' to false")
def rds_public(ctx):
    out = []
    for r in _of_type(ctx, "rds_instance"):
        if r.attrs.get("public") is True:  # None = unknown
            out.append(r.cause("Instance is exposed publicly"))
    return out


@check("AVD-AWS-0028", "EC2 instance allows IMDSv1", severity="HIGH",
       file_types=_C, provider="aws", service="ec2",
       resolution="Enable HTTP token requirement for IMDS "
                  "(http_tokens = required)")
def ec2_imdsv1(ctx):
    out = []
    for r in _of_type(ctx, "ec2_instance"):
        tokens = r.attrs.get("http_tokens")
        if tokens is not None and tokens != "required":
            out.append(r.cause(
                "Instance does not require IMDS access to require a "
                "token"))
        elif tokens is None:
            out.append(r.cause(
                "Instance does not configure metadata_options "
                "http_tokens; IMDSv1 is allowed by default"))
    return out


@check("AVD-AWS-0057", "IAM policy allows wildcard actions",
       severity="HIGH", file_types=_C, provider="aws", service="iam",
       resolution="Specify the exact permissions required, and the "
                  "resources they apply to")
def iam_wildcard(ctx):
    out = []
    for r in _of_type(ctx, "iam_policy"):
        doc = r.attrs.get("document")
        if not isinstance(doc, dict):
            continue
        stmts = doc.get("Statement")
        if isinstance(stmts, dict):
            stmts = [stmts]
        for stmt in stmts or []:
            if not isinstance(stmt, dict):
                continue
            if str(stmt.get("Effect", "Allow")) != "Allow":
                continue
            actions = stmt.get("Action")
            actions = [actions] if isinstance(actions, str) else actions
            resources_ = stmt.get("Resource")
            resources_ = [resources_] if isinstance(resources_, str) \
                else resources_
            if any(a == "*" for a in actions or []) and \
                    any(x == "*" for x in resources_ or []):
                out.append(r.cause(
                    "IAM policy document uses wildcarded action and "
                    "resource"))
    return out


# ------------------------------------------------------------ terraform plan


def adapt_terraform_plan(doc: dict) -> list[CloudResource]:
    """tfplan JSON (terraform show -json): planned_values.root_module
    resources carry fully-resolved values, so the mapping mirrors
    adapt_terraform with concrete values and no line info (reference
    pkg/iac/scanners/terraformplan)."""
    out: list[CloudResource] = []
    sse_buckets: set[str] = set()

    # attrs computed at apply time are absent from planned_values;
    # resource_changes' after_unknown marks them so absent-vs-unknown is
    # distinguishable (an unknown encryption key must not read as unset)
    unknowns: dict[str, dict] = {}
    for rc in doc.get("resource_changes") or []:
        au = (rc.get("change") or {}).get("after_unknown")
        if isinstance(au, dict):
            unknowns[str(rc.get("address", ""))] = au

    def collect_sse(mod: dict):
        for res in mod.get("resources") or []:
            if res.get("type") == \
                    "aws_s3_bucket_server_side_encryption_configuration":
                bucket = (res.get("values") or {}).get("bucket")
                if bucket:
                    sse_buckets.add(str(bucket))
        for child in mod.get("child_modules") or []:
            collect_sse(child)

    def walk_module(mod: dict):
        for res in mod.get("resources") or []:
            cr = _plan_resource(
                res, unknowns.get(str(res.get("address", "")), {}))
            if cr is not None:
                if cr.type == "s3_bucket" and \
                        str(cr.attrs.get("bucket_name") or "") in sse_buckets:
                    cr.attrs["encrypted"] = True
                out.append(cr)
        for child in mod.get("child_modules") or []:
            walk_module(child)

    planned = doc.get("planned_values") or {}
    collect_sse(planned.get("root_module") or {})
    walk_module(planned.get("root_module") or {})
    plan_apply_public_access_blocks(doc, out)
    return out


def _plan_resource(res: dict,
                   unknown: dict | None = None) -> CloudResource | None:
    t = str(res.get("type", ""))
    vals = res.get("values") or {}
    unknown = unknown or {}
    cr = CloudResource(name=str(res.get("address", "")))
    if t == "aws_s3_bucket":
        sse = vals.get("server_side_encryption_configuration")
        cr.type = "s3_bucket"
        cr.attrs = {
            "acl": vals.get("acl"),
            "bucket_name": vals.get("bucket"),
            "encrypted": bool(sse),
            "public_access_block": False,  # separate resource; see below
            "logging": bool(vals.get("logging")),
            "versioning": bool(
                (vals.get("versioning") or [{}])[0].get("enabled")
                if isinstance(vals.get("versioning"), list)
                else (vals.get("versioning") or {}).get("enabled")),
        }
    elif t in ("aws_security_group", "aws_security_group_rule",
               "aws_vpc_security_group_ingress_rule"):
        cr.type = "security_group"
        ingress_cidrs, egress_cidrs = [], []
        if t == "aws_security_group":
            for rule in vals.get("ingress") or []:
                ingress_cidrs.extend(rule.get("cidr_blocks") or [])
            for rule in vals.get("egress") or []:
                egress_cidrs.extend(rule.get("cidr_blocks") or [])
        elif t == "aws_security_group_rule":
            cidrs = vals.get("cidr_blocks") or []
            (ingress_cidrs if vals.get("type") == "ingress"
             else egress_cidrs).extend(cidrs)
        else:
            v = vals.get("cidr_ipv4")
            if v:
                ingress_cidrs.append(v)
        cr.attrs = {
            "ingress_cidrs": ingress_cidrs,
            "egress_cidrs": egress_cidrs,
            "description": vals.get("description"),
        }
    elif t == "aws_ebs_volume":
        cr.type = "ebs_volume"
        cr.attrs = {"encrypted": bool(vals.get("encrypted"))}
    elif t == "aws_db_instance":
        cr.type = "rds_instance"
        cr.attrs = {
            "encrypted": bool(vals.get("storage_encrypted")),
            "public": bool(vals.get("publicly_accessible")),
        }
    elif t == "aws_instance":
        cr.type = "ec2_instance"
        mo = vals.get("metadata_options")
        mo = mo[0] if isinstance(mo, list) and mo else (mo or {})
        cr.attrs = {"http_tokens": mo.get("http_tokens")}
    elif t in ("aws_iam_policy", "aws_iam_role_policy",
               "aws_iam_user_policy", "aws_iam_group_policy"):
        cr.type = "iam_policy"
        cr.attrs = {"document": _policy_doc(vals.get("policy"))}
    elif t == "aws_cloudtrail":
        cr.type = "cloudtrail"
        cr.attrs = {
            "multi_region": bool(vals.get("is_multi_region_trail")),
            "kms_key": vals.get("kms_key_id"),
            # a key created in the same apply is unknown at plan time
            # (marked in after_unknown, absent from planned values)
            "kms_unknown": bool(unknown.get("kms_key_id")),
            "log_validation": bool(vals.get("enable_log_file_validation")),
        }
    elif t == "aws_efs_file_system":
        cr.type = "efs"
        enc = vals.get("encrypted")
        cr.attrs = {"encrypted": None if unknown.get("encrypted")
                    else bool(enc)}
    elif t == "aws_eks_cluster":
        cr.type = "eks_cluster"
        vpcs = vals.get("vpc_config")
        vpc = vpcs[0] if isinstance(vpcs, list) and vpcs else (
            vpcs if isinstance(vpcs, dict) else {})
        vu = unknown.get("vpc_config")
        vu = vu[0] if isinstance(vu, list) and vu else (
            vu if isinstance(vu, dict) else {})
        pub = vpc.get("endpoint_public_access")
        cidrs = vpc.get("public_access_cidrs")
        if cidrs is None:
            cidrs_attr = None if vu.get("public_access_cidrs") \
                else ["0.0.0.0/0"]
        else:
            cidrs_attr = [c for c in cidrs if isinstance(c, str)]
        cr.attrs = {
            "public_access": True if pub is None else bool(pub),
            "public_cidrs": cidrs_attr,
        }
    elif t == "aws_sqs_queue":
        cr.type = "sqs_queue"
        cr.attrs = {
            "encrypted": bool(vals.get("kms_master_key_id"))
            or bool(vals.get("sqs_managed_sse_enabled")),
            "unknown_enc": bool(unknown.get("kms_master_key_id")
                                or unknown.get("sqs_managed_sse_enabled")),
        }
    elif t == "aws_sns_topic":
        cr.type = "sns_topic"
        cr.attrs = {
            "encrypted": bool(vals.get("kms_master_key_id")),
            "unknown_enc": bool(unknown.get("kms_master_key_id")),
        }
    elif t in ("aws_lb_listener", "aws_alb_listener"):
        cr.type = "lb_listener"

        def _first_block(v):
            if isinstance(v, list) and v:
                return v[0] if isinstance(v[0], dict) else {}
            return v if isinstance(v, dict) else {}

        redirect_https = False
        acts = vals.get("default_action") or []
        # a wholly-unknown attribute encodes as the literal `true` in
        # after_unknown, not a mirrored list
        unk_acts = unknown.get("default_action")
        if not isinstance(unk_acts, list):
            unk_acts = []
        for i, act in enumerate(acts):
            if not isinstance(act, dict) or act.get("type") != "redirect":
                continue
            red = _first_block(act.get("redirect"))
            proto = red.get("protocol")
            if proto is None:
                # computed at apply time -> unknown -> exempt (matches
                # the HCL/CFN unknown handling); truly absent defaults
                # to #{protocol} (scheme kept) -> not exempt
                unk_act = unk_acts[i] if i < len(unk_acts) and \
                    isinstance(unk_acts[i], dict) else {}
                unk_red = _first_block(unk_act.get("redirect"))
                if unk_red.get("protocol"):
                    redirect_https = True
            elif str(proto).upper() == "HTTPS":
                redirect_https = True
        cr.attrs = {"protocol": vals.get("protocol"),
                    "redirect_https": redirect_https}
    elif t == "aws_cloudfront_distribution":
        cr.type = "cloudfront"
        policies = []
        for key in ("default_cache_behavior", "ordered_cache_behavior"):
            v = vals.get(key)
            items = v if isinstance(v, list) else (
                [v] if isinstance(v, dict) else [])
            for cb in items:
                if isinstance(cb, dict):
                    policies.append(cb.get("viewer_protocol_policy"))
        cr.attrs = {"viewer_protocols": policies}
    else:
        return None
    return cr


def plan_apply_public_access_blocks(doc: dict,
                                    resources: list[CloudResource]) -> None:
    """aws_s3_bucket_public_access_block resources in the plan mark their
    bucket as protected (mirrors the companion-resource handling in
    adapt_terraform)."""
    protected: set[str] = set()

    def walk(mod: dict):
        for res in mod.get("resources") or []:
            if res.get("type") == "aws_s3_bucket_public_access_block":
                vals = res.get("values") or {}
                bucket = vals.get("bucket")
                if bucket and all(vals.get(k) for k in (
                        "block_public_acls", "block_public_policy",
                        "ignore_public_acls", "restrict_public_buckets")):
                    protected.add(str(bucket))
        for child in mod.get("child_modules") or []:
            walk(child)

    walk((doc.get("planned_values") or {}).get("root_module") or {})
    if not protected:
        return
    for cr in resources:
        if cr.type == "s3_bucket" and \
                str(cr.attrs.get("bucket_name") or "") in protected:
            cr.attrs["public_access_block"] = True


@check("AVD-AWS-0014", "CloudTrail is not a multi-region trail",
       severity="MEDIUM", file_types=_C, provider="aws",
       service="cloudtrail", resolution="Enable is_multi_region_trail")
def cloudtrail_multi_region(ctx):
    out = []
    for r in _of_type(ctx, "cloudtrail"):
        if r.attrs.get("multi_region") is False:
            out.append(r.cause("Trail is not a multi-region trail"))
    return out


@check("AVD-AWS-0015", "CloudTrail is not encrypted with a customer key",
       severity="HIGH", file_types=_C, provider="aws",
       service="cloudtrail", resolution="Set kms_key_id")
def cloudtrail_encryption(ctx):
    out = []
    for r in _of_type(ctx, "cloudtrail"):
        # kms_key_id = aws_kms_key.x.arn is the idiomatic form: an
        # unresolved reference means a key IS configured — stay silent
        if not r.attrs.get("kms_key") and not r.attrs.get("kms_unknown"):
            out.append(r.cause("Trail is not encrypted with a CMK"))
    return out


@check("AVD-AWS-0016", "CloudTrail log file validation is disabled",
       severity="HIGH", file_types=_C, provider="aws",
       service="cloudtrail", resolution="Enable log file validation")
def cloudtrail_validation(ctx):
    out = []
    for r in _of_type(ctx, "cloudtrail"):
        if r.attrs.get("log_validation") is False:
            out.append(r.cause("Trail does not have log validation "
                               "enabled"))
    return out


@check("AVD-AWS-0037", "EFS file system is unencrypted", severity="HIGH",
       file_types=_C, provider="aws", service="efs",
       resolution="Enable encryption for the file system")
def efs_encryption(ctx):
    out = []
    for r in _of_type(ctx, "efs"):
        if r.attrs.get("encrypted") is False:
            out.append(r.cause("File system is not encrypted"))
    return out


@check("AVD-AWS-0040", "EKS cluster endpoint is publicly accessible",
       severity="CRITICAL", file_types=_C, provider="aws", service="eks",
       resolution="Disable endpoint_public_access or restrict "
                  "public_access_cidrs")
def eks_public_endpoint(ctx):
    out = []
    for r in _of_type(ctx, "eks_cluster"):
        if r.attrs.get("public_access") is True and \
                "0.0.0.0/0" in (r.attrs.get("public_cidrs") or []):
            out.append(r.cause(
                "Cluster endpoint is publicly accessible from anywhere"))
    return out


@check("AVD-AWS-0096", "SQS queue is unencrypted", severity="HIGH",
       file_types=_C, provider="aws", service="sqs",
       resolution="Enable server-side encryption for the queue")
def sqs_encryption(ctx):
    out = []
    for r in _of_type(ctx, "sqs_queue"):
        if not r.attrs.get("encrypted") and not r.attrs.get("unknown_enc"):
            out.append(r.cause("Queue is not encrypted"))
    return out


@check("AVD-AWS-0095", "SNS topic is unencrypted", severity="HIGH",
       file_types=_C, provider="aws", service="sns",
       resolution="Set kms_master_key_id on the topic")
def sns_encryption(ctx):
    out = []
    for r in _of_type(ctx, "sns_topic"):
        if not r.attrs.get("encrypted") and not r.attrs.get("unknown_enc"):
            out.append(r.cause("Topic does not have encryption enabled"))
    return out


@check("AVD-AWS-0054", "Load balancer listener uses plain HTTP",
       severity="CRITICAL", file_types=_C, provider="aws", service="elb",
       resolution="Switch the listener to HTTPS/TLS")
def lb_plain_http(ctx):
    out = []
    for r in _of_type(ctx, "lb_listener"):
        if str(r.attrs.get("protocol") or "").upper() == "HTTP" \
                and not r.attrs.get("redirect_https"):
            out.append(r.cause("Listener uses plain HTTP"))
    return out


@check("AVD-AWS-0012", "CloudFront distribution allows unencrypted "
                       "viewer traffic", severity="HIGH", file_types=_C,
       provider="aws", service="cloudfront",
       resolution="Set viewer_protocol_policy to redirect-to-https or "
                  "https-only")
def cloudfront_viewer_policy(ctx):
    out = []
    for r in _of_type(ctx, "cloudfront"):
        if any(str(p or "") == "allow-all"
               for p in r.attrs.get("viewer_protocols") or []):
            out.append(r.cause(
                "Distribution allows unencrypted communications"))
    return out
