"""Post-scan result filtering (reference pkg/result/filter.go:37-61):
severity selection, ignore-status, .trivyignore entries, then stable
sorting.

Copy of trivy_tpu/result/filter.py, less an unused import."""

from __future__ import annotations

from trivy_tpu_torch.result.ignore import IgnoreConfig
from trivy_tpu_torch.types.enums import Severity
from trivy_tpu_torch.types.report import Report, Result


def filter_report(
    report: Report,
    severities: list[Severity] | None = None,
    ignore_statuses: list[str] | None = None,
    ignore_config: IgnoreConfig | None = None,
    include_non_failures: bool = False,
    ignore_unfixed: bool = False,
    ignore_policy=None,
) -> Report:
    for res in report.results:
        filter_result(
            res, severities, ignore_statuses, ignore_config,
            include_non_failures, ignore_unfixed, ignore_policy,
        )
    return report


def filter_result(
    res: Result,
    severities=None,
    ignore_statuses=None,
    ignore_config: IgnoreConfig | None = None,
    include_non_failures: bool = False,
    ignore_unfixed: bool = False,
    ignore_policy=None,
) -> None:
    sev_names = {str(s) for s in severities} if severities else None
    statuses = set(ignore_statuses or [])
    ign = ignore_config or IgnoreConfig()

    def sev_ok(s: str) -> bool:
        return sev_names is None or s in sev_names

    def policy_ok(finding) -> bool:
        # --ignore-policy (reference filter.go applyPolicy): the policy
        # sees the finding's report-JSON document
        if ignore_policy is None:
            return True
        return not ignore_policy.ignored(finding.to_dict())

    res.vulnerabilities = [
        v
        for v in res.vulnerabilities
        if sev_ok(str(v.severity))
        and (not statuses or v.status.label not in statuses)
        # --ignore-unfixed (reference pkg/result/filter.go): drop
        # findings with no fix available
        and not (ignore_unfixed and not v.fixed_version)
        and not ign.ignored(
            "vulnerabilities", v.vulnerability_id,
            path=v.pkg_path or res.target, purl=v.pkg_identifier.purl,
        )
        and policy_ok(v)
    ]
    res.vulnerabilities.sort(key=lambda v: v.sort_key())

    res.misconfigurations = [
        m
        for m in res.misconfigurations
        if (m.status == "FAIL" or include_non_failures)
        and sev_ok(m.severity)
        and not ign.ignored("misconfigurations", m.id, path=res.target)
        and policy_ok(m)
    ]
    if res.misconf_summary is not None:
        res.misconf_summary.failures = sum(
            1 for m in res.misconfigurations if m.status == "FAIL"
        )

    res.secrets = [
        s
        for s in res.secrets
        if sev_ok(s.severity)
        and not ign.ignored("secrets", s.rule_id, path=res.target)
        and policy_ok(s)
    ]
    res.licenses = [
        l
        for l in res.licenses
        if sev_ok(l.severity)
        and not ign.ignored("licenses", l.name, path=res.target)
        and policy_ok(l)
    ]
