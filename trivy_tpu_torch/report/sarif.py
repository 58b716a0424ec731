"""SARIF 2.1.0 writer (reference pkg/report/sarif.go).

One run; a rule per unique finding ID (indexed in first-seen order, rule
data refreshed on every occurrence, matching the reference's AddRule
semantics); one result per detected vulnerability / misconfiguration /
secret / license. Help text, CVSS-backed security-severity, tags and
location messages follow the reference's shapes byte-for-byte so SARIF
consumers (GitHub code scanning) see identical reports.

Copy of trivy_tpu/report/sarif.py.
"""

from __future__ import annotations

import html
import json
import re

import trivy_tpu_torch
from trivy_tpu_torch.types.enums import Severity
from trivy_tpu_torch.types.report import Report

_SARIF_VERSION = "2.1.0"
_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/main/"
    "sarif-2.1/schema/sarif-schema-2.1.0.json"
)

_SECRET_RULES_URL = (
    "https://github.com/aquasecurity/trivy/blob/main/pkg/fanal/secret/"
    "builtin-rules.go"
)

# reference pkg/report/sarif.go toSarifErrorLevel
_LEVELS = {
    "CRITICAL": "error",
    "HIGH": "error",
    "MEDIUM": "warning",
    "LOW": "note",
    "UNKNOWN": "note",
}

# severityToScore (used when no vendor CVSS score exists)
_SEVERITY_SCORE = {
    "CRITICAL": "9.5",
    "HIGH": "8.0",
    "MEDIUM": "5.5",
    "LOW": "2.0",
}

# strip a trailing " (distro info)" from OS-package targets (pathRegex)
_PATH_RX = re.compile(r"^(?P<path>.+?)(?:\s*\((?:.*?)\).*?)?$")


def _level(severity: str) -> str:
    return _LEVELS.get(str(severity), "none")


def _escape(s: str) -> str:
    """Go html.EscapeString: <, >, &, ', " (in that charset)."""
    return html.escape(s or "", quote=True).replace(
        "&#x27;", "&#39;").replace("&quot;", "&#34;")


_REPO_COMPONENT = re.compile(r"^[a-z0-9]+(?:(?:[._]|__|[-]+)[a-z0-9]+)*$")


def _repository_str(name: str) -> str | None:
    """go-containerregistry ParseReference(...).Context().RepositoryStr():
    drop tag/digest and the registry host, add the library/ namespace for
    single-component Docker Hub names. None when `name` does not parse
    as an image reference (callers keep the input unchanged)."""
    s = name
    if "@" in s:
        s = s.split("@", 1)[0]
    # a ":" after the last "/" is a tag separator
    head, _, last = s.rpartition("/")
    if ":" in last:
        last = last.split(":", 1)[0]
        s = f"{head}/{last}" if head else last
    parts = s.split("/")
    # leading registry component contains "." / ":" or is localhost
    if len(parts) > 1 and ("." in parts[0] or ":" in parts[0]
                           or parts[0] == "localhost"):
        parts = parts[1:]
    if not parts or not all(_REPO_COMPONENT.match(p) for p in parts):
        return None
    if len(parts) == 1:
        return f"library/{parts[0]}"
    return "/".join(parts)


def _to_path_uri(target: str, result_class: str) -> str:
    """ToPathUri: only OS-package targets carry image/distro decoration
    worth stripping."""
    if result_class != "os-pkgs":
        return target
    m = _PATH_RX.match(target or "")
    if m:
        target = m.group("path")
    repo = _repository_str(target)
    if repo is not None:
        target = repo
    return _clear_uri(target)


def _clear_uri(s: str) -> str:
    """clearURI: normalize go-getter-style module sources to URLs."""
    s = (s or "").replace("\\", "/")
    if s.startswith("git@github.com:"):
        s = s.replace("git@github.com:", "github.com/")
        s = s.replace(".git", "").replace("?ref=", "/tree/")
    elif s.startswith("git::https:/") and not s.startswith("git::https://"):
        s = s[len("git::https:/"):].replace(".git", "")
    elif s.startswith("git::ssh://"):
        _, _, rest = s.partition("@")
        if rest:
            s = rest
        s = s.replace(".git", "")
    elif s.startswith("git::"):
        s = s[len("git::"):].replace(".git", "")
    elif s.startswith("hg::"):
        s = s[len("hg::"):].replace(".hg", "")
    elif s.startswith(("s3::", "gcs::")):
        s = s.split("::", 1)[1]
    return s


def _rule_name(result_class: str) -> str:
    return {
        "os-pkgs": "OsPackageVulnerability",
        "lang-pkgs": "LanguageSpecificPackageVulnerability",
        "config": "MisconfigurationFiles",
        "secret": "SecretFiles",
        "license": "LicenseFiles",
        "license-file": "LicenseFiles",
    }.get(str(result_class), "UnknownIssue")


def _cvss_score(v) -> str:
    """Vendor CVSS V3 score when present (getCVSSScore: the
    SeveritySource's entry), else severity-derived."""
    cvss = (getattr(v.info, "cvss", None) or {}) if v.info else {}
    entry = cvss.get(v.severity_source or "")
    if isinstance(entry, dict):
        # Go formats the struct field (0 when absent) with %.1f
        return f"{float(entry.get('V3Score') or 0.0):.1f}"
    return _SEVERITY_SCORE.get(str(v.severity), "0.0")


class _Run:
    """Accumulates rules (dedup by id, last data wins) and results."""

    def __init__(self):
        self.rules: list[dict] = []
        self.index: dict[str, int] = {}
        self.results: list[dict] = []

    def add(self, *, rule_id: str, name: str, short: str, full: str,
            help_text: str, help_md: str, severity: str, score: str,
            tag: str, url: str, message: str, location_msg: str,
            artifact_uri: str, locations: list[tuple[int, int]]):
        rule = {
            "id": rule_id,
            "name": name,
            # the reference html-escapes both descriptions
            # (html.EscapeString in sarif.go)
            "shortDescription": {"text": _escape(short)},
            "fullDescription": {"text": _escape(full)},
            "defaultConfiguration": {"level": _level(severity)},
        }
        if url:
            rule["helpUri"] = url
        rule["help"] = {"text": help_text, "markdown": help_md}
        rule["properties"] = {
            "precision": "very-high",
            "security-severity": score,
            "tags": [tag, "security", str(severity)],
        }
        idx = self.index.get(rule_id)
        if idx is None:
            idx = len(self.rules)
            self.index[rule_id] = idx
            self.rules.append(rule)
        else:
            self.rules[idx] = rule  # AddRule refreshes existing rule data
        if not locations:
            locations = [(1, 1)]
        self.results.append({
            "ruleId": rule_id,
            "ruleIndex": idx,
            "level": _level(severity),
            "message": {"text": message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": artifact_uri,
                        "uriBaseId": "ROOTPATH",
                    },
                    "region": {
                        "startLine": lo or 1,
                        "startColumn": 1,
                        "endLine": hi or lo or 1,
                        "endColumn": 1,
                    },
                },
                "message": {"text": location_msg},
            } for lo, hi in locations],
        })


def _pkg_locations(res, name: str, version: str) -> list[tuple[int, int]]:
    for pkg in getattr(res, "packages", None) or []:
        if pkg.name == name and pkg.version == version:
            return [(loc.start_line, loc.end_line)
                    for loc in getattr(pkg, "locations", None) or []]
    return []


def render_sarif(report: Report) -> str:
    run = _Run()

    for res in report.results:
        rclass = str(res.result_class or "")
        target = _to_path_uri(res.target, rclass)
        for v in res.vulnerabilities:
            sev = str(v.severity)
            title = (v.info.title if v.info else "") or ""
            desc = (v.info.description if v.info else "") or ""
            full = desc or title
            path = target
            if v.pkg_path:
                path = _to_path_uri(v.pkg_path, rclass)
            vid, url = v.vulnerability_id, v.primary_url
            fixed = v.fixed_version or ""
            run.add(
                rule_id=vid, name=_rule_name(rclass), short=title,
                full=full, severity=sev, score=_cvss_score(v),
                tag="vulnerability", url=url,
                help_text=(
                    f"Vulnerability {vid}\nSeverity: {sev}\n"
                    f"Package: {v.pkg_name}\nFixed Version: {fixed}\n"
                    f"Link: [{vid}]({url})\n{desc}"),
                help_md=(
                    f"**Vulnerability {vid}**\n"
                    "| Severity | Package | Fixed Version | Link |\n"
                    "| --- | --- | --- | --- |\n"
                    f"|{sev}|{v.pkg_name}|{fixed}|[{vid}]({url})|\n\n"
                    f"{desc}"),
                message=(
                    f"Package: {v.pkg_name}\n"
                    f"Installed Version: {v.installed_version}\n"
                    f"Vulnerability {vid}\nSeverity: {sev}\n"
                    f"Fixed Version: {fixed}\nLink: [{vid}]({url})"),
                location_msg=(
                    f"{path}: {v.pkg_name}@{v.installed_version}"),
                artifact_uri=path,
                locations=_pkg_locations(res, v.pkg_name,
                                         v.installed_version),
            )
        for m in res.misconfigurations:
            sev = str(Severity.parse(m.severity))
            uri = _clear_uri(res.target)
            mid, url = m.id, m.primary_url
            run.add(
                rule_id=mid, name=_rule_name(rclass), short=m.title,
                full=m.description, severity=sev,
                score=_SEVERITY_SCORE.get(sev, "0.0"),
                tag="misconfiguration", url=url,
                help_text=(
                    f"Misconfiguration {mid}\nType: {res.type}\n"
                    f"Severity: {sev}\nCheck: {m.title}\n"
                    f"Message: {m.message}\nLink: [{mid}]({url})\n"
                    f"{m.description}"),
                help_md=(
                    f"**Misconfiguration {mid}**\n"
                    "| Type | Severity | Check | Message | Link |\n"
                    "| --- | --- | --- | --- | --- |\n"
                    f"|{res.type}|{sev}|{m.title}|{m.message}|"
                    f"[{mid}]({url})|\n\n{m.description}"),
                message=(
                    f"Artifact: {uri}\nType: {res.type}\n"
                    f"Vulnerability {mid}\nSeverity: {sev}\n"
                    f"Message: {m.message}\nLink: [{mid}]({url})"),
                location_msg=uri, artifact_uri=uri,
                locations=[(m.cause_metadata.start_line,
                            m.cause_metadata.end_line)],
            )
        for s in res.secrets:
            sev = str(Severity.parse(s.severity))
            run.add(
                rule_id=s.rule_id, name=_rule_name(rclass),
                short=s.title, full=s.match, severity=sev,
                score=_SEVERITY_SCORE.get(sev, "0.0"), tag="secret",
                url=_SECRET_RULES_URL,
                help_text=(
                    f"Secret {s.title}\nSeverity: {sev}\n"
                    f"Match: {s.match}"),
                help_md=(
                    f"**Secret {s.title}**\n| Severity | Match |\n"
                    f"| --- | --- |\n|{sev}|{s.match}|"),
                message=(
                    f"Artifact: {res.target}\nType: {res.type}\n"
                    f"Secret {s.title}\nSeverity: {sev}\n"
                    f"Match: {s.match}"),
                location_msg=target, artifact_uri=target,
                locations=[(s.start_line, s.end_line)],
            )
        for lic in res.licenses:
            sev = str(Severity.parse(lic.severity))
            lid = f"{lic.pkg_name}:{lic.name}"
            desc = f"{lic.name} in {lic.pkg_name}"
            run.add(
                rule_id=lid, name=_rule_name(rclass),
                short=desc, full=desc, severity=sev,
                score=_SEVERITY_SCORE.get(sev, "0.0"), tag="license",
                url=lic.link,
                help_text=f"License {desc}\nClassification: {lic.category}",
                help_md=(
                    f"**License {desc}**\n| Classification |\n"
                    f"| --- |\n|{lic.category}|"),
                message=(
                    f"Artifact: {res.target}\nLicense {lic.name}\n"
                    f"PkgName: {lic.pkg_name}\n"
                    f"Classification: {lic.category}\n"),
                location_msg=target, artifact_uri=target,
                locations=[],
            )

    doc = {
        "version": _SARIF_VERSION,
        "$schema": _SCHEMA,
        "runs": [{
            "tool": {
                "driver": {
                    "fullName": "Trivy Vulnerability Scanner",
                    "informationUri": "https://github.com/aquasecurity/trivy",
                    "name": "Trivy",
                    "rules": run.rules,
                    "version": trivy_tpu_torch.__version__,
                },
            },
            "results": run.results,
            "columnKind": "utf16CodeUnits",
            "originalUriBaseIds": {
                "ROOTPATH": {"uri": "file:///"},
            },
        }],
    }
    if str(report.artifact_type) == "container_image":
        # Go renders this Properties map with sorted keys and JSON null
        # for absent slices
        doc["runs"][0]["properties"] = {
            "imageID": report.metadata.image_id,
            "imageName": report.artifact_name,
            "repoDigests": report.metadata.repo_digests or None,
            "repoTags": report.metadata.repo_tags or None,
        }
    return json.dumps(doc, indent=2, ensure_ascii=False) + "\n"
