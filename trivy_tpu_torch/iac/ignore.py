"""`trivy:ignore` / `tfsec:ignore` comment handling (reference
pkg/iac/ignore/parse.go + rule.go, exercised by
pkg/iac/scanners/terraform/ignore_test.go).

Supported forms, in `#`, `//` and `/* */` comment styles:

- trailing on a line: suppresses findings on that line
- standalone: attaches to the next code line; consecutive comment-only
  lines stack onto the same code line (a blank line breaks the chain)
- `ignore:*` suppresses every rule; otherwise the segment names a rule
  id / AVD id
- `ignore:<rule>[path.to.attr=value]` — parameterized: only suppress
  when the resolved resource attribute matches (unresolvable parameter
  -> the ignore is inactive)
- `ignore:<rule>:exp:2022-01-02` — expires at end of that date; an
  invalid date deactivates the ignore
- `ignore:<rule>:ws:name` — only in the named terraform workspace
  (supports * globs)

Copy of trivy_tpu/iac/ignore.py, whole.
"""

from __future__ import annotations

import datetime
import fnmatch
import re
from dataclasses import dataclass, field

_COMMENT_START = re.compile(r"#|//|/\*")
_MARK = re.compile(r"(?:trivy|tfsec):ignore:(\S+)", re.I)
_COMMENT_ONLY = re.compile(r"^\s*(#|//|/\*)")


@dataclass
class IgnoreRule:
    rule: str = "*"
    target_line: int = 0
    params: dict = field(default_factory=dict)  # attr path -> wanted str
    exp: datetime.date | None = None
    exp_invalid: bool = False
    workspace: str | None = None


def _parse_segments(spec: str) -> IgnoreRule | None:
    """`<rule>[k=v]:exp:DATE:ws:NAME` -> IgnoreRule."""
    if spec.endswith("*/"):     # '/* trivy:ignore:x */' close marker
        spec = spec[:-2].rstrip()
    rule = spec
    params: dict = {}
    m = re.match(r"^([^:\[\]]+)\[([^\]]*)\](.*)$", spec)
    rest = ""
    if m:
        rule, rest = m.group(1), m.group(3)
        for kv in m.group(2).split(","):
            k, _, v = kv.partition("=")
            if k.strip():
                params[k.strip()] = v.strip()
    else:
        rule, _, rest = spec.partition(":")
        rest = ":" + rest if rest else ""
    out = IgnoreRule(rule=rule, params=params)
    segs = [s for s in rest.split(":") if s != ""]
    i = 0
    while i < len(segs):
        key = segs[i].lower()
        if key == "exp" and i + 1 < len(segs):
            try:
                out.exp = datetime.date.fromisoformat(segs[i + 1])
            except ValueError:
                out.exp_invalid = True
            i += 2
        elif key == "ws" and i + 1 < len(segs):
            out.workspace = segs[i + 1]
            i += 2
        else:
            i += 1      # unknown segment: tolerate
    return out


def parse_ignores(content: bytes) -> list[IgnoreRule]:
    lines = content.decode("utf-8", "replace").splitlines()
    out: list[IgnoreRule] = []
    for n, line in enumerate(lines, start=1):
        cm = _COMMENT_START.search(line)
        if not cm:
            continue
        # everything after the comment marker may stack several
        # `trivy:ignore:` / `tfsec:ignore:` directives on one line
        offset = cm.start()
        for m in _MARK.finditer(line[offset:]):
            rec = _parse_segments(m.group(1).strip())
            if rec is None:
                continue
            before = line[:offset].strip()
            if before:                          # trailing a code line
                rec.target_line = n
            else:       # standalone: chain through stacked comments to
                j = n + 1                       # the next code line
                while j <= len(lines) and \
                        _COMMENT_ONLY.match(lines[j - 1]):
                    j += 1
                if j > len(lines) or not lines[j - 1].strip():
                    continue                    # blank breaks the chain
                rec.target_line = j
            out.append(rec)
    return out


def _param_matches(params: dict, attrs) -> bool:
    for path, want in params.items():
        node = attrs
        for part in path.split("."):
            if isinstance(node, dict):
                if part in node:
                    node = node[part]
                    continue
                # tolerate flattened keys (versioning.enabled vs
                # versioning_enabled in normalized adapters)
                flat = path.replace(".", "_")
                if flat in attrs:
                    node = attrs[flat]
                    break
                return False
            return False
        got = node
        if isinstance(got, bool):
            got_s = "true" if got else "false"
        elif got is None:
            return False
        else:
            got_s = str(got)
        if got_s != str(want):
            return False
    return True


def is_ignored(ignores: list[IgnoreRule], rule_id: str, avd_id: str,
               start_line: int, end_line: int = 0,
               resource_start: int = 0, attrs: dict | None = None,
               workspace: str = "default",
               today: datetime.date | None = None) -> bool:
    end = max(end_line, start_line)
    for rec in ignores:
        if rec.rule != "*" and rec.rule != rule_id and \
                rec.rule != avd_id:
            continue
        if not (start_line <= rec.target_line <= end or
                (resource_start and rec.target_line == resource_start)):
            continue
        if rec.exp_invalid:
            continue
        if rec.exp is not None:
            now = today or datetime.date.today()
            if now > rec.exp:
                continue
        if rec.workspace is not None and not fnmatch.fnmatch(
                workspace, rec.workspace):
            continue
        if rec.params:
            if attrs is None or not _param_matches(rec.params, attrs):
                continue
        return True
    return False
