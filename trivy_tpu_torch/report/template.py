"""Template writer: a Go-text/template subset interpreter
(reference pkg/report/template.go, which feeds the report through
text/template + sprig).

Supported constructs — the set used by the reference's contrib templates:
  {{ .Field.Sub }}         dotted access (maps, lists, report dict)
  {{ $var }} / {{ $var := pipeline }}
  {{ range .X }}...{{ end }}   (also: range $i, $v := .X, with {{ else }})
  {{ if pipeline }}...{{ else if }}...{{ else }}...{{ end }}
  {{ pipeline | func arg | func }}
  {{- ... -}}              whitespace trimming
functions: eq ne lt gt le ge not and or len index default empty
  toLower toUpper title trim nospace abbrev replace escapeXML escapeString
  printf toJson now getEnv sprintf join first last contains hasPrefix
  hasSuffix
Builtin templates are addressed as "@builtin/junit.tpl" etc. or by the
same names the reference documents ("@contrib/junit.tpl").

Copy of trivy_tpu/report/template.py.
"""

from __future__ import annotations

import hashlib
import html
import json
import os
import re

import trivy_tpu_torch
from trivy_tpu_torch.types.report import Report
from trivy_tpu_torch.utils import clock

# ------------------------------------------------------------ lexer


_TOKEN = re.compile(r"\{\{-?\s*(.*?)\s*-?\}\}", re.S)


def _lex(src: str) -> list[tuple[str, str]]:
    """-> [(kind, value)] where kind is 'text' or 'action'."""
    out: list[tuple[str, str]] = []
    pos = 0
    for m in _TOKEN.finditer(src):
        text = src[pos:m.start()]
        if m.group(0).startswith("{{-"):
            text = text.rstrip()
        if out and out[-1][0] == "rtrim":
            out.pop()
            text = text.lstrip()
        if text:
            out.append(("text", text))
        out.append(("action", m.group(1)))
        if m.group(0).endswith("-}}"):
            out.append(("rtrim", ""))
        pos = m.end()
    tail = src[pos:]
    if out and out[-1][0] == "rtrim":
        out.pop()
        tail = tail.lstrip()
    if tail:
        out.append(("text", tail))
    return out


# ------------------------------------------------------------ parser

class _Node:
    pass


class _Text(_Node):
    def __init__(self, s):
        self.s = s


class _Action(_Node):
    def __init__(self, expr):
        self.expr = expr


class _If(_Node):
    def __init__(self, branches, else_body):
        self.branches = branches  # [(cond_expr, body)]
        self.else_body = else_body


class _Range(_Node):
    def __init__(self, ivar, vvar, expr, body, else_body):
        self.ivar, self.vvar, self.expr = ivar, vvar, expr
        self.body, self.else_body = body, else_body


class _Assign(_Node):
    def __init__(self, var, expr, declare=True):
        self.var, self.expr, self.declare = var, expr, declare


def _parse(tokens: list[tuple[str, str]], i: int = 0,
           until: tuple = ()) -> tuple[list[_Node], int, str | None]:
    body: list[_Node] = []
    while i < len(tokens):
        kind, val = tokens[i]
        if kind == "text":
            body.append(_Text(val))
            i += 1
            continue
        if kind == "rtrim":
            i += 1
            continue
        word = val.split(None, 1)[0] if val else ""
        if word in until:
            return body, i, val
        if word == "if":
            cond = val[2:].strip()
            branches = []
            else_body: list[_Node] = []
            inner, i, stop = _parse(tokens, i + 1, ("else", "end"))
            branches.append((cond, inner))
            while stop and stop.startswith("else"):
                rest = stop[4:].strip()
                if rest.startswith("if"):
                    inner, i, stop = _parse(tokens, i + 1, ("else", "end"))
                    branches.append((rest[2:].strip(), inner))
                else:
                    else_body, i, stop = _parse(tokens, i + 1, ("end",))
                    break
            body.append(_If(branches, else_body))
            i += 1
        elif word == "range":
            rest = val[5:].strip()
            ivar = vvar = None
            m = re.match(
                r"(\$\w+)\s*(?:,\s*(\$\w+))?\s*:=\s*(.*)", rest, re.S
            )
            if m:
                if m.group(2):
                    ivar, vvar, expr = m.group(1), m.group(2), m.group(3)
                else:
                    vvar, expr = m.group(1), m.group(3)
            else:
                expr = rest
            inner, i, stop = _parse(tokens, i + 1, ("else", "end"))
            else_body = []
            if stop == "else":
                else_body, i, stop = _parse(tokens, i + 1, ("end",))
            body.append(_Range(ivar, vvar, expr, inner, else_body))
            i += 1
        elif word == "end":
            raise ValueError("unexpected {{end}}")
        else:
            m = re.match(r"(\$\w+)\s*(:?=)\s*(.*)", val, re.S)
            if m and not val.startswith("$ "):
                body.append(_Assign(m.group(1), m.group(3),
                                    declare=m.group(2) == ":="))
            else:
                body.append(_Action(val))
            i += 1
    return body, i, None


# ------------------------------------------------------------ evaluator

_NOPIPE = object()  # sentinel: "no piped value" (None is a real value)


def _truthy(v) -> bool:
    if v is None:
        return False
    if isinstance(v, (list, dict, str, tuple)):
        return len(v) > 0
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return v != 0
    return True


def _esc_xml(s) -> str:
    return (str(s).replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;")
            .replace("'", "&#39;"))


def _go_date(layout, t=None) -> str:
    """Go reference-time layout -> formatted timestamp (the sprig `date`
    subset the contrib templates use)."""
    import datetime as _dt

    if t is None:
        t = clock.now()
    if not hasattr(t, "strftime"):
        return clock.now_rfc3339()
    fmt = str(layout)
    # fractional seconds: .999... trims trailing zeros (omitted when
    # zero), .000... is fixed-width
    frac = ""
    m9 = re.search(r"\.(9+)", fmt)
    m0 = re.search(r"\.(0+)", fmt)
    if m9:
        width = len(m9.group(1))
        digits = f"{t.microsecond:06d}"
        if width > 6:
            # nanosecond layouts pick up the fake clock's sub-µs rest so
            # goldens rendered with a ns fake clock byte-match
            digits = (digits + f"{clock.ns_extra():03d}")[:min(width, 9)]
        else:
            digits = digits[:width]
        digits = digits.rstrip("0")
        frac = f".{digits}" if digits else ""
        fmt = fmt.replace(m9.group(0), "\x00FRAC\x00")
    elif m0:
        micro = f"{t.microsecond:06d}"[: min(len(m0.group(1)), 6)]
        frac = f".{micro}"
        fmt = fmt.replace(m0.group(0), "\x00FRAC\x00")
    # Z07:00 renders "Z" for UTC, else a colon offset (RFC3339)
    off = ""
    if "Z07:00" in fmt:
        utcoff = t.utcoffset() if t.tzinfo else _dt.timedelta(0)
        if not utcoff:
            off = "Z"
        else:
            total = int(utcoff.total_seconds())
            sign = "+" if total >= 0 else "-"
            total = abs(total)
            off = f"{sign}{total // 3600:02d}:{total % 3600 // 60:02d}"
        fmt = fmt.replace("Z07:00", "\x00OFF\x00")
    for go, py in (("2006", "%Y"), ("01", "%m"), ("02", "%d"),
                   ("15", "%H"), ("04", "%M"), ("05", "%S"),
                   ("MST", "%Z"), ("Jan", "%b"), ("Mon", "%a")):
        fmt = fmt.replace(go, py)
    # strftime segments BETWEEN the markers: platform C strftime treats
    # the format as NUL-terminated, so a \x00 marker inside the format
    # string silently truncates everything after it (glibc drops the
    # "Z" of ".999999999Z07:00" layouts)
    out = []
    # re.split with a capture group alternates segment/marker: odd
    # indices are the markers (a literal "FRAC" in a layout stays text)
    for k, tok in enumerate(re.split(r"\x00(FRAC|OFF)\x00", fmt)):
        if k % 2:
            out.append(frac if tok == "FRAC" else off)
        elif tok:
            out.append(t.strftime(tok))
    return "".join(out)


_FUNCS = {
    "eq": lambda a, *bs: any(a == b for b in bs),
    "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "gt": lambda a, b: a > b,
    "le": lambda a, b: a <= b,
    "ge": lambda a, b: a >= b,
    "not": lambda a: not _truthy(a),
    "and": lambda *a: a[-1] if all(_truthy(x) for x in a) else next(
        (x for x in a if not _truthy(x)), a[-1]),
    "or": lambda *a: next((x for x in a if _truthy(x)), a[-1]),
    "len": lambda a: len(a) if a is not None else 0,
    "index": lambda c, *ks: _index(c, ks),
    "default": lambda d, v=None: v if _truthy(v) else d,
    "empty": lambda v: not _truthy(v),
    "toLower": lambda s: str(s).lower(),
    "lower": lambda s: str(s).lower(),
    "toUpper": lambda s: str(s).upper(),
    "upper": lambda s: str(s).upper(),
    "title": lambda s: str(s).title(),
    "trim": lambda s: str(s).strip(),
    "nospace": lambda s: re.sub(r"\s+", "", str(s)),
    "abbrev": lambda n, s: (str(s)[: n - 3] + "...")
    if len(str(s)) > n else str(s),
    "replace": lambda old, new, s: str(s).replace(old, new),
    "escapeXML": _esc_xml,
    "escapeString": lambda s: html.escape(str(s)),
    "printf": lambda fmt, *a: _sprintf(fmt, a),
    "sprintf": lambda fmt, *a: _sprintf(fmt, a),
    "toJson": lambda v: json.dumps(v),
    "toPrettyJson": lambda v: json.dumps(v, indent=2),
    "now": lambda: clock.now(),
    "date": lambda fmt, t=None: _go_date(fmt, t),
    "getEnv": lambda k: os.environ.get(str(k), ""),
    "env": lambda k: os.environ.get(str(k), ""),
    "appVersion": lambda: trivy_tpu_torch.__version__,
    # trivy registers sourceID to map a string onto its SourceID type
    # (report.CustomTemplateFuncMap); the dict form is the string itself
    "sourceID": lambda s: str(s),
    "list": lambda *a: list(a),
    "add": lambda *a: sum(a),
    "toString": lambda v: str(v),
    "splitList": lambda sep, s: str(s).split(str(sep)),
    "trimSuffix": lambda suf, s: str(s).removesuffix(str(suf)),
    "trimPrefix": lambda pre, s: str(s).removeprefix(str(pre)),
    "regexMatch": lambda pat, s: bool(re.search(pat, str(s))),
    "regexFind": lambda pat, s: (
        (lambda m: m.group(0) if m else "")(re.search(pat, str(s)))),
    # sprig substr start end string (end < 0 = to the end)
    "substr": lambda start, end, s: str(s)[int(start):]
    if int(end) < 0 else str(s)[int(start):int(end)],
    "sha1sum": lambda s: hashlib.sha1(str(s).encode()).hexdigest(),
    "sha256sum": lambda s: hashlib.sha256(str(s).encode()).hexdigest(),
    "join": lambda sep, xs: str(sep).join(str(x) for x in xs or []),
    "first": lambda xs: xs[0] if xs else None,
    "last": lambda xs: xs[-1] if xs else None,
    "contains": lambda sub, s: str(sub) in str(s),
    "hasPrefix": lambda p, s: str(s).startswith(str(p)),
    "hasSuffix": lambda p, s: str(s).endswith(str(p)),
    "endsWith": lambda s, p: str(s).endswith(str(p)),
}


def _sprintf(fmt: str, args) -> str:
    # translate Go verbs to Python %-format (the common ones)
    pyfmt = re.sub(r"%([-+ #0-9.]*)[vs]", r"%\1s", fmt)
    pyfmt = pyfmt.replace("%q", '"%s"')
    try:
        return pyfmt % tuple(args)
    except TypeError:
        return fmt


def _index(c, ks):
    for k in ks:
        if c is None:
            return None
        if isinstance(c, dict):
            c = c.get(k)
        elif isinstance(c, (list, tuple)) and isinstance(k, int):
            c = c[k] if -len(c) <= k < len(c) else None
        else:
            c = getattr(c, str(k), None)
    return c


_STR = re.compile(r'"((?:[^"\\]|\\.)*)"|`([^`]*)`')


def _split_args(expr: str) -> list[str]:
    """Split a command into space-separated args honoring quotes/parens."""
    out, buf, depth, q = [], [], 0, None
    i = 0
    while i < len(expr):
        ch = expr[i]
        if q:
            buf.append(ch)
            if ch == "\\" and i + 1 < len(expr):
                buf.append(expr[i + 1])
                i += 2
                continue
            if ch == q:
                q = None
        elif ch in "\"`":
            q = ch
            buf.append(ch)
        elif ch == "(":
            depth += 1
            buf.append(ch)
        elif ch == ")":
            depth -= 1
            buf.append(ch)
        elif ch.isspace() and depth == 0:
            if buf:
                out.append("".join(buf))
                buf = []
        else:
            buf.append(ch)
        i += 1
    if buf:
        out.append("".join(buf))
    return out


def _go_str(v) -> str:
    """Go's default %v rendering for template output. The only case that
    differs from str() is time.Time: Go prints
    "2006-01-02 15:04:05.999999999 -0700 MST"."""
    import datetime as _dt

    if isinstance(v, _dt.datetime):
        frac = ""
        micro = v.microsecond
        ns = clock.ns_extra()
        if micro or ns:
            frac = f".{micro:06d}{ns:03d}".rstrip("0") if ns \
                else f".{micro:06d}".rstrip("0")
        off = v.utcoffset() or _dt.timedelta(0)
        total = int(off.total_seconds())
        sign = "+" if total >= 0 else "-"
        total = abs(total)
        zone = v.tzname() or "UTC"
        if zone in ("UTC+00:00", "+00:00"):
            zone = "UTC"
        return (f"{v:%Y-%m-%d %H:%M:%S}{frac} "
                f"{sign}{total // 3600:02d}{total % 3600 // 60:02d} {zone}")
    return str(v)


class _Engine:
    def __init__(self, data):
        self.root = data

    def render(self, nodes: list[_Node], dot, scope: dict) -> str:
        out = []
        for n in nodes:
            if isinstance(n, _Text):
                out.append(n.s)
            elif isinstance(n, _Action):
                v = self.eval_pipeline(n.expr, dot, scope)
                if v is None:
                    pass
                elif v is True or v is False:
                    out.append("true" if v else "false")
                else:
                    out.append(_go_str(v))
            elif isinstance(n, _Assign):
                val = self.eval_pipeline(n.expr, dot, scope)
                if not n.declare and n.var in scope:
                    scope[n.var][0] = val
                else:
                    scope[n.var] = [val]
            elif isinstance(n, _If):
                done = False
                for cond, b in n.branches:
                    if _truthy(self.eval_pipeline(cond, dot, scope)):
                        out.append(self.render(b, dot, dict(scope)))
                        done = True
                        break
                if not done and n.else_body:
                    out.append(self.render(n.else_body, dot, dict(scope)))
            elif isinstance(n, _Range):
                coll = self.eval_pipeline(n.expr, dot, scope)
                items = []
                if isinstance(coll, dict):
                    items = list(coll.items())
                elif coll:
                    items = list(enumerate(coll))
                if not items and n.else_body:
                    out.append(self.render(n.else_body, dot, dict(scope)))
                for i, v in items:
                    inner = dict(scope)
                    if n.ivar:
                        inner[n.ivar] = [i]
                    if n.vvar:
                        inner[n.vvar] = [v]
                    out.append(self.render(n.body, v, inner))
        return "".join(out)

    def eval_pipeline(self, expr: str, dot, scope: dict):
        parts = self._split_pipes(expr)
        val = self.eval_command(parts[0], dot, scope, piped=_NOPIPE)
        for p in parts[1:]:
            val = self.eval_command(p, dot, scope, piped=val)
        return val

    @staticmethod
    def _split_pipes(expr: str) -> list[str]:
        out, buf, depth, q = [], [], 0, None
        for ch in expr:
            if q:
                buf.append(ch)
                if ch == q:
                    q = None
            elif ch in "\"`":
                q = ch
                buf.append(ch)
            elif ch == "(":
                depth += 1
                buf.append(ch)
            elif ch == ")":
                depth -= 1
                buf.append(ch)
            elif ch == "|" and depth == 0:
                out.append("".join(buf).strip())
                buf = []
            else:
                buf.append(ch)
        out.append("".join(buf).strip())
        return out

    def eval_command(self, cmd: str, dot, scope, piped):
        args = _split_args(cmd)
        if not args:
            return None if piped is _NOPIPE else piped
        head, rest = args[0], args[1:]
        if head in _FUNCS:
            vals = [self.eval_atom(a, dot, scope) for a in rest]
            if piped is not _NOPIPE:
                vals.append(piped)  # Go: piped value becomes the last arg
            try:
                return _FUNCS[head](*vals)
            except Exception as exc:
                # Go text/template fails loudly on function errors
                raise ValueError(
                    f"template: error calling {head!r}: {exc}"
                ) from exc
        # Go text/template errors on undefined functions at parse time;
        # mirror that instead of silently passing the value through
        if (re.fullmatch(r"[A-Za-z_]\w*", head)
                and head not in ("true", "false", "nil")):
            raise ValueError(f"template: function {head!r} not defined")
        return self.eval_atom(head, dot, scope)

    def eval_atom(self, atom: str, dot, scope):
        atom = atom.strip()
        if not atom:
            return None
        if atom.startswith("("):
            # find the matching close paren: "(expr)" or "(expr).Field"
            # (Go: a parenthesized pipeline is an operand and accepts
            # field chains, e.g. (index .CVSS "nvd").V3Score)
            depth, q = 0, None
            close = -1
            for i, ch in enumerate(atom):
                if q:
                    if ch == q:
                        q = None
                elif ch in "\"`":
                    q = ch
                elif ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
                    if depth == 0:
                        close = i
                        break
            if close == len(atom) - 1:
                return self.eval_pipeline(atom[1:-1], dot, scope)
            if close > 0 and atom[close + 1] == ".":
                inner = self.eval_pipeline(atom[1:close], dot, scope)
                return _walk(inner, atom[close + 2:])
        m = _STR.fullmatch(atom)
        if m:
            s = m.group(1) if m.group(1) is not None else m.group(2)
            return s.replace('\\"', '"').replace("\\n", "\n").replace(
                "\\t", "\t").replace("\\\\", "\\")
        if re.fullmatch(r"-?\d+", atom):
            return int(atom)
        if re.fullmatch(r"-?\d+\.\d+", atom):
            return float(atom)
        if atom == "true":
            return True
        if atom == "false":
            return False
        if atom == "nil":
            return None
        if atom.startswith("$"):
            var, _, path = atom.partition(".")
            cell = scope.get(var)  # every scope entry is a [value] cell
            base = cell[0] if cell is not None else None
            return _walk(base, path) if path else base
        if atom == ".":
            return dot
        if atom.startswith("."):
            return _walk(dot, atom[1:])
        if atom in _FUNCS:
            try:
                return _FUNCS[atom]()
            except Exception:
                return None
        return None


def _walk(base, path: str):
    cur = base
    for part in path.split("."):
        if not part:
            continue
        if cur is None:
            return None
        if isinstance(cur, dict):
            cur = cur.get(part)
        elif isinstance(cur, (list, tuple)) and part.isdigit():
            i = int(part)
            cur = cur[i] if i < len(cur) else None
        else:
            cur = getattr(cur, part, None)
    return cur


def render_template_str(tpl: str, data) -> str:
    nodes, _, _ = _parse(_lex(tpl))
    # Go text/template predefines $ as the root data value; seed the cell
    # so $ / $.Field resolve inside range blocks
    return _Engine(data).render(nodes, data, {"$": [data]})


# ------------------------------------------------------------ builtins

_BUILTIN = {
    "junit.tpl": """<?xml version="1.0" ?>
<testsuites>
{{- range . }}
    <testsuite tests="{{ len .Vulnerabilities }}" failures="{{ len .Vulnerabilities }}" name="{{ .Target | escapeXML }}" errors="0" skipped="0" time="">
    {{- range .Vulnerabilities }}
        <testcase classname="{{ .PkgName | escapeXML }}-{{ .InstalledVersion | escapeXML }}" name="[{{ .Severity }}] {{ .VulnerabilityID }}" time="">
            <failure message="{{ .Title | escapeXML }}" type="description">{{ .Description | abbrev 512 | escapeXML }}</failure>
        </testcase>
    {{- end }}
    </testsuite>
{{- end }}
</testsuites>
""",
    "gitlab-codequality.tpl": """[
{{- $first := true }}
{{- range . }}
{{- $target := .Target }}
{{- range $v := .Vulnerabilities }}
{{- if $first }}{{ $first = false }}{{ else }},{{ end }}
  {
    "type": "issue",
    "check_name": "container_scanning",
    "description": {{ printf "%s - %s" $v.VulnerabilityID $v.Title | toJson }},
    "fingerprint": "{{ $v.VulnerabilityID }}-{{ $v.PkgName }}-{{ $v.InstalledVersion }}",
    "severity": "{{ if eq $v.Severity "CRITICAL" }}critical{{ else if eq $v.Severity "HIGH" }}major{{ else if eq $v.Severity "MEDIUM" }}minor{{ else }}info{{ end }}",
    "location": { "path": {{ $target | toJson }}, "lines": { "begin": 1 } }
  }
{{- end }}
{{- end }}
]
""",
    "html.tpl": """<!DOCTYPE html>
<html><head><title>trivy-tpu report</title>
<style>table{border-collapse:collapse}td,th{border:1px solid #999;padding:4px 8px}</style>
</head><body>
{{- range . }}
<h2>{{ .Target | escapeString }} ({{ .Type }})</h2>
{{- if .Vulnerabilities }}
<table><tr><th>ID</th><th>Severity</th><th>Package</th><th>Installed</th><th>Fixed</th><th>Title</th></tr>
{{- range .Vulnerabilities }}
<tr><td>{{ .VulnerabilityID }}</td><td>{{ .Severity }}</td><td>{{ .PkgName | escapeString }}</td><td>{{ .InstalledVersion | escapeString }}</td><td>{{ .FixedVersion | escapeString }}</td><td>{{ .Title | escapeString }}</td></tr>
{{- end }}
</table>
{{- else }}
<p>No vulnerabilities.</p>
{{- end }}
{{- end }}
</body></html>
""",
}


def _augment(report_dict: dict) -> dict:
    """Flatten vuln info fields to top level the way text/template sees
    the Go struct (Title/Description/Severity are embedded)."""
    for res in report_dict.get("Results", []):
        for v in res.get("Vulnerabilities", []):
            v.setdefault("Title", "")
            v.setdefault("Description", "")
            v.setdefault("Severity", "UNKNOWN")
            v.setdefault("FixedVersion", "")
            # Go's DetectedVulnerability embeds types.Vulnerability as a
            # named field that json inlines; templates address both forms
            # (contrib/junit.tpl uses .Vulnerability.Severity). A flat
            # COPY, not a self-reference: toJson over a vulnerability
            # must not hit a circular structure.
            v.setdefault("Vulnerability", dict(v))
        res.setdefault("Vulnerabilities", [])
        res.setdefault("Misconfigurations", [])
        res.setdefault("Secrets", [])
        res.setdefault("Type", "")
    report_dict.setdefault("Results", [])
    return report_dict


def render_template(report: Report, template: str) -> str:
    """template: inline text, "@/path/to/file.tpl", or a builtin name
    ("@contrib/junit.tpl", "@builtin/html.tpl", "junit")."""
    tpl = template
    if template.startswith("@"):
        path = template[1:]
        base = os.path.basename(path)
        if base in _BUILTIN and not os.path.exists(path):
            tpl = _BUILTIN[base]
        else:
            # newline="" keeps CRLF template bytes intact (Go renders
            # them verbatim; gitlab-codequality.tpl ships with CRLF)
            with open(path, encoding="utf-8", newline="") as f:
                tpl = f.read()
    elif template in _BUILTIN:
        tpl = _BUILTIN[template]
    elif template + ".tpl" in _BUILTIN:
        tpl = _BUILTIN[template + ".tpl"]
    data = _augment(report.to_dict())
    # the template root is the RESULTS slice, exactly like the reference
    # template writer (report/template.go passes report.Results), so
    # published trivy templates (contrib/*.tpl) render unmodified
    return render_template_str(tpl, data.get("Results") or [])
