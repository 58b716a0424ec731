"""Helm chart rendering (reference pkg/iac/scanners/helm: renders charts
through the helm engine, then scans the output as kubernetes YAML).

This is a self-contained Go-template-subset engine: actions, pipelines,
if/else/with/range/define/include, the sprig helpers charts actually use
(default, quote, indent/nindent, toYaml, trunc, trimSuffix, printf, eq,
...). Anything unresolvable renders as the empty string — same spirit as
the reference's lenient scanning mode, where a value that can't be
resolved must not kill the scan.

Copy of trivy_tpu/iac/helm.py, whole.
"""

from __future__ import annotations

import base64
import json
import os
import re
from dataclasses import dataclass, field

import yaml

# ------------------------------------------------------------ AST


@dataclass
class _Text:
    text: str


@dataclass
class _Action:
    expr: str


@dataclass
class _Block:
    kind: str                   # if / with / range / define
    expr: str
    body: list = field(default_factory=list)
    # for if: list of (expr|None, body) else-if chains; for others: else body
    branches: list = field(default_factory=list)


_TOKEN_RX = re.compile(r"\{\{(-?)\s*(.*?)\s*(-?)\}\}", re.S)


def _tokenize(src: str) -> list:
    """-> [('text', str) | ('action', str)] with {{- -}} trimming applied."""
    out = []
    pos = 0
    pending_trim = False
    for m in _TOKEN_RX.finditer(src):
        text = src[pos:m.start()]
        if pending_trim:
            text = text.lstrip()
        if m.group(1) == "-":
            text = text.rstrip()
        if text:
            out.append(("text", text))
        out.append(("action", m.group(2)))
        pending_trim = m.group(3) == "-"
        pos = m.end()
    tail = src[pos:]
    if pending_trim:
        tail = tail.lstrip()
    if tail:
        out.append(("text", tail))
    return out


class TemplateError(Exception):
    pass


def _parse(tokens: list, pos: int = 0, in_block: bool = False):
    """-> (nodes, next_pos, terminator) where terminator is 'end'/'else'/
    ('else if', expr) or None at EOF."""
    nodes: list = []
    while pos < len(tokens):
        kind, val = tokens[pos]
        pos += 1
        if kind == "text":
            nodes.append(_Text(val))
            continue
        word = val.split(None, 1)[0] if val.split() else ""
        rest = val.split(None, 1)[1] if len(val.split(None, 1)) > 1 else ""
        if word == "end":
            if not in_block:
                raise TemplateError("unexpected end")
            return nodes, pos, "end"
        if word == "else":
            if not in_block:
                raise TemplateError("unexpected else")
            if rest.startswith("if"):
                return nodes, pos, ("elseif", rest[2:].strip())
            return nodes, pos, "else"
        if word in ("if", "with", "range", "define", "block"):
            blk = _Block(kind="define" if word == "block" else word,
                         expr=rest.strip().strip('"')
                         if word in ("define", "block") else rest)
            body, pos, term = _parse(tokens, pos, True)
            blk.body = body
            while term not in ("end", None):
                if term == "else":
                    els, pos, term2 = _parse(tokens, pos, True)
                    blk.branches.append((None, els))
                    term = term2
                else:  # ('elseif', expr)
                    els, pos, term2 = _parse(tokens, pos, True)
                    blk.branches.append((term[1], els))
                    term = term2
            nodes.append(blk)
            continue
        if word == "template":
            # {{ template "name" ctx }} == include without pipelining
            nodes.append(_Action(f"include {rest}"))
            continue
        if word in ("/*", "comment"):  # comments {{/* ... */}}
            continue
        if val.startswith("/*"):
            continue
        nodes.append(_Action(val))
    return nodes, pos, None


# ------------------------------------------------------------ expressions


_WORD_RX = re.compile(
    r'"(?:[^"\\]|\\.)*"|`[^`]*`|\((?:[^()]|\([^()]*\))*\)|[^\s|]+'
)


def _truthy(v) -> bool:
    if v is None or v is False:
        return False
    if isinstance(v, (int, float)) and v == 0:
        return False
    if isinstance(v, (str, list, dict, tuple)) and len(v) == 0:
        return False
    return True


class _Engine:
    def __init__(self, defines: dict[str, list], root_ctx: dict):
        self.defines = defines
        self.root = root_ctx

    # -------------------------------------------------- render

    def render(self, nodes: list, dot, vars_: dict | None = None) -> str:
        vars_ = dict(vars_ or {})
        out = []
        for n in nodes:
            if isinstance(n, _Text):
                out.append(n.text)
            elif isinstance(n, _Action):
                expr = n.expr
                if expr.startswith("$") and ":=" in expr:
                    name, _, rhs = expr.partition(":=")
                    vars_[name.strip().lstrip("$")] = self.eval(
                        rhs.strip(), dot, vars_)
                    continue
                v = self.eval(expr, dot, vars_)
                out.append(self._fmt(v))
            elif isinstance(n, _Block):
                out.append(self._render_block(n, dot, vars_))
        return "".join(out)

    def _render_block(self, blk: _Block, dot, vars_: dict) -> str:
        if blk.kind == "define":
            self.defines[blk.expr] = blk.body
            return ""
        if blk.kind == "if":
            if _truthy(self.eval(blk.expr, dot, vars_)):
                return self.render(blk.body, dot, vars_)
            for cond, body in blk.branches:
                if cond is None or _truthy(self.eval(cond, dot, vars_)):
                    return self.render(body, dot, vars_)
            return ""
        if blk.kind == "with":
            v = self.eval(blk.expr, dot, vars_)
            if _truthy(v):
                return self.render(blk.body, v, vars_)
            for cond, body in blk.branches:
                if cond is None:
                    return self.render(body, dot, vars_)
            return ""
        if blk.kind == "range":
            expr = blk.expr
            kv_names: list[str] = []
            if ":=" in expr:
                names, _, expr = expr.partition(":=")
                kv_names = [x.strip().lstrip("$")
                            for x in names.split(",")]
            coll = self.eval(expr.strip(), dot, vars_)
            chunks = []
            if isinstance(coll, dict):
                items = list(coll.items())
            elif isinstance(coll, (list, tuple)):
                items = list(enumerate(coll))
            else:
                items = []
            for k, v in items:
                inner = dict(vars_)
                if len(kv_names) == 2:
                    inner[kv_names[0]], inner[kv_names[1]] = k, v
                elif len(kv_names) == 1:
                    inner[kv_names[0]] = v
                chunks.append(self.render(blk.body, v, inner))
            if not items:
                for cond, body in blk.branches:
                    if cond is None:
                        return self.render(body, dot, vars_)
            return "".join(chunks)
        return ""

    @staticmethod
    def _fmt(v) -> str:
        if v is None:
            return ""
        if v is True:
            return "true"
        if v is False:
            return "false"
        if isinstance(v, float) and v.is_integer():
            return str(int(v))
        return str(v)

    # -------------------------------------------------- eval

    def eval(self, expr: str, dot, vars_: dict):
        try:
            segments = self._split_pipeline(expr)
            value = _NOVAL
            for seg in segments:
                value = self._eval_command(seg, dot, vars_, value)
            return None if value is _NOVAL else value
        except Exception:
            return None

    @staticmethod
    def _split_pipeline(expr: str) -> list[str]:
        out, depth, cur, q = [], 0, [], None
        for ch in expr:
            if q:
                cur.append(ch)
                if ch == q:
                    q = None
                continue
            if ch in "\"`":
                q = ch
                cur.append(ch)
            elif ch == "(":
                depth += 1
                cur.append(ch)
            elif ch == ")":
                depth -= 1
                cur.append(ch)
            elif ch == "|" and depth == 0:
                out.append("".join(cur).strip())
                cur = []
            else:
                cur.append(ch)
        out.append("".join(cur).strip())
        return [s for s in out if s]

    def _eval_command(self, seg: str, dot, vars_: dict, piped):
        words = _WORD_RX.findall(seg)
        if not words:
            return piped
        head, args = words[0], words[1:]
        if head in _FUNCS or head == "include":
            vals = [self._eval_primary(a, dot, vars_) for a in args]
            if piped is not _NOVAL:
                vals.append(piped)
            if head == "include":
                return self._include(vals)
            return _FUNCS[head](self, vals)
        # plain value (possibly with index-style path); pipe ignores extras
        return self._eval_primary(head, dot, vars_)

    def _include(self, vals):
        if len(vals) < 1:
            return ""
        name = vals[0]
        ctx = vals[1] if len(vals) > 1 else self.root
        body = self.defines.get(str(name))
        if body is None:
            return ""
        return self.render(body, ctx)

    def _eval_primary(self, tok: str, dot, vars_: dict):
        if tok.startswith("(") and tok.endswith(")"):
            return self.eval(tok[1:-1], dot, vars_)
        if tok.startswith('"') and tok.endswith('"'):
            return tok[1:-1].replace('\\"', '"').replace("\\\\", "\\") \
                .replace("\\n", "\n").replace("\\t", "\t")
        if tok.startswith("`") and tok.endswith("`"):
            return tok[1:-1]
        if tok in ("true", "false"):
            return tok == "true"
        if tok in ("nil", "null"):
            return None
        if re.fullmatch(r"-?\d+", tok):
            return int(tok)
        if re.fullmatch(r"-?\d+\.\d+", tok):
            return float(tok)
        if tok == ".":
            return dot
        if tok == "$":
            return self.root
        if tok.startswith("$"):
            path = tok[1:].split(".")
            base = vars_.get(path[0], self.root if path[0] == "" else None)
            return _walk(base, [p for p in path[1:] if p])
        if tok.startswith("."):
            parts = [p for p in tok[1:].split(".") if p]
            # .Values/.Chart/.Release resolve from the root context even
            # when dot is rebound (helm always exposes them via $, and
            # charts overwhelmingly use the absolute spelling)
            if parts and parts[0] in ("Values", "Chart", "Release",
                                      "Capabilities", "Template", "Files"):
                return _walk(self.root, parts)
            return _walk(dot, parts)
        return None


_NOVAL = object()


def _walk(base, parts: list[str]):
    cur = base
    for p in parts:
        if isinstance(cur, dict):
            cur = cur.get(p)
        elif isinstance(cur, (list, tuple)) and p.isdigit():
            i = int(p)
            cur = cur[i] if i < len(cur) else None
        else:
            return None
    return cur


# ------------------------------------------------------------ functions


def _to_yaml(v) -> str:
    return yaml.safe_dump(v, default_flow_style=False).rstrip("\n") \
        if v is not None else ""


def _indent(n, s) -> str:
    pad = " " * int(n)
    return "\n".join(pad + line for line in str(s).splitlines())


def _go_printf(fmt, *args) -> str:
    py = re.sub(r"%[-+ #0-9.]*[vs]", "%s", str(fmt))
    py = re.sub(r"%[-+ #0-9.]*d", "%d", py)
    try:
        return py % tuple(args)
    except TypeError:
        return str(fmt)


_FUNCS = {
    "default": lambda e, a: a[1] if len(a) > 1 and _truthy(a[1]) else a[0],
    "quote": lambda e, a: '"%s"' % _Engine._fmt(a[0]) if a else '""',
    "squote": lambda e, a: "'%s'" % _Engine._fmt(a[0]) if a else "''",
    "upper": lambda e, a: str(a[0]).upper(),
    "lower": lambda e, a: str(a[0]).lower(),
    "title": lambda e, a: str(a[0]).title(),
    "trim": lambda e, a: str(a[0]).strip(),
    "trimSuffix": lambda e, a: str(a[1]).removesuffix(str(a[0])),
    "trimPrefix": lambda e, a: str(a[1]).removeprefix(str(a[0])),
    "trunc": lambda e, a: str(a[1])[: int(a[0])] if int(a[0]) >= 0
    else str(a[1])[int(a[0]):],
    "replace": lambda e, a: str(a[2]).replace(str(a[0]), str(a[1])),
    "contains": lambda e, a: str(a[0]) in str(a[1]),
    "hasPrefix": lambda e, a: str(a[1]).startswith(str(a[0])),
    "hasSuffix": lambda e, a: str(a[1]).endswith(str(a[0])),
    "indent": lambda e, a: _indent(a[0], a[1]),
    "nindent": lambda e, a: "\n" + _indent(a[0], a[1]),
    "toYaml": lambda e, a: _to_yaml(a[0]),
    "toJson": lambda e, a: json.dumps(a[0]),
    "fromYaml": lambda e, a: yaml.safe_load(str(a[0])) or {},
    "b64enc": lambda e, a: base64.b64encode(str(a[0]).encode()).decode(),
    "b64dec": lambda e, a: base64.b64decode(str(a[0])).decode("utf-8",
                                                              "replace"),
    "required": lambda e, a: a[1] if len(a) > 1 else None,
    "coalesce": lambda e, a: next((x for x in a if _truthy(x)), None),
    "ternary": lambda e, a: a[0] if _truthy(a[2]) else a[1],
    "empty": lambda e, a: not _truthy(a[0]),
    "not": lambda e, a: not _truthy(a[0]),
    "and": lambda e, a: next((x for x in a if not _truthy(x)), a[-1] if a
                             else None),
    "or": lambda e, a: next((x for x in a if _truthy(x)), a[-1] if a
                            else None),
    "eq": lambda e, a: all(x == a[0] for x in a[1:]),
    "ne": lambda e, a: len(a) > 1 and a[0] != a[1],
    "lt": lambda e, a: a[0] < a[1],
    "le": lambda e, a: a[0] <= a[1],
    "gt": lambda e, a: a[0] > a[1],
    "ge": lambda e, a: a[0] >= a[1],
    "add": lambda e, a: sum(int(x) for x in a),
    "sub": lambda e, a: int(a[0]) - int(a[1]),
    "mul": lambda e, a: int(a[0]) * int(a[1]),
    "div": lambda e, a: int(a[0]) // int(a[1]) if int(a[1]) else 0,
    "len": lambda e, a: len(a[0]) if a[0] is not None else 0,
    "list": lambda e, a: list(a),
    "dict": lambda e, a: {str(a[i]): a[i + 1]
                          for i in range(0, len(a) - 1, 2)},
    "get": lambda e, a: (a[0] or {}).get(str(a[1])),
    "hasKey": lambda e, a: isinstance(a[0], dict) and str(a[1]) in a[0],
    "keys": lambda e, a: list((a[0] or {}).keys()),
    "first": lambda e, a: a[0][0] if a[0] else None,
    "last": lambda e, a: a[0][-1] if a[0] else None,
    "join": lambda e, a: str(a[0]).join(str(x) for x in (a[1] or [])),
    "split": lambda e, a: dict(enumerate(str(a[1]).split(str(a[0])))),
    "splitList": lambda e, a: str(a[1]).split(str(a[0])),
    "printf": lambda e, a: _go_printf(*a),
    "print": lambda e, a: "".join(_Engine._fmt(x) for x in a),
    "lookup": lambda e, a: {},
    "tpl": lambda e, a: e.render(
        _parse(_tokenize(str(a[0])))[0],
        a[1] if len(a) > 1 else e.root),
    "int": lambda e, a: int(float(a[0])) if a and a[0] is not None else 0,
    "toString": lambda e, a: _Engine._fmt(a[0]),
    "kindIs": lambda e, a: {"map": dict, "slice": list, "string": str,
                            "bool": bool, "int": int}.get(
        str(a[0]), object) is type(a[1]),
    "semverCompare": lambda e, a: True,
    "include": None,  # handled specially (needs engine recursion)
}
del _FUNCS["include"]


# ------------------------------------------------------------ chart API


DEFAULT_RELEASE = {
    "Name": "release-name", "Namespace": "default", "Service": "Helm",
    "IsInstall": True, "IsUpgrade": False, "Revision": 1,
}


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def find_chart_roots(paths) -> list[str]:
    """Every directory containing a Chart.yaml. Each chart (including
    charts/ subcharts and unrelated nested charts) renders independently:
    render_chart only consumes a root's own templates/, so there is no
    double-rendering. Independent rendering of subcharts approximates
    helm's parent-merged values with the subchart's own values.yaml."""
    return sorted(
        os.path.dirname(p) for p in paths
        if os.path.basename(p) == "Chart.yaml"
    )


def render_chart(files: dict[str, bytes],
                 value_overrides: dict | None = None,
                 ) -> list[tuple[str, bytes]]:
    """files: chart-root-relative path -> content. Returns
    [(template_path, rendered_yaml_bytes)] for scannable outputs."""
    chart_meta = {}
    if "Chart.yaml" in files:
        try:
            chart_meta = yaml.safe_load(files["Chart.yaml"]) or {}
        except yaml.YAMLError:
            chart_meta = {}
    values = {}
    if "values.yaml" in files:
        try:
            values = yaml.safe_load(files["values.yaml"]) or {}
        except yaml.YAMLError:
            values = {}
    if value_overrides:
        values = _deep_merge(values, value_overrides)

    root_ctx = {
        "Values": values,
        "Chart": {
            "Name": chart_meta.get("name", ""),
            "Version": chart_meta.get("version", ""),
            "AppVersion": chart_meta.get("appVersion", ""),
            "Description": chart_meta.get("description", ""),
        },
        "Release": dict(DEFAULT_RELEASE),
        "Capabilities": {
            "KubeVersion": {"Version": "v1.29.0", "Major": "1",
                            "Minor": "29"},
            "APIVersions": [],
        },
        "Template": {"Name": "", "BasePath": "templates"},
    }

    engine = _Engine(defines={}, root_ctx=root_ctx)
    template_files = {
        p: c for p, c in files.items()
        if p.startswith("templates/") and p.endswith((".yaml", ".yml",
                                                      ".tpl", ".txt"))
    }
    # pass 1: collect defines from every template (helpers first)
    parsed: dict[str, list] = {}
    for p in sorted(template_files,
                    key=lambda x: (not os.path.basename(x).startswith("_"),
                                   x)):
        try:
            nodes, _, _ = _parse(_tokenize(
                template_files[p].decode("utf-8", "replace")))
        except TemplateError:
            continue
        parsed[p] = nodes
        engine.render([n for n in nodes if isinstance(n, _Block)
                       and n.kind == "define"], root_ctx)

    out = []
    for p, nodes in sorted(parsed.items()):
        base = os.path.basename(p)
        if base.startswith("_") or base == "NOTES.txt":
            continue
        root_ctx["Template"]["Name"] = p
        try:
            text = engine.render(nodes, root_ctx)
        except Exception:
            continue
        if text.strip():
            out.append((p, text.encode()))
    return out
