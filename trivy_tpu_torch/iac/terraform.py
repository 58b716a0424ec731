"""Terraform evaluation: expressions, core functions, locals/variables,
count/for_each expansion, and module calls (reference pkg/iac/terraform +
pkg/iac/scanners/terraform — rebuilt as a compact fixpoint evaluator
instead of the reference's full HCL graph machinery).

The evaluator consumes the Block IR from iac.parsers.hcl. Expressions the
parser kept opaque (`Expr`) are evaluated against a module scope built
from variable defaults + caller inputs, locals, resources, data blocks,
and child-module outputs. Anything unresolvable (computed attributes like
`arn`, providers we don't model, unsupported syntax) evaluates to UNKNOWN
and propagates — a check sees the original opaque Expr rather than a
wrong literal, so evaluation can only add signal, never corrupt it.

Evaluation runs a bounded number of passes over locals/modules until the
scope stops changing (the reference orders a reference graph; a fixpoint
over the small per-module scope reaches the same result without the
graph plumbing).

Copy of trivy_tpu/iac/terraform.py, whole.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field

from trivy_tpu_torch.iac.parsers.hcl import (
    Attribute,
    Block,
    Expr,
    parse_hcl,
    parse_tf_json,
)
from trivy_tpu_torch.log import logger

_log = logger("terraform")

MAX_PASSES = 8
MAX_MODULE_DEPTH = 6
MAX_EXPANSION = 256  # count/for_each clone cap per block


class _Unknown:
    """Unresolvable value; any operation on it stays unknown."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "UNKNOWN"

    def __bool__(self):
        return False


UNKNOWN = _Unknown()


def _is_unknown(v) -> bool:
    return v is UNKNOWN


# ------------------------------------------------------------ functions


def _fn_lookup(m, key, default=UNKNOWN):
    if _is_unknown(m) or not isinstance(m, dict):
        return UNKNOWN
    return m.get(key, default)


def _fn_format(fmt, *args):
    if _is_unknown(fmt) or any(_is_unknown(a) for a in args):
        return UNKNOWN
    out = []
    i = 0
    ai = 0
    s = str(fmt)
    while i < len(s):
        ch = s[i]
        if ch == "%" and i + 1 < len(s):
            spec = s[i + 1]
            if spec == "%":
                out.append("%")
            elif spec in "sdvq":
                a = args[ai] if ai < len(args) else ""
                ai += 1
                if spec == "q":
                    out.append(json.dumps(_to_str(a)))
                elif spec == "d":
                    try:
                        out.append(str(int(a)))
                    except (TypeError, ValueError):
                        return UNKNOWN
                else:
                    out.append(_to_str(a))
            else:
                out.append(ch + spec)
            i += 2
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def _to_str(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return ""
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


class TfSet(list):
    """List subclass marking a terraform set value: iteration contexts
    that distinguish sets from lists (dynamic-block for_each exposes
    key == value for sets but key == index for lists/tuples) check for
    this marker. Everywhere else it behaves as the plain list the rest
    of the evaluator expects."""


def _guard(fn):
    """Wrap a function so UNKNOWN arguments yield UNKNOWN."""

    def wrapped(*args):
        if any(_is_unknown(a) for a in args):
            return UNKNOWN
        try:
            return fn(*args)
        except Exception:
            return UNKNOWN

    return wrapped


FUNCTIONS: dict[str, object] = {
    "lower": _guard(lambda s: str(s).lower()),
    "upper": _guard(lambda s: str(s).upper()),
    "title": _guard(lambda s: str(s).title()),
    "trimspace": _guard(lambda s: str(s).strip()),
    "trimprefix": _guard(lambda s, p: str(s).removeprefix(str(p))),
    "trimsuffix": _guard(lambda s, p: str(s).removesuffix(str(p))),
    "trim": _guard(lambda s, cut: str(s).strip(str(cut))),
    "replace": _guard(lambda s, a, b: str(s).replace(str(a), str(b))),
    "split": _guard(lambda sep, s: str(s).split(str(sep))),
    "join": _guard(lambda sep, xs: str(sep).join(_to_str(x) for x in xs)),
    "substr": _guard(lambda s, off, n: str(s)[int(off):]
                     if int(n) < 0 else str(s)[int(off):int(off) + int(n)]),
    "format": _fn_format,
    "length": _guard(len),
    "concat": _guard(lambda *ls: [x for sub in ls for x in sub]),
    "contains": _guard(lambda xs, v: v in xs),
    "element": _guard(lambda xs, i: xs[int(i) % len(xs)]),
    "index": _guard(lambda xs, v: list(xs).index(v)),
    "keys": _guard(lambda m: sorted(m.keys())),
    "values": _guard(lambda m: [m[k] for k in sorted(m.keys())]),
    "lookup": _fn_lookup,
    "merge": _guard(lambda *ms: {k: v for m in ms if isinstance(m, dict)
                                 for k, v in m.items()}),
    "flatten": _guard(lambda xs: _flatten(xs)),
    "distinct": _guard(lambda xs: list(dict.fromkeys(xs))),
    "compact": _guard(lambda xs: [x for x in xs if x not in ("", None)]),
    "coalesce": lambda *xs: next(
        (x for x in xs if not _is_unknown(x) and x not in (None, "")),
        UNKNOWN),
    "coalescelist": lambda *xs: next(
        (x for x in xs if not _is_unknown(x) and x), UNKNOWN),
    "tostring": _guard(_to_str),
    "tonumber": _guard(lambda v: float(v) if "." in str(v) else int(v)),
    "tobool": _guard(lambda v: v if isinstance(v, bool)
                     else str(v).lower() == "true"),
    "tolist": _guard(list),
    "toset": _guard(lambda xs: TfSet(dict.fromkeys(xs))),
    "max": _guard(max),
    "min": _guard(min),
    "abs": _guard(abs),
    "ceil": _guard(lambda v: -(-int(v) // 1) if float(v).is_integer()
                   else int(float(v)) + 1),
    "floor": _guard(lambda v: int(float(v) // 1)),
    "jsonencode": _guard(lambda v: json.dumps(v, separators=(",", ":"))),
    "jsondecode": _guard(lambda s: json.loads(s)),
    "base64encode": _guard(
        lambda s: __import__("base64").b64encode(
            str(s).encode()).decode()),
    "base64decode": _guard(
        lambda s: __import__("base64").b64decode(str(s)).decode()),
    "startswith": _guard(lambda s, p: str(s).startswith(str(p))),
    "endswith": _guard(lambda s, p: str(s).endswith(str(p))),
}


def _flatten(xs):
    out = []
    for x in xs:
        if isinstance(x, list):
            out.extend(_flatten(x))
        else:
            out.append(x)
    return out


# ------------------------------------------------------ expression eval

_EXPR_TOKEN = re.compile(r"""
    (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<number>\d+(?:\.\d+)?)
  | (?P<op>==|!=|<=|>=|&&|\|\||[-+*/%<>!?:()\[\]{},.=])
  | (?P<ident>[A-Za-z_][A-Za-z0-9_-]*)
  | (?P<ws>\s+)
""", re.X)


def _lex(text: str) -> list[tuple[str, str]]:
    toks = []
    pos = 0
    while pos < len(text):
        m = _EXPR_TOKEN.match(text, pos)
        if not m:
            raise ValueError(f"bad token at {text[pos:pos+10]!r}")
        if m.lastgroup != "ws":
            toks.append((m.lastgroup, m.group(0)))
        pos = m.end()
    toks.append(("eof", ""))
    return toks


_BINARY = {
    "||": 1, "&&": 2,
    "==": 3, "!=": 3,
    "<": 4, ">": 4, "<=": 4, ">=": 4,
    "+": 5, "-": 5,
    "*": 6, "/": 6, "%": 6,
}


class _ExprParser:
    def __init__(self, toks, scope: "Scope"):
        self.toks = toks
        self.i = 0
        self.scope = scope

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text):
        t = self.next()
        if t[1] != text:
            raise ValueError(f"expected {text!r}, got {t[1]!r}")

    def parse(self, min_prec=0):
        left = self.parse_unary()
        while True:
            kind, text = self.peek()
            if text == "?" and min_prec == 0:
                self.next()
                then = self.parse()
                self.expect(":")
                other = self.parse()
                cond = left
                if _is_unknown(cond):
                    return UNKNOWN
                return then if _truthy(cond) else other
            prec = _BINARY.get(text)
            if prec is None or prec < min_prec:
                return left
            self.next()
            right = self.parse(prec + 1)
            left = _binop(text, left, right)

    def parse_unary(self):
        kind, text = self.peek()
        if text == "!":
            self.next()
            v = self.parse_unary()
            return UNKNOWN if _is_unknown(v) else not _truthy(v)
        if text == "-":
            self.next()
            v = self.parse_unary()
            try:
                return UNKNOWN if _is_unknown(v) else -v
            except TypeError:
                return UNKNOWN
        return self.parse_postfix()

    def parse_postfix(self):
        v = self.parse_primary()
        while True:
            kind, text = self.peek()
            if text == ".":
                self.next()
                attr = self.next()[1]
                v = _access(v, attr)
            elif text == "[":
                self.next()
                idx = self.parse()
                self.expect("]")
                v = _access(v, idx)
            else:
                return v

    def parse_primary(self):
        kind, text = self.next()
        if kind == "string":
            raw = text[1:-1]
            return _interp(raw, self.scope)
        if kind == "number":
            return float(text) if "." in text else int(text)
        if text == "(":
            v = self.parse()
            self.expect(")")
            return v
        if text == "[":
            items = []
            while self.peek()[1] != "]":
                items.append(self.parse())
                if self.peek()[1] == ",":
                    self.next()
            self.next()
            return UNKNOWN if any(_is_unknown(i) for i in items) else items
        if text == "{":
            obj = {}
            unknown = False
            while self.peek()[1] != "}":
                # naked identifier keys are literal strings in HCL
                if self.peek()[0] == "ident" and \
                        self.toks[self.i + 1][1] in (":", "="):
                    k = self.next()[1]
                else:
                    k = self.parse()
                if self.peek()[1] in (":", "="):
                    self.next()
                val = self.parse()
                if _is_unknown(k):
                    unknown = True
                else:
                    obj[_to_str(k)] = val
                if self.peek()[1] == ",":
                    self.next()
            self.next()
            return UNKNOWN if unknown else obj
        if kind == "ident":
            if text == "true":
                return True
            if text == "false":
                return False
            if text == "null":
                return None
            if self.peek()[1] == "(":
                return self.call(text)
            return self.reference(text)
        raise ValueError(f"unexpected {text!r}")

    def call(self, name):
        self.expect("(")
        args = []
        while self.peek()[1] != ")":
            args.append(self.parse())
            if self.peek()[1] == ",":
                self.next()
        self.next()
        if name == "try":
            return next((a for a in args if not _is_unknown(a)), UNKNOWN)
        if name == "can":
            return UNKNOWN if all(_is_unknown(a) for a in args) else True
        fn = FUNCTIONS.get(name)
        if fn is None:
            return UNKNOWN
        try:
            return fn(*args)
        except Exception:
            return UNKNOWN

    def reference(self, head):
        """Resolve a traversal starting at `head`; postfix handles the
        remaining .attr/[idx] parts, so only the root namespace is read
        here — except multi-part roots (var.x, resource refs) which need
        the following segments."""
        parts = [head]
        while self.peek()[1] == "." and \
                self.toks[self.i + 1][0] == "ident":
            # consume the traversal greedily; _access on the resolved
            # object would lose resource/namespace semantics
            self.next()
            parts.append(self.next()[1])
        v = self.scope.resolve(parts)
        return v


def _truthy(v) -> bool:
    if isinstance(v, str):
        return v == "true"
    return bool(v)


def _binop(op, a, b):
    if _is_unknown(a) or _is_unknown(b):
        return UNKNOWN
    try:
        if op == "||":
            return _truthy(a) or _truthy(b)
        if op == "&&":
            return _truthy(a) and _truthy(b)
        if op == "==":
            return a == b
        if op == "!=":
            return a != b
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return a / b
        if op == "%":
            return a % b
        if op == "<":
            return a < b
        if op == ">":
            return a > b
        if op == "<=":
            return a <= b
        if op == ">=":
            return a >= b
    except TypeError:
        return UNKNOWN
    return UNKNOWN


def _access(v, key):
    if _is_unknown(v) or _is_unknown(key):
        return UNKNOWN
    if isinstance(v, dict):
        return v.get(key, UNKNOWN)
    if isinstance(v, list):
        try:
            return v[int(key)]
        except (ValueError, IndexError, TypeError):
            return UNKNOWN
    if isinstance(v, Block):
        if isinstance(key, (int, float)) and not isinstance(key, bool):
            # res.name[N]: the registry holds the pre-expansion
            # prototype; any instance shares its literal attrs
            return v
        out = v.get(key, UNKNOWN)
        return out
    return UNKNOWN


_INTERP_RX = re.compile(r"\$\{([^{}]*)\}")


def _interp(raw: str, scope: "Scope"):
    """String with ${...} interpolations -> value. A string that is one
    single interpolation returns the inner value unconverted."""
    raw = raw.replace('\\"', '"')
    m = _INTERP_RX.fullmatch(raw)
    if m:
        return eval_expr(m.group(1), scope)
    unknown = False

    def sub(mm):
        nonlocal unknown
        v = eval_expr(mm.group(1), scope)
        if _is_unknown(v):
            unknown = True
            return ""
        return _to_str(v)

    out = _INTERP_RX.sub(sub, raw)
    return UNKNOWN if unknown else out


def eval_expr(text: str, scope: "Scope"):
    """Evaluate one expression string; UNKNOWN when unsupported."""
    try:
        toks = _lex(text)
        p = _ExprParser(toks, scope)
        v = p.parse()
        if p.peek()[0] != "eof":
            return UNKNOWN
        return v
    except Exception:
        return UNKNOWN


# ------------------------------------------------------------- scope


@dataclass
class Scope:
    variables: dict = field(default_factory=dict)
    locals: dict = field(default_factory=dict)
    modules: dict = field(default_factory=dict)  # name -> outputs dict
    resources: dict = field(default_factory=dict)  # "type.name" -> Block
    data: dict = field(default_factory=dict)  # "type.name" -> Block
    each: tuple | None = None  # (key, value)
    count_index: int | None = None
    # dynamic-block iterators in scope: name -> (key, value). The name
    # defaults to the dynamic block's label, overridable via `iterator`
    # (reference: hcl dynblock expansion in pkg/iac/scanners/terraform)
    iterators: dict = field(default_factory=dict)

    def resolve(self, parts: list[str]):
        head = parts[0]
        if head == "var":
            if len(parts) < 2:
                return UNKNOWN
            return _walk(self.variables.get(parts[1], UNKNOWN), parts[2:])
        if head == "local":
            if len(parts) < 2:
                return UNKNOWN
            return _walk(self.locals.get(parts[1], UNKNOWN), parts[2:])
        if head == "module":
            if len(parts) < 3:
                return UNKNOWN
            outs = self.modules.get(parts[1], UNKNOWN)
            return _walk(outs, parts[2:])
        if head == "each":
            if self.each is None or len(parts) < 2:
                return UNKNOWN
            return _walk(self.each[0] if parts[1] == "key"
                         else self.each[1] if parts[1] == "value"
                         else UNKNOWN, parts[2:])
        if head == "count":
            if self.count_index is None or parts[1:2] != ["index"]:
                return UNKNOWN
            return self.count_index
        if head in self.iterators:
            if len(parts) < 2:
                return UNKNOWN
            k, v = self.iterators[head]
            return _walk(k if parts[1] == "key"
                         else v if parts[1] == "value"
                         else UNKNOWN, parts[2:])
        if head == "data":
            if len(parts) < 3:
                return UNKNOWN
            blk = self.data.get(f"{parts[1]}.{parts[2]}")
            return _block_attr(blk, parts[3:], self)
        # resource reference: TYPE.NAME[.attr...]
        if len(parts) >= 2:
            blk = self.resources.get(f"{head}.{parts[1]}")
            return _block_attr(blk, parts[2:], self)
        return UNKNOWN


def _walk(v, rest):
    for r in rest:
        v = _access(v, r)
    return v


def _block_attr(blk, rest, scope):
    if blk is None:
        return UNKNOWN
    if not rest:
        return blk
    v = blk.get(rest[0], UNKNOWN)
    if isinstance(v, Expr):
        v = eval_expr(v.text, scope)
    return _walk(v, rest[1:])


# -------------------------------------------------------- module eval


@dataclass
class EvaluatedModule:
    """Evaluated blocks of one module tree, with per-block source paths."""

    blocks: list[Block]  # resource/data blocks, expanded + evaluated
    outputs: dict


class ModuleLoader:
    """Resolves module `source` directories against an in-memory file
    map {relpath: bytes} (the post-analyzer's virtual FS). Parsed blocks
    are cached per path — module_dirs and every (re-)evaluation share one
    parse per file. Cached blocks are treated as immutable (evaluation
    always copies before mutating)."""

    def __init__(self, files: dict[str, bytes]):
        self.files = files
        self._parsed: dict[str, list[Block]] = {}

    def parse_files(self, files: dict[str, bytes]) -> list[Block]:
        blocks: list[Block] = []
        for path in sorted(files):
            cached = self._parsed.get(path)
            if cached is None:
                cached = _parse_one(path, files[path])
                self._parsed[path] = cached
            blocks.extend(cached)
        return blocks

    def tf_files(self, dirname: str) -> dict[str, bytes]:
        out = {}
        prefix = dirname.rstrip("/") + "/" if dirname not in ("", ".") else ""
        for path, content in self.files.items():
            if not path.startswith(prefix):
                continue
            rel = path[len(prefix):]
            if "/" in rel:
                continue
            if rel.endswith((".tf", ".tf.json")):
                out[path] = content
        return out

    def has_dir(self, dirname: str) -> bool:
        return bool(self.tf_files(dirname))


def _parse_one(path: str, content: bytes) -> list[Block]:
    parse = parse_tf_json if path.endswith(".tf.json") else parse_hcl
    try:
        parsed = parse(content)
    except Exception as exc:
        _log.debug("tf parse failed", path=path, err=str(exc))
        return []
    for b in parsed:
        b.src_path = path
    return parsed


def _eval_value(v, scope: Scope):
    if isinstance(v, Expr):
        out = eval_expr(v.text, scope)
        return v if _is_unknown(out) else out  # keep opaque, never wrong
    if isinstance(v, str) and "${" in v:
        out = _interp(v, scope)
        return v if _is_unknown(out) else out
    if isinstance(v, list):
        return [_eval_value(x, scope) for x in v]
    if isinstance(v, dict):
        return {k: _eval_value(x, scope) for k, x in v.items()}
    return v


def _eval_block(blk: Block, scope: Scope) -> Block:
    out = Block(type=blk.type, labels=list(blk.labels),
                start_line=blk.start_line, end_line=blk.end_line)
    out.src_path = getattr(blk, "src_path", "")
    for name, attr in blk.attrs.items():
        out.attrs[name] = Attribute(name, _eval_value(attr.value, scope),
                                    attr.line)
    kids: list[Block] = []
    for b in blk.blocks:
        if b.type == "dynamic" and len(b.labels) == 1:
            kids.extend(_expand_dynamic(b, scope))
        else:
            kids.append(_eval_block(b, scope))
    out.blocks = kids
    return out


def _expand_dynamic(b: Block, scope: Scope) -> list[Block]:
    """`dynamic "L" { for_each = ...; content { ... } }` -> one block of
    type L per collection element, with the iterator (label or the
    `iterator` attr) resolving .key/.value inside content (reference:
    hcl dynblock expansion used by pkg/iac/scanners/terraform). An
    unresolvable for_each yields ONE instance whose iterator refs stay
    unknown — checks stay silent rather than wrong, matching the
    evaluator's general unresolved-value policy."""
    content = b.child("content")
    if content is None:
        return []
    label = b.labels[0]
    it_attr = b.attrs.get("iterator")
    it_name = label
    if it_attr is not None:
        v = it_attr.value
        # a bare identifier parses as an Expr; its text is the name
        it_name = v if isinstance(v, str) else (
            v.text if isinstance(v, Expr) else label)
    coll = UNKNOWN
    if "for_each" in b.attrs:
        coll = _eval_value(b.attrs["for_each"].value, scope)
    if isinstance(coll, dict):
        items = list(coll.items())
    elif isinstance(coll, TfSet):
        items = [(x, x) for x in coll]  # set: key == value (hcl dynblock)
    elif isinstance(coll, (list, tuple)):
        items = list(enumerate(coll))  # list/tuple: key == index
    else:
        items = None  # unknown
    proto = Block(type=label, labels=[], attrs=content.attrs,
                  blocks=content.blocks, start_line=b.start_line,
                  end_line=b.end_line)
    proto.src_path = getattr(b, "src_path", "")
    if items is None:
        return [_eval_block(proto, scope)]
    out = []
    for k, v in items[:MAX_EXPANSION]:
        s = Scope(**{**scope.__dict__,
                     "iterators": {**scope.iterators, it_name: (k, v)}})
        out.append(_eval_block(proto, s))
    return out


def _expand(blk: Block, scope: Scope) -> list[tuple[Block, Scope]]:
    """count / for_each expansion -> [(clone, scope-with-iterator)]."""
    count_attr = blk.attrs.get("count")
    each_attr = blk.attrs.get("for_each")
    if count_attr is not None:
        n = _eval_value(count_attr.value, scope)
        if isinstance(n, bool) or not isinstance(n, (int, float)):
            return [(blk, scope)]
        n = min(int(n), MAX_EXPANSION)
        out = []
        for i in range(n):
            s = Scope(**{**scope.__dict__, "count_index": i})
            out.append((blk, s))
        return out
    if each_attr is not None:
        coll = _eval_value(each_attr.value, scope)
        items: list[tuple] = []
        if isinstance(coll, dict):
            items = list(coll.items())
        elif isinstance(coll, list):
            items = [(x, x) for x in coll]
        else:
            return [(blk, scope)]
        out = []
        for k, v in items[:MAX_EXPANSION]:
            s = Scope(**{**scope.__dict__, "each": (k, v)})
            out.append((blk, s))
        return out
    return [(blk, scope)]


def evaluate_module(files: dict[str, bytes], dirname: str,
                    loader: ModuleLoader, inputs: dict | None = None,
                    depth: int = 0) -> EvaluatedModule:
    """Evaluate the module rooted at `dirname` (its *.tf files must be in
    `files`), resolving child modules through `loader`."""
    blocks = loader.parse_files(files)
    scope = Scope()

    # variables: caller inputs override defaults
    inputs = inputs or {}
    for b in blocks:
        if b.type == "variable" and b.labels:
            name = b.labels[0]
            if name in inputs:
                scope.variables[name] = inputs[name]
            else:
                d = b.get("default", UNKNOWN)
                scope.variables[name] = (
                    UNKNOWN if isinstance(d, Expr) else d)

    # resource/data registry for references
    for b in blocks:
        if b.type == "resource" and len(b.labels) >= 2:
            scope.resources[f"{b.labels[0]}.{b.labels[1]}"] = b
        elif b.type == "data" and len(b.labels) >= 2:
            scope.data[f"{b.labels[0]}.{b.labels[1]}"] = b

    # fixpoint over locals + module outputs (reference orders the graph;
    # bounded repetition converges for acyclic references). Child modules
    # are keyed by module NAME: when inputs resolve further on a later
    # pass the child is re-evaluated and REPLACES the stale evaluation —
    # accumulating both would duplicate every child resource.
    child_cache: dict[str, tuple[str, EvaluatedModule]] = {}
    for _pass in range(MAX_PASSES):
        changed = False
        for b in blocks:
            if b.type == "locals":
                for name, attr in b.attrs.items():
                    v = _eval_value(attr.value, scope)
                    if not isinstance(v, Expr) and \
                            scope.locals.get(name, UNKNOWN) != v:
                        scope.locals[name] = v
                        changed = True
        if depth < MAX_MODULE_DEPTH:
            for b in blocks:
                if b.type != "module" or not b.labels:
                    continue
                name = b.labels[0]
                src = b.get("source")
                if not isinstance(src, str) or not src.startswith("."):
                    continue  # registry/git modules are not on disk
                mod_dir = os.path.normpath(os.path.join(dirname, src))
                if not loader.has_dir(mod_dir):
                    continue
                mod_inputs = {}
                for k, attr in b.attrs.items():
                    if k in ("source", "version", "count", "for_each",
                             "providers", "depends_on"):
                        continue
                    v = _eval_value(attr.value, scope)
                    mod_inputs[k] = UNKNOWN if isinstance(v, Expr) else v
                inputs_key = json.dumps(
                    {k: repr(v) for k, v in sorted(mod_inputs.items())})
                prev = child_cache.get(name)
                if prev is not None and prev[0] == inputs_key:
                    continue
                child = evaluate_module(
                    loader.tf_files(mod_dir), mod_dir, loader,
                    inputs=mod_inputs, depth=depth + 1)
                child_cache[name] = (inputs_key, child)
                scope.modules[name] = child.outputs
                changed = True
        if not changed:
            break
    child_blocks = []
    for name, (_k, c) in child_cache.items():
        for blk in c.blocks:
            # stamp the module-instance path (fresh per evaluation —
            # c.blocks are this child evaluation's own clones), so two
            # instantiations of one source dir stay distinguishable
            blk.module_id = f"{name}.{blk.module_id}" \
                if blk.module_id else name
            child_blocks.append(blk)

    # outputs
    outputs: dict = {}
    for b in blocks:
        if b.type == "output" and b.labels:
            v = _eval_value(b.attrs["value"].value, scope) \
                if "value" in b.attrs else UNKNOWN
            outputs[b.labels[0]] = UNKNOWN if isinstance(v, Expr) else v

    # expand + evaluate resource/data blocks
    out_blocks: list[Block] = []
    for b in blocks:
        if b.type not in ("resource", "data"):
            continue
        for clone, s in _expand(b, scope):
            out_blocks.append(_eval_block(clone, s))
    out_blocks.extend(child_blocks)
    return EvaluatedModule(blocks=out_blocks, outputs=outputs)


def module_dirs(files: dict[str, bytes],
                loader: ModuleLoader | None = None) -> list[str]:
    """Root terraform module directories in a file map: dirs containing
    *.tf files that are not referenced as a `source` of another dir."""
    dirs = sorted({os.path.dirname(p) for p in files
                   if p.endswith((".tf", ".tf.json"))})
    if loader is None:
        loader = ModuleLoader(files)
    referenced: set[str] = set()
    for d in dirs:
        for b in loader.parse_files(loader.tf_files(d)):
            if b.type == "module":
                src = b.get("source")
                if isinstance(src, str) and src.startswith("."):
                    referenced.add(os.path.normpath(os.path.join(d, src)))
    return [d for d in dirs if d not in referenced]
