"""Mini-Rego interpreter for user checks and ignore policies.

The reference's entire custom-check ecosystem is Rego: misconfig checks
are `deny` rules evaluated by OPA (reference pkg/iac/rego/scanner.go:179,
load.go), and `--ignore-policy` evaluates `package trivy; ignore {...}`
per finding (pkg/result/filter.go applyPolicy). This module implements
the Rego subset those policies actually use, so a migrating user's
`.rego` files run unmodified:

- complete rules (`name = value { body }`, `name := value`, constants),
  partial-set rules (`deny[msg] { body }`), default rules, functions
  (`f(x) = y { body }`), multiple bodies (disjunction)
- rego.v1 keywords: `name if body`, `name contains x if body`, `x in xs`
- `:=` / `=` binding, `not`, `some`, `[_]` iteration, refs over
  input/data/rules/literals, arrays/objects/sets, array/set/object
  comprehensions, arithmetic + comparison operators
- builtins: count/split/concat/sprintf/startswith/endswith/contains/
  lower/upper/trim*/replace/to_number/format_int/abs/sum/min/max/sort/
  array.concat/object.get/regex.match/json.unmarshal/... (sandboxed: no
  I/O, no http.send, no opa.runtime)
- `# METADATA` annotations and `__rego_metadata__` rules for check
  id/title/severity/selector (pkg/iac/rego/metadata.go)
- the `data.lib.trivy` helper module (parse_cvss_vector_v3) that the
  published ignore-policy examples import (pkg/result/module.go),
  provided as a native function

Undefined propagates the Rego way: an expression over a missing key
yields no results, `not` succeeds on undefined/false, comprehensions
over undefined collections yield empty collections, and a rule with no
succeeding body falls back to its `default` or is undefined.

Unsupported (raise RegoError at parse time): `else`, `every`, `with`,
dotted rule heads, multi-target unification beyond simple var binding.

Copy of trivy_tpu/iac/rego.py, whole.
"""

from __future__ import annotations

import json
import re

import yaml

__all__ = ["RegoError", "Set", "parse_module", "Evaluator",
           "load_rego_checks"]


class RegoError(Exception):
    pass


class _Undefined(Exception):
    """Internal: builtin hit an error -> expression is undefined."""


# ----------------------------------------------------------------- values


def _canon(v):
    if isinstance(v, Set):
        return {"__set__": sorted(_vkey(x) for x in v)}
    if isinstance(v, dict):
        return {str(k): _canon(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_canon(x) for x in v]
    return v


def _vkey(v) -> str:
    return json.dumps(_canon(v), sort_keys=True, default=str)


class Set:
    """A Rego set: ordered-insertion, dedup by structural equality
    (members may be unhashable dicts/lists)."""

    __slots__ = ("_items", "_keys")

    def __init__(self, items=()):
        self._items: list = []
        self._keys: set = set()
        for it in items:
            self.add(it)

    def add(self, v):
        k = _vkey(v)
        if k not in self._keys:
            self._keys.add(k)
            self._items.append(v)

    def __contains__(self, v):
        return _vkey(v) in self._keys

    def __iter__(self):
        return iter(self._items)

    def __len__(self):
        return len(self._items)

    def __eq__(self, other):
        return isinstance(other, Set) and self._keys == other._keys

    def __ne__(self, other):
        return not self.__eq__(other)

    def __repr__(self):
        return "Set(%r)" % (self._items,)

    def to_json(self):
        return sorted(self._items, key=_vkey)


# -------------------------------------------------------------- tokenizer


_PUNCTS = (":=", "==", "!=", "<=", ">=", "{", "}", "[", "]", "(", ")",
           ",", ":", ";", "=", "<", ">", "+", "-", "*", "/", "%", "|",
           "&", ".")

_NAME_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_NUM_RE = re.compile(r"\d+(\.\d+)?([eE][+-]?\d+)?")


class Tok:
    __slots__ = ("kind", "val", "line")

    def __init__(self, kind, val, line):
        self.kind, self.val, self.line = kind, val, line

    def __repr__(self):
        return f"Tok({self.kind},{self.val!r},{self.line})"


def _tokenize(src: str):
    toks: list[Tok] = []
    comments: dict[int, str] = {}
    i, n, line = 0, len(src), 1
    while i < n:
        c = src[i]
        if c == "\n":
            toks.append(Tok("nl", "\n", line))
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        if c == "#":
            j = src.find("\n", i)
            j = n if j < 0 else j
            comments[line] = src[i:j]
            i = j
            continue
        if c == '"':
            j, out = i + 1, []
            while j < n and src[j] != '"':
                if src[j] == "\\" and j + 1 < n:
                    esc = src[j + 1]
                    out.append({"n": "\n", "t": "\t", "r": "\r",
                                '"': '"', "\\": "\\", "/": "/"}.get(
                                    esc, "\\" + esc))
                    j += 2
                else:
                    out.append(src[j])
                    j += 1
            if j >= n:
                raise RegoError(f"line {line}: unterminated string")
            toks.append(Tok("str", "".join(out), line))
            i = j + 1
            continue
        if c == "`":
            j = src.find("`", i + 1)
            if j < 0:
                raise RegoError(f"line {line}: unterminated raw string")
            raw = src[i + 1:j]
            toks.append(Tok("str", raw, line))
            line += raw.count("\n")
            i = j + 1
            continue
        m = _NUM_RE.match(src, i)
        if m and c.isdigit():
            text = m.group(0)
            toks.append(Tok("num",
                            float(text) if ("." in text or "e" in text
                                            or "E" in text) else int(text),
                            line))
            i = m.end()
            continue
        m = _NAME_RE.match(src, i)
        if m:
            toks.append(Tok("name", m.group(0), line))
            i = m.end()
            continue
        for p in _PUNCTS:
            if src.startswith(p, i):
                toks.append(Tok("punct", p, line))
                i += len(p)
                break
        else:
            raise RegoError(f"line {line}: unexpected character {c!r}")
    toks.append(Tok("eof", "", line))
    return toks, comments


# ------------------------------------------------------------------ AST

# terms/stmts are tuples: ("scalar", v) ("var", name)
# ("ref", base_term, [("dot", name) | ("idx", term)])
# ("array", [t]) ("object", [(k, v)]) ("set", [t])
# ("compr_arr", t, query) ("compr_set", t, query)
# ("compr_obj", k, v, query) ("call", (path...), [args])
# ("binop", op, l, r) ("not", stmt) ("in", x, coll) ("inkv", k, v, coll)
# ("assign", name, t) ("unify", l, r) ("some", [names])
# ("somein", names, coll)


class Rule:
    __slots__ = ("name", "kind", "args", "key", "value", "bodies",
                 "default", "line")

    def __init__(self, name, kind, args=None, key=None, value=None,
                 bodies=None, default=None, line=0):
        self.name, self.kind = name, kind   # complete | set | obj | func
        self.args, self.key, self.value = args, key, value
        self.bodies = bodies if bodies is not None else []
        self.default = default              # ("has", term) or None
        self.line = line


class Module:
    __slots__ = ("package", "imports", "rules", "metadata", "source")

    def __init__(self, package, imports, rules, metadata, source=""):
        self.package = package      # tuple path, e.g. ("user", "foo")
        self.imports = imports      # {alias: tuple path}
        self.rules = rules          # {name: [Rule]}
        self.metadata = metadata    # {rule_name_or_"": dict}
        self.source = source


class _Parser:
    def __init__(self, toks, comments):
        self.toks = toks
        self.comments = comments
        self.i = 0

    # -- token plumbing
    def _peek(self, skip_nl=True):
        j = self.i
        while skip_nl and self.toks[j].kind == "nl":
            j += 1
        return self.toks[j]

    def _next(self, skip_nl=True):
        while skip_nl and self.toks[self.i].kind == "nl":
            self.i += 1
        t = self.toks[self.i]
        self.i += 1
        return t

    def _at(self, val, skip_nl=True):
        t = self._peek(skip_nl)
        return (t.kind in ("punct", "name")) and t.val == val

    def _eat(self, val, skip_nl=True):
        if self._at(val, skip_nl):
            self._next(skip_nl)
            return True
        return False

    def _expect(self, val):
        t = self._next()
        if t.val != val:
            raise RegoError(f"line {t.line}: expected {val!r}, "
                            f"got {t.val!r}")
        return t

    def _name(self):
        t = self._next()
        if t.kind != "name":
            raise RegoError(f"line {t.line}: expected name, got {t.val!r}")
        return t.val

    # -- module
    def parse_module(self) -> Module:
        pkg_line = self._peek().line
        pkg_md = self._metadata_above(pkg_line)
        self._expect("package")
        package = tuple(self._ref_path())
        imports: dict[str, tuple] = {}
        while self._at("import"):
            self._next()
            path = self._ref_path()
            alias = None
            if self._at("as"):
                self._next()
                alias = self._name()
            path_t = tuple(path)
            if path_t in (("rego", "v1"), ("future", "keywords")) or \
                    (len(path_t) == 3 and path_t[:2] == ("future",
                                                         "keywords")):
                continue        # keyword imports: always-on here
            if path_t[0] != "data":
                raise RegoError(f"unsupported import {'.'.join(path)}")
            imports[alias or path_t[-1]] = path_t[1:]
        rules: dict[str, list[Rule]] = {}
        metadata: dict[str, dict] = {}
        if pkg_md:
            metadata[""] = pkg_md
        while self._peek().kind != "eof":
            if self._at("else"):
                raise RegoError("`else` is not supported")
            line = self._peek().line
            r = self._rule()
            md = self._metadata_above(line)
            if md and r.name not in metadata:
                metadata[r.name] = md
            rules.setdefault(r.name, []).append(r)
        return Module(package, imports, rules, metadata)

    def _metadata_above(self, rule_line: int) -> dict | None:
        """Contiguous comment block ending at rule_line-1 that starts
        with `# METADATA` -> YAML-parsed annotations."""
        lines = []
        ln = rule_line - 1
        while ln in self.comments:
            lines.append(self.comments[ln])
            ln -= 1
        lines.reverse()
        if not lines or lines[0].strip() != "# METADATA":
            return None
        body = "\n".join(l.lstrip("#").removeprefix(" ")
                         for l in lines[1:])
        try:
            doc = yaml.safe_load(body)
        except yaml.YAMLError:
            return None
        return doc if isinstance(doc, dict) else None

    def _ref_path(self) -> list[str]:
        parts = [self._name()]
        while self._at(".", skip_nl=False):
            self._next(skip_nl=False)
            parts.append(self._name())
        return parts

    # -- rules
    def _rule(self) -> Rule:
        if self._at("default"):
            self._next()
            name = self._name()
            if not (self._eat(":=") or self._eat("=")):
                raise RegoError("default rule needs a value")
            val = self._term()
            return Rule(name, "complete", default=("has", val))
        t = self._peek()
        name = self._name()
        line = t.line
        for bad in ("else", "every", "with"):
            if self._at(bad):
                raise RegoError(f"line {line}: `{bad}` is not supported")
        if self._at("(", skip_nl=False):
            return self._func_rule(name, line)
        if self._at("[", skip_nl=False):
            return self._bracket_rule(name, line)
        if self._at("contains"):
            self._next()
            key = self._term()
            bodies = self._if_bodies()
            return Rule(name, "set", key=key, bodies=bodies, line=line)
        if self._eat(":=") or self._eat("="):
            value = self._term()
            bodies = self._if_bodies(optional=True)
            if not bodies:
                bodies = [[]]       # constant: vacuously true body
            return Rule(name, "complete", value=value, bodies=bodies,
                        line=line)
        bodies = self._if_bodies()
        return Rule(name, "complete", value=("scalar", True),
                    bodies=bodies, line=line)

    def _func_rule(self, name, line) -> Rule:
        self._expect("(")
        args = []
        if not self._at(")"):
            while True:
                args.append(self._term())
                if not self._eat(","):
                    break
        self._expect(")")
        value = ("scalar", True)
        if self._eat(":=") or self._eat("="):
            value = self._term()
        bodies = self._if_bodies(optional=True) or [[]]
        return Rule(name, "func", args=args, value=value, bodies=bodies,
                    line=line)

    def _bracket_rule(self, name, line) -> Rule:
        self._expect("[")
        key = self._term()
        self._expect("]")
        if self._eat(":=") or self._eat("="):
            value = self._term()
            bodies = self._if_bodies(optional=True) or [[]]
            return Rule(name, "obj", key=key, value=value, bodies=bodies,
                        line=line)
        bodies = self._if_bodies(optional=True) or [[]]
        return Rule(name, "set", key=key, bodies=bodies, line=line)

    def _if_bodies(self, optional=False) -> list[list]:
        """`if { q }` | `if stmt` | `{ q }` (possibly chained)."""
        bodies = []
        if self._at("if"):
            self._next()
            if self._at("{"):
                bodies.append(self._braced_query())
            else:
                bodies.append([self._stmt()])
        while self._at("{"):
            bodies.append(self._braced_query())
        if not bodies and not optional:
            t = self._peek()
            raise RegoError(f"line {t.line}: expected rule body")
        return bodies

    def _braced_query(self) -> list:
        self._expect("{")
        q = self._query(end="}")
        self._expect("}")
        return q

    # -- queries / statements
    def _query(self, end) -> list:
        stmts = []
        while True:
            while self._peek(skip_nl=False).kind == "nl" or \
                    self._at(";", skip_nl=False):
                self._next(skip_nl=False)
            if self._at(end):
                return stmts
            stmts.append(self._stmt())

    def _stmt(self):
        for bad in ("every", "with", "else"):
            if self._at(bad):
                t = self._peek()
                raise RegoError(
                    f"line {t.line}: `{bad}` is not supported")
        if self._at("not"):
            self._next()
            return ("not", self._stmt())
        if self._at("some"):
            self._next()
            names = [self._name()]
            while self._eat(",", skip_nl=False):
                names.append(self._name())
            if self._at("in"):
                self._next()
                return ("somein", names, self._expr())
            return ("some", names)
        return self._expr()

    # -- expressions (precedence: * / % > + - > cmp/in > = :=)
    def _expr(self):
        left = self._cmp()
        if self._at(":=", skip_nl=False):
            self._next()
            if left[0] != "var":
                raise RegoError(":= target must be a variable")
            return ("assign", left[1], self._cmp())
        if self._at("=", skip_nl=False):
            self._next()
            return ("unify", left, self._cmp())
        return left

    def _cmp(self, no_union=False):
        left = self._add(no_union)
        t = self._peek(skip_nl=False)
        if t.kind == "punct" and t.val in ("==", "!=", "<", "<=", ">",
                                           ">="):
            op = self._next(skip_nl=False).val
            return ("binop", op, left, self._add())
        if t.kind == "name" and t.val == "in":
            self._next(skip_nl=False)
            return ("in", left, self._add())
        return left

    def _add(self, no_union=False):
        left = self._mul()
        while True:
            t = self._peek(skip_nl=False)
            if no_union and t.kind == "punct" and t.val == "|":
                return left
            if t.kind == "punct" and t.val in ("+", "-", "|", "&"):
                op = self._next(skip_nl=False).val
                left = ("binop", op, left, self._mul())
            else:
                return left

    def _mul(self):
        left = self._unary()
        while True:
            t = self._peek(skip_nl=False)
            if t.kind == "punct" and t.val in ("*", "/", "%"):
                op = self._next(skip_nl=False).val
                left = ("binop", op, left, self._unary())
            else:
                return left

    def _unary(self):
        if self._at("-"):
            self._next()
            inner = self._unary()
            if inner[0] == "scalar" and isinstance(inner[1], (int, float)):
                return ("scalar", -inner[1])
            return ("binop", "-", ("scalar", 0), inner)
        return self._postfix()

    def _postfix(self):
        base = self._primary()
        ops = []
        while True:
            t = self._peek(skip_nl=False)
            if t.kind == "punct" and t.val == ".":
                self._next(skip_nl=False)
                ops.append(("dot", self._name()))
            elif t.kind == "punct" and t.val == "[":
                self._next(skip_nl=False)
                ops.append(("idx", self._term()))
                self._expect("]")
            elif t.kind == "punct" and t.val == "(":
                # call: base must be a plain ref path
                path = _ref_to_path(base, ops)
                if path is None:
                    raise RegoError(
                        f"line {t.line}: cannot call a non-reference")
                self._next(skip_nl=False)
                args = []
                if not self._at(")"):
                    while True:
                        args.append(self._term())
                        if not self._eat(","):
                            break
                self._expect(")")
                base, ops = ("call", tuple(path), args), []
            else:
                break
        if not ops:
            return base
        return ("ref", base, ops)

    def _primary(self):
        t = self._peek()
        if t.kind == "str":
            self._next()
            return ("scalar", t.val)
        if t.kind == "num":
            self._next()
            return ("scalar", t.val)
        if t.kind == "name":
            if t.val in ("true", "false"):
                self._next()
                return ("scalar", t.val == "true")
            if t.val == "null":
                self._next()
                return ("scalar", None)
            if t.val == "not":
                self._next()
                return ("not", self._stmt())
            self._next()
            return ("var", t.val)
        if t.val == "(":
            self._next()
            e = self._expr()
            self._expect(")")
            return e
        if t.val == "[":
            return self._array_or_compr()
        if t.val == "{":
            return self._obj_set_or_compr()
        raise RegoError(f"line {t.line}: unexpected token {t.val!r}")

    def _term(self, no_union=False):
        return self._cmp(no_union)

    def _array_or_compr(self):
        self._expect("[")
        if self._at("]"):
            self._next()
            return ("array", [])
        first = self._term(no_union=True)
        if self._at("|"):
            self._next()
            q = self._query(end="]")
            self._expect("]")
            return ("compr_arr", first, q)
        items = [first]
        while self._eat(","):
            if self._at("]"):
                break
            items.append(self._term())
        self._expect("]")
        return ("array", items)

    def _obj_set_or_compr(self):
        self._expect("{")
        if self._at("}"):
            self._next()
            return ("object", [])
        first = self._term(no_union=True)
        if self._at(":"):
            self._next()
            v = self._term(no_union=True)
            if self._at("|"):
                self._next()
                q = self._query(end="}")
                self._expect("}")
                return ("compr_obj", first, v, q)
            pairs = [(first, v)]
            while self._eat(","):
                if self._at("}"):
                    break
                k = self._term()
                self._expect(":")
                pairs.append((k, self._term()))
            self._expect("}")
            return ("object", pairs)
        if self._at("|"):
            self._next()
            q = self._query(end="}")
            self._expect("}")
            return ("compr_set", first, q)
        items = [first]
        while self._eat(","):
            if self._at("}"):
                break
            items.append(self._term())
        self._expect("}")
        return ("set", items)


def _ref_to_path(base, ops):
    if base[0] != "var":
        return None
    path = [base[1]]
    for op in ops:
        if op[0] == "dot":
            path.append(op[1])
        elif op[0] == "idx" and op[1][0] == "scalar" and \
                isinstance(op[1][1], str):
            path.append(op[1][1])
        else:
            return None
    return path


def parse_module(src: str) -> Module:
    toks, comments = _tokenize(src)
    mod = _Parser(toks, comments).parse_module()
    mod.source = src
    return mod


# ---------------------------------------------------------------- builtins


def _go_sprintf(fmt: str, args: list) -> str:
    out, ai = [], 0
    i, n = 0, len(fmt)
    while i < n:
        c = fmt[i]
        if c != "%":
            out.append(c)
            i += 1
            continue
        if i + 1 < n and fmt[i + 1] == "%":
            out.append("%")
            i += 2
            continue
        j = i + 1
        while j < n and not fmt[j].isalpha():
            j += 1
        if j >= n:
            out.append(fmt[i:])
            break
        verb, flags = fmt[j], fmt[i + 1:j]
        if verb not in "vsdfxXeqt":
            out.append(fmt[i:j + 1])    # unknown verb: keep literal,
            i = j + 1                   # do not consume an argument
            continue
        a = args[ai] if ai < len(args) else ""
        ai += 1
        if verb == "v":
            out.append(json.dumps(_canon(a)) if isinstance(
                a, (dict, list, Set)) else
                ("true" if a is True else "false" if a is False
                 else str(a)))
        elif verb == "s":
            out.append(("%" + flags + "s") % (str(a),))
        elif verb == "q":
            out.append(json.dumps(str(a)))
        elif verb == "t":
            out.append("true" if a else "false")
        elif verb in "dxX":
            out.append(("%" + flags + verb) % (int(a),))
        elif verb in "ef":
            out.append(("%" + flags + verb) % (float(a),))
        i = j + 1
    return "".join(out)


def _b_contains(a, b=None):
    if b is None:
        raise _Undefined
    if isinstance(a, str):
        return b in a if isinstance(b, str) else False
    if isinstance(a, (list, Set)):
        return b in a if isinstance(a, Set) else any(
            _vkey(x) == _vkey(b) for x in a)
    raise _Undefined


def _num2(f):
    def g(a, b):
        if isinstance(a, bool) or isinstance(b, bool) or not \
                isinstance(a, (int, float)) or not \
                isinstance(b, (int, float)):
            raise _Undefined
        return f(a, b)
    return g


def _parse_cvss_vector_v3(cvss):
    """Native data.lib.trivy.parse_cvss_vector_v3 (reference
    pkg/result/module.go embeds the equivalent Rego)."""
    if not isinstance(cvss, str):
        raise _Undefined
    s = cvss.split("/")
    tables = [
        ("AttackVector", {"AV:N": "Network", "AV:A": "Adjacent",
                          "AV:L": "Local", "AV:P": "Physical"}),
        ("AttackComplexity", {"AC:L": "Low", "AC:H": "High"}),
        ("PrivilegesRequired", {"PR:N": "None", "PR:L": "Low",
                                "PR:H": "High"}),
        ("UserInteraction", {"UI:N": "None", "UI:R": "Required"}),
        ("Scope", {"S:U": "Unchanged", "S:C": "Changed"}),
        ("Confidentiality", {"C:N": "None", "C:L": "Low", "C:H": "High"}),
        ("Integrity", {"I:N": "None", "I:L": "Low", "I:H": "High"}),
        ("Availability", {"A:N": "None", "A:L": "Low", "A:H": "High"}),
    ]
    out = {}
    for k, (name, table) in enumerate(tables, start=1):
        if k >= len(s) or s[k] not in table:
            raise _Undefined
        out[name] = table[s[k]]
    return out


def _b_sort(x):
    if isinstance(x, list):
        return sorted(x, key=_vkey)
    if isinstance(x, Set):
        return sorted(x, key=_vkey)
    raise _Undefined


_BUILTINS = {
    ("count",): lambda x: len(x) if isinstance(
        x, (list, dict, Set, str)) else (_ for _ in ()).throw(
            _Undefined()),
    ("split",): lambda s, d: s.split(d) if isinstance(s, str) else
    (_ for _ in ()).throw(_Undefined()),
    ("concat",): lambda d, xs: d.join(list(xs)),
    ("sprintf",): _go_sprintf,
    ("startswith",): lambda s, p: isinstance(s, str) and s.startswith(p),
    ("endswith",): lambda s, p: isinstance(s, str) and s.endswith(p),
    ("contains",): _b_contains,
    ("indexof",): lambda s, x: s.find(x),
    ("lower",): lambda s: s.lower(),
    ("upper",): lambda s: s.upper(),
    ("trim",): lambda s, cut: s.strip(cut),
    ("trim_space",): lambda s: s.strip(),
    ("trim_left",): lambda s, cut: s.lstrip(cut),
    ("trim_right",): lambda s, cut: s.rstrip(cut),
    ("trim_prefix",): lambda s, p: s[len(p):] if s.startswith(p) else s,
    ("trim_suffix",): lambda s, p: s[:-len(p)] if p and s.endswith(p)
    else s,
    ("replace",): lambda s, old, new: s.replace(old, new),
    ("substring",): lambda s, off, ln: s[off:] if ln < 0
    else s[off:off + ln],
    ("format_int",): lambda x, base: ({2: "{0:b}", 8: "{0:o}",
                                       10: "{0:d}", 16: "{0:x}"}
                                      [base]).format(int(x)),
    ("to_number",): lambda x: (int(x) if isinstance(x, bool) else
                               x if isinstance(x, (int, float)) else
                               float(x) if "." in str(x) else int(x)),
    ("abs",): lambda x: abs(x),
    ("round",): lambda x: round(x),
    ("ceil",): lambda x: __import__("math").ceil(x),
    ("floor",): lambda x: __import__("math").floor(x),
    ("max",): lambda xs: max(xs) if len(xs) else
    (_ for _ in ()).throw(_Undefined()),
    ("min",): lambda xs: min(xs) if len(xs) else
    (_ for _ in ()).throw(_Undefined()),
    ("sum",): lambda xs: sum(xs),
    ("product",): lambda xs: __import__("math").prod(xs),
    ("sort",): _b_sort,
    ("array", "concat"): lambda a, b: list(a) + list(b),
    ("array", "slice"): lambda a, i, j: a[max(i, 0):max(j, 0)],
    ("array", "reverse"): lambda a: list(reversed(a)),
    ("object", "get"): lambda o, k, d: o.get(k, d) if isinstance(
        o, dict) else d,
    ("object", "keys"): lambda o: Set(o.keys()),
    ("json", "marshal"): lambda x: json.dumps(_canon(x),
                                              separators=(",", ":")),
    ("json", "unmarshal"): lambda s: json.loads(s),
    ("base64", "encode"): lambda s: __import__("base64").b64encode(
        s.encode()).decode(),
    ("base64", "decode"): lambda s: __import__("base64").b64decode(
        s).decode(),
    ("regex", "match"): lambda p, s: re.search(p, s) is not None,
    ("re_match",): lambda p, s: re.search(p, s) is not None,
    ("regex", "replace"): lambda s, p, r: re.sub(p, r, s),
    ("regex", "split"): lambda p, s: re.split(p, s),
    ("is_string",): lambda x: isinstance(x, str),
    ("is_number",): lambda x: isinstance(x, (int, float)) and not
    isinstance(x, bool),
    ("is_boolean",): lambda x: isinstance(x, bool),
    ("is_array",): lambda x: isinstance(x, list),
    ("is_object",): lambda x: isinstance(x, dict),
    ("is_set",): lambda x: isinstance(x, Set),
    ("is_null",): lambda x: x is None,
    ("type_name",): lambda x: ("null" if x is None else
                               "boolean" if isinstance(x, bool) else
                               "number" if isinstance(x, (int, float))
                               else "string" if isinstance(x, str) else
                               "array" if isinstance(x, list) else
                               "set" if isinstance(x, Set) else
                               "object"),
    ("numbers", "range"): lambda a, b: list(range(a, b + 1)) if a <= b
    else list(range(a, b - 1, -1)),
    ("glob", "match"): lambda pat, delim, s: __import__(
        "fnmatch").fnmatch(s, pat),
    # data.lib.trivy natives (reference pkg/result/module.go)
    ("lib", "trivy", "parse_cvss_vector_v3"): _parse_cvss_vector_v3,
}


# --------------------------------------------------------------- evaluator


class _Node:
    """Position in the virtual `data` document: package tree + user
    data, merged (rules shadow plain data)."""

    __slots__ = ("tree", "data")

    def __init__(self, tree, data):
        self.tree, self.data = tree, data


_MAX_STEPS = 2_000_000


class Evaluator:
    def __init__(self, modules: list[Module], input=None, data=None):
        self.input = input
        self.data = data if isinstance(data, dict) else {}
        self.tree: dict = {}
        for m in modules:
            node = self.tree
            for part in m.package:
                node = node.setdefault(part, {})
            for name, group in m.rules.items():
                node.setdefault(name, []).extend(
                    (m, r) for r in group)
        self._cache: dict = {}
        self._steps = 0

    # ---- public
    def query(self, path: str, input=None):
        """Evaluate e.g. "data.user.foo.deny". Returns the document
        (sets materialize to Set) or None when undefined."""
        if input is not None:
            self.input = input
            self._cache.clear()
        parts = path.split(".")
        if parts[0] != "data":
            raise RegoError("query must start with data.")
        node: object = _Node(self.tree, self.data)
        for p in parts[1:]:
            node = self._descend(node, p)
            if node is None:
                return None
        if isinstance(node, _Node):
            return self._materialize_node(node)
        return node

    # ---- data descent
    def _descend(self, node, key):
        if isinstance(node, _Node):
            t = node.tree.get(key) if isinstance(node.tree, dict) else None
            d = node.data.get(key) if isinstance(node.data, dict) else None
            if isinstance(t, list):        # rule group leaf
                return self._rule_value(t)
            if t is not None:
                return _Node(t, d if isinstance(d, dict) else {})
            if d is not None or (isinstance(node.data, dict)
                                 and key in node.data):
                return d
            return None
        if isinstance(node, dict):
            return node.get(key)
        return None

    def _materialize_node(self, node: _Node):
        out = dict(node.data) if isinstance(node.data, dict) else {}
        for k, v in node.tree.items():
            if isinstance(v, list):
                rv = self._rule_value(v)
                if rv is not None:
                    out[k] = rv
            else:
                out[k] = self._materialize_node(_Node(v, out.get(k, {})))
        return out

    # ---- rule evaluation
    def _rule_value(self, group: list):
        key = id(group)
        if key in self._cache:
            return self._cache[key]
        self._cache[key] = None     # cycle guard: undefined during eval
        mod, first = group[0]
        kind = first.kind
        result = None
        if kind == "func":
            result = None   # functions are not values; calls go
            # through _call_func with the rule group directly
        elif kind == "set":
            out = Set()
            for mod, r in group:
                for body in r.bodies:
                    for env in self._eval_query(body, 0, {}, mod):
                        for v, env2 in self._eval_term(
                                r.key, env, mod):
                            out.add(v)
            result = out
        elif kind == "obj":
            obj = {}
            for mod, r in group:
                for body in r.bodies:
                    for env in self._eval_query(body, 0, {}, mod):
                        for k, env2 in self._eval_term(
                                r.key, env, mod):
                            for v, _ in self._eval_term(
                                    r.value, env2, mod):
                                obj[k] = v
            result = obj
        else:                       # complete
            default = None
            for mod, r in group:
                if r.default is not None:
                    for v, _ in self._eval_term(r.default[1], {},
                                                      mod):
                        default = v
            value = None
            found = False
            for mod, r in group:
                if r.default is not None and not r.bodies:
                    continue
                for body in r.bodies:
                    for env in self._eval_query(body, 0, {}, mod):
                        for v, _ in self._eval_term(r.value, env,
                                                          mod):
                            value, found = v, True
                            break
                        if found:
                            break
                    if found:
                        break
                if found:
                    break
            result = value if found else default
        self._cache[key] = result
        return result

    # ---- query evaluation: generator of envs
    def _eval_query(self, stmts, i, env, mod):
        self._steps += 1
        if self._steps > _MAX_STEPS:
            raise RegoError("evaluation budget exceeded")
        if i >= len(stmts):
            yield env
            return
        stmt = stmts[i]
        for env2 in self._eval_stmt(stmt, env, mod):
            yield from self._eval_query(stmts, i + 1, env2, mod)

    def _eval_stmt(self, stmt, env, mod):
        kind = stmt[0]
        if kind == "not":
            ok = True
            for v, _ in self._eval_stmt_values(stmt[1], env, mod):
                if v is not False:
                    ok = False
                    break
            if ok:
                yield env
            return
        if kind == "some":
            env2 = dict(env)
            for name in stmt[1]:
                env2.pop(name, None)
            yield env2
            return
        if kind == "somein":
            names, coll_t = stmt[1], stmt[2]
            for coll, env2 in self._eval_term(coll_t, env, mod):
                yield from self._iter_bind(names, coll, env2)
            return
        if kind == "assign":
            for v, env2 in self._eval_term(stmt[2], env, mod):
                env3 = dict(env2)
                env3[stmt[1]] = v
                yield env3
            return
        if kind == "unify":
            yield from self._unify(stmt[1], stmt[2], env, mod)
            return
        for v, env2 in self._eval_term(stmt, env, mod):
            if v is not False:
                yield env2

    def _eval_stmt_values(self, stmt, env, mod):
        """Like _eval_stmt but yields (value, env) — used by `not`."""
        kind = stmt[0]
        if kind in ("assign", "unify", "some", "somein", "not"):
            for env2 in self._eval_stmt(stmt, env, mod):
                yield True, env2
            return
        yield from self._eval_term(stmt, env, mod)

    def _iter_bind(self, names, coll, env):
        if isinstance(coll, list):
            for idx, v in enumerate(coll):
                env2 = dict(env)
                if len(names) == 1:
                    env2[names[0]] = v
                else:
                    env2[names[0]], env2[names[1]] = idx, v
                yield env2
        elif isinstance(coll, dict):
            for k, v in coll.items():
                env2 = dict(env)
                if len(names) == 1:
                    env2[names[0]] = v
                else:
                    env2[names[0]], env2[names[1]] = k, v
                yield env2
        elif isinstance(coll, Set):
            for v in coll:
                env2 = dict(env)
                env2[names[0]] = v
                yield env2

    def _unify(self, lt, rt, env, mod):
        # simple var on either side binds; otherwise equality
        if lt[0] == "var" and lt[1] != "_" and lt[1] not in env and not \
                self._is_rule_name(lt[1], mod):
            for v, env2 in self._eval_term(rt, env, mod):
                env3 = dict(env2)
                env3[lt[1]] = v
                yield env3
            return
        if rt[0] == "var" and rt[1] != "_" and rt[1] not in env and not \
                self._is_rule_name(rt[1], mod):
            for v, env2 in self._eval_term(lt, env, mod):
                env3 = dict(env2)
                env3[rt[1]] = v
                yield env3
            return
        if lt[0] == "array":
            # destructure [a, b] = expr (incl. array-literal rhs)
            for v, env2 in self._eval_term(rt, env, mod):
                if not isinstance(v, list) or len(v) != len(lt[1]):
                    continue
                envs = [env2]
                ok = True
                for elt_t, elt_v in zip(lt[1], v):
                    nxt = []
                    for e in envs:
                        nxt.extend(self._unify(
                            elt_t, ("scalar", elt_v), e, mod))
                    envs = nxt
                    if not envs:
                        ok = False
                        break
                if ok:
                    yield from iter(envs)
            return
        for lv, env2 in self._eval_term(lt, env, mod):
            for rv, env3 in self._eval_term(rt, env2, mod):
                if _eq(lv, rv):
                    yield env3

    def _is_rule_name(self, name, mod):
        return name in mod.rules

    # ---- term evaluation: generator of (value, env)
    def _eval_term(self, t, env, mod):
        self._steps += 1
        if self._steps > _MAX_STEPS:
            raise RegoError("evaluation budget exceeded")
        kind = t[0]
        if kind == "scalar":
            yield t[1], env
        elif kind == "var":
            yield from self._eval_var(t[1], env, mod)
        elif kind == "ref":
            for base, env2 in self._eval_term(t[1], env, mod):
                yield from self._apply_ops(base, t[2], 0, env2, mod)
        elif kind == "call":
            yield from self._eval_call(t[1], t[2], env, mod)
        elif kind == "array":
            yield from self._eval_seq(t[1], env, mod, list)
        elif kind == "set":
            yield from self._eval_seq(t[1], env, mod, Set)
        elif kind == "object":
            yield from self._eval_object(t[1], env, mod)
        elif kind == "compr_arr":
            out = []
            for e in self._eval_query(t[2], 0, env, mod):
                for v, _ in self._eval_term(t[1], e, mod):
                    out.append(v)
                    break
            yield out, env
        elif kind == "compr_set":
            out = Set()
            for e in self._eval_query(t[2], 0, env, mod):
                for v, _ in self._eval_term(t[1], e, mod):
                    out.add(v)
                    break
            yield out, env
        elif kind == "compr_obj":
            out = {}
            for e in self._eval_query(t[3], 0, env, mod):
                for k, e2 in self._eval_term(t[1], e, mod):
                    for v, _ in self._eval_term(t[2], e2, mod):
                        out[k] = v
                        break
                    break
            yield out, env
        elif kind == "binop":
            yield from self._eval_binop(t[1], t[2], t[3], env, mod)
        elif kind == "in":
            for x, env2 in self._eval_term(t[1], env, mod):
                for coll, env3 in self._eval_term(t[2], env2, mod):
                    yield _member(x, coll), env3
        elif kind == "not":
            ok = True
            for v, _ in self._eval_stmt_values(t[1], env, mod):
                if v is not False:
                    ok = False
                    break
            yield ok, env
        elif kind in ("assign", "unify"):
            for env2 in self._eval_stmt(t, env, mod):
                yield True, env2
        else:
            raise RegoError(f"cannot evaluate {kind}")

    def _eval_var(self, name, env, mod):
        if name in env:
            yield env[name], env
            return
        if name == "input":
            if self.input is not None:
                yield self.input, env
            return
        if name == "data":
            yield _Node(self.tree, self.data), env
            return
        if name in mod.imports:
            node: object = _Node(self.tree, self.data)
            for p in mod.imports[name]:
                node = self._descend(node, p)
                if node is None:
                    return
            yield node, env
            return
        if name in mod.rules:
            v = self._rule_value(self._group_for(name, mod))
            if v is not None:
                yield v, env
            return
        if name == "_":
            raise RegoError("`_` used outside an index position")
        # unbound var in value position: undefined
        return

    def _group_for(self, name, mod):
        node = self.tree
        for part in mod.package:
            node = node.get(part, {})
        return node.get(name, [])

    def _apply_ops(self, val, ops, i, env, mod):
        if i >= len(ops):
            if isinstance(val, _Node):
                val = self._materialize_node(val)
            yield val, env
            return
        op = ops[i]
        if op[0] == "dot":
            nxt = self._index(val, op[1])
            for v in nxt:
                yield from self._apply_ops(v, ops, i + 1, env, mod)
            return
        idx_t = op[1]
        # unbound-var (or `_`) index: iterate the collection
        if idx_t[0] == "var" and (idx_t[1] == "_" or
                                  (idx_t[1] not in env and not
                                   self._is_rule_name(idx_t[1], mod))):
            if isinstance(val, _Node):
                val = self._materialize_node(val)
            var = idx_t[1]
            if isinstance(val, list):
                items = list(enumerate(val))
            elif isinstance(val, dict):
                items = list(val.items())
            elif isinstance(val, Set):
                items = [(v, v) for v in val]
            else:
                return
            for k, v in items:
                env2 = env if var == "_" else {**env, var: k}
                yield from self._apply_ops(v, ops, i + 1, env2, mod)
            return
        for key, env2 in self._eval_term(idx_t, env, mod):
            for v in self._index(val, key):
                yield from self._apply_ops(v, ops, i + 1, env2, mod)

    def _index(self, val, key):
        if isinstance(val, _Node):
            v = self._descend(val, key)
            return [] if v is None else [v]
        if isinstance(val, dict):
            return [val[key]] if key in val else []
        if isinstance(val, list):
            if isinstance(key, bool) or not isinstance(key, int):
                return []
            return [val[key]] if 0 <= key < len(val) else []
        if isinstance(val, Set):
            return [key] if key in val else []
        return []

    def _eval_seq(self, terms, env, mod, ctor):
        def rec(j, env2, acc):
            if j >= len(terms):
                yield ctor(acc), env2
                return
            for v, env3 in self._eval_term(terms[j], env2, mod):
                yield from rec(j + 1, env3, acc + [v])
        yield from rec(0, env, [])

    def _eval_object(self, pairs, env, mod):
        def rec(j, env2, acc):
            if j >= len(pairs):
                yield dict(acc), env2
                return
            kt, vt = pairs[j]
            for k, env3 in self._eval_term(kt, env2, mod):
                for v, env4 in self._eval_term(vt, env3, mod):
                    yield from rec(j + 1, env4, acc + [(k, v)])
        yield from rec(0, env, [])

    def _eval_binop(self, op, lt, rt, env, mod):
        for lv, env2 in self._eval_term(lt, env, mod):
            for rv, env3 in self._eval_term(rt, env2, mod):
                try:
                    yield _binop(op, lv, rv), env3
                except _Undefined:
                    pass

    def _eval_call(self, path, args, env, mod):
        # resolve: local/imported function rule, else builtin
        group = None
        if len(path) == 1 and path[0] in mod.rules:
            group = self._group_for(path[0], mod)
        elif path[0] in mod.imports:
            node = self.tree
            for p in mod.imports[path[0]] + tuple(path[1:-1]):
                node = node.get(p, {}) if isinstance(node, dict) else {}
            g = node.get(path[-1]) if isinstance(node, dict) else None
            if isinstance(g, list):
                group = g
            else:
                # native fallthrough under the imported path
                native = _BUILTINS.get(
                    mod.imports[path[0]] + tuple(path[1:]))
                if native is not None:
                    yield from self._call_native(native, args, env, mod)
                    return
        elif path[0] == "data":
            node = self.tree
            for p in path[1:-1]:
                node = node.get(p, {}) if isinstance(node, dict) else {}
            g = node.get(path[-1]) if isinstance(node, dict) else None
            if isinstance(g, list):
                group = g
            elif tuple(path[1:]) in _BUILTINS:
                yield from self._call_native(_BUILTINS[tuple(path[1:])],
                                             args, env, mod)
                return
        if group:
            yield from self._call_func(group, args, env, mod)
            return
        native = _BUILTINS.get(tuple(path))
        if native is None:
            raise RegoError(f"unknown function {'.'.join(path)}")
        yield from self._call_native(native, args, env, mod)

    def _call_native(self, fn, args, env, mod):
        def rec(j, env2, acc):
            if j >= len(args):
                try:
                    yield fn(*acc), env2
                except _Undefined:
                    return
                except RegoError:
                    raise
                except Exception:
                    return          # builtin error -> undefined
                return
            for v, env3 in self._eval_term(args[j], env2, mod):
                yield from rec(j + 1, env3, acc + [v])
        yield from rec(0, env, [])

    def _call_func(self, group, args, env, mod):
        # evaluate args in caller env first (ground semantics)
        def rec(j, env2, acc):
            if j >= len(args):
                yield acc, env2
                return
            for v, env3 in self._eval_term(args[j], env2, mod):
                yield from rec(j + 1, env3, acc + [v])
        for vals, env2 in rec(0, env, []):
            for fmod, rule in group:
                if len(rule.args) != len(vals):
                    continue
                # bind params (vars bind, ground params must match)
                fenv: dict | None = {}
                for pt, pv in zip(rule.args, vals):
                    if pt[0] == "var" and pt[1] != "_":
                        fenv[pt[1]] = pv
                    elif pt[0] == "scalar":
                        if not _eq(pt[1], pv):
                            fenv = None
                            break
                if fenv is None:
                    continue
                done = False
                for body in rule.bodies:
                    for benv in self._eval_query(body, 0, fenv, fmod):
                        for v, _ in self._eval_term(rule.value, benv,
                                                    fmod):
                            yield v, env2
                            done = True
                            break
                        if done:
                            break
                    if done:
                        break
                if done:
                    break


def _eq(a, b):
    if isinstance(a, Set) or isinstance(b, Set):
        return isinstance(a, Set) and isinstance(b, Set) and a == b
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    return _vkey(a) == _vkey(b) if isinstance(
        a, (dict, list)) or isinstance(b, (dict, list)) else a == b


def _member(x, coll):
    if isinstance(coll, (list, Set)):
        return any(_eq(x, v) for v in coll)
    if isinstance(coll, dict):
        return any(_eq(x, v) for v in coll.values())
    if isinstance(coll, str) and isinstance(x, str):
        return x in coll
    return False


def _binop(op, a, b):
    if op in ("==", "!="):
        r = _eq(a, b)
        return r if op == "==" else not r
    if op in ("<", "<=", ">", ">="):
        if type(a) is bool or type(b) is bool:
            raise _Undefined
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            pass
        elif isinstance(a, str) and isinstance(b, str):
            pass
        else:
            raise _Undefined
        return {"<": a < b, "<=": a <= b, ">": a > b,
                ">=": a >= b}[op]
    if isinstance(a, Set) and isinstance(b, Set):
        if op == "|":
            return Set(list(a) + list(b))
        if op == "&":
            return Set(v for v in a if v in b)
        if op == "-":
            return Set(v for v in a if v not in b)
        raise _Undefined
    return {"+": _num2(lambda x, y: x + y),
            "-": _num2(lambda x, y: x - y),
            "*": _num2(lambda x, y: x * y),
            "/": _num2(_div),
            "%": _num2(lambda x, y: x % y if y else
                       (_ for _ in ()).throw(_Undefined()))}[op](a, b)


def _div(x, y):
    if y == 0:
        raise _Undefined
    r = x / y
    return int(r) if isinstance(x, int) and isinstance(y, int) and \
        x % y == 0 else r


# ------------------------------------------------------- check integration


_SEVERITIES = ("CRITICAL", "HIGH", "MEDIUM", "LOW", "UNKNOWN")

_ALL_TYPES = ("dockerfile", "kubernetes", "terraform", "cloudformation",
              "terraformplan", "azure-arm", "helm", "yaml", "json")

_SELECTOR_MAP = {
    "dockerfile": ("dockerfile",),
    "kubernetes": ("kubernetes", "helm"),
    "rbac": ("kubernetes", "helm"),
    "cloud": ("terraform", "cloudformation", "terraformplan",
              "azure-arm"),
    "terraform": ("terraform", "terraformplan"),
    "cloudformation": ("cloudformation",),
    "yaml": ("yaml",),
    "json": ("json",),
    "toml": (),
    "azure-arm": ("azure-arm",),
    "helm": ("helm",),
}


def _module_metadata(mod: Module, ev: Evaluator) -> dict:
    """Check metadata: `# METADATA` annotations (custom: id/severity/
    input.selector) or a `__rego_metadata__` rule (legacy), reference
    pkg/iac/rego/metadata.go."""
    md: dict = {}
    ann = mod.metadata.get("deny") or mod.metadata.get("") or {}
    if ann:
        md.update({k: v for k, v in ann.items()
                   if k in ("title", "description")})
        custom = ann.get("custom") or {}
        if isinstance(custom, dict):
            md.update(custom)
    if "__rego_metadata__" in mod.rules:
        v = ev.query("data." + ".".join(mod.package) +
                     ".__rego_metadata__")
        if isinstance(v, dict):
            md.update(v)
    sel = md.get("input", {}).get("selector") if isinstance(
        md.get("input"), dict) else None
    if not sel and "__rego_input__" in mod.rules:
        v = ev.query("data." + ".".join(mod.package) + ".__rego_input__")
        if isinstance(v, dict):
            sel = (v.get("selector") or {})
            if isinstance(sel, dict):
                sel = [sel]
    if sel:
        # selector present: scope strictly to what it maps to (an
        # unsupported type maps to no inputs, not to every input)
        types: list[str] = []
        for s in sel:
            if isinstance(s, dict):
                types.extend(_SELECTOR_MAP.get(s.get("type", ""), ()))
        md["_file_types"] = tuple(dict.fromkeys(types))
    else:
        md["_file_types"] = _ALL_TYPES
    return md


def load_rego_checks(paths: list[str], data: dict | None = None) -> list:
    """Parse .rego files into engine Checks. All modules load into one
    shared Evaluator so cross-module imports (`import data.lib.x`)
    resolve; only modules with a `deny` rule become checks (the rest are
    libraries). Reference scanner behavior: a module without metadata
    reports ID "N/A" / severity UNKNOWN and applies to every input
    type (integration/testdata/dockerfile-custom-policies.json.golden)."""
    from trivy_tpu_torch.iac.check import Cause, Check
    from trivy_tpu_torch.iac.engine import input_doc

    modules = []
    for p in paths:
        with open(p, encoding="utf-8", errors="replace") as f:
            src = f.read()
        try:
            modules.append(parse_module(src))
        except RegoError as e:
            raise RegoError(f"{p}: {e}")
    checks = []
    for mod in modules:
        if "deny" not in mod.rules:
            continue
        pkg = ".".join(mod.package)
        ev = Evaluator(modules, data=data)
        md = _module_metadata(mod, ev)
        sev = str(md.get("severity", "UNKNOWN")).upper()
        if sev not in _SEVERITIES:
            sev = "UNKNOWN"

        def fn(ctx, _pkg=pkg, _modules=modules, _data=data):
            evq = Evaluator(_modules, input=input_doc(ctx), data=_data)
            res = evq.query(f"data.{_pkg}.deny")
            causes = []
            if res is True:         # classic complete rule: deny { .. }
                return [Cause(message=f"data.{_pkg}.deny")]
            if isinstance(res, (str, dict)):
                res = Set([res])    # deny = "msg" { .. } style
            if res is False or res is None:
                res = ()
            for item in res:
                if isinstance(item, dict):
                    causes.append(Cause(
                        message=str(item.get("msg", "")),
                        start_line=int(item.get("startline", 0) or 0),
                        end_line=int(item.get("endline", 0) or 0),
                    ))
                else:
                    causes.append(Cause(message=str(item)))
            return causes

        checks.append(Check(
            id=str(md.get("id", "N/A")),
            avd_id=str(md.get("avd_id", md.get("id", "N/A"))),
            title=str(md.get("title", "N/A")),
            description=md.get("description",
                               f"Rego module: data.{pkg}"),
            resolution=str(md.get("recommended_actions",
                                  md.get("recommended_action", ""))),
            severity=sev,
            file_types=md["_file_types"],
            provider="Generic", service="general",
            url=str(md.get("url", "")),
            namespace=pkg,
            fn=fn,
        ))
    return checks
