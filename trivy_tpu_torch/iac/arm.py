"""Azure ARM template expression evaluator.

The reference resolves `[...]` expressions in ARM templates before
scanning: an expression tree (pkg/iac/scanners/azure/expressions/
{lex,node}.go) is evaluated against the deployment's parameters and
variables with ~100 template functions (pkg/iac/scanners/azure/
functions/*.go, resolver/resolver.go). Without this, a template that
routes `supportsHttpsTrafficOnly` through `[parameters('x')]` scans as
an opaque string and every azure check stays silent.

This module is the tpu-repo equivalent: parse the expression grammar
(single-quoted strings with '' escapes, nested calls, `.prop` and
`[idx]` access), evaluate against a Deployment (parameter values /
defaultValues, lazily-resolved variables, copyIndex context), expand
resource `copy` loops, drop `condition: false` resources, and flatten
nested Microsoft.Resources/deployments (azure/arm/parser, deployment.go).

Unresolvable expressions (unknown functions like reference()/list*(),
parameters with no value or defaultValue) resolve to None — the
adapters' "unknown" marker — matching the reference's KindUnresolvable
semantics (resolver.go:36-40): checks stay silent rather than
false-positive on a value the scanner cannot know.

Copy of trivy_tpu/iac/arm.py, whole.
"""

from __future__ import annotations

import copy as _copy
import hashlib
import json
import re


class ArmError(Exception):
    pass


class _UnresolvedType:
    __slots__ = ()

    def __repr__(self):
        return "UNRESOLVED"

    def __bool__(self):
        return False


UNRESOLVED = _UnresolvedType()

_MAX_DEPLOYMENT_DEPTH = 8


# ------------------------------------------------------------ expression


def is_expression(v) -> bool:
    """ARM: a string wrapped in [ ] is an expression; `[[` escapes a
    literal bracket (azure/arm/parser/template.go)."""
    return (isinstance(v, str) and v.startswith("[") and v.endswith("]")
            and not v.startswith("[["))


_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<num>-?\d+(\.\d+)?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<punct>[(),.\[\]])
""", re.X)


def _lex(code: str) -> list[tuple[str, object]]:
    toks: list[tuple[str, object]] = []
    i, n = 0, len(code)
    while i < n:
        c = code[i]
        if c == "'":
            j, out = i + 1, []
            while j < n:
                if code[j] == "'":
                    if j + 1 < n and code[j + 1] == "'":   # '' escape
                        out.append("'")
                        j += 2
                        continue
                    break
                out.append(code[j])
                j += 1
            if j >= n:
                raise ArmError(f"unterminated string in {code!r}")
            toks.append(("str", "".join(out)))
            i = j + 1
            continue
        m = _TOKEN_RE.match(code, i)
        if not m:
            raise ArmError(f"bad character {c!r} in {code!r}")
        if m.lastgroup == "num":
            text = m.group("num")
            toks.append(("num", float(text) if "." in text
                         else int(text)))
        elif m.lastgroup == "name":
            toks.append(("name", m.group("name")))
        elif m.lastgroup == "punct":
            toks.append(("punct", m.group("punct")))
        i = m.end()
    toks.append(("eof", ""))
    return toks


class _ExprParser:
    """expr := (call | literal) postfix*; call := name '(' args ')';
    postfix := '.' name | '[' expr ']' (expressions/node.go shapes)."""

    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def _peek(self):
        return self.toks[self.i]

    def _next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def parse(self):
        e = self._expr()
        if self._peek()[0] != "eof":
            raise ArmError(f"trailing tokens at {self._peek()!r}")
        return e

    def _expr(self):
        kind, val = self._peek()
        if kind in ("str", "num"):
            self._next()
            node = ("lit", val)
        elif kind == "name":
            self._next()
            if self._peek() == ("punct", "("):
                self._next()
                args = []
                if self._peek() != ("punct", ")"):
                    while True:
                        args.append(self._expr())
                        if self._peek() == ("punct", ","):
                            self._next()
                            continue
                        break
                if self._next() != ("punct", ")"):
                    raise ArmError(f"expected ) in call {val}")
                node = ("call", val, args)
            else:
                # bare name: ARM only allows function calls; treat a
                # bare identifier as unresolvable
                node = ("lit", UNRESOLVED)
        else:
            raise ArmError(f"unexpected token {self._peek()!r}")
        while True:
            if self._peek() == ("punct", "."):
                self._next()
                k, v = self._next()
                if k != "name":
                    raise ArmError("expected property name after .")
                node = ("dot", node, v)
            elif self._peek() == ("punct", "["):
                self._next()
                idx = self._expr()
                if self._next() != ("punct", "]"):
                    raise ArmError("expected ] after index")
                node = ("idx", node, idx)
            else:
                return node


def parse_expression(code: str):
    return _ExprParser(_lex(code)).parse()


# ------------------------------------------------------------ deployment


class Deployment:
    """Resolution context: parameter values (supplied > defaultValue),
    lazily-memoized variables, copy-loop indices."""

    def __init__(self, template: dict, parameter_values: dict | None =
                 None):
        self.template = template or {}
        self._param_defs = self.template.get("parameters") or {}
        self._param_values = dict(parameter_values or {})
        self._var_defs = self.template.get("variables") or {}
        self._var_memo: dict = {}
        self._resolving: set = set()
        self.copy_indices: dict[str, int] = {}

    def parameter(self, name):
        key = "p:" + name
        if key in self._resolving:      # parameter cycle
            return UNRESOLVED
        self._resolving.add(key)
        try:
            if name in self._param_values:
                return resolve_value(self._param_values[name], self)
            d = self._param_defs.get(name)
            if isinstance(d, dict) and "defaultValue" in d:
                return resolve_value(d["defaultValue"], self)
            return UNRESOLVED
        finally:
            self._resolving.discard(key)

    def variable(self, name):
        if name in self._var_memo:
            return self._var_memo[name]
        if name not in self._var_defs:
            return UNRESOLVED
        if "v:" + name in self._resolving:      # variable cycle
            return UNRESOLVED
        self._resolving.add("v:" + name)
        try:
            v = resolve_value(self._var_defs[name], self)
        finally:
            self._resolving.discard("v:" + name)
        self._var_memo[name] = v
        return v

    def copy_index(self, name: str | None, offset: int = 0):
        if name is None:
            if len(self.copy_indices) != 1:
                cur = self.copy_indices.get("")
                if cur is None:
                    return UNRESOLVED
                return cur + offset
            return next(iter(self.copy_indices.values())) + offset
        idx = self.copy_indices.get(name)
        return UNRESOLVED if idx is None else idx + offset


# ------------------------------------------------------------- functions


def _want_str(args):
    return all(isinstance(a, str) for a in args)


def _concat(*args):
    if args and all(isinstance(a, list) for a in args):
        out = []
        for a in args:
            out.extend(a)
        return out
    return "".join(_to_str(a) for a in args)


def _to_str(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, (dict, list)):
        return json.dumps(v, separators=(",", ":"))
    return str(v)


def _format(fmt, *args):
    if not isinstance(fmt, str):
        return UNRESOLVED
    out = fmt
    for i, a in enumerate(args):
        out = out.replace("{%d}" % i, _to_str(a))
    return out


def _equals(a, b):
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    return a == b


def _empty(x):
    if x is None:
        return True
    if isinstance(x, (str, list, dict)):
        return len(x) == 0
    return False


def _contains(coll, item):
    if isinstance(coll, str):
        return _to_str(item) in coll
    if isinstance(coll, list):
        return item in coll
    if isinstance(coll, dict):
        return item in coll
    return False


def _split(s, d):
    if not isinstance(s, str):
        return UNRESOLVED
    if isinstance(d, list):
        if not d:
            return [s]
        for other in d[1:]:     # split once on ANY delimiter
            s = s.replace(other, d[0])
        return s.split(d[0])
    return s.split(d)


def _length(x):
    if isinstance(x, (str, list, dict)):
        return len(x)
    return UNRESOLVED


def _unique_string(*args):
    # deterministic 13-hex-char digest of the joined inputs
    # (functions/unique_string.go)
    joined = "".join(_to_str(a) for a in args)
    return hashlib.sha256(joined.encode()).hexdigest()[:13]


def _guid(*args):
    h = hashlib.sha256("-".join(_to_str(a) for a in args).encode())
    d = h.hexdigest()
    return f"{d[0:8]}-{d[8:12]}-{d[12:16]}-{d[16:20]}-{d[20:32]}"


def _resource_id(*args):
    # reference joins every arg with "/" (functions/resource.go:7-20)
    if len(args) < 2:
        return UNRESOLVED
    return "".join("/" + _to_str(a) for a in args)


def _resource_group():
    return {
        "id": "/subscriptions/00000000-0000-0000-0000-000000000000"
              "/resourceGroups/PlaceHolderResourceGroup",
        "name": "Placeholder Resource Group",
        "type": "Microsoft.Resources/resourceGroups",
        "location": "westus",
        "tags": {},
        "properties": {"provisioningState": "Succeeded"},
    }


def _subscription():
    return {
        "id": "/subscriptions/00000000-0000-0000-0000-000000000000",
        "subscriptionId": "00000000-0000-0000-0000-000000000000",
        "tenantId": "00000000-0000-0000-0000-000000000000",
        "displayName": "Placeholder Subscription",
    }


def _coalesce(*xs):
    """Left-to-right: first definite non-null wins; UNRESOLVED only
    when an unknown is hit before any definite value."""
    for x in xs:
        if x is UNRESOLVED:
            return UNRESOLVED
        if x is not None:
            return x
    return None


def _int2(f):
    def g(*args):
        nums = []
        for a in args:
            if isinstance(a, bool) or not isinstance(a, (int, float)):
                return UNRESOLVED
            nums.append(a)
        try:
            return f(*nums)
        except ZeroDivisionError:
            return UNRESOLVED
    return g


def _union(*args):
    if all(isinstance(a, dict) for a in args):
        out: dict = {}
        for a in args:
            out.update(a)
        return out
    if all(isinstance(a, list) for a in args):
        out_l: list = []
        for a in args:
            for x in a:
                if x not in out_l:
                    out_l.append(x)
        return out_l
    return UNRESOLVED


def _intersection(*args):
    if all(isinstance(a, list) for a in args) and args:
        out = [x for x in args[0] if all(x in a for a in args[1:])]
        return out
    if all(isinstance(a, dict) for a in args) and args:
        keys = set(args[0])
        for a in args[1:]:
            keys &= set(a)
        return {k: args[0][k] for k in args[0] if k in keys}
    return UNRESOLVED


def _items(obj):
    if not isinstance(obj, dict):
        return UNRESOLVED
    return [{"key": k, "value": obj[k]} for k in sorted(obj)]


def _to_int(x):
    try:
        return int(x)
    except (TypeError, ValueError):
        return UNRESOLVED


def _to_bool(x):
    if isinstance(x, bool):
        return x
    if isinstance(x, str):
        return x.lower() == "true"
    if isinstance(x, (int, float)):
        return x != 0
    return UNRESOLVED


# name -> (fn, needs_deployment)
_FUNCS: dict = {
    "concat": _concat,
    "format": _format,
    "toLower": lambda s: s.lower() if isinstance(s, str) else UNRESOLVED,
    "toUpper": lambda s: s.upper() if isinstance(s, str) else UNRESOLVED,
    "replace": lambda s, a, b: s.replace(a, b) if _want_str((s, a, b))
    else UNRESOLVED,
    "trim": lambda s: s.strip() if isinstance(s, str) else UNRESOLVED,
    "substring": lambda s, off, ln=None: (
        s[off:] if ln is None else s[off:off + ln]) if isinstance(
            s, str) else UNRESOLVED,
    "split": _split,
    "join": lambda arr, d: d.join(_to_str(x) for x in arr)
    if isinstance(arr, list) else UNRESOLVED,
    "startsWith": lambda s, p: s.startswith(p) if _want_str((s, p))
    else UNRESOLVED,
    "endsWith": lambda s, p: s.endswith(p) if _want_str((s, p))
    else UNRESOLVED,
    "indexOf": lambda s, x: s.find(x) if _want_str((s, x))
    else UNRESOLVED,
    "lastIndexOf": lambda s, x: s.rfind(x) if _want_str((s, x))
    else UNRESOLVED,
    "padLeft": lambda s, w, c=" ": _to_str(s).rjust(w, c),
    "string": _to_str,
    "int": _to_int,
    "float": lambda x: float(x) if not isinstance(x, (dict, list))
    else UNRESOLVED,
    "bool": _to_bool,
    "length": _length,
    "empty": _empty,
    "contains": _contains,
    "equals": _equals,
    "not": lambda b: (not b) if isinstance(b, bool) else UNRESOLVED,
    "and": lambda *bs: (False if any(b is False for b in bs) else
                        UNRESOLVED if any(b is UNRESOLVED for b in bs)
                        else all(b is True for b in bs)),
    "or": lambda *bs: (True if any(b is True for b in bs) else
                       UNRESOLVED if any(b is UNRESOLVED for b in bs)
                       else False),
    "if": lambda c, t, f: (UNRESOLVED if c is UNRESOLVED else
                           t if c is True else f),
    "coalesce": _coalesce,
    "add": _int2(lambda a, b: a + b),
    "sub": _int2(lambda a, b: a - b),
    "mul": _int2(lambda a, b: a * b),
    "div": _int2(lambda a, b: a // b if isinstance(a, int) and
                 isinstance(b, int) else a / b),
    "mod": _int2(lambda a, b: a % b),
    "min": _int2(min),
    "max": _int2(max),
    "range": lambda start, count: list(range(start, start + count))
    if isinstance(start, int) and isinstance(count, int)
    else UNRESOLVED,
    "array": lambda x: x if isinstance(x, list) else [x],
    "createArray": lambda *xs: list(xs),
    "createObject": lambda *xs: {xs[i]: xs[i + 1]
                                 for i in range(0, len(xs) - 1, 2)},
    "items": _items,
    "first": lambda x: (x[0] if x else UNRESOLVED) if isinstance(
        x, (list, str)) else UNRESOLVED,
    "last": lambda x: (x[-1] if x else UNRESOLVED) if isinstance(
        x, (list, str)) else UNRESOLVED,
    "take": lambda x, n: x[:n] if isinstance(x, (list, str))
    else UNRESOLVED,
    "skip": lambda x, n: x[n:] if isinstance(x, (list, str))
    else UNRESOLVED,
    "union": _union,
    "intersection": _intersection,
    "uniqueString": _unique_string,
    "guid": _guid,
    "base64": lambda s: __import__("base64").b64encode(
        s.encode()).decode() if isinstance(s, str) else UNRESOLVED,
    "base64ToString": lambda s: __import__("base64").b64decode(
        s).decode() if isinstance(s, str) else UNRESOLVED,
    "base64ToJson": lambda s: json.loads(__import__(
        "base64").b64decode(s)) if isinstance(s, str) else UNRESOLVED,
    "dataUri": lambda s: "data:text/plain;charset=utf8;base64," +
    __import__("base64").b64encode(_to_str(s).encode()).decode(),
    "json": lambda s: json.loads(s) if isinstance(s, str)
    else UNRESOLVED,
    "true": lambda: True,
    "false": lambda: False,
    "null": lambda: None,
    "resourceId": _resource_id,
    "subscriptionResourceId": _resource_id,
    "tenantResourceId": _resource_id,
    "extensionResourceId": _resource_id,
    "resourceGroup": _resource_group,
    "subscription": _subscription,
    "tenant": lambda: {"tenantId":
                       "00000000-0000-0000-0000-000000000000"},
    "deployment": lambda: {"name": "placeholder-deployment",
                           "properties": {}},
    "environment": lambda *a: UNRESOLVED,
    "managementGroup": lambda *a: UNRESOLVED,
    # runtime-only: cannot be known at scan time
    "reference": lambda *a: UNRESOLVED,
    "list": lambda *a: UNRESOLVED,
    "listKeys": lambda *a: UNRESOLVED,
    "listSecrets": lambda *a: UNRESOLVED,
    "newGuid": lambda *a: UNRESOLVED,
    "utcNow": lambda *a: UNRESOLVED,
    "pickZones": lambda *a: UNRESOLVED,
}

_DEPLOYMENT_FUNCS = {"parameters", "variables", "copyIndex"}


def _eval(node, dep: Deployment):
    kind = node[0]
    if kind == "lit":
        return node[1]
    if kind == "dot":
        base = _eval(node[1], dep)
        if isinstance(base, dict) and node[2] in base:
            return resolve_value(base[node[2]], dep)
        return UNRESOLVED
    if kind == "idx":
        base = _eval(node[1], dep)
        idx = _eval(node[2], dep)
        if isinstance(base, list) and isinstance(idx, int) and not \
                isinstance(idx, bool) and 0 <= idx < len(base):
            return resolve_value(base[idx], dep)
        if isinstance(base, dict) and isinstance(idx, str) and \
                idx in base:
            return resolve_value(base[idx], dep)
        return UNRESOLVED
    # call
    name, arg_nodes = node[1], node[2]
    args = [_eval(a, dep) for a in arg_nodes]
    if name == "parameters":
        return dep.parameter(args[0]) if args and isinstance(
            args[0], str) else UNRESOLVED
    if name == "variables":
        return dep.variable(args[0]) if args and isinstance(
            args[0], str) else UNRESOLVED
    if name == "copyIndex":
        if not args:
            return dep.copy_index(None)
        if isinstance(args[0], str):
            return dep.copy_index(args[0], args[1] if len(args) > 1
                                  else 0)
        return dep.copy_index(None, args[0] if isinstance(args[0], int)
                              else 0)
    fn = _FUNCS.get(name)
    if fn is None:
        return UNRESOLVED
    if name not in ("if", "coalesce", "and", "or") and any(
            a is UNRESOLVED for a in args):
        return UNRESOLVED
    try:
        return fn(*args)
    except Exception:
        return UNRESOLVED


def evaluate_expression(code: str, dep: Deployment):
    """Evaluate the inside of one `[...]` expression string."""
    try:
        return _eval(parse_expression(code), dep)
    except ArmError:
        return UNRESOLVED


def resolve_value(v, dep: Deployment):
    """Recursively resolve a template value: expression strings
    evaluate, `[[` unescapes, containers recurse."""
    if is_expression(v):
        # evaluate exactly once: parameters()/variables()/property
        # access resolve their own raw template subtrees, so the result
        # is final — a computed "[x]" string must NOT be re-parsed
        return evaluate_expression(v[1:-1], dep)
    if isinstance(v, str) and v.startswith("[["):
        return v[1:]
    if isinstance(v, dict):
        return {k: resolve_value(x, dep) for k, x in v.items()}
    if isinstance(v, list):
        return [resolve_value(x, dep) for x in v]
    return v


# --------------------------------------------------------------- template


def _strip_unresolved(v):
    if v is UNRESOLVED:
        return None
    if isinstance(v, dict):
        return {k: _strip_unresolved(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_strip_unresolved(x) for x in v]
    return v


def _expand_resource(res: dict, dep: Deployment, depth: int) -> list:
    """One raw resource -> resolved resource(s): copy loops expand,
    false conditions drop, nested deployments flatten."""
    copy_spec = res.get("copy")
    if isinstance(copy_spec, dict):
        name = str(copy_spec.get("name", ""))
        count = resolve_value(copy_spec.get("count", 1), dep)
        if not isinstance(count, int) or isinstance(count, bool) or \
                count < 0:
            count = 1
        out = []
        body = {k: v for k, v in res.items() if k != "copy"}
        for i in range(min(count, 256)):
            dep.copy_indices[name] = i
            dep.copy_indices[""] = i
            out.extend(_expand_resource(body, dep, depth))
        dep.copy_indices.pop(name, None)
        dep.copy_indices.pop("", None)
        return out

    if "condition" in res:
        cond = resolve_value(res["condition"], dep)
        if cond is False:
            return []

    rtype = res.get("type")
    if rtype == "Microsoft.Resources/deployments" and \
            depth < _MAX_DEPLOYMENT_DEPTH:
        props = res.get("properties") or {}
        inner = props.get("template")
        if isinstance(inner, dict):
            raw_params = resolve_value(props.get("parameters") or {},
                                       dep)
            inner_values = {
                k: v.get("value") for k, v in raw_params.items()
                if isinstance(v, dict)
            } if isinstance(raw_params, dict) else {}
            return _evaluate_resources(inner, inner_values, depth + 1)

    return [resolve_value(res, dep)]


def _evaluate_resources(template: dict, parameter_values: dict | None,
                        depth: int) -> list:
    dep = Deployment(template, parameter_values)
    out = []
    for res in template.get("resources") or []:
        if isinstance(res, dict):
            out.extend(_expand_resource(res, dep, depth))
    return out


def evaluate_template(doc: dict,
                      parameter_values: dict | None = None) -> dict:
    """Resolve every expression in an ARM template document. Returns a
    new document whose `resources` are fully resolved (copy loops
    expanded, nested deployments hoisted inline, unresolvable values
    as None)."""
    doc = _copy.deepcopy(doc) if doc else {}
    resources = _evaluate_resources(doc, parameter_values, 0)
    doc["resources"] = [_strip_unresolved(r) for r in resources]
    return doc
