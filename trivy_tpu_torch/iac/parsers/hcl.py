"""HCL2 subset parser for terraform files (reference pkg/iac/scanners/
terraform wraps hashicorp/hcl; this is a from-scratch recursive-descent
parser for the structural subset checks need: blocks, attributes,
literals, lists, objects, heredocs; expressions that reference variables
or call functions are kept as opaque Expr markers).

Copy of trivy_tpu/iac/parsers/hcl.py, whole.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


class Expr:
    """Unevaluated expression (reference: hcl traversal/function exprs)."""

    def __init__(self, text: str):
        self.text = text.strip()

    def __repr__(self):
        return f"Expr({self.text!r})"

    def __eq__(self, other):
        return isinstance(other, Expr) and self.text == other.text

    def __hash__(self):
        return hash(("Expr", self.text))


@dataclass
class Attribute:
    name: str
    value: object
    line: int = 0


@dataclass
class Block:
    type: str = ""                 # resource / provider / variable / ...
    labels: list[str] = field(default_factory=list)
    attrs: dict[str, Attribute] = field(default_factory=dict)
    blocks: list["Block"] = field(default_factory=list)
    start_line: int = 0
    end_line: int = 0
    src_path: str = ""             # set by the terraform evaluator
    # module-instance path ("a.b" = module "b" inside module "a"; "" =
    # root), set by the terraform evaluator — distinguishes two
    # instantiations of the SAME source directory for checks whose
    # reference scopes per module instance
    module_id: str = ""

    def get(self, name: str, default=None):
        a = self.attrs.get(name)
        return a.value if a is not None else default

    def line_of(self, name: str) -> int:
        a = self.attrs.get(name)
        return a.line if a is not None else self.start_line

    def children(self, btype: str) -> list["Block"]:
        return [b for b in self.blocks if b.type == btype]

    def child(self, btype: str) -> "Block | None":
        for b in self.blocks:
            if b.type == btype:
                return b
        return None


# ------------------------------------------------------------ tokenizer

_TOKEN_RE = re.compile(r"""
    (?P<comment>\#[^\n]*|//[^\n]*|/\*.*?\*/)
  | (?P<heredoc><<-?\s*(?P<hd_tag>\w+)\n)
  | (?P<string>"(?:\$\{[^}]*\}|[^"\\]|\\.)*")
  | (?P<number>-?\d+(?:\.\d+)?)
  | (?P<ident>[A-Za-z_][\w.\-*]*(?:\[[^\]\n]*\][\w.\-*]*)*)
  | (?P<op>\|\||&&|==|!=|<=|>=|=>|\?|[+*/%!<>-])
  | (?P<punct>[{}\[\](),=:])
  | (?P<newline>\n)
  | (?P<ws>[ \t\r]+)
""", re.X | re.S)


@dataclass
class _Tok:
    kind: str
    text: str
    line: int


def _tokenize(text: str) -> list[_Tok]:
    toks: list[_Tok] = []
    line = 1
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            pos += 1  # skip unknown char
            continue
        kind = m.lastgroup
        tok_text = m.group(0)
        if kind == "heredoc":
            tag = m.group("hd_tag")
            end = re.search(rf"^\s*{re.escape(tag)}\s*$", text[m.end():],
                            re.M)
            if end:
                body = text[m.end():m.end() + end.start()]
                full_end = m.end() + end.end()
            else:
                body = text[m.end():]
                full_end = len(text)
            toks.append(_Tok("string", body, line))
            line += text[pos:full_end].count("\n")
            pos = full_end
            continue
        if kind not in ("ws", "comment"):
            if kind == "newline":
                toks.append(_Tok("newline", "\n", line))
            else:
                toks.append(_Tok(kind, tok_text, line))
        line += tok_text.count("\n")
        pos = m.end()
    toks.append(_Tok("eof", "", line))
    return toks


# ------------------------------------------------------------ parser


class _Parser:
    def __init__(self, toks: list[_Tok]):
        self.toks = toks
        self.i = 0

    def peek(self, skip_nl=True) -> _Tok:
        j = self.i
        while skip_nl and self.toks[j].kind == "newline":
            j += 1
        return self.toks[j]

    def next(self, skip_nl=True) -> _Tok:
        while skip_nl and self.toks[self.i].kind == "newline":
            self.i += 1
        t = self.toks[self.i]
        self.i += 1
        return t

    def parse_body(self, end_brace=False) -> tuple[dict, list]:
        attrs: dict[str, Attribute] = {}
        blocks: list[Block] = []
        while True:
            t = self.peek()
            if t.kind == "eof":
                break
            if end_brace and t.text == "}":
                self.next()
                break
            if t.kind in ("ident", "string"):
                self._parse_item(attrs, blocks)
            else:
                self.next()  # skip stray token
        return attrs, blocks

    def _parse_item(self, attrs, blocks):
        first = self.next()
        name = first.text.strip('"')
        nxt = self.peek()
        if nxt.text == "=":
            self.next()
            start = self.i
            if self.peek().kind == "op":    # unary !x / -x / ...
                value = self._capture_expr(start, ())
            else:
                value = self.parse_value()
                if self.peek(skip_nl=False).kind == "op":
                    # operator continues the expression (a ? b : c,
                    # x + y, ...): recapture the whole source span
                    value = self._capture_expr(start, ())
            attrs[name] = Attribute(name, value, first.line)
            return
        # block: ident [labels...] {
        labels = []
        while True:
            t = self.peek()
            if t.kind in ("string", "ident") and t.text != "{":
                labels.append(self.next().text.strip('"'))
            elif t.text == "{":
                self.next()
                a, b = self.parse_body(end_brace=True)
                blk = Block(type=name, labels=labels, attrs=a, blocks=b,
                            start_line=first.line,
                            end_line=self.toks[self.i - 1].line)
                blocks.append(blk)
                return
            else:
                return  # malformed; bail on this item

    def _capture_expr(self, start_idx: int, terminators) -> Expr:
        """Re-join raw tokens from start_idx up to the end of the
        expression (newline / terminator / closing bracket at depth 0)
        into an Expr for the terraform evaluator — multi-token
        expressions like `var.enabled ? 1 : 0` or `!var.open` span
        several tokens the literal-value grammar can't hold."""
        self.i = start_idx
        parts = []
        depth = 0
        while True:
            t = self.peek(skip_nl=False)
            if t.kind == "eof":
                break
            if t.kind == "newline":
                if depth == 0:
                    break
                self.next(skip_nl=False)
                continue
            if t.text in ("(", "[", "{"):
                depth += 1
            elif t.text in (")", "]", "}"):
                if depth == 0:
                    break
                depth -= 1
            elif depth == 0 and t.text in terminators:
                break
            parts.append(self.next(skip_nl=False).text)
        if not parts:
            self.next(skip_nl=False)    # always advance: a stuck
            # caller loop must never re-enter at the same token
        return Expr(" ".join(parts))

    def parse_value(self):
        t = self.peek()
        if t.text == "[":
            self.next()
            items = []
            while True:
                p = self.peek()
                if p.text == "]":
                    self.next()
                    break
                if p.kind == "eof":
                    break
                while self.peek(skip_nl=False).kind == "newline":
                    self.next(skip_nl=False)  # keep start off newlines:
                    # _capture_expr stops at depth-0 newlines
                start = self.i
                v = self.parse_value()
                if self.peek(skip_nl=False).kind == "op":
                    v = self._capture_expr(start, (",",))
                items.append(v)
                if self.peek().text == ",":
                    self.next()
            return items
        if t.text == "{":
            self.next()
            obj = {}
            while True:
                p = self.peek()
                if p.text == "}":
                    self.next()
                    break
                if p.kind == "eof":
                    break
                key = self.next().text.strip('"')
                if self.peek().text in ("=", ":"):
                    self.next()
                while self.peek(skip_nl=False).kind == "newline":
                    self.next(skip_nl=False)
                start = self.i
                v = self.parse_value()
                if self.peek(skip_nl=False).kind == "op":
                    v = self._capture_expr(start, (",",))
                obj[key] = v
                if self.peek().text == ",":
                    self.next()
            return obj
        if t.kind == "string":
            self.next()
            s = t.text
            if s.startswith('"'):
                s = s[1:-1]
            if "${" in s:
                # interpolation: literal if it collapses, else Expr
                stripped = re.sub(r"\$\{[^}]*\}", "", s)
                if stripped != s and not stripped:
                    return Expr(s)
            return s.replace('\\"', '"').replace("\\\\", "\\")
        if t.kind == "number":
            self.next()
            return float(t.text) if "." in t.text else int(t.text)
        if t.kind == "ident":
            # true/false/null or a reference/function-call expression
            self.next()
            if t.text == "true":
                return True
            if t.text == "false":
                return False
            if t.text == "null":
                return None
            expr = [t.text]
            # swallow a call's parens / indexing on the same line
            while self.peek(skip_nl=False).text == "(":
                depth = 0
                while True:
                    tok = self.next(skip_nl=False)
                    expr.append(tok.text)
                    if tok.text == "(":
                        depth += 1
                    elif tok.text == ")":
                        depth -= 1
                        if depth == 0:
                            break
                    if tok.kind == "eof":
                        break
            return Expr("".join(expr))
        self.next()
        return Expr(t.text)


def parse_hcl(content: bytes) -> list[Block]:
    """-> top-level blocks (resource/provider/module/variable/...)."""
    toks = _tokenize(content.decode("utf-8", "replace"))
    attrs, blocks = _Parser(toks).parse_body()
    # top-level attributes (tf.json style) are ignored here
    return blocks


def parse_tf_json(content: bytes) -> list[Block]:
    """Terraform JSON syntax (*.tf.json): {"resource": {"aws_s3_bucket":
    {"name": {attrs...}}}} -> the same Block IR parse_hcl yields."""
    import json as _json

    try:
        doc = _json.loads(content)
    except ValueError:
        return []
    if not isinstance(doc, dict):
        return []
    out: list[Block] = []
    for btype, groups in doc.items():
        if not isinstance(groups, dict):
            continue
        if btype in ("resource", "data"):
            for rtype, named in groups.items():
                if not isinstance(named, dict):
                    continue
                for name, body in named.items():
                    if isinstance(body, dict):
                        out.append(_json_block(btype, [rtype, name], body))
        else:  # provider/variable/... : one level of labels
            for name, body in groups.items():
                if isinstance(body, dict):
                    out.append(_json_block(btype, [name], body))
    return out


def _json_block(btype: str, labels: list[str], body: dict) -> Block:
    blk = Block(type=btype, labels=labels)
    for k, v in body.items():
        if isinstance(v, dict):
            blk.blocks.append(_json_block(k, [], v))
        elif (isinstance(v, list) and v
              and all(isinstance(i, dict) for i in v)):
            # repeated nested blocks (e.g. ingress rules)
            for i in v:
                blk.blocks.append(_json_block(k, [], i))
        else:
            val = v
            if isinstance(v, str) and "${" in v:
                val = Expr(v)
            blk.attrs[k] = Attribute(k, val, 0)
    return blk


def resources(blocks: list[Block], rtype: str | None = None) -> list[Block]:
    out = [b for b in blocks if b.type == "resource"]
    if rtype:
        out = [b for b in out if b.labels and b.labels[0] == rtype]
    return out
