"""SPDX license-expression model: lexer, recursive-descent parser, and
precedence-aware stringification.

Behavioral parity with reference pkg/licensing/expression/
(lexer.go:14-119, parser.go.y grammar, expression.go:27-89,
types.go:24-75): expressions are IDENT trees joined by OR < AND < WITH
(loosest to tightest binding), idents may carry a trailing '+', GNU
family licenses render as '-only' / '-or-later' instead of the bare
id / '+'.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "LicenseParseError", "SimpleExpr", "CompoundExpr", "parse",
    "normalize_expression", "normalize_for_spdx", "GNU_LICENSES",
]


class LicenseParseError(ValueError):
    pass


# reference expression/category.go:170-188 — GNU ids that take
# -only/-or-later suffixes per the SPDX spec.
GNU_LICENSES = frozenset({
    "AGPL-1.0", "AGPL-3.0",
    "GFDL-1.1-invariants", "GFDL-1.1-no-invariants", "GFDL-1.1",
    "GFDL-1.2-invariants", "GFDL-1.2-no-invariants", "GFDL-1.2",
    "GFDL-1.3-invariants", "GFDL-1.3-no-invariants", "GFDL-1.3",
    "GPL-1.0", "GPL-2.0", "GPL-3.0",
    "LGPL-2.0", "LGPL-2.1", "LGPL-3.0",
})

# binding strength; parenthesize a child whose op binds looser than its
# parent (reference expression.go:62-75 compares token ints the same way)
_PRECEDENCE = {"OR": 1, "AND": 2, "WITH": 3}


@dataclass(frozen=True)
class SimpleExpr:
    license: str
    has_plus: bool = False

    def __str__(self) -> str:
        if self.license in GNU_LICENSES:
            return self.license + ("-or-later" if self.has_plus else "-only")
        return self.license + ("+" if self.has_plus else "")


@dataclass(frozen=True)
class CompoundExpr:
    left: object
    op: str  # "AND" | "OR" | "WITH"
    right: object

    def __str__(self) -> str:
        def side(child) -> str:
            s = str(child)
            if (isinstance(child, CompoundExpr)
                    and _PRECEDENCE[self.op] > _PRECEDENCE[child.op]):
                return f"({s})"
            return s
        return f"{side(self.left)} {self.op} {side(self.right)}"


def _tokenize(text: str) -> list[str]:
    """Split into idents, operators, parens; a '+' glued to the end of a
    word stays attached to it (reference lexer.go:25-70)."""
    tokens: list[str] = []
    word: list[str] = []

    def flush():
        if word:
            tokens.append("".join(word))
            word.clear()

    for ch in text:
        if ch.isspace():
            flush()
        elif ch in "()":
            flush()
            tokens.append(ch)
        else:
            word.append(ch)
    flush()
    return tokens


_OPS = {"and": "AND", "or": "OR", "with": "WITH"}


class _Parser:
    def __init__(self, tokens: list[str]):
        self.tokens = tokens
        self.pos = 0

    def peek(self) -> str | None:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> str:
        tok = self.peek()
        if tok is None:
            raise LicenseParseError("unexpected end of license expression")
        self.pos += 1
        return tok

    def parse_or(self):
        left = self.parse_and()
        while (tok := self.peek()) and _OPS.get(tok.lower()) == "OR":
            self.next()
            left = CompoundExpr(left, "OR", self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_with()
        while (tok := self.peek()) and _OPS.get(tok.lower()) == "AND":
            self.next()
            left = CompoundExpr(left, "AND", self.parse_with())
        return left

    def parse_with(self):
        left = self.parse_primary()
        if (tok := self.peek()) and _OPS.get(tok.lower()) == "WITH":
            self.next()
            left = CompoundExpr(left, "WITH", self.parse_primary())
        return left

    def parse_primary(self):
        tok = self.next()
        if tok == "(":
            inner = self.parse_or()
            if self.next() != ")":
                raise LicenseParseError("unbalanced parenthesis")
            return inner
        if tok == ")" or _OPS.get(tok.lower()):
            raise LicenseParseError(f"unexpected token {tok!r}")
        if tok.endswith("+") and len(tok) > 1:
            return SimpleExpr(tok[:-1], has_plus=True)
        return SimpleExpr(tok)


def parse(text: str):
    tokens = _tokenize(text)
    if not tokens:
        raise LicenseParseError("empty license expression")
    p = _Parser(tokens)
    expr = p.parse_or()
    if p.peek() is not None:
        # bare idents side by side ("MIT Apache-2.0") are not valid SPDX
        raise LicenseParseError(f"trailing tokens in {text!r}")
    return expr


def normalize_expression(expr, fn):
    """Recursively apply a SimpleExpr→Expression normalization fn
    (reference expression.go:39-55)."""
    normalized = fn(expr)
    if isinstance(normalized, CompoundExpr):
        return CompoundExpr(
            normalize_expression(normalized.left, fn),
            normalized.op.upper(),
            normalize_expression(normalized.right, fn),
        )
    return normalized


def normalize_for_spdx(expr):
    """Replace characters invalid in an SPDX idstring with '-'
    (reference expression.go:58-84)."""
    if not isinstance(expr, SimpleExpr):
        return expr
    out = []
    for c in expr.license:
        if (c.isascii() and c.isalnum()) or c in "-.:":
            out.append(c)
        else:
            out.append("-")
    return SimpleExpr("".join(out), expr.has_plus)
