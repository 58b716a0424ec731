"""Minimal TOML loader for Python <= 3.10 (no stdlib ``tomllib``).

The lockfile/manifest parsers (`poetry.lock`, `uv.lock`, `Cargo.lock`,
`pyproject.toml`, Julia `Manifest.toml`) import ``tomllib`` lazily and
fall back to this module on interpreters that predate it.  It covers
the TOML subset those documents actually use:

- tables ``[a.b]`` and arrays-of-tables ``[[a.b]]`` (dotted headers);
- dotted keys, bare/quoted keys;
- basic / literal strings, their multi-line forms, common escapes;
- integers, floats, booleans;
- arrays (multi-line, trailing comma) and inline tables;
- comments and blank lines anywhere whitespace is legal.

Exotic corners (date-times, ``+nan``, CRLF escapes inside multi-line
strings…) raise ``TOMLDecodeError`` rather than mis-parse — callers
already treat a decode error as "not a parseable manifest".

Copy of trivy_tpu/parsers/toml_compat.py.
"""

from __future__ import annotations

import re


class TOMLDecodeError(ValueError):
    """The document does not parse under the supported TOML subset."""


_BARE_KEY_RX = re.compile(r"[A-Za-z0-9_-]+")
_NUM_RX = re.compile(
    r"[+-]?(?:0x[0-9A-Fa-f_]+|0o[0-7_]+|0b[01_]+"
    r"|(?:[0-9][0-9_]*)(?:\.[0-9_]+)?(?:[eE][+-]?[0-9_]+)?)")
_ESCAPES = {
    "b": "\b", "t": "\t", "n": "\n", "f": "\f", "r": "\r",
    '"': '"', "\\": "\\",
}


def load(fp) -> dict:
    return loads(fp.read().decode("utf-8"))


def loads(s: str) -> dict:
    if isinstance(s, (bytes, bytearray)):  # tolerated, like tomllib isn't
        s = bytes(s).decode("utf-8")
    return _Parser(s).parse()


class _Parser:
    def __init__(self, s: str):
        self.s = s.replace("\r\n", "\n")
        self.i = 0
        self.n = len(self.s)

    # ------------------------------------------------------------ cursor

    def _err(self, msg: str) -> TOMLDecodeError:
        line = self.s.count("\n", 0, self.i) + 1
        return TOMLDecodeError(f"{msg} (line {line})")

    def _peek(self) -> str:
        return self.s[self.i] if self.i < self.n else ""

    def _skip_ws(self, newlines: bool = False) -> None:
        """Skip spaces/tabs and comments; with ``newlines`` also skip
        line breaks (value positions inside arrays)."""
        while self.i < self.n:
            c = self.s[self.i]
            if c in " \t" or (newlines and c == "\n"):
                self.i += 1
            elif c == "#":
                nl = self.s.find("\n", self.i)
                self.i = self.n if nl < 0 else nl
            else:
                return

    def _expect_eol(self) -> None:
        self._skip_ws()
        if self.i < self.n and self.s[self.i] != "\n":
            raise self._err(
                f"unexpected trailing content {self.s[self.i:self.i+8]!r}")

    # ------------------------------------------------------------- keys

    def _key_part(self) -> str:
        c = self._peek()
        if c in ('"', "'"):
            return self._string()
        m = _BARE_KEY_RX.match(self.s, self.i)
        if not m:
            raise self._err("expected a key")
        self.i = m.end()
        return m.group(0)

    def _dotted_key(self) -> list[str]:
        parts = [self._key_part()]
        while True:
            self._skip_ws()
            if self._peek() != ".":
                return parts
            self.i += 1
            self._skip_ws()
            parts.append(self._key_part())

    @staticmethod
    def _descend(table: dict, parts: list[str]) -> dict:
        for p in parts:
            nxt = table.setdefault(p, {})
            if isinstance(nxt, list):  # [[x]] then [x.y]: into the last
                nxt = nxt[-1]
            if not isinstance(nxt, dict):
                raise TOMLDecodeError(f"key {p!r} is not a table")
            table = nxt
        return table

    # ------------------------------------------------------------ values

    def _string(self) -> str:
        q = self.s[self.i]
        triple = self.s.startswith(q * 3, self.i)
        self.i += 3 if triple else 1
        if triple and self._peek() == "\n":
            self.i += 1  # a newline right after ''' / """ is trimmed
        out: list[str] = []
        while self.i < self.n:
            c = self.s[self.i]
            if triple:
                if self.s.startswith(q * 3, self.i):
                    self.i += 3
                    return "".join(out)
            elif c == q:
                self.i += 1
                return "".join(out)
            elif c == "\n":
                raise self._err("newline in single-line string")
            if q == '"' and c == "\\":
                self.i += 1
                e = self._peek()
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 1
                elif e in "uU":
                    width = 4 if e == "u" else 8
                    hexs = self.s[self.i + 1: self.i + 1 + width]
                    if len(hexs) != width:
                        raise self._err("truncated unicode escape")
                    try:
                        out.append(chr(int(hexs, 16)))
                    except ValueError:
                        raise self._err(f"bad unicode escape {hexs!r}")
                    self.i += 1 + width
                elif triple and e == "\n":
                    # line-ending backslash: skip following whitespace
                    self.i += 1
                    while self._peek() in (" ", "\t", "\n"):
                        self.i += 1
                else:
                    raise self._err(f"unsupported escape \\{e}")
            else:
                out.append(c)
                self.i += 1
        raise self._err("unterminated string")

    def _value(self):
        self._skip_ws()
        c = self._peek()
        if c in ('"', "'"):
            return self._string()
        if c == "[":
            return self._array()
        if c == "{":
            return self._inline_table()
        if self.s.startswith("true", self.i):
            self.i += 4
            return True
        if self.s.startswith("false", self.i):
            self.i += 5
            return False
        m = _NUM_RX.match(self.s, self.i)
        if m:
            tok = m.group(0)
            # a date-time would continue with '-' or ':' — unsupported
            nxt = self.s[m.end(): m.end() + 1]
            if nxt in ("-", ":"):
                raise self._err("date-time values are not supported")
            self.i = m.end()
            tok = tok.replace("_", "")
            try:
                if any(x in tok for x in (".", "e", "E")) \
                        and not tok.lower().startswith(("0x", "-0x", "+0x")):
                    return float(tok)
                return int(tok, 0)
            except ValueError:
                raise self._err(f"bad number {tok!r}")
        raise self._err(f"cannot parse value at {self.s[self.i:self.i+12]!r}")

    def _array(self) -> list:
        self.i += 1  # '['
        out: list = []
        while True:
            self._skip_ws(newlines=True)
            if self._peek() == "]":
                self.i += 1
                return out
            if self.i >= self.n:
                raise self._err("unterminated array")
            out.append(self._value())
            self._skip_ws(newlines=True)
            if self._peek() == ",":
                self.i += 1
            elif self._peek() != "]":
                raise self._err("expected ',' or ']' in array")

    def _inline_table(self) -> dict:
        self.i += 1  # '{'
        out: dict = {}
        self._skip_ws()
        if self._peek() == "}":
            self.i += 1
            return out
        while True:
            self._skip_ws()
            parts = self._dotted_key()
            self._skip_ws()
            if self._peek() != "=":
                raise self._err("expected '=' in inline table")
            self.i += 1
            self._descend(out, parts[:-1])[parts[-1]] = self._value()
            self._skip_ws()
            c = self._peek()
            if c == ",":
                self.i += 1
            elif c == "}":
                self.i += 1
                return out
            else:
                raise self._err("expected ',' or '}' in inline table")

    # ----------------------------------------------------------- document

    def parse(self) -> dict:
        root: dict = {}
        cur = root
        while True:
            self._skip_ws(newlines=True)
            if self.i >= self.n:
                return root
            if self._peek() == "[":
                aot = self.s.startswith("[[", self.i)
                self.i += 2 if aot else 1
                self._skip_ws()
                parts = self._dotted_key()
                self._skip_ws()
                closer = "]]" if aot else "]"
                if not self.s.startswith(closer, self.i):
                    raise self._err(f"expected {closer!r}")
                self.i += len(closer)
                self._expect_eol()
                parent = self._descend(root, parts[:-1])
                leaf = parts[-1]
                if aot:
                    arr = parent.setdefault(leaf, [])
                    if not isinstance(arr, list):
                        raise self._err(f"key {leaf!r} is not an array "
                                        "of tables")
                    arr.append({})
                    cur = arr[-1]
                else:
                    nxt = parent.setdefault(leaf, {})
                    if isinstance(nxt, list):
                        nxt = nxt[-1]
                    if not isinstance(nxt, dict):
                        raise self._err(f"key {leaf!r} redefined as a "
                                        "table")
                    cur = nxt
            else:
                parts = self._dotted_key()
                self._skip_ws()
                if self._peek() != "=":
                    raise self._err("expected '=' after key")
                self.i += 1
                self._descend(cur, parts[:-1])[parts[-1]] = self._value()
                self._expect_eol()
