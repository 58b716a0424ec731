"""Plain reference of trivy's secret scanner (`pkg/fanal/secret/scanner.go`).

For one file: skip binary extensions, files an allow rule's path
excludes, and contents with a NUL byte in their first 8,000 bytes; then
for every built-in rule whose keyword occurs in the lowercased content
(or that has none) and whose path pattern fits, run the rule's regex
over the whole content, take the secret group (or the whole match),
drop values an allow rule excuses, and report the rule, the lines, the
censored line and the offset, sorted by line and rule.

`lossy=True` is the control: each rule runs over independent 16 KiB
pieces of the file, with no overlap, so a secret across a piece's edge
is lost. That is the shortcut a faster screen would tempt, and it breaks
the guarantee that every secret of the whole file is found.
"""

from __future__ import annotations

import re

from portbench.reference.secret_rules import (
    BUILTIN_ALLOW_RULES,
    BUILTIN_RULES,
    SKIP_EXTENSIONS,
)

PIECE = 16384


class _Rule:
    __slots__ = ("id", "regex", "keywords", "group", "path_rx")

    def __init__(self, r):
        self.id = r.id
        self.regex = re.compile(r.regex.encode())
        self.keywords = [k.lower().encode() for k in r.keywords]
        self.group = r.secret_group
        self.path_rx = (re.compile(re.escape(r.path_pattern)
                                   .replace(r"\*", ".*") + "$")
                        if r.path_pattern else None)


class SecretReference:
    def __init__(self, lossy: bool = False):
        self.lossy = lossy
        self.rules = [_Rule(r) for r in BUILTIN_RULES]
        self.path_allow = [re.compile(a.path) for a in BUILTIN_ALLOW_RULES
                           if a.path and not a.regex]
        self.value_allow = [(re.compile(a.path) if a.path else None,
                             re.compile(a.regex.encode()))
                            for a in BUILTIN_ALLOW_RULES if a.regex]
        self.skip = tuple(SKIP_EXTENSIONS)

    def _allowed(self, path: str, secret: bytes) -> bool:
        return any((p is None or p.match(path)) and v.match(secret)
                   for p, v in self.value_allow)

    @staticmethod
    def _finding(rule_id: str, content: bytes, start: int, end: int):
        line_start = content.rfind(b"\n", 0, start) + 1
        line_end = content.find(b"\n", end)
        if line_end < 0:
            line_end = len(content)
        text = (content[line_start:start] + b"*" * min(end - start, 60)
                + content[end:line_end]).decode("utf-8", "replace")
        if len(text) > 120:
            text = text[:117] + "..."
        return (content.count(b"\n", 0, start) + 1, rule_id,
                content.count(b"\n", 0, end) + 1, text, start)

    def _spans(self, rule: _Rule, content: bytes):
        if not self.lossy:
            yield from rule.regex.finditer(content)
            return
        for lo in range(0, len(content), PIECE):
            yield from rule.regex.finditer(content, lo,
                                           min(lo + PIECE, len(content)))

    def scan(self, path: str, content: bytes) -> list[tuple]:
        """-> sorted (start line, rule ID, end line, censored line,
        offset) of every finding in `content` at `path`."""
        if path.lower().endswith(self.skip) \
                or any(p.match(path) for p in self.path_allow) \
                or b"\x00" in content[:8000]:
            return []
        low = content.lower()
        out = []
        for rule in self.rules:
            if rule.keywords and not any(k in low for k in rule.keywords):
                continue
            if rule.path_rx is not None and not rule.path_rx.match(path):
                continue
            for m in self._spans(rule, content):
                if rule.group:
                    try:
                        start, end = m.span(rule.group)
                    except IndexError:
                        continue
                    if start < 0:
                        continue
                else:
                    start, end = m.span()
                if self._allowed(path, content[start:end]):
                    continue
                out.append(self._finding(rule.id, content, start, end))
        out.sort(key=lambda f: (f[0], f[1]))
        return out
