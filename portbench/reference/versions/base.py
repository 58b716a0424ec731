"""Version-scheme plumbing shared by all comparators.

Each scheme (apk/deb/rpm/generic/npm/pep440/maven/rubygems/bitnami) provides:
  parse(s)        -> opaque parsed form
  compare(a, b)   -> -1/0/+1 exact total order (host truth; mirrors the
                     reference's per-scheme Go libs, e.g. knqyf263/go-deb-version)
  tokens(s)       -> [(tag, payload)] token stream whose flat lexicographic
                     order equals compare() order — or raises Inexact.

The token stream is packed (pack_key) into a fixed-width byte key so numpy
searchsorted / the TPU kernel can rank versions with pure integer compares.
A version whose ordering cannot be exactly captured in the fixed width is
flagged inexact; the tensor compiler then marks the row NEEDS_HOST and the
match kernel emits it as an always-candidate for exact host rescreen
(zero-diff guarantee, SURVEY.md §7 hard part #1).
"""

from __future__ import annotations

# 24 groups comfortably covers real distro versions (e.g. debian
# "1.1.1k-1+deb11u2" = 18 tokens); keys are host-side only — the device
# sees int32 ranks — so width costs nothing on TPU
KEY_GROUPS = 24  # tokens per key
GROUP_BYTES = 8  # 1 tag byte + 7 payload bytes
KEY_BYTES = KEY_GROUPS * GROUP_BYTES

# Reserved low tag values usable by any scheme. A scheme may define its own
# tags as long as their numeric order equals the intended sort order.
TAG_MIN = 0x01
TAG_END = 0x10  # terminator; every token stream must end with exactly one

STR_TERM = 0x02  # terminator char appended to every string payload


class Inexact(Exception):
    """Raised when a version can't be exactly encoded in the fixed key."""


class ParseError(ValueError):
    """Raised when a version string is unparseable for the scheme."""


def num_payload(n: int) -> bytes:
    """7-byte big-endian unsigned. Values >= 2^56 can't be represented."""
    if n < 0:
        raise Inexact(f"negative numeric component {n}")
    if n >= 1 << 56:
        raise Inexact(f"numeric component too large: {n}")
    return n.to_bytes(7, "big")


def str_payload(s: str, char_map=None) -> bytes:
    """Remapped chars + terminator, zero-padded to 7 bytes.

    char_map maps a character to its 1-byte sort value (must be > STR_TERM
    for chars that sort after end-of-string, < STR_TERM for chars like
    Debian's '~' that sort before it). Default: chr -> ord clamped printable,
    offset above STR_TERM.
    """
    out = bytearray()
    for ch in s:
        if char_map is not None:
            v = char_map(ch)
        else:
            v = min(ord(ch), 0xFF - STR_TERM - 1) + STR_TERM + 1
        out.append(v)
    out.append(STR_TERM)
    if len(out) > 7:
        raise Inexact(f"string component too long: {s!r}")
    return bytes(out) + b"\x00" * (7 - len(out))


def pack_key(tokens) -> bytes:
    """[(tag, payload7)] -> fixed KEY_BYTES key. Raises Inexact on overflow."""
    if len(tokens) > KEY_GROUPS:
        raise Inexact(f"too many tokens: {len(tokens)}")
    out = bytearray()
    for tag, payload in tokens:
        if not (0 < tag < 256):
            raise ValueError(f"bad tag {tag}")
        if len(payload) != 7:
            raise ValueError(f"payload must be 7 bytes, got {len(payload)}")
        out.append(tag)
        out += payload
    out += b"\x00" * (KEY_BYTES - len(out))
    return bytes(out)


MIN_KEY = b"\x00" * KEY_BYTES  # sorts before every packed key
MAX_KEY = b"\xff" * KEY_BYTES  # sorts after every packed key


class Scheme:
    """Base class; subclasses implement parse/compare_parsed/tokens."""

    name = "base"

    def parse(self, s: str):
        raise NotImplementedError

    def compare_parsed(self, a, b) -> int:
        raise NotImplementedError

    def compare(self, a: str, b: str) -> int:
        return self.compare_parsed(self.parse(a), self.parse(b))

    def tokens(self, s: str):
        raise NotImplementedError

    def key(self, s: str) -> tuple[bytes, bool]:
        """Returns (packed key, exact). On Inexact — or an unparseable
        version — returns a best-effort key with exact=False (still usable
        as a search anchor; the caller must treat comparisons against it as
        uncertain and take the exact host path)."""
        try:
            return pack_key(self.tokens(s)), True
        except (Inexact, ParseError):
            try:
                toks = self._tokens_lossy(s)
                if len(toks) > KEY_GROUPS:
                    toks = toks[:KEY_GROUPS - 1] + toks[-1:]
                return pack_key(toks), False
            except Exception:
                return MIN_KEY, False

    def _tokens_lossy(self, s: str):
        """Best-effort token stream where individual tokens never raise:
        long strings truncated, large numbers clamped."""
        raise Inexact("no lossy encoding")


def cmp(a, b) -> int:
    return (a > b) - (a < b)
