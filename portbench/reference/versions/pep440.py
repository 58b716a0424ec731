"""PEP 440 version ordering (reference uses aquasecurity/go-pep440-version,
pkg/detector/library/compare/pep440).

Parsing and total order delegate to the stdlib-adjacent `packaging` library
(the canonical PEP 440 implementation). Token encoding converts the parsed
components (epoch, release, pre/post/dev) into the shared tagged stream;
exotic combinations (local version segments) fall back to Inexact.
"""

from __future__ import annotations

from packaging.version import InvalidVersion, Version

from . import base
from .base import Inexact, ParseError, Scheme, cmp

RELEASE_SLOTS = 5

# ascending tag order == ascending version order.
# PEP 440 suffix order: .devN < aN < bN < rcN < release < .postN
TAG_DEV = 0x04
TAG_PRE_A = 0x08
TAG_PRE_B = 0x0a
TAG_PRE_RC = 0x0c
TAG_RELEASE = 0x10
TAG_POST = 0x18
TAG_NUM = 0x30

# within a pre-release: 1.0a1.dev2 < 1.0a1 < 1.0a1.post1 (post within pre is
# not legal PEP 440 input, but dev within pre is)
TAG_SUB_DEV = 0x04
TAG_SUB_END = 0x10

_PRE_TAG = {"a": TAG_PRE_A, "b": TAG_PRE_B, "rc": TAG_PRE_RC}


class Pep440Scheme(Scheme):
    name = "pep440"

    def parse(self, s: str) -> Version:
        try:
            return Version(s.strip())
        except InvalidVersion as e:
            raise ParseError(str(e)) from e

    def compare_parsed(self, a: Version, b: Version) -> int:
        return cmp(a, b)

    def tokens(self, s: str):
        v = self.parse(s)
        if v.local:
            raise Inexact(f"local version segment: {s!r}")
        release = v.release
        if len(release) > RELEASE_SLOTS:
            if any(n != 0 for n in release[RELEASE_SLOTS:]):
                raise Inexact(f"release too long: {s!r}")
            release = release[:RELEASE_SLOTS]
        toks = [(TAG_NUM, base.num_payload(v.epoch))]
        for i in range(RELEASE_SLOTS):
            n = release[i] if i < len(release) else 0
            toks.append((TAG_NUM, base.num_payload(n)))
        # suffix structure, in PEP 440 precedence order
        if v.pre is not None:
            letter, num = v.pre
            if v.post is not None:
                # e.g. 1.0a1.post1 — legal but vanishingly rare; host path
                raise Inexact(f"pre+post combination: {s!r}")
            toks.append((_PRE_TAG[letter], base.num_payload(num)))
            if v.dev is not None:
                toks.append((TAG_SUB_DEV, base.num_payload(v.dev)))
            else:
                toks.append((TAG_SUB_END, b"\x00" * 7))
        elif v.post is not None:
            toks.append((TAG_POST, base.num_payload(v.post)))
            if v.dev is not None:
                toks.append((TAG_SUB_DEV, base.num_payload(v.dev)))
            else:
                toks.append((TAG_SUB_END, b"\x00" * 7))
        elif v.dev is not None:
            toks.append((TAG_DEV, base.num_payload(v.dev)))
            toks.append((TAG_SUB_END, b"\x00" * 7))
        else:
            toks.append((TAG_RELEASE, b"\x00" * 7))
            toks.append((TAG_SUB_END, b"\x00" * 7))
        return toks

    def _tokens_lossy(self, s: str):
        v = self.parse(s)
        cap = (1 << 56) - 1
        toks = [(TAG_NUM, base.num_payload(min(v.epoch, cap)))]
        for i in range(RELEASE_SLOTS):
            n = v.release[i] if i < len(v.release) else 0
            toks.append((TAG_NUM, base.num_payload(min(n, cap))))
        if v.pre is not None:
            toks.append((_PRE_TAG[v.pre[0]], base.num_payload(min(v.pre[1], cap))))
        elif v.post is not None:
            toks.append((TAG_POST, base.num_payload(min(v.post, cap))))
        elif v.dev is not None:
            toks.append((TAG_DEV, base.num_payload(min(v.dev, cap))))
        else:
            toks.append((TAG_RELEASE, b"\x00" * 7))
        return toks


SCHEME = Pep440Scheme()
