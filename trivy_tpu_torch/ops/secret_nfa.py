"""Batched secret screening on a CUDA card.

Port of trivy_tpu/ops/secret_nfa.py. The device is a *screen*, the host
regex is the *verifier*. Every rule (and every rule keyword) compiles to
an **anchor**: up to K=8 consecutive byte-class predicates chosen as the
least-likely window of the pattern (literal bytes are 1/256-density
classes, so "ghp_", "AKIA", "xoxb-" anchors are essentially free of
false hits). One kernel evaluates every anchor at every byte position of
a [chunks, CHUNK] uint8 tensor and reduces the hits to *chunk
resolution*, packed as uint32 rule-bitmap words (16-odd bytes back per
16 KiB chunk).

The host then runs the real regex only inside hit chunks (expanded by
the pattern width so straddling matches are seen in full), and reads
keyword presence for the reference's keyword-prefilter semantics
straight from the same bitmap (case variance is folded into the anchor
classes).

False negatives are impossible by construction: anchor classes are
case-closed supersets, keywords are truncated (never extended), chunk
overlap covers the anchor span, and any anchor that cannot be encoded
(class-budget overflow) degrades to always-hit, never to never-hit.

Two banks, two kernels, one contract (chunks -> uint32[C, rw] words,
carried as int32 bit patterns):

- `AnchorBank` (<= 128 distinct classes): `anchor_words` on an
  `AnchorTensors`, the hand-written kernel ops/csrc/secret_anchor.cu on
  a CUDA tensor, the plain version `anchor_words_ref` on a CPU tensor;
- `ConvAnchorBank` (no class budget): `conv_anchor_words` on a
  `ConvTensors`, kernel ops/csrc/secret_conv.cu, plain version
  `conv_anchor_words_ref` (the reference's one-hot convolution, in
  float32).

Both kernels are one bit-sliced screen (ops/csrc/secret_screen.cuh) on
one compact form of the bank (`screen_taps`), built once per matcher;
the keyword prefilter (ops/secret_prefilter.py) is its third user.

The class-sequence compiler, the anchors, both banks' arrays and the
chunking are copies of the reference's, so the banks hold identical
arrays for the same rows.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass

try:  # the private regex internals moved under re.* in Python 3.11
    import re._constants as sre_c
    import re._parser as sre_parse
except ImportError:  # Python <= 3.10: same modules, top-level names
    import sre_constants as sre_c
    import sre_parse

import numpy as np
import torch

from trivy_tpu_torch.device import resolve_device

CHUNK = 16384
K_ANCHOR = 8
MAX_CLASS_WORDS = 4  # up to 128 distinct byte classes per bank

# bump on any change to what the screen can MATCH (anchor extraction,
# kernel semantics, chunking/packing) — the secret analyzer folds this
# into its cache-key version so cached blob results from an older
# screen are re-scanned. Same value as the reference's: both screens
# match exactly the same
KERNEL_VERSION = 3


# ----------------------------------------------------- class sequences


def _class_from_in(items, ignorecase: bool) -> np.ndarray | None:
    """sre IN items -> 256-bool acceptance mask."""
    mask = np.zeros(256, dtype=bool)
    negate = False
    for op, arg in items:
        if op is sre_c.NEGATE:
            negate = True
        elif op is sre_c.LITERAL:
            if arg > 255:
                return None
            mask[arg] = True
        elif op is sre_c.RANGE:
            lo, hi = arg
            if hi > 255:
                return None
            mask[lo: hi + 1] = True
        elif op is sre_c.CATEGORY:
            cat = _category_mask(arg)
            if cat is None:
                return None
            mask |= cat
        else:
            return None
    if negate:
        mask = ~mask
    if ignorecase:
        mask = _close_case(mask)
    return mask


def _category_mask(cat) -> np.ndarray | None:
    mask = np.zeros(256, dtype=bool)
    if cat is sre_c.CATEGORY_DIGIT:
        mask[ord("0"): ord("9") + 1] = True
    elif cat is sre_c.CATEGORY_NOT_DIGIT:
        mask[:] = True
        mask[ord("0"): ord("9") + 1] = False
    elif cat is sre_c.CATEGORY_WORD:
        for a, b in ((48, 57), (65, 90), (97, 122)):
            mask[a: b + 1] = True
        mask[ord("_")] = True
    elif cat is sre_c.CATEGORY_NOT_WORD:
        m = _category_mask(sre_c.CATEGORY_WORD)
        mask = ~m
    elif cat is sre_c.CATEGORY_SPACE:
        for c in b" \t\n\r\f\v":
            mask[c] = True
    elif cat is sre_c.CATEGORY_NOT_SPACE:
        m = _category_mask(sre_c.CATEGORY_SPACE)
        mask = ~m
    else:
        return None
    return mask


def _close_case(mask: np.ndarray) -> np.ndarray:
    out = mask.copy()
    for c in range(ord("a"), ord("z") + 1):
        if mask[c] or mask[c - 32]:
            out[c] = out[c - 32] = True
    return out


def _literal_class(ch: int, ignorecase: bool) -> np.ndarray | None:
    if ch > 255:
        return None
    mask = np.zeros(256, dtype=bool)
    mask[ch] = True
    if ignorecase:
        mask = _close_case(mask)
    return mask


def _walk(items, flags: int) -> list[np.ndarray] | None:
    """sre parse-tree items -> list of 256-bool classes, or None if the
    pattern is not a fixed-length class sequence."""
    ic = bool(flags & re.IGNORECASE)
    seq: list[np.ndarray] = []
    for op, arg in items:
        if op is sre_c.LITERAL:
            cls = _literal_class(arg, ic)
            if cls is None:
                return None
            seq.append(cls)
        elif op is sre_c.NOT_LITERAL:
            cls = _literal_class(arg, ic)
            if cls is None:
                return None
            seq.append(~cls)
        elif op is sre_c.IN:
            cls = _class_from_in(arg, ic)
            if cls is None:
                return None
            seq.append(cls)
        elif op is sre_c.ANY:
            mask = np.ones(256, dtype=bool)
            if not flags & re.DOTALL:
                mask[ord("\n")] = False
            seq.append(mask)
        elif op is sre_c.CATEGORY:
            cls = _category_mask(arg)
            if cls is None:
                return None
            seq.append(cls)
        elif op in (sre_c.MAX_REPEAT, sre_c.MIN_REPEAT):
            lo, hi, sub = arg
            if lo != hi or not isinstance(lo, int):
                return None
            inner = _walk(list(sub), flags)
            if inner is None:
                return None
            seq.extend(inner * lo)
        elif op is sre_c.SUBPATTERN:
            _group, add_f, del_f, sub = arg
            inner = _walk(list(sub), (flags | add_f) & ~del_f)
            if inner is None:
                return None
            seq.extend(inner)
        elif op is sre_c.BRANCH:
            _none, branches = arg
            alts = [_walk(list(b), flags) for b in branches]
            if any(a is None for a in alts):
                return None
            lens = {len(a) for a in alts}
            if len(lens) != 1:
                return None
            # per-position class union: a SUPERSET of the alternation
            # (cross-branch mixes accepted too) — safe, because device
            # hits are only candidate windows the real regex verifies
            merged = []
            for i in range(lens.pop()):
                m = np.zeros(256, dtype=bool)
                for a in alts:
                    m |= a[i]
                merged.append(m)
            seq.extend(merged)
        else:
            # anchors, lookarounds, groups refs, variable repeats, ...
            return None
    return seq


MAX_SEQ = 512  # sanity cap for {m} unrolling


def compile_class_sequence(pattern: str) -> list[np.ndarray] | None:
    """regex -> fixed-length class sequence (or None). The sequence
    accepts a SUPERSET of the regex language (equal except across
    same-length alternations, where per-position unions admit mixes),
    so anchor hits are complete candidates for regex verification —
    never a source of false negatives."""
    try:
        parsed = sre_parse.parse(pattern)
    except re.error:
        return None
    seq = _walk(list(parsed), parsed.state.flags)
    if seq is None or not seq or len(seq) > MAX_SEQ:
        return None
    return seq


def regex_width(pattern: str) -> tuple[int, int] | None:
    """(min, max) match width, or None if unparseable. max is capped by
    sre at MAXWIDTH for unbounded patterns."""
    try:
        parsed = sre_parse.parse(pattern)
    except re.error:
        return None
    lo, hi = parsed.getwidth()
    return int(lo), int(hi)


def has_anchor(pattern: str) -> bool:
    """True if the pattern uses ^/$/\\b-style assertions anywhere (those
    are position-sensitive, so window slicing could change semantics)."""
    try:
        parsed = sre_parse.parse(pattern)
    except re.error:
        return True

    def walk(items) -> bool:
        for op, arg in items:
            if op is sre_c.AT:
                return True
            if op in (sre_c.ASSERT, sre_c.ASSERT_NOT):
                return True
            if op is sre_c.SUBPATTERN:
                if walk(list(arg[3])):
                    return True
            elif op in (sre_c.MAX_REPEAT, sre_c.MIN_REPEAT):
                if walk(list(arg[2])):
                    return True
            elif op is sre_c.BRANCH:
                for b in arg[1]:
                    if walk(list(b)):
                        return True
        return False

    return walk(list(parsed))


def required_literal(pattern: str) -> bytes | None:
    """Longest literal byte run every match of the pattern must contain
    (>=3 bytes), lowercased, or None.

    Used to anchor candidate windows: scanning for this literal can
    never lose a match, unlike the rule's configured keywords which are
    only a heuristic prefilter. Conservative: runs inside optional
    parts, branches, or lookarounds don't count."""
    try:
        parsed = sre_parse.parse(pattern)
    except re.error:
        return None
    runs: list[bytes] = []

    def walk(items) -> None:
        cur = bytearray()

        def flush():
            if len(cur) >= 3:
                runs.append(bytes(cur))
            cur.clear()

        for op, arg in items:
            if op is sre_c.LITERAL and arg < 256:
                cur.append(arg)
            elif op is sre_c.SUBPATTERN:
                flush()
                walk(list(arg[3]))
            elif op in (sre_c.MAX_REPEAT, sre_c.MIN_REPEAT):
                lo, _hi, sub = arg
                flush()
                if isinstance(lo, int) and lo >= 1:
                    walk(list(sub))
            else:
                flush()
        flush()

    walk(list(parsed))
    if not runs:
        return None
    return max(runs, key=len).lower()


def prefix_literal(pattern: str) -> bytes | None:
    """Leading literal byte run every match must START with (>= 3
    bytes), or None.  Unlike ``required_literal`` (which anchors a
    window the match merely *contains*), occurrences of this literal
    are candidate match *starts*, so a host verifier can run the real
    regex only inside ``[pos, pos + max_width]`` windows — the host
    analogue of the device lit tier (docs/secrets.md "host floor").
    Conservative: stops at the first non-literal element."""
    try:
        parsed = sre_parse.parse(pattern)
    except re.error:
        return None
    out = bytearray()

    def walk(items) -> bool:
        """Collect leading literals; False = stop everywhere."""
        for op, arg in items:
            if op is sre_c.LITERAL and arg < 256:
                out.append(arg)
                continue
            if op is sre_c.SUBPATTERN:
                if not walk(list(arg[3])):
                    return False
                continue
            if op in (sre_c.MAX_REPEAT, sre_c.MIN_REPEAT):
                lo, hi, sub = arg
                if isinstance(lo, int) and lo == hi and lo <= 64:
                    for _ in range(lo):
                        if not walk(list(sub)):
                            return False
                    continue
                return False
            return False
        return True

    walk(list(parsed))
    return bytes(out) if len(out) >= 3 else None


# --------------------------------------------- anchor-row serialization


def pack_anchor_rows(rows: list[list[np.ndarray]]):
    """Anchor class rows -> (bits uint8[n_positions, 32], lens
    int32[n_rows]), the reference's compiled-NFA cache encoding.
    Lossless: each 256-bool class mask packs to 32 bytes."""
    lens = np.array([len(r) for r in rows], dtype=np.int32)
    flat = [m for r in rows for m in r]
    if not flat:
        return np.zeros((0, 32), dtype=np.uint8), lens
    bits = np.packbits(np.stack(flat).astype(bool), axis=1)
    return bits.astype(np.uint8), lens


def unpack_anchor_rows(bits: np.ndarray,
                       lens: np.ndarray) -> list[list[np.ndarray]]:
    """Inverse of pack_anchor_rows."""
    masks = np.unpackbits(bits.astype(np.uint8), axis=1)[:, :256] \
        .astype(bool)
    rows: list[list[np.ndarray]] = []
    pos = 0
    for n in lens.tolist():
        rows.append([masks[pos + j] for j in range(n)])
        pos += n
    return rows


# ------------------------------------------------------------- anchors


def choose_anchor(seq: list[np.ndarray]) -> tuple[int, list[np.ndarray]]:
    """Pick the least-likely window of up to K_ANCHOR consecutive classes
    (minimum product of class densities). -> (offset, classes)."""
    k = min(K_ANCHOR, len(seq))
    dens = [max(int(m.sum()), 1) for m in seq]
    best_s, best_p = 0, float("inf")
    for s in range(len(seq) - k + 1):
        p = 1.0
        for d in dens[s: s + k]:
            p *= d / 256.0
        if p < best_p:
            best_p, best_s = p, s
    return best_s, seq[best_s: best_s + k]


def literal_anchor(lit: bytes) -> list[np.ndarray]:
    """Case-closed singleton classes for (up to K_ANCHOR bytes of) a
    literal byte run — matches the literal case-insensitively, a superset
    of any case-sensitive occurrence."""
    out = []
    for b in lit[:K_ANCHOR]:
        m = np.zeros(256, dtype=bool)
        m[b] = True
        out.append(_close_case(m))
    return out


class AnchorBank:
    """Compiled anchor set: a byte->predicate-bitset table plus per-row
    (word, bit, active) indices for up to K_ANCHOR positions.

    Rows whose classes exceed the MAX_CLASS_WORDS budget become
    *always-hit* (all positions inactive) — a pure perf degradation,
    never a correctness one."""

    def __init__(self, rows: list[list[np.ndarray]]):
        self.n = len(rows)
        self.rw = max(1, -(-self.n // 32))  # output words
        cls_ids: dict[bytes, int] = {}
        budget = MAX_CLASS_WORDS * 32
        self.bit_word = np.zeros((self.n, K_ANCHOR), dtype=np.int32)
        self.bit_idx = np.zeros((self.n, K_ANCHOR), dtype=np.uint32)
        self.active = np.zeros((self.n, K_ANCHOR), dtype=bool)
        self.overflow_rows: set[int] = set()
        masks: list[np.ndarray] = []
        for r, classes in enumerate(rows):
            # stage this row's new classes; commit only if the whole row
            # fits the budget (a rejected row must not burn slots)
            new: dict[bytes, np.ndarray] = {}
            ids: list[bytes] = []
            for m in classes[:K_ANCHOR]:
                key = np.packbits(m).tobytes()
                if key not in cls_ids and key not in new:
                    new[key] = m
                ids.append(key)
            if not ids or len(cls_ids) + len(new) > budget:
                self.overflow_rows.add(r)
                continue  # row stays always-hit
            for key, m in new.items():
                cls_ids[key] = len(cls_ids)
                masks.append(m)
            for j, key in enumerate(ids):
                i = cls_ids[key]
                self.bit_word[r, j] = i // 32
                self.bit_idx[r, j] = i % 32
                self.active[r, j] = True
        self.words = max(1, -(-len(cls_ids) // 32))
        self.table = np.zeros((256, self.words), dtype=np.uint32)
        for i, m in enumerate(masks):
            self.table[m, i // 32] |= np.uint32(1 << (i % 32))

    @property
    def overflowed(self) -> int:
        return len(self.overflow_rows)


class ConvAnchorBank:
    """Anchor bank with no class budget and no overflow rows, in the
    reference's one-dimensional convolution form over one-hot bytes.

    Position i hits rule r iff every active tap j satisfies
    byte[i+j] in class(r, j).  With U[i, c] the byte->class indicator
    (multi-hot: a byte may sit in many classes) and taps[j, c, r] a
    one-hot selector of class(r, j), the conv sum
        S[i, r] = sum_j U[i + j, :] . taps[j, :, r]
    counts satisfied taps, so S[i, r] == n_active[r] is EXACT AND
    semantics: products are 0/1, sums never exceed K_ANCHOR.

    Beside the reference's dense arrays (classtab, taps, n_active),
    which the plain version contracts, the bank keeps what the CUDA
    screen's compact form is built from (ConvTensors, screen_taps):
    tap_cls / tap_act (the class index and active flag of each (rule,
    tap), the reference's locals) and cls_bits, the class table as a
    uint32[256, ceil(nc / 32)] bitset (class i = bit i % 32 of word
    i // 32), i.e. an AnchorBank without the class budget."""

    def __init__(self, rows: list[list[np.ndarray]]):
        self.n = len(rows)
        self.rw = max(1, -(-self.n // 32))
        self.overflow_rows: set[int] = set()  # conv taps have no budget
        cls_ids: dict[bytes, int] = {}
        masks: list[np.ndarray] = []
        tap_cls = np.zeros((self.n, K_ANCHOR), dtype=np.int32)
        tap_act = np.zeros((self.n, K_ANCHOR), dtype=bool)
        for r, classes in enumerate(rows):
            for j, m in enumerate(classes[:K_ANCHOR]):
                key = np.packbits(m).tobytes()
                if key not in cls_ids:
                    cls_ids[key] = len(cls_ids)
                    masks.append(m)
                tap_cls[r, j] = cls_ids[key]
                tap_act[r, j] = True
        nc = len(cls_ids)
        # pad contraction dims to the 128-lane register width
        self.nc = -(-max(nc, 1) // 128) * 128
        self.r_pad = -(-max(self.n, 1) // 128) * 128
        self.classtab = np.zeros((256, self.nc), dtype=np.float32)
        for i, m in enumerate(masks):
            self.classtab[m, i] = 1.0
        self.taps = np.zeros((K_ANCHOR, self.nc, self.r_pad),
                             dtype=np.float32)
        for r in range(self.n):
            for j in range(K_ANCHOR):
                if tap_act[r, j]:
                    self.taps[j, tap_cls[r, j], r] = 1.0
        self.n_active = np.full(self.r_pad, np.float32(1e9))  # pad: never
        self.n_active[: self.n] = tap_act.sum(axis=1).astype(np.float32)
        self.tap_cls = tap_cls
        self.tap_act = tap_act
        self.cls_bits = np.zeros((256, max(1, -(-nc // 32))), dtype=np.uint32)
        for i, m in enumerate(masks):
            self.cls_bits[m, i // 32] |= np.uint32(1 << (i % 32))

    @property
    def overflowed(self) -> int:
        return 0


CONV_TILE = 2048  # positions scored per step of the plain conv version

# ------------------------------------------------------------- kernels

_count_lock = threading.Lock()  # guards the launch counters
_MASK32 = 0xFFFFFFFF
# bools a plain version materialises per block of chunks
_REF_BLOCK = 1 << 25


def _rule_words(n_rules: int) -> int:
    """Output words per chunk for `n_rules` rules (at least one)."""
    return max(1, -(-n_rules // 32))


def _pack_hits(hit: torch.Tensor, rw: int) -> torch.Tensor:
    """bool[C, R'] -> int32[C, rw] words: rule r is bit r % 32 of word
    r // 32 (uint32 bit patterns); rules at or past rw * 32 are dropped,
    missing ones read as no hit."""
    c = hit.shape[0]
    hb = torch.zeros((c, rw * 32), dtype=torch.int64, device=hit.device)
    n = min(hit.shape[1], rw * 32)
    hb[:, :n] = hit[:, :n].to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=hit.device) \
        << torch.arange(32, dtype=torch.int64, device=hit.device)
    words = (hb.reshape(c, rw, 32) * weights).sum(-1)
    # bit 31: wrap the uint32 value into int32 explicitly
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def anchor_words_ref(chunks: torch.Tensor, table: torch.Tensor,
                     bit_word: torch.Tensor, bit_idx: torch.Tensor,
                     active: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the anchor kernel (the reference's
    _anchor_kernel): -> int32[C, ceil(R / 32)] packed per-chunk hit words.

    `pred = table[byte]` is each byte's NW-word class bitset, zero past
    the chunk's end (K_ANCHOR - 1 positions). Rule r hits at position i
    when every active tap j has bit bit_idx[r, j] of word bit_word[r, j]
    set in pred[i + j]; a rule with no active tap hits everywhere. A
    rule's bit is the any-hit over the chunk's positions.

    chunks uint8[C, L]; table int32[256, NW] (uint32 bit patterns);
    bit_word int32[R, 8]; bit_idx int32[R, 8] (uint32 values); active
    bool[R, 8]. A tap that names a word or bit outside the table never
    holds, as in the reference."""
    c, length = chunks.shape
    r = bit_word.shape[0]
    rw = _rule_words(r)
    dev = chunks.device
    nw = table.shape[1]
    # member[b, cls]: byte b is in class cls = 32 * word + bit; row 256
    # is the zero predicate past the chunk's end; two extra columns
    # read as "never" (an active tap outside the table) and "always"
    # (an inactive tap, past the chunk's end too)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    bits = ((table.to(torch.int64) & _MASK32)[..., None] >> shifts) & 1
    member = torch.zeros((257, nw * 32 + 2), dtype=torch.bool, device=dev)
    member[:256, : nw * 32] = bits.reshape(256, nw * 32).bool()
    member[:, nw * 32 + 1] = True
    bw = bit_word.to(torch.int64)
    bi = bit_idx.to(torch.int64) & _MASK32
    valid = (bw >= 0) & (bw < nw) & (bi < 32)
    cls = torch.where(valid, bw * 32 + bi.clamp(max=31), nw * 32)
    cls = torch.where(active, cls, nw * 32 + 1).clamp(min=0)
    # taps[j, b, r]: tap j of rule r holds for byte b
    taps = member[:, cls].permute(2, 0, 1).contiguous()
    ext = torch.cat([chunks.to(torch.int64),
                     torch.full((c, K_ANCHOR - 1), 256, dtype=torch.int64,
                                device=dev)], dim=1)
    hit = torch.zeros((c, r), dtype=torch.bool, device=dev)
    blk = max(1, _REF_BLOCK // max(length * r, 1))
    for c0 in range(0, c, blk):
        x = ext[c0: c0 + blk]
        acc = taps[0].index_select(0, x[:, :length].reshape(-1))
        for j in range(1, K_ANCHOR):
            acc &= taps[j].index_select(0, x[:, j: j + length].reshape(-1))
        hit[c0: c0 + blk] = acc.view(x.shape[0], length, r).any(dim=1)
    return _pack_hits(hit, rw)


def conv_anchor_words_ref(chunks: torch.Tensor, classtab: torch.Tensor,
                          taps: torch.Tensor, n_active: torch.Tensor,
                          rw: int) -> torch.Tensor:
    """Plain PyTorch version of the conv anchor kernel: the reference's
    _conv_anchor_kernel formulation, in float32 (exact: 0/1 products,
    sums <= K_ANCHOR). -> int32[C, rw] packed per-chunk hit words.

    Bytes widen and pad with the sentinel 256, whose one-hot row is
    zero, so padded positions fail every class.
    S[i, r] = sum_j onehot(byte[i + j]) . classtab . taps[j][:, r];
    rule r hits at i when S >= n_active[r].

    chunks uint8[C, L]; classtab float32[256, nc]; taps float32[8, nc,
    r_pad]; n_active float32[r_pad]."""
    c, length = chunks.shape
    dev = chunks.device
    r_pad = taps.shape[2]
    ext = torch.cat([chunks.to(torch.int64),
                     torch.full((c, K_ANCHOR - 1), 256, dtype=torch.int64,
                                device=dev)], dim=1)
    alphabet = torch.arange(256, dtype=torch.int64, device=dev)
    ct = classtab.to(torch.float32)
    tp = taps.to(torch.float32)
    na = n_active.to(torch.float32)
    hit = torch.zeros((c, r_pad), dtype=torch.bool, device=dev)
    blk = max(1, _REF_BLOCK // (CONV_TILE * max(r_pad, 256)))
    for c0 in range(0, c, blk):
        for t0 in range(0, length, CONV_TILE):
            t = min(CONV_TILE, length - t0)
            sl = ext[c0: c0 + blk, t0: t0 + t + K_ANCHOR - 1]
            oh = (sl[..., None] == alphabet).to(torch.float32)
            u = torch.einsum("cpb,bn->cpn", oh, ct)
            s = torch.zeros((sl.shape[0], t, r_pad), dtype=torch.float32,
                            device=dev)
            for j in range(K_ANCHOR):
                s += torch.einsum("cpn,nr->cpr", u[:, j: j + t, :], tp[j])
            hit[c0: c0 + blk] |= (s >= na).any(dim=1)
    return _pack_hits(hit, rw)


# ------------------------------------------------------ the CUDA screen
#
# Both banks reach the card in one compact form, and one hand-written
# screen (ops/csrc/secret_screen.cuh) serves both, through the entry
# points of ops/csrc/secret_anchor.cu and ops/csrc/secret_conv.cu (and
# a keyword bank through ops/csrc/secret_prefilter.cu).

SCREEN_MIN_BLOCKS = 4  # blocks an SM holds at least (__launch_bounds__)
SM_SMEM = 228 * 1024  # shared memory of one H100 SM
BLOCK_SMEM_MAX = 227 * 1024  # the most one block may take
# the most shared memory a block may take with 2,048-position tiles: two
# blocks an SM (1 KB each is the card's own). On the H100 the larger tile
# screened the overflow bank's 256 classes faster at two blocks an SM
# than the smaller one at four (PERF.md)
SCREEN_SMEM_TARGET = SM_SMEM // 2 - 1024
SCREEN_TILE_WORDS = (64, 32, 16, 8, 4, 2, 1)  # 32-position words a tile
# the fewest rules a slice of a bank too large for one block takes
# before the tile shrinks instead
SCREEN_MIN_SLICE = 256


def screen_taps(cls_bits: np.ndarray, tap_cls: np.ndarray,
                tap_act: np.ndarray, tap_never: np.ndarray,
                rarity: np.ndarray | None = None, shift_bits: int = 3):
    """A bank's taps in the screen's compact form. -> (taps int32[R, T],
    n_taps int32[R]), T = tap_cls.shape[1] (K_ANCHOR for the anchor
    banks, MAX_KW for a keyword bank).

    cls_bits uint32[256, ncw] (class i = bit i % 32 of word i // 32);
    tap_cls int[R, T] class of each tap; tap_act bool[R, T] active taps;
    tap_never bool[R, T] active taps that name no class. Row r lists its
    active taps as (class << shift_bits) | tap position, rarest class
    first (by `rarity[class]`, default the class's byte count, then the
    position); the rest of the row is 0. n_taps[r] is the number of
    active taps, -1 when one names no class (the rule never hits), 0
    when none is active (it hits wherever the chunk has a position). AND
    does not depend on the order, so the screen's result does not
    either; the order lets it leave a rule early."""
    if rarity is None:
        rarity = np.unpackbits(
            np.ascontiguousarray(cls_bits).view(np.uint8), axis=1,
            bitorder="little").sum(axis=0)
    r, width = tap_cls.shape
    taps = np.zeros((r, width), dtype=np.int32)
    n_taps = np.zeros(r, dtype=np.int32)
    for i in range(r):
        if tap_never[i].any():
            n_taps[i] = -1
            continue
        js = sorted(np.nonzero(tap_act[i])[0].tolist(),
                    key=lambda j: (rarity[tap_cls[i, j]], j))
        n_taps[i] = len(js)
        for t, j in enumerate(js):
            taps[i, t] = int(tap_cls[i, j]) << shift_bits | j
    return taps, n_taps


def _put(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclass
class ScreenTensors:
    """A bank in the screen's compact form on one device (screen_taps),
    uint32 words as int32 bit patterns."""

    cls_bits: torch.Tensor  # int32[256, ncw]
    taps: torch.Tensor  # int32[R, K_ANCHOR] (MAX_KW for keywords)
    n_taps: torch.Tensor  # int32[R]
    rw: int  # output words per chunk

    @property
    def device(self) -> torch.device:
        return self.taps.device


@dataclass
class AnchorTensors(ScreenTensors):
    """An AnchorBank on one device: the compact form the CUDA kernel
    reads. The reference arrays (table, bit_word, bit_idx, active) stay
    on the host; `reference` puts them on a device for the plain
    version."""

    host: tuple  # (table, bit_word, bit_idx, active) as numpy arrays

    @classmethod
    def from_arrays(cls, table: np.ndarray, bit_word: np.ndarray,
                    bit_idx: np.ndarray, active: np.ndarray,
                    device) -> "AnchorTensors":
        """table uint32[256, NW]; bit_word int32[R, 8]; bit_idx uint32[R,
        8]; active bool[R, 8] (the _anchor_kernel contract). A tap whose
        word or bit lies outside the table never holds."""
        nw = table.shape[1]
        bw = bit_word.astype(np.int64)
        bi = bit_idx.astype(np.int64) & _MASK32
        valid = (bw >= 0) & (bw < nw) & (bi < 32)
        taps, n_taps = screen_taps(table, np.where(valid, bw * 32 + bi, 0),
                                   active & valid, active & ~valid)
        return cls(cls_bits=_put(table.view(np.int32), device),
                   taps=_put(taps, device), n_taps=_put(n_taps, device),
                   rw=_rule_words(bit_word.shape[0]),
                   host=(table, bit_word, bit_idx, active))

    @classmethod
    def from_bank(cls, bank: AnchorBank, device) -> "AnchorTensors":
        return cls.from_arrays(bank.table, bank.bit_word, bank.bit_idx,
                               bank.active, device)

    def reference(self, device=None) -> tuple[torch.Tensor, ...]:
        """-> (table, bit_word, bit_idx, active), the plain version's
        operands, on `device` (default: the compact form's)."""
        device = self.device if device is None else torch.device(device)
        table, bit_word, bit_idx, active = self.host
        return tuple(_put(a, device) for a in (
            table.view(np.int32), bit_word, bit_idx.view(np.int32), active))


@dataclass
class ConvTensors(ScreenTensors):
    """A ConvAnchorBank on one device: the compact form the CUDA kernel
    reads (the bank's cls_bits, and its tap_cls / tap_act through
    screen_taps). The dense reference contract stays in the host bank;
    `dense` puts it on a device for the plain version."""

    bank: ConvAnchorBank

    @classmethod
    def from_bank(cls, bank: ConvAnchorBank, device) -> "ConvTensors":
        n_cls = bank.cls_bits.shape[1] * 32
        never = bank.tap_act & ((bank.tap_cls < 0) | (bank.tap_cls >= n_cls))
        taps, n_taps = screen_taps(bank.cls_bits, bank.tap_cls,
                                   bank.tap_act, never)
        return cls(cls_bits=_put(bank.cls_bits.view(np.int32), device),
                   taps=_put(taps, device), n_taps=_put(n_taps, device),
                   rw=bank.rw, bank=bank)

    def dense(self, device=None) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
        """-> (classtab, taps, n_active), the plain version's operands,
        on `device` (default: the compact form's; on the CPU they share
        the bank's memory)."""
        device = self.device if device is None else torch.device(device)
        return tuple(torch.from_numpy(a).to(device) for a in (
            self.bank.classtab, self.bank.taps, self.bank.n_active))


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def screen_smem(ncw: int, rules: int, rw: int, tile_words: int,
                tab_in_smem: bool = True, taps: int = K_ANCHOR) -> int:
    """Dynamic shared memory of one screen block, in bytes: two byte
    buffers of a tile and its halo word, the class table (unless it is
    read from global memory), the `taps` tap words and the tap count of
    each of a slice of `rules` rules, the hit mask and the tile's class
    bitmaps (the Layout of ops/csrc/secret_screen.cuh)."""
    return (2 * _align16(tile_words * 32 + 32)
            + (_align16(1024 * ncw) if tab_in_smem else 0)
            + _align16(4 * taps * rules) + _align16(rules)
            + _align16(4 * rw) + 128 * ncw * (tile_words + 1))


@dataclass(frozen=True)
class ScreenLayout:
    tile_words: int  # 32-position words per tile (64 down to 1)
    tiles_per_block: int  # the run of one chunk's tiles a block walks
    rules_per_slice: int  # the slice of the rules one block screens
    tab_in_smem: bool  # the class table in shared (else global) memory
    blocks: int
    smem: int  # dynamic shared memory per block, bytes
    slots: int  # blocks the card holds at once (estimate)


def _screen_fit(ncw: int, n_rules: int, rw: int,
                taps: int) -> tuple[int, int, bool]:
    """-> (tile_words, rules_per_slice, tab_in_smem) of a block that fits
    the card: the largest tile (2,048 positions only while two blocks
    share an SM), the class table in shared memory before global, and
    the fewest slices of rules, each of at least SCREEN_MIN_SLICE rules
    (or all of them)."""
    least = min(n_rules, SCREEN_MIN_SLICE)
    per_rule = 4 * taps + 1  # its tap words and its count
    for tab in (True, False):
        for tw in SCREEN_TILE_WORDS:
            limit = SCREEN_SMEM_TARGET if tw == 64 else BLOCK_SMEM_MAX
            room = limit - screen_smem(ncw, 0, rw, tw, tab, taps)
            most = max(0, room // per_rule)
            while most and (_align16(4 * taps * most) + _align16(most)
                            > room):
                most -= 1
            if most >= least:
                slices = -(-n_rules // most)
                return tw, -(-n_rules // slices), tab
    raise ValueError(f"screen: {ncw} class words need more shared memory "
                     f"than a block has ({BLOCK_SMEM_MAX} bytes)")


def screen_layout(c: int, length: int, ncw: int, n_rules: int, rw: int,
                  n_sm: int, taps: int = K_ANCHOR) -> ScreenLayout:
    """The grid of one screen launch over `c` chunks of `length` bytes on
    a card of `n_sm` SMs. Tiles hold 2,048 positions while a block's
    shared memory lets two blocks share an SM, else 1,024; a bank too
    large for that is staged in slices of rules, then screened in
    smaller tiles, then with its class table in global memory
    (_screen_fit). A block screens one slice of the rules over a run of
    one chunk's tiles, in order (so a rule hit in one tile is skipped in
    the later ones); a batch with fewer chunk slices than the card has
    block slots splits each chunk into several runs. `taps`: tap words a
    rule (K_ANCHOR, or MAX_KW for a keyword bank)."""
    n_rules = max(n_rules, 1)
    tile_words, per_slice, tab = _screen_fit(ncw, n_rules, rw, taps)
    smem = screen_smem(ncw, per_slice, rw, tile_words, tab, taps)
    slots = min(SCREEN_MIN_BLOCKS, SM_SMEM // (smem + 1024)) * n_sm
    slices = -(-n_rules // per_slice)
    tiles = -(-length // (32 * tile_words))
    runs = max(1, min(tiles, slots // max(c * slices, 1)))
    per_block = -(-tiles // runs)
    return ScreenLayout(tile_words=tile_words, tiles_per_block=per_block,
                        rules_per_slice=per_slice, tab_in_smem=tab,
                        blocks=c * slices * -(-tiles // per_block),
                        smem=smem, slots=slots)


def _screen_words(name: str, what: str, chunks: torch.Tensor,
                  bank: ScreenTensors) -> tuple[torch.Tensor, bool]:
    """The shared screen through csrc/<name>.cu on a card tensor: check
    the arguments, lay out the grid, zero the output and launch. ->
    (int32[C, rw] words, whether the kernel was launched)."""
    from trivy_tpu_torch.ops import kernels

    dev = chunks.device
    if chunks.dim() != 2 or bank.cls_bits.dim() != 2 \
            or bank.taps.dim() != 2:
        raise ValueError(f"{what}: chunks, cls_bits and taps must be 2-d")
    c, length = chunks.shape
    ncw = bank.cls_bits.shape[1]
    r = bank.taps.shape[0]
    check = kernels.check_tensor
    check(f"{what}: chunks", chunks, torch.uint8, (c, length), dev)
    check(f"{what}: cls_bits", bank.cls_bits, torch.int32, (256, ncw), dev)
    check(f"{what}: taps", bank.taps, torch.int32, (r, K_ANCHOR), dev)
    check(f"{what}: n_taps", bank.n_taps, torch.int32, (r,), dev)
    if r > bank.rw * 32:
        raise ValueError(f"{what}: {r} rules do not fit {bank.rw} words")
    out = torch.zeros((c, bank.rw), dtype=torch.int32, device=dev)
    if c == 0 or length == 0 or r == 0:
        return out, False
    if length % 16 or chunks.data_ptr() % 16:
        raise ValueError(f"{what}: chunk rows must be 16-byte aligned "
                         f"(length {length})")
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    lay = screen_layout(c, length, ncw, r, bank.rw, kernels.sm_count(index))
    kernels.screen_words_cuda(name, chunks, bank.cls_bits, bank.taps,
                              bank.n_taps, out, lay)
    return out, True


def anchor_words(chunks: torch.Tensor, bank: AnchorTensors) -> torch.Tensor:
    """-> int32[C, bank.rw] packed per-chunk rule-hit words (uint32 bit
    patterns) of an AnchorBank.

    On a CUDA tensor: the hand-written kernel (ops/csrc/secret_anchor.cu)
    on the compact form; raises if it cannot launch. On a CPU tensor:
    `anchor_words_ref` on the reference arrays."""
    if chunks.device.type == "cpu":
        return anchor_words_ref(chunks, *bank.reference(chunks.device))
    nw = bank.cls_bits.shape[-1]
    if not 1 <= nw <= MAX_CLASS_WORDS:
        raise ValueError(f"anchor_words: table has {nw} class words; the "
                         f"kernel takes 1..{MAX_CLASS_WORDS}")
    out, launched = _screen_words("secret_anchor", "anchor_words", chunks,
                                  bank)
    if launched:
        with _count_lock:
            anchor_words.launches += 1
    return out


anchor_words.launches = 0  # kernel launches (CUDA path only)


def conv_anchor_words(chunks: torch.Tensor,
                      bank: ConvTensors) -> torch.Tensor:
    """-> int32[C, bank.rw] packed per-chunk rule-hit words (uint32 bit
    patterns) of a ConvAnchorBank; rule bits >= the bank's n stay zero.

    On a CUDA tensor: the hand-written kernel (ops/csrc/secret_conv.cu)
    on the compact form; raises if it cannot launch. On a CPU tensor:
    `conv_anchor_words_ref` on the bank's dense form."""
    if chunks.device.type == "cpu":
        return conv_anchor_words_ref(chunks, *bank.dense(chunks.device),
                                     bank.rw)
    out, launched = _screen_words("secret_conv", "conv_anchor_words",
                                  chunks, bank)
    if launched:
        with _count_lock:
            conv_anchor_words.launches += 1
    return out


conv_anchor_words.launches = 0  # kernel launches (CUDA path only)


# ------------------------------------------------------------ chunking


def chunk_files(contents: list[bytes], overlap: int = K_ANCHOR - 1,
                lower: bool = False):
    """-> (chunks uint8[N, CHUNK], owners int[N], starts int[N]).
    starts[i] is the file offset of chunk i's first byte."""
    owners: list[int] = []
    starts: list[int] = []
    arrs: list[np.ndarray] = []
    step = CHUNK - overlap
    for fi, content in enumerate(contents):
        data = content.lower() if lower else content
        pos = 0
        while True:
            piece = data[pos: pos + CHUNK]
            if not piece and pos > 0:
                break
            arr = np.zeros(CHUNK, dtype=np.uint8)
            if piece:
                arr[: len(piece)] = np.frombuffer(piece, dtype=np.uint8)
            arrs.append(arr)
            owners.append(fi)
            starts.append(pos)
            if pos + CHUNK >= len(data):
                break
            pos += step
    if not arrs:
        return (np.zeros((0, CHUNK), dtype=np.uint8),
                np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))
    return np.stack(arrs), np.array(owners), np.array(starts)


def chunk_files_packed(contents: list[bytes], overlap: int = K_ANCHOR - 1):
    """Chunking with small-file packing: files shorter than the chunk
    share chunks, separated by `overlap` zero bytes so an anchor window
    (span <= K_ANCHOR) starting inside one file can never reach the next
    file's bytes. Cuts device bytes ~30-40% on many-small-file corpora
    (a kernel tree averages ~20 KiB/file, so one-file-per-chunk wastes
    nearly half of every final 16 KiB chunk as zero padding).

    -> (chunks uint8[N, CHUNK], segments), segments[c] = list of
    (file_idx, file_off, chunk_off, seg_len) spans laid out in chunk c.
    A chunk-level rule hit is attributed to EVERY segment of the chunk
    (the bitmap has chunk resolution); the host regex confirms inside
    per-file windows, so over-attribution costs host work, never
    correctness."""
    arrs: list[np.ndarray] = []
    segments: list[list[tuple[int, int, int, int]]] = []
    gap = overlap
    step = CHUNK - overlap

    pack_buf = np.zeros(CHUNK, dtype=np.uint8)
    pack_pos = 0
    pack_segs: list[tuple[int, int, int, int]] = []

    def flush_pack():
        nonlocal pack_pos, pack_buf, pack_segs
        if pack_segs:
            arrs.append(pack_buf)
            segments.append(pack_segs)
            pack_buf = np.zeros(CHUNK, dtype=np.uint8)
            pack_pos = 0
            pack_segs = []

    def pack(fi: int, file_off: int, piece: bytes) -> None:
        nonlocal pack_pos
        need = len(piece) + (gap if pack_pos else 0)
        if pack_pos + need > CHUNK:
            flush_pack()
        if pack_pos:
            pack_pos += gap  # zero separator
        if piece:
            pack_buf[pack_pos: pack_pos + len(piece)] = (
                np.frombuffer(piece, dtype=np.uint8))
        pack_segs.append((fi, file_off, pack_pos, len(piece)))
        pack_pos += len(piece)

    for fi, content in enumerate(contents):
        pos = 0
        # full chunks stream as-is; the sub-chunk tail (and any whole
        # small file) goes through the pack buffer — consecutive chunks
        # of one file overlap by `overlap` bytes so anchors straddling
        # a cut are still seen in full by some chunk
        while len(content) - pos >= CHUNK:
            arr = np.frombuffer(
                content[pos: pos + CHUNK], dtype=np.uint8).copy()
            arrs.append(arr)
            segments.append([(fi, pos, 0, CHUNK)])
            pos += step
        pack(fi, pos, content[pos:])
    flush_pack()
    if not arrs:
        return np.zeros((0, CHUNK), dtype=np.uint8), []
    return np.stack(arrs), segments


def make_anchor_bank(rows: list[list[np.ndarray]], device: torch.device):
    """The bitset bank whenever it fits the class budget; rows that
    overflow MAX_CLASS_WORDS degrade to always-hit (whole-file host
    regex), so once that happens on a card the conv bank's unlimited
    class space is taken instead. "A card" means `device` is CUDA."""
    bank = AnchorBank(rows)
    if bank.overflowed == 0:
        return bank
    return ConvAnchorBank(rows) if device.type == "cuda" else bank


@dataclass
class _Pending:
    """One in-flight screen batch. On a card the words are copied into
    a pinned host buffer with `non_blocking=True` on the launch stream
    right after the launch, and an event marks the copy's end:
    collection waits on that event alone."""

    host: torch.Tensor  # int32[real, rw], pinned on a card
    event: "torch.cuda.Event | None"

    def words(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy().view(np.uint32)


class AnchorMatcher:
    """Runs the anchor bank over a file batch on `device` and maps
    chunk-level hits back to per-file windows / presence bits. The
    bank's arrays go to the device once, here."""

    def __init__(self, bank, batch_chunks: int | None = None, device=None):
        self.bank = bank
        self.device = resolve_device(device)
        if batch_chunks is None:
            # the reference's per-bank defaults
            batch_chunks = 128 if isinstance(bank, ConvAnchorBank) else 256
        self.batch_chunks = batch_chunks
        if isinstance(bank, ConvAnchorBank):
            self._dev = ConvTensors.from_bank(bank, self.device)
        else:
            self._dev = AnchorTensors.from_bank(bank, self.device)

    def _dispatch(self, batch: np.ndarray) -> _Pending:
        """Copy one [n, CHUNK] batch to the device and enqueue the
        screen on it, without waiting for the result (on a card the
        batch is staged in pinned memory, so neither copy blocks)."""
        if self.device.type == "cuda":
            staged = torch.empty(batch.shape, dtype=torch.uint8,
                                 pin_memory=True)
            staged.numpy()[...] = batch
            chunks = staged.to(self.device, non_blocking=True)
        else:
            chunks = torch.from_numpy(np.ascontiguousarray(batch))
        if isinstance(self.bank, ConvAnchorBank):
            words = conv_anchor_words(chunks, self._dev)
        else:
            words = anchor_words(chunks, self._dev)
        if words.device.type == "cpu":
            return _Pending(host=words, event=None)
        host = torch.empty(words.shape, dtype=words.dtype, pin_memory=True)
        host.copy_(words, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(words.device))
        return _Pending(host=host, event=event)

    def chunk_hits_packed(self, contents: list[bytes]):
        """Like chunk_hits but with small-file packing: -> (hits
        bool[n_chunks, n_rows], segments) where segments[c] lists the
        (file_idx, file_off, chunk_off, seg_len) spans of chunk c."""
        chunks, segments = chunk_files_packed(contents)
        return self._run_chunks(chunks), segments

    def chunk_hits(self, contents: list[bytes]):
        """-> (hits bool[n_chunks, n_rows], owners, starts). Device
        dispatches are pipelined (async) and synced once at the end."""
        chunks, owners, starts = chunk_files(contents)
        return self._run_chunks(chunks), owners, starts

    def dispatch_chunks(self, chunks: np.ndarray) -> list[_Pending]:
        """Enqueue every batch without blocking -> opaque pending list.
        The device computes (and its results stream host-ward) while the
        caller does other work — collect_chunks blocks only on whatever
        is still in flight. Each launch covers the batch's real chunks."""
        return [self._dispatch(chunks[s0: s0 + self.batch_chunks])
                for s0 in range(0, len(chunks), self.batch_chunks)]

    def collect_chunks(self, outs: list[_Pending]) -> np.ndarray:
        bank = self.bank
        if not outs:
            return np.zeros((0, bank.n), dtype=bool)
        words = np.concatenate([p.words() for p in outs])  # [NC, rw]
        bits = np.unpackbits(
            np.ascontiguousarray(words).view(np.uint8).reshape(
                words.shape[0], -1),
            axis=1, bitorder="little")[:, : bank.n]
        return bits.astype(bool)

    def _run_chunks(self, chunks: np.ndarray) -> np.ndarray:
        return self.collect_chunks(self.dispatch_chunks(chunks))


def merge_windows(wins: list[tuple[int, int]]) -> list[tuple[int, int]]:
    wins.sort()
    out = []
    for lo, hi in wins:
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out
