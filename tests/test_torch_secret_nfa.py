"""Port parity, secret anchor screen: trivy_tpu_torch.ops.secret_nfa
against the JAX package's trivy_tpu.ops.secret_nfa.

The host half (class sequences, anchors, banks, chunking) must give the
same values and arrays; the plain versions of the bitset and conv
kernels must give the JAX kernels' words bit for bit on seeded inputs
(the JAX kernels run on the JAX CPU backend). Outputs are integers, so
the tolerance is exact equality. The CUDA kernels themselves are held
against the plain versions by the `cuda`-marked test, which needs a card.
"""

import dataclasses
import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_secret_scanner import secret_corpus

from trivy_tpu.ops import secret_nfa as jn
from trivy_tpu.secret.scanner import SecretScanner as JaxScanner
from trivy_tpu_torch.ops import secret_nfa as tn

CPU = torch.device("cpu")
SEED = 20261016


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and idle OpenMP workers spin on cores their neighbours' timing
    tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# the patterns tests/test_secret_nfa.py compiles, plus a few edge shapes
PATTERNS = [
    r"ghp_[0-9a-zA-Z]{36}", r"(?i)akia[0-9]{4}", r"(?:AKIA|ASIA)[0-9]{2}",
    r"ey[A-Za-z0-9]{17,}", r"-----BEGIN.*KEY-----", r"^AKIA[0-9]{16}",
    r"(?<=x)abc", r"\d{3}\.\w", r"abc[0-9]{2}", r"a+", r"^foo", r"foo\b",
    r"foo[0-9]+", r"xoxb-[0-9]{10}-token", r"(?:maybe)?yes[0-9]+",
    r"(?:aaaa|bbbb)", r"ab[0-9]+", r"AKIA[0-9A-Z]{16}",
    r"xoxb-[0-9]{12}-[a-z]{3}", r"(?i)bearer [a-z0-9]{8}", r"[^\s]\S\W\D",
    r"(?s)k.y", r"x{600}", r"café", r"[\x00-\x1f]{2}ok",
]


def builtin_patterns() -> list[str]:
    from trivy_tpu_torch.secret.rules import BUILTIN_RULES

    return [r.regex for r in BUILTIN_RULES]


def same_classes(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


@pytest.mark.parametrize("source", ["tests", "builtin"])
def test_host_helpers_equal_jax(source):
    pats = PATTERNS if source == "tests" else builtin_patterns()
    for p in pats:
        seq = tn.compile_class_sequence(p)
        assert same_classes(seq, jn.compile_class_sequence(p)), p
        if seq is not None:
            off, cls = tn.choose_anchor(seq)
            joff, jcls = jn.choose_anchor(jn.compile_class_sequence(p))
            assert off == joff and same_classes(cls, jcls), p
        assert tn.regex_width(p) == jn.regex_width(p), p
        assert tn.has_anchor(p) == jn.has_anchor(p), p
        assert tn.required_literal(p) == jn.required_literal(p), p
        assert tn.prefix_literal(p) == jn.prefix_literal(p), p
    for lit in (b"akia", b"x" * 40, b"dockerconfigjson", b"sk_live_"):
        assert same_classes(tn.literal_anchor(lit), jn.literal_anchor(lit))


@functools.cache
def builtin_rows():
    """The anchor rows of the builtin ruleset, compiled by the JAX
    package's scanner (204 rows: 44 seq, 46 lit, 114 keyword)."""
    return JaxScanner()._compile_program()["rows"]


def singleton_rows(n: int):
    rows = []
    for b in range(n):
        m = np.zeros(256, dtype=bool)
        m[b] = True
        rows.append([m])
    return rows


@pytest.mark.parametrize("which", ["builtin", "overflow"])
def test_banks_equal_jax(which):
    rows = builtin_rows() if which == "builtin" else singleton_rows(130)
    b, jb = tn.AnchorBank(rows), jn.AnchorBank(rows)
    for a in ("n", "rw", "words", "overflow_rows"):
        assert getattr(b, a) == getattr(jb, a), a
    for a in ("table", "bit_word", "bit_idx", "active"):
        np.testing.assert_array_equal(getattr(b, a), getattr(jb, a))
        assert getattr(b, a).dtype == getattr(jb, a).dtype
    c, jc = tn.ConvAnchorBank(rows), jn.ConvAnchorBank(rows)
    for a in ("n", "rw", "nc", "r_pad"):
        assert getattr(c, a) == getattr(jc, a), a
    for a in ("classtab", "taps", "n_active"):
        np.testing.assert_array_equal(getattr(c, a), getattr(jc, a))
        assert getattr(c, a).dtype == getattr(jc, a).dtype
    if which == "builtin":
        assert (b.words, b.rw, b.overflowed) == (3, 7, 0)
        assert (c.nc, c.r_pad) == (128, 256)
    else:
        assert b.overflowed == 2


def test_conv_bank_compact_form_matches_dense():
    """The compact arrays the conv kernel reads hold exactly the dense
    contract: rebuilding classtab and taps from them gives the bank's."""
    rng = np.random.default_rng(SEED)
    for n_cls in (100, 200, 300):
        rows = make_rows(rng, n_cls, 90)
        bank = tn.ConvAnchorBank(rows)
        bits = np.unpackbits(bank.cls_bits.view(np.uint8), axis=1,
                             bitorder="little").astype(np.float32)
        classtab = np.zeros_like(bank.classtab)
        classtab[:, : bits.shape[1]] = bits[:, : bank.nc]
        np.testing.assert_array_equal(classtab, bank.classtab)
        taps = np.zeros_like(bank.taps)
        for r in range(bank.n):
            for j in range(tn.K_ANCHOR):
                if bank.tap_act[r, j]:
                    taps[j, bank.tap_cls[r, j], r] = 1.0
        np.testing.assert_array_equal(taps, bank.taps)
        np.testing.assert_array_equal(bank.tap_act.sum(1),
                                      bank.n_active[: bank.n])


@pytest.mark.parametrize("overlap", [tn.K_ANCHOR - 1, 31])
def test_chunking_equals_jax(overlap):
    contents = [c for _p, c in secret_corpus(seed=3, n_files=25)]
    contents += [bytes(range(256)) * 200, b"", b"x" * tn.CHUNK,
                 b"y" * (2 * tn.CHUNK - 7)]
    got = tn.chunk_files(contents, overlap=overlap)
    want = jn.chunk_files(contents, overlap=overlap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    lower = tn.chunk_files(contents, overlap=overlap, lower=True)
    np.testing.assert_array_equal(
        lower[0], jn.chunk_files(contents, overlap=overlap, lower=True)[0])
    chunks, segs = tn.chunk_files_packed(contents, overlap=overlap)
    jchunks, jsegs = jn.chunk_files_packed(contents, overlap=overlap)
    np.testing.assert_array_equal(chunks, jchunks)
    assert segs == jsegs
    wins = [(5, 9), (0, 3), (2, 4), (9, 12), (20, 21)]
    assert tn.merge_windows(list(wins)) == jn.merge_windows(list(wins))


def test_anchor_row_packing_roundtrip():
    rows = builtin_rows()
    bits, lens = tn.pack_anchor_rows(rows)
    jbits, jlens = jn.pack_anchor_rows(rows)
    np.testing.assert_array_equal(bits, jbits)
    np.testing.assert_array_equal(lens, jlens)
    assert all(same_classes(a, b) for a, b in
               zip(tn.unpack_anchor_rows(bits, lens), rows))


# ------------------------------------------------ kernels, plain versions


def make_table_case(rng, c: int, nw: int, r: int):
    """Raw bitset-kernel inputs: a random class table (byte 0 in about
    half the classes), rules of 1-8 active taps on arbitrary tap slots
    (every fourth rule a prefix of taps, bit 31 often), two rules with
    no active tap (overflow rows) when r > 2, and chunks with planted
    satisfying runs, some ending on the chunk's last byte and some cut
    off by it, over a zero tail."""
    table = (rng.random((256, nw, 32)) < 0.04)
    table[0] = rng.random((nw, 32)) < 0.5
    bit_word = rng.integers(0, nw, size=(r, tn.K_ANCHOR)).astype(np.int32)
    bit_idx = rng.integers(0, 32, size=(r, tn.K_ANCHOR)).astype(np.uint32)
    bit_idx[rng.random((r, tn.K_ANCHOR)) < 0.2] = 31
    active = np.zeros((r, tn.K_ANCHOR), dtype=bool)
    for i in range(r):
        k = int(rng.integers(1, tn.K_ANCHOR + 1))
        if i % 4 == 0:
            active[i, :k] = True
        else:
            active[i, rng.choice(tn.K_ANCHOR, size=k, replace=False)] = True
    if r > 2:
        active[[1, r - 1]] = False
    words = np.zeros((256, nw), dtype=np.uint32)
    for w in range(nw):
        for q in range(32):
            words[table[:, w, q], w] |= np.uint32(1 << q)
    chunks = rng.integers(1, 256, size=(c, tn.CHUNK), dtype=np.uint8)
    chunks[:, -200:] = 0
    for ci in range(c):
        for _ in range(12):
            i = int(rng.integers(0, r))
            taps = np.nonzero(active[i])[0]
            if not len(taps):
                continue
            span = int(taps[-1]) + 1
            pos = int(rng.integers(0, tn.CHUNK - span + 1))
            roll = rng.random()
            if roll < 0.25:
                pos = tn.CHUNK - span  # ends on the last byte
            elif roll < 0.4:
                pos = tn.CHUNK - span + int(rng.integers(1, span + 1))
            for j in taps:
                if pos + j >= tn.CHUNK:
                    break
                ok = np.nonzero(table[:, bit_word[i, j], bit_idx[i, j]])[0]
                if len(ok):
                    chunks[ci, pos + j] = rng.choice(ok)
    return chunks, words, bit_word, bit_idx, active


def make_rows(rng, n_cls: int, n_rows: int, full: bool = False):
    """Bank-shaped rows of 1-8 classes (8 when `full`) from a pool of
    n_cls random classes (singletons, small sets, negated sets holding
    byte 0)."""
    pool = []
    for i in range(n_cls):
        m = np.zeros(256, dtype=bool)
        kind = i % 4
        if kind == 0:
            m[int(rng.integers(0, 256))] = True
        elif kind == 1:
            m[rng.integers(0, 256, size=int(rng.integers(2, 12)))] = True
        elif kind == 2:
            m[:] = True
            m[rng.integers(1, 256, size=5)] = False
        else:
            m[int(rng.integers(0, 256))] = True
            m[0] = True
        m[int(rng.integers(0, 256))] = True  # keeps the pool distinct
        pool.append(m)
    idx = list(range(n_cls))
    rng.shuffle(idx)
    rows = []
    for r in range(n_rows):
        k = tn.K_ANCHOR if full else int(rng.integers(1, tn.K_ANCHOR + 1))
        rows.append([pool[idx[(r * 8 + j) % n_cls]] for j in range(k)])
    return rows


def plant_rows(rng, c: int, rows):
    chunks = rng.integers(1, 256, size=(c, tn.CHUNK), dtype=np.uint8)
    chunks[:, -64:] = 0
    for ci in range(c):
        for _ in range(12):
            row = rows[int(rng.integers(0, len(rows)))]
            pos = int(rng.integers(0, tn.CHUNK - len(row) + 1))
            if rng.random() < 0.3:
                pos = tn.CHUNK - len(row)
            for j, m in enumerate(row):
                chunks[ci, pos + j] = rng.choice(np.nonzero(m)[0])
    return chunks


def port_anchor(chunks, words, bit_word, bit_idx, active,
                fn=tn.anchor_words_ref) -> np.ndarray:
    """Raw bitset-kernel inputs through the plain version, or through the
    wrapper on their compact form (fn=tn.anchor_words)."""
    if fn is tn.anchor_words:
        bank = tn.AnchorTensors.from_arrays(words, bit_word, bit_idx, active,
                                            CPU)
        out = fn(torch.from_numpy(np.ascontiguousarray(chunks)), bank)
    else:
        out = fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
            chunks, words.view(np.int32), bit_word, bit_idx.view(np.int32),
            active)))
    assert out.dtype == torch.int32
    return out.numpy().view(np.uint32)


@pytest.mark.parametrize("nw,r", [(nw, r) for nw in (1, 2, 3, 4)
                                  for r in (1, 31, 32, 33, 204)])
def test_anchor_plain_equals_jax_kernel(nw, r):
    rng = np.random.default_rng([SEED, nw, r])
    c = 3 if (nw + r) % 2 else 1
    case = make_table_case(rng, c, nw, r)
    chunks, words, bit_word, bit_idx, active = case
    want = np.asarray(jn._anchor_kernel(r, nw, -(-r // 32))(
        *(jnp.asarray(a) for a in case)))
    got = port_anchor(*case)
    np.testing.assert_array_equal(got, want)
    assert got.any(), "case produced no hits"
    if r > 2:  # overflow rows hit everywhere
        for i in (1, r - 1):
            assert (got[:, i // 32] >> (i % 32) & 1).all()
    # the wrapper takes the plain version for a CPU tensor
    before = tn.anchor_words.launches
    np.testing.assert_array_equal(port_anchor(*case, fn=tn.anchor_words),
                                  want)
    assert tn.anchor_words.launches == before


def test_anchor_plain_bit31_and_tail():
    """Hits on bit 31 of a word, and a row whose class holds byte 0
    hitting in a chunk's zero fill but not past its end."""
    rows = [[np.eye(256, dtype=bool)[65]]] * 31 + singleton_rows(1)
    rows.append([np.eye(256, dtype=bool)[0]] * 8)  # eight NULs: rule 32
    rows.append([np.eye(256, dtype=bool)[66]] * 8)  # eight "B"s: rule 33
    bank = tn.AnchorBank(rows)
    chunks = np.full((2, tn.CHUNK), 67, dtype=np.uint8)
    chunks[0, -7:] = 0  # seven NULs at the end: rule 32 needs eight
    chunks[1, -8:] = 0
    chunks[1, -16:-8] = 66
    args = (chunks, bank.table, bank.bit_word, bank.bit_idx, bank.active)
    want = np.asarray(jn._anchor_kernel(bank.n, bank.words, bank.rw)(
        *(jnp.asarray(a) for a in args)))
    got = port_anchor(*args)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] >> 31 & 1).all()  # rule 31: byte 0 is in its class
    assert got[0, 1] == 0 and got[1, 1] == 0b11


def compact_form(bank):
    """A ConvAnchorBank's compact form as bitset-kernel inputs."""
    return (bank.cls_bits, bank.tap_cls // 32,
            (bank.tap_cls % 32).astype(np.uint32), bank.tap_act)


def conv_inputs(bank):
    return (bank.classtab, bank.taps, bank.n_active)


@pytest.mark.parametrize("n_cls,r,nc", [(40, 1, 128), (100, 33, 128),
                                        (200, 90, 256)])
def test_conv_plain_equals_jax_kernel(n_cls, r, nc):
    rng = np.random.default_rng([SEED, n_cls, r])
    rows = make_rows(rng, n_cls, r)
    bank = tn.ConvAnchorBank(rows)
    assert bank.nc == nc
    chunks = plant_rows(rng, 1 if r == 1 else 2, rows)
    want = np.asarray(jn._conv_anchor_kernel(bank.nc, bank.r_pad, bank.rw)(
        jnp.asarray(chunks), *(jnp.asarray(a) for a in conv_inputs(bank))))
    got = tn.conv_anchor_words_ref(
        torch.from_numpy(chunks),
        *(torch.from_numpy(a) for a in conv_inputs(bank)), bank.rw)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert want.any()
    # the compact form, screened as an unbounded bitset bank, agrees
    compact = port_anchor(chunks, *compact_form(bank))
    np.testing.assert_array_equal(compact, want)
    wrapped = tn.conv_anchor_words(torch.from_numpy(chunks),
                                   tn.ConvTensors.from_bank(bank, CPU))
    np.testing.assert_array_equal(wrapped.numpy().view(np.uint32), want)


def test_conv_plain_384_classes_and_pad_rules():
    """nc = 384 (no class budget) and rule bits past n stay zero."""
    rng = np.random.default_rng(SEED + 1)
    rows = make_rows(rng, 300, 45, full=True)
    bank = tn.ConvAnchorBank(rows)
    assert bank.nc == 384 and bank.r_pad == 128 and bank.rw == 2
    chunks = plant_rows(rng, 2, rows)
    got = tn.conv_anchor_words_ref(
        torch.from_numpy(chunks),
        *(torch.from_numpy(a) for a in conv_inputs(bank)), bank.rw)
    words = got.numpy().view(np.uint32)
    assert not (words[:, 1] >> (45 - 32)).any()
    compact = port_anchor(chunks, *compact_form(bank))
    np.testing.assert_array_equal(words, compact)
    hits = tn.AnchorMatcher(bank, batch_chunks=1, device="cpu") \
        .collect_chunks([tn._Pending(host=got, event=None)])
    assert hits.shape == (2, 45) and hits.any()


def test_conv_is_exact_where_bitset_overflows():
    rows = singleton_rows(130)
    bank = tn.make_anchor_bank(rows, torch.device("cuda"))
    assert isinstance(bank, tn.ConvAnchorBank) and bank.overflowed == 0
    assert isinstance(tn.make_anchor_bank(rows, CPU), tn.AnchorBank)
    hits, _, _ = tn.AnchorMatcher(bank, batch_chunks=4, device="cpu") \
        .chunk_hits([b"zzzz"])
    assert set(np.nonzero(hits[0])[0].tolist()) == {0, ord("z")}


# ------------------------------------------------ the screen's compact form


def plain_screen(chunks: np.ndarray, bank: tn.ScreenTensors) -> np.ndarray:
    """The compact form evaluated plainly: rule r hits at position i when
    each of its n_taps[r] listed taps' class holds at i + the tap's
    position (no class past the chunk's end); n_taps 0 hits, -1 never.
    -> uint32[C, rw] words."""
    bits = np.unpackbits(bank.cls_bits.numpy().view(np.uint8), axis=1,
                         bitorder="little").astype(bool)
    member = np.zeros((257, bits.shape[1]), dtype=bool)
    member[:256] = bits
    taps, n_taps = bank.taps.numpy(), bank.n_taps.numpy()
    c, length = chunks.shape
    ext = np.concatenate([chunks.astype(np.int64),
                          np.full((c, tn.K_ANCHOR - 1), 256)], axis=1)
    hit = np.zeros((c, bank.rw * 32), dtype=bool)
    for r, n in enumerate(n_taps.tolist()):
        acc = np.full((c, length), n >= 0)
        for e in taps[r, : max(n, 0)].tolist():
            acc &= member[:, e >> 3][ext[:, (e & 7): (e & 7) + length]]
        hit[:, r] = acc.any(axis=1)
    return np.packbits(hit, axis=1, bitorder="little").view("<u4")


def check_taps(bank: tn.ScreenTensors, tap_cls, tap_act, never) -> int:
    """Each rule's compact taps are its active (class, position) pairs,
    rarest class first, the rest of the row zero; never rows count -1
    and rows without an active tap 0. -> rules whose taps were
    reordered."""
    count = np.unpackbits(bank.cls_bits.numpy().view(np.uint8), axis=1,
                          bitorder="little").sum(axis=0)
    taps, n_taps = bank.taps.numpy(), bank.n_taps.numpy()
    reordered = 0
    for r in range(taps.shape[0]):
        if never[r].any():
            assert n_taps[r] == -1
            continue
        js = np.nonzero(tap_act[r])[0].tolist()
        assert n_taps[r] == len(js)
        got = [(e >> 3, e & 7) for e in taps[r, : len(js)].tolist()]
        assert sorted(got, key=lambda p: p[1]) == [(tap_cls[r, j], j)
                                                   for j in js]
        keys = [(count[k], j) for k, j in got]
        assert keys == sorted(keys)
        assert not taps[r, len(js):].any()
        reordered += [j for _k, j in got] != js
    return reordered


def screen_edge_case(rng):
    """make_table_case rows plus three never rows (an active tap on a
    word past the table, on bit 40, on word -1), an active tap on an
    empty class (no byte holds it), and the two no-tap rows."""
    chunks, words, bit_word, bit_idx, active = make_table_case(rng, 2, 2, 40)
    for r, (w, b) in zip((5, 6, 7), ((2, 3), (0, 40), (-1, 3))):
        j = int(np.nonzero(active[r])[0][0])
        bit_word[r, j], bit_idx[r, j] = w, b
    empty = np.nonzero(~(words[:, 1:2] >> np.arange(32, dtype=np.uint32)
                         & 1).any(axis=0))[0]
    j = int(np.nonzero(active[8])[0][-1])
    if len(empty):
        bit_word[8, j], bit_idx[8, j] = 1, empty[0]
    else:
        words[:, 1] &= ~np.uint32(1 << 7)  # class 39 holds no byte
        bit_word[8, j], bit_idx[8, j] = 1, 7
    return chunks, words, bit_word, bit_idx, active


@pytest.mark.parametrize("which", ["builtin", "overflow", "edges"])
def test_screen_form_equals_references(which):
    """The compact form both CUDA screens read holds the bank's contract:
    evaluated plainly it gives anchor_words_ref's, conv_anchor_words_ref's
    and the JAX kernels' words, and its taps are each rule's active taps,
    rarest class first."""
    rng = np.random.default_rng([SEED, len(which)])
    if which == "edges":
        chunks, words, bit_word, bit_idx, active = screen_edge_case(rng)
        at = tn.AnchorTensors.from_arrays(words, bit_word, bit_idx, active,
                                          CPU)
        n, nw, rw = bit_word.shape[0], words.shape[1], at.rw
        valid = (bit_word >= 0) & (bit_word < nw) & (bit_idx < 32)
        check_taps(at, bit_word * 32 + bit_idx.astype(np.int64),
                   active & valid, active & ~valid)
        assert at.n_taps[[5, 6, 7]].tolist() == [-1] * 3
        assert at.n_taps[[1, 39]].tolist() == [0, 0]
        rows = None
    else:
        rows = builtin_rows() if which == "builtin" else singleton_rows(130)
        bank = tn.AnchorBank(rows)
        at = tn.AnchorTensors.from_bank(bank, CPU)
        n, nw, rw = bank.n, bank.words, bank.rw
        reordered = check_taps(at, bank.bit_word * 32 + bank.bit_idx,
                               bank.active, np.zeros_like(bank.active))
        assert reordered if which == "builtin" else not reordered
        if which == "builtin":
            contents = [c for _p, c in secret_corpus(seed=5, n_files=8)]
            chunks = tn.chunk_files_packed(contents)[0][:3]
        else:
            chunks = np.zeros((2, tn.CHUNK), dtype=np.uint8)
            chunks[0, :256] = np.arange(256)
            chunks[1, 100:110] = 200
    args = (chunks, *at.host)
    want = np.asarray(jn._anchor_kernel(n, nw, rw)(
        *(jnp.asarray(a) for a in args)))
    np.testing.assert_array_equal(plain_screen(chunks, at), want)
    np.testing.assert_array_equal(port_anchor(*args), want)
    np.testing.assert_array_equal(port_anchor(*args, fn=tn.anchor_words),
                                  want)
    bit = want[:, np.arange(n) // 32] >> (np.arange(n) % 32) & 1
    np.testing.assert_array_equal(bit[:, at.n_taps.numpy() == 0], 1)
    np.testing.assert_array_equal(bit[:, at.n_taps.numpy() < 0], 0)
    if rows is None:
        return
    cb = tn.ConvAnchorBank(rows)
    ct = tn.ConvTensors.from_bank(cb, CPU)
    check_taps(ct, cb.tap_cls, cb.tap_act, np.zeros_like(cb.tap_act))
    cwant = np.asarray(jn._conv_anchor_kernel(cb.nc, cb.r_pad, cb.rw)(
        jnp.asarray(chunks), *(jnp.asarray(a) for a in conv_inputs(cb))))
    np.testing.assert_array_equal(plain_screen(chunks, ct), cwant)
    got = tn.conv_anchor_words(torch.from_numpy(chunks), ct)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), cwant)
    if which == "builtin":  # no overflow: both banks screen alike
        np.testing.assert_array_equal(cwant, want)
    else:  # the two overflow rows hit everywhere in the bitset bank only
        assert (bit[:, 128:] == 1).all() and cwant.any()


def test_screen_layout_fills_the_card():
    """The grid of a screen launch: 2,048-position tiles for the builtin
    bank and the overflow bank's 256 classes, 1,024 for 384 classes and
    384 rules, one run of tiles per
    chunk once the batch fills the card's block slots, down to one tile
    per block for a small batch."""
    n_sm = 132
    main = tn.screen_layout(256, tn.CHUNK, 3, 204, 7, n_sm)
    assert (main.tile_words, main.tiles_per_block, main.blocks) \
        == (64, 4, 512) and main.blocks <= main.slots
    conv = tn.screen_layout(128, tn.CHUNK, 8, 332, 11, n_sm)
    assert (conv.tile_words, conv.tiles_per_block, conv.blocks) \
        == (64, 4, 256) and conv.smem <= tn.SCREEN_SMEM_TARGET
    assert tn.screen_layout(128, tn.CHUNK, 12, 384, 12, n_sm).tile_words \
        == 32
    for c in (1, 3, 7, 64, 600):
        for ncw, r, rw in ((1, 1, 1), (3, 204, 7), (8, 332, 11),
                           (12, 384, 12)):
            lay = tn.screen_layout(c, tn.CHUNK, ncw, r, rw, n_sm)
            tiles = tn.CHUNK // (32 * lay.tile_words)
            runs, rest = divmod(lay.blocks, c)
            assert not rest and runs == -(-tiles // lay.tiles_per_block)
            assert (lay.rules_per_slice, lay.tab_in_smem) == (r, True)
            assert lay.smem == tn.screen_smem(ncw, r, rw, lay.tile_words)
            assert lay.smem <= tn.BLOCK_SMEM_MAX
            if c * tiles <= lay.slots:
                assert runs == tiles
            if c >= lay.slots:
                assert runs == 1


@pytest.mark.parametrize("ncw, r, want", [
    (4, 7000, (64, 1750, True)),  # rules in four slices
    (43, 2000, (16, 2000, True)),  # past 1,024-position tiles
    (48, 7000, (16, 1750, True)),  # both
    (64, 10, (16, 10, True)),
    (266, 2000, (4, 1000, False)),  # the class table in global memory
    (300, 1200, (4, 1200, False)),
    (880, 100, (1, 100, False)),  # 28,160 classes, 32-position tiles
])
def test_screen_layout_takes_large_banks(ncw, r, want):
    """A bank too large for one block's shared memory at once still
    fits: its rules in even slices of at least SCREEN_MIN_SLICE, one
    slice a block, then smaller tiles, then the class table in global
    memory; only a class count whose 32-position bitmaps alone overflow
    a block raises."""
    n_sm = 132
    rw = -(-r // 32)
    for c in (1, 3, 600):
        lay = tn.screen_layout(c, tn.CHUNK, ncw, r, rw, n_sm)
        assert (lay.tile_words, lay.rules_per_slice, lay.tab_in_smem) == want
        assert lay.smem == tn.screen_smem(ncw, lay.rules_per_slice, rw,
                                          lay.tile_words, lay.tab_in_smem)
        assert lay.smem <= tn.BLOCK_SMEM_MAX
        slices = -(-r // lay.rules_per_slice)
        assert slices * lay.rules_per_slice - r < slices  # even slices
        assert lay.rules_per_slice >= min(r, tn.SCREEN_MIN_SLICE)
        # the next larger tile, or the table in shared memory, overflows
        bigger = tn.SCREEN_TILE_WORDS.index(lay.tile_words) - 1
        if bigger >= 0 and lay.tile_words < 32:
            assert tn.screen_smem(
                ncw, min(r, tn.SCREEN_MIN_SLICE), rw,
                tn.SCREEN_TILE_WORDS[bigger], lay.tab_in_smem) \
                > tn.BLOCK_SMEM_MAX
        if not lay.tab_in_smem:
            assert tn.screen_smem(ncw, min(r, tn.SCREEN_MIN_SLICE), rw, 1) \
                > tn.BLOCK_SMEM_MAX
        runs, rest = divmod(lay.blocks, c * slices)
        tiles = tn.CHUNK // (32 * lay.tile_words)
        assert not rest and runs == -(-tiles // lay.tiles_per_block)
        if c * slices * tiles <= lay.slots:
            assert runs == tiles
    with pytest.raises(ValueError, match="shared memory"):
        tn.screen_layout(1, tn.CHUNK, 1000, 10, 1, n_sm)


# ------------------------------------------------------------ matcher


@pytest.mark.parametrize("batch_chunks", [1, 8])
def test_matcher_equals_jax(batch_chunks):
    """The port's AnchorMatcher (CPU plain versions, launches on the
    real chunk count) against the JAX matcher (padded jit batches)."""
    rows = builtin_rows()
    contents = [c for _p, c in secret_corpus(seed=4, n_files=6)]
    contents.append(b"a" * (tn.CHUNK - 2) + b"ghp_" + b"Z" * 36)
    m = tn.AnchorMatcher(tn.AnchorBank(rows), batch_chunks=batch_chunks,
                         device="cpu")
    jm = jn.AnchorMatcher(jn.AnchorBank(rows), batch_chunks=batch_chunks)
    (h, o, s), (jh, jo, js) = m.chunk_hits(contents), jm.chunk_hits(contents)
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(o, jo)
    np.testing.assert_array_equal(s, js)
    (hp, sp), (jhp, jsp) = (m.chunk_hits_packed(contents),
                            jm.chunk_hits_packed(contents))
    np.testing.assert_array_equal(hp, jhp)
    assert sp == jsp and h.any()
    assert m.collect_chunks([]).shape == (0, len(rows))


def test_wrappers_reject_malformed_inputs_on_a_card():
    """The CUDA path checks types, shapes and alignment before it
    launches (a meta tensor stands in for a card's, so nothing runs)."""
    meta = torch.device("meta")
    chunks = torch.empty((2, tn.CHUNK), dtype=torch.uint8, device=meta)
    good = tn.AnchorTensors(
        cls_bits=torch.empty((256, 3), dtype=torch.int32, device=meta),
        taps=torch.empty((3, tn.K_ANCHOR), dtype=torch.int32, device=meta),
        n_taps=torch.empty(3, dtype=torch.int32, device=meta), rw=1,
        host=())
    with pytest.raises(ValueError, match="class words"):
        tn.anchor_words(chunks, dataclasses.replace(
            good, cls_bits=torch.empty((256, 5), dtype=torch.int32,
                                       device=meta)))
    with pytest.raises(ValueError, match="int32"):
        tn.anchor_words(chunks, dataclasses.replace(good,
                                                    taps=good.taps.long()))
    with pytest.raises(ValueError, match="do not fit"):
        tn.anchor_words(chunks, dataclasses.replace(good, rw=0))
    with pytest.raises(ValueError, match="16-byte aligned"):
        tn.conv_anchor_words(torch.empty((2, 100), dtype=torch.uint8,
                                         device=meta), tn.ConvTensors(
            good.cls_bits, good.taps, good.n_taps, 1, bank=None))


@pytest.mark.cuda
def test_cuda_anchor_kernels_equal_plain_versions():
    """On a card: both anchor kernels against their plain versions, bit
    for bit (the same check chip_smoke.py runs, smaller)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 2)
    for nw, r, c in [(1, 1, 1), (3, 204, 3), (4, 33, 2)]:
        chunks, *arrays = make_table_case(rng, c, nw, r)
        bank = tn.AnchorTensors.from_arrays(*arrays, dev)
        ch = torch.from_numpy(chunks).to(dev)
        got = tn.anchor_words(ch, bank)
        torch.cuda.synchronize()
        assert torch.equal(got, tn.anchor_words_ref(ch, *bank.reference()))
    # the last two fit a block only in slices of rules, or in
    # 512-position tiles (48 class words)
    for n_cls, r in [(100, 33), (300, 90), (120, 3000), (1530, 400)]:
        rows = make_rows(rng, n_cls, r, full=True)
        bank = tn.ConvTensors.from_bank(tn.ConvAnchorBank(rows), dev)
        chunks = torch.from_numpy(plant_rows(rng, 3, rows)).to(dev)
        got = tn.conv_anchor_words(chunks, bank)
        torch.cuda.synchronize()
        assert torch.equal(got, tn.conv_anchor_words_ref(
            chunks, *bank.dense(), bank.rw))


def test_random_corpus_rows_equal_jax_matcher():
    """Builtin rows over a random printable corpus through both
    matchers, packed (the scanner's layout), in batches of four chunks
    (the JAX matcher pads each batch to its size)."""
    rng = random.Random(SEED)
    contents = [bytes(rng.randrange(32, 127)
                      for _ in range(rng.randrange(0, 9000)))
                for _ in range(6)]
    rows = builtin_rows()
    hp, sp = tn.AnchorMatcher(tn.AnchorBank(rows), batch_chunks=4,
                              device="cpu").chunk_hits_packed(contents)
    jhp, jsp = jn.AnchorMatcher(jn.AnchorBank(rows), batch_chunks=4) \
        .chunk_hits_packed(contents)
    np.testing.assert_array_equal(hp, jhp)
    assert sp == jsp


# ------------------------------------------------------------ building


def test_entry_argtypes_match_the_sources():
    """Each ctypes binding in ops/kernels.py names its source's extern "C"
    entry with one argtype per parameter: c_void_p for a pointer, c_int
    for an int (ctypes would pass anything else as a 32-bit int)."""
    import ctypes
    import re

    from trivy_tpu_torch.ops import kernels

    for name, (fn, argtypes) in kernels._ENTRY.items():
        src = (kernels._CSRC / f"{name}.cu").read_text()
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
        assert m, (name, fn)
        params = [p.strip() for p in m.group(1).split(",")]
        want = [ctypes.c_void_p if "*" in p else ctypes.c_int
                for p in params]
        assert all(p.startswith(("int ", "const void*", "void*"))
                   for p in params), params
        assert argtypes == want, name


def test_kernel_build_hashes_headers_and_builds_in_parallel(tmp_path,
                                                            monkeypatch):
    """ops/kernels.py names each library by its source and the shared
    headers, builds several sources at once, skips built ones and
    reports every failed build (a shell script stands in for nvcc)."""
    from trivy_tpu_torch.ops import kernels

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b", "bad"):
        (csrc / f"{name}.cu").write_text(name)
    (csrc / "shared.cuh").write_text("1")
    monkeypatch.setattr(kernels, "_CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    first = kernels.so_path("a")
    (csrc / "shared.cuh").write_text("2")
    assert kernels.so_path("a") != first
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\n'
                    'for a; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
                    'case "$a" in *bad.cu) echo boom >&2; exit 1;; esac\n'
                    'echo built > "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    seconds = kernels.build(["a", "b"])
    assert set(seconds) == {"a", "b"} and min(seconds.values()) > 0
    assert kernels.so_path("a").read_text() == "built\n"
    assert kernels.build(["a", "b"]) == {"a": 0.0, "b": 0.0}
    with pytest.raises(RuntimeError, match="nvcc failed on bad.cu"):
        kernels.build(["bad"])
    assert not kernels.so_path("bad").exists()
