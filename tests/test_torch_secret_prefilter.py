"""Port parity, secret keyword prefilter: trivy_tpu_torch.ops.
secret_prefilter against the JAX package's trivy_tpu.ops.secret_prefilter.

The plain version of the prefilter kernel must give the JAX kernel's
hit mask bit for bit on seeded inputs (the JAX kernel runs on the JAX
CPU backend), and DevicePrefilter(device="cpu") and HostPrefilter must
give the JAX package's masks on the corpora of tests/test_fanal.py.
Outputs are booleans: the tolerance is exact equality. The CUDA kernel
itself is held against its plain version by the `cuda`-marked test.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trivy_tpu.ops import secret_prefilter as jp
from trivy_tpu_torch.ops import secret_nfa as tn
from trivy_tpu_torch.ops import secret_prefilter as tp
from trivy_tpu_torch.secret.rules import BUILTIN_RULES

SEED = 20261016
ALPHABET = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789_-:\x00",
                         dtype=np.uint8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and idle OpenMP workers spin on cores their neighbours' timing
    tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def builtin_keywords() -> list[bytes]:
    return sorted({k.lower().encode() for r in BUILTIN_RULES
                   for k in r.keywords})


def make_case(rng, c: int, k: int, max_len: int):
    """Keywords of 1..max_len bytes over a small alphabet that holds byte
    0 (a zero-length row first), and chunks of the same alphabet with a
    keyword planted at each chunk's end and some keywords cut by it, so
    the zero pad decides them."""
    kw = np.zeros((k, tp.MAX_KW), dtype=np.uint8)
    kw_len = rng.integers(1, max_len + 1, size=k).astype(np.int32)
    kw_len[0] = 0
    for i in range(k):
        kw[i, : kw_len[i]] = rng.choice(ALPHABET, size=kw_len[i])
        if i % 5 == 1 and kw_len[i] > 1:
            kw[i, kw_len[i] - 1] = 0  # ends in NUL: the pad can complete it
    chunks = rng.choice(ALPHABET[:-1], size=(c, tp.CHUNK)).astype(np.uint8)
    for ci in range(c):
        i = int(rng.integers(1, k)) if k > 1 else 0
        n = int(kw_len[i])
        if n:
            chunks[ci, tp.CHUNK - n:] = kw[i, :n]
        j = int(rng.integers(0, k))
        n = int(kw_len[j])
        if n > 1:  # all but the keyword's last byte, at the very end
            chunks[ci, tp.CHUNK - n + 1:] = kw[j, : n - 1]
        pos = int(rng.integers(0, tp.CHUNK - tp.MAX_KW))
        chunks[ci, pos: pos + int(kw_len[j])] = kw[j, : kw_len[j]]
    return chunks, kw, kw_len


@pytest.mark.parametrize("max_len,k,c", [(1, 1, 1), (5, 1, 2), (5, 114, 1),
                                         (24, 114, 2), (24, 7, 3)])
def test_prefilter_plain_equals_jax_kernel(max_len, k, c):
    rng = np.random.default_rng([SEED, max_len, k, c])
    chunks, kw, kw_len = make_case(rng, c, k, max_len)
    want = np.asarray(jp._kernel(k, max_len)(
        jnp.asarray(chunks), jnp.asarray(kw), jnp.asarray(kw_len)))
    args = (torch.from_numpy(chunks), torch.from_numpy(kw),
            torch.from_numpy(kw_len))
    got = tp.prefilter_hits_ref(*args, max_len).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:, 0].all(), "a zero-length keyword hits everywhere"
    before = tp.prefilter_hits.launches
    np.testing.assert_array_equal(tp.prefilter_hits(*args, max_len).numpy(),
                                  want)
    assert tp.prefilter_hits.launches == before


def test_prefilter_pad_is_byte_zero():
    """A keyword ending in NUL matches at the chunk's end through the
    zero pad, as in the JAX kernel; one needing a byte past the pad
    does not."""
    kw = np.zeros((2, tp.MAX_KW), dtype=np.uint8)
    kw[0, :3] = [ord("a"), ord("b"), 0]
    kw[1, :3] = [ord("a"), ord("b"), ord("c")]
    kw_len = np.array([3, 3], dtype=np.int32)
    chunks = np.full((1, tp.CHUNK), ord("x"), dtype=np.uint8)
    chunks[0, -2:] = [ord("a"), ord("b")]
    want = np.asarray(jp._kernel(2, 3)(jnp.asarray(chunks), jnp.asarray(kw),
                                       jnp.asarray(kw_len)))
    got = tp.prefilter_hits_ref(torch.from_numpy(chunks),
                                torch.from_numpy(kw),
                                torch.from_numpy(kw_len), 3).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [[True, False]]
    with pytest.raises(ValueError, match="max_len"):
        tp.prefilter_hits(torch.from_numpy(chunks), torch.from_numpy(kw),
                          torch.from_numpy(kw_len), 25)


def test_keyword_bank_equals_jax():
    kws = builtin_keywords() + [b"X" * 40, b""]
    b, jb = tp.KeywordBank(kws), jp.KeywordBank(kws)
    assert b.keywords == jb.keywords and b.max_len == jb.max_len
    np.testing.assert_array_equal(b.kw, jb.kw)
    np.testing.assert_array_equal(b.kw_len, jb.kw_len)
    assert len(builtin_keywords()) == 114


# ------------------------------------- the keyword bank's compact form


def plain_keyword_screen(chunks: np.ndarray,
                         form: tp.KeywordTensors) -> np.ndarray:
    """The compact form evaluated plainly, as the shared screen reads it:
    keyword k hits at start position i < L when the class of each listed
    tap holds at i + the tap's offset, positions past the chunk's end
    holding byte 0's class; no tap hits everywhere. -> bool[C, K]."""
    bits = np.unpackbits(form.cls_bits.numpy().view(np.uint8), axis=1,
                         bitorder="little").astype(bool)
    taps, n_taps = form.taps.numpy(), form.n_taps.numpy()
    c, length = chunks.shape
    ext = np.concatenate([chunks, np.zeros((c, tp.MAX_KW - 1), np.uint8)],
                         axis=1)
    hit = np.zeros((c, taps.shape[0]), dtype=bool)
    for r, n in enumerate(n_taps.tolist()):
        acc = np.ones((c, length), dtype=bool)
        for e in taps[r, :n].tolist():
            s = e & ((1 << tp.KW_SHIFT_BITS) - 1)
            acc &= bits[:, e >> tp.KW_SHIFT_BITS][ext[:, s: s + length]]
        hit[:, r] = acc.any(axis=1)
    return hit


def check_keyword_taps(form: tp.KeywordTensors, kw, kw_len, max_len):
    """Keyword k's taps are its (byte class, offset) pairs for offsets <
    min(kw_len, max_len), rarest byte first (byte_rarity, then offset);
    each class holds exactly one byte value, one of the keywords'."""
    bits = np.unpackbits(form.cls_bits.numpy().view(np.uint8), axis=1,
                         bitorder="little").astype(bool)
    assert (bits.sum(axis=0) <= 1).all()
    value = bits.argmax(axis=0)  # the byte value of each class
    rarity = tp.byte_rarity()
    taps, n_taps = form.taps.numpy(), form.n_taps.numpy()
    for k in range(kw.shape[0]):
        n = int(np.clip(kw_len[k], 0, max_len))
        assert n_taps[k] == n
        got = [(int(value[e >> tp.KW_SHIFT_BITS]),
                e & ((1 << tp.KW_SHIFT_BITS) - 1))
               for e in taps[k, :n].tolist()]
        assert sorted(got, key=lambda p: p[1]) == [
            (int(kw[k, j]), j) for j in range(n)]
        keys = [(rarity[b], j) for b, j in got]
        assert keys == sorted(keys)
        assert not taps[k, n:].any()


@pytest.mark.parametrize("case,max_len,k,c,length", [
    ("random", 1, 7, 3, tp.CHUNK),
    ("random", 20, 114, 2, tp.CHUNK),
    ("random", 24, 114, 2, tp.CHUNK),
    ("random", 24, 40, 3, 100),  # not a multiple of 32
    ("random", 7, 33, 3, 1000),
    ("random", 20, 9, 2, 31),
    ("builtin", 20, 114, 3, tp.CHUNK),
])
def test_keyword_form_equals_references(case, max_len, k, c, length):
    """The compact form the prefilter kernel reads holds the bank's
    contract: evaluated plainly it gives prefilter_hits_ref's hits (and
    the JAX _kernel's, which takes CHUNK-byte chunks only), over
    keywords holding byte 0, keywords the zero pad completes, a
    zero-length keyword, max_len 1 to 24, keywords cut by the chunk's
    end, and chunk lengths that are not a multiple of 32."""
    rng = np.random.default_rng([SEED, max_len, k, c, length])
    if case == "builtin":
        kws = builtin_keywords()
        bank = tp.KeywordBank(kws)
        kw, kw_len = bank.kw, bank.kw_len
        _kw, contents = fanal_corpus()
        body = b"".join(contents).lower()
        chunks = np.frombuffer(body[: c * length], dtype=np.uint8).reshape(
            c, length).copy()
    else:
        chunks, kw, kw_len = make_case(rng, c, k, max_len)
        chunks = chunks[:, :length].copy()
        chunks[0, length - 2:] = kw[1, :2]  # keyword 1 ends in NUL
    form = tp.KeywordTensors.from_arrays(kw, kw_len, max_len, "cpu")
    check_keyword_taps(form, kw, kw_len, max_len)
    args = (torch.from_numpy(chunks), torch.from_numpy(kw),
            torch.from_numpy(kw_len))
    want = tp.prefilter_hits_ref(*args, max_len).numpy()
    np.testing.assert_array_equal(plain_keyword_screen(chunks, form), want)
    if length == tp.CHUNK:
        np.testing.assert_array_equal(want, np.asarray(
            jp._kernel(k, max_len)(*(jnp.asarray(a)
                                     for a in (chunks, kw, kw_len)))))
    if case == "random":
        assert want[:, 0].all()  # the zero-length keyword
        assert form.n_taps[0] == 0
    assert want.any()


def test_keyword_form_of_the_builtin_bank():
    """The builtin bank's 114 keywords use 38 distinct byte values: two
    class words, 789 taps, the first of each keyword its rarest byte."""
    bank = tp.KeywordBank(builtin_keywords())
    form = tp.KeywordTensors.from_arrays(bank.kw, bank.kw_len, bank.max_len,
                                         "cpu")
    bits = np.unpackbits(form.cls_bits.numpy().view(np.uint8), axis=1,
                         bitorder="little").astype(bool)
    assert bits.any(axis=0).sum() == 38 and form.cls_bits.shape == (256, 2)
    assert form.taps.shape == (114, tp.MAX_KW) and form.rw == 4
    assert int(form.n_taps.sum()) == int(bank.kw_len.sum()) == 789
    check_keyword_taps(form, bank.kw, bank.kw_len, bank.max_len)
    empty = tp.KeywordTensors.from_arrays(np.zeros((2, tp.MAX_KW), np.uint8),
                                          np.zeros(2, np.int32), 5, "cpu")
    assert empty.cls_bits.shape == (256, 1) and not empty.cls_bits.any()
    assert empty.n_taps.tolist() == [0, 0]


def test_keyword_layout_at_1024_chunks():
    """The grid of the main path's prefilter launch (1,024 chunks, the
    builtin bank): 2,048-position tiles, one block a chunk walking its 8
    tiles in order (so a keyword found in one tile is skipped in the
    later ones), every keyword in one slice, the class table in shared
    memory, and a block small enough for four an SM."""
    n_sm = 132
    lay = tn.screen_layout(1024, tp.CHUNK, 2, 114, 4, n_sm, taps=tp.MAX_KW)
    assert (lay.tile_words, lay.tiles_per_block, lay.rules_per_slice,
            lay.tab_in_smem, lay.blocks) == (64, 8, 114, True, 1024)
    assert lay.smem == tn.screen_smem(2, 114, 4, 64, True, tp.MAX_KW)
    assert 4 * (lay.smem + 1024) <= tn.SM_SMEM and lay.slots == 4 * n_sm
    # a small batch splits its chunks into runs of tiles
    small = tn.screen_layout(3, tp.CHUNK, 2, 114, 4, n_sm, taps=tp.MAX_KW)
    assert (small.tiles_per_block, small.blocks) == (1, 24)
    # 256 byte classes and 1,000 keywords still fit
    big = tn.screen_layout(1024, tp.CHUNK, 8, 1000, 32, n_sm, taps=tp.MAX_KW)
    assert big.smem <= tn.BLOCK_SMEM_MAX and big.rules_per_slice <= 1000


def test_keyword_form_is_tied_to_its_bank():
    """prefilter_hits takes a compact form only with the very bank
    tensors of_bank built it from, unchanged since, at its max_len: a
    form of another bank of the same shape, a form built from host
    arrays, another max_len and an in-place edit of the bank raise."""
    rng = np.random.default_rng(SEED + 5)
    chunks, kw, kw_len = (torch.from_numpy(a)
                          for a in make_case(rng, 2, 9, 12))
    form = tp.KeywordTensors.of_bank(kw, kw_len, 12)
    assert form.is_of(kw, kw_len, 12)
    np.testing.assert_array_equal(
        plain_keyword_screen(chunks.numpy(), form),
        tp.prefilter_hits(chunks, kw, kw_len, 12, form).numpy())
    _c, kw2, kw_len2 = (torch.from_numpy(a)
                        for a in make_case(rng, 2, 9, 12))
    loose = tp.KeywordTensors.from_arrays(kw.numpy(), kw_len.numpy(), 12,
                                          "cpu")
    for bad in ((kw2, kw_len2, 12, form), (kw, kw_len, 12, loose),
                (kw, kw_len, 11, form)):
        with pytest.raises(ValueError, match="of_bank"):
            tp.prefilter_hits(chunks, *bad)
    kw[1, 0] += 1
    assert not form.is_of(kw, kw_len, 12)
    with pytest.raises(ValueError, match="of_bank"):
        tp.prefilter_hits(chunks, kw, kw_len, 12, form)


def test_cuda_bindings_pass_every_argument(monkeypatch):
    """The prefilter and match wrappers hand their entry points one
    argument per ctypes argtype (the stream is added by _launch), in the
    order of the sources' extern "C" parameters."""
    from trivy_tpu_torch.ops import kernels
    from trivy_tpu_torch.ops import match as tm
    from trivy_tpu_torch.ops import secret_nfa as nfa

    seen = {}
    monkeypatch.setattr(kernels, "_launch",
                        lambda name, what, device, *args:
                        seen.setdefault(name, args))
    bank = tp.KeywordBank([b"akia", b"ghp_"])
    form = tp.KeywordTensors.from_arrays(bank.kw, bank.kw_len, bank.max_len,
                                         "cpu")
    chunks = torch.zeros((3, 100), dtype=torch.uint8)
    words = torch.zeros((3, form.rw), dtype=torch.int32)
    out = torch.zeros((3, 2), dtype=torch.bool)
    lay = nfa.screen_layout(3, 100, 1, 2, 1, 132, taps=tp.MAX_KW)
    kernels.prefilter_hits_cuda(chunks, form, words, out, lay)
    args = seen["secret_prefilter"]
    assert len(args) + 1 == len(kernels._ENTRY["secret_prefilter"][1])
    assert args[:6] == (chunks.data_ptr(), form.cls_bits.data_ptr(),
                        form.taps.data_ptr(), form.n_taps.data_ptr(),
                        words.data_ptr(), out.data_ptr())
    assert args[6:] == (3, 100, 1, 2, 1, lay.tile_words, lay.tiles_per_block,
                        lay.rules_per_slice, 1)
    ddb = tm.DeviceDB.from_arrays(np.arange(5, dtype=np.uint32),
                                  np.zeros(5, np.uint32),
                                  np.zeros(5, np.int32), np.zeros(5, np.int32),
                                  np.zeros(5, np.int32), window=40,
                                  device="cpu")
    q = [torch.zeros(7, dtype=torch.int32) for _ in range(4)]
    mout = torch.zeros((7, 2), dtype=torch.int32)
    kernels.match_words_cuda(ddb.h1, ddb.h1_index, ddb.table, *q, mout, 2)
    args = seen["match"]
    assert len(args) + 1 == len(kernels._ENTRY["match"][1])
    assert args[:3] == (ddb.h1.data_ptr(), ddb.h1_index.data_ptr(),
                        ddb.table.data_ptr())
    assert args[8:] == (5, 7, 2, 2)


def fanal_corpus():
    """tests/test_fanal.py's prefilter corpus: random printable bodies,
    half with an upper-cased keyword, and one file bigger than a chunk
    with a keyword near its end."""
    kw = builtin_keywords()
    rng = random.Random(0)
    contents = []
    for _ in range(40):
        body = bytes(rng.randrange(32, 127)
                     for _ in range(rng.randrange(0, 4000)))
        if rng.random() < 0.5:
            k = kw[rng.randrange(len(kw))]
            pos = rng.randrange(0, len(body) + 1)
            body = body[:pos] + k.upper() + body[pos:]
        contents.append(body)
    contents.append(b"x" * 40000 + b"AKIA" + b"y" * 100)
    return kw, contents


@pytest.mark.parametrize("case", ["builtin", "tail", "straddle"])
def test_device_and_host_prefilters_equal_jax(case):
    if case == "builtin":
        kw, contents = fanal_corpus()
    elif case == "tail":
        kw = [b"akia"]
        contents = [b"x" * (tp.CHUNK - 4) + b"AKIA",
                    b"x" * (tp.CHUNK - 2) + b"AK", b"x" * tp.CHUNK, b""]
    else:
        kw = [b"secret_keyword"]
        contents = [b"x" * (tp.CHUNK - 5) + b"SECRET_KEYWORD" + b"y" * 100]
    # batches of four chunks: the JAX prefilter pads each to its size
    want = jp.DevicePrefilter(jp.KeywordBank(kw), batch_chunks=4) \
        .keyword_hits(contents)
    np.testing.assert_array_equal(
        want, jp.HostPrefilter(jp.KeywordBank(kw)).keyword_hits(contents))
    bank = tp.KeywordBank(kw)
    dev = tp.DevicePrefilter(bank, batch_chunks=4, device="cpu")
    np.testing.assert_array_equal(dev.keyword_hits(contents), want)
    np.testing.assert_array_equal(
        tp.HostPrefilter(bank).keyword_hits(contents), want)
    np.testing.assert_array_equal(
        tp.HostPrefilter(bank, use_native=False).keyword_hits(contents), want)
    assert want.any()
    if case == "tail":
        assert want[:, 0].tolist() == [True, False, False, False]


def test_device_prefilter_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.DevicePrefilter(tp.KeywordBank([b"akia"]))
    empty = tp.DevicePrefilter(tp.KeywordBank([]), device="cpu")
    assert empty.keyword_hits([b"akia"]).shape == (1, 0)


@pytest.mark.cuda
def test_cuda_prefilter_kernel_equals_plain_version():
    """On a card: the prefilter kernel against its plain version, bit
    for bit (the same check chip_smoke.py runs, smaller)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 3)
    # rows of 1,000 and 16,383 bytes are not 16-byte aligned: the screen
    # copies them byte by byte
    for max_len, k, c, length in [(1, 1, 1, tp.CHUNK), (24, 114, 5, tp.CHUNK),
                                  (7, 33, 2, tp.CHUNK), (24, 114, 3, 1000),
                                  (20, 40, 2, tp.CHUNK - 1)]:
        chunks, kw, kw_len = make_case(rng, c, k, max_len)
        args = [torch.from_numpy(a).to(dev) for a in (
            chunks[:, :length].copy(), kw, kw_len)]
        form = tp.KeywordTensors.of_bank(args[1], args[2], max_len)
        got = tp.prefilter_hits(*args, max_len)
        torch.cuda.synchronize()
        want = tp.prefilter_hits_ref(*args, max_len)
        assert torch.equal(got, want)
        assert torch.equal(tp.prefilter_hits(*args, max_len, form), want)
    kw, contents = fanal_corpus()
    bank = tp.KeywordBank(kw)
    np.testing.assert_array_equal(
        tp.DevicePrefilter(bank, device=dev).keyword_hits(contents),
        tp.HostPrefilter(bank).keyword_hits(contents))
