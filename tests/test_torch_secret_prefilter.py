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
    for max_len, k, c in [(1, 1, 1), (24, 114, 5), (7, 33, 2)]:
        args = [torch.from_numpy(a).to(dev)
                for a in make_case(rng, c, k, max_len)]
        got = tp.prefilter_hits(*args, max_len)
        torch.cuda.synchronize()
        assert torch.equal(got, tp.prefilter_hits_ref(*args, max_len))
