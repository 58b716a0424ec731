"""Port parity, secret scanning as a whole: trivy_tpu_torch's
SecretScanner (device="cpu", so the screen's plain versions answer)
against the JAX package's SecretScanner, through scan_files with every
use_device mode, the conv bank, custom and allow rules, and the
streaming path. Plus the port's no-fallback rule: a device failure
raises out of every entry point instead of degrading to the host.

Findings are compared as (file_path, rule_id, start_line, end_line,
match, offset) tuples: the tolerance is exact equality.
"""

import io
import random

import pytest
import torch
from test_secret_engine import _big_file
from test_secret_nfa import SECRETS

import trivy_tpu.ops.secret_nfa as jn
import trivy_tpu.secret.scanner as jsc
import trivy_tpu_torch.ops.secret_nfa as tn
import trivy_tpu_torch.secret.scanner as tsc
from trivy_tpu.secret.rules import Rule as JaxRule
from trivy_tpu_torch.secret.rules import Rule

CHUNK = tn.CHUNK


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and idle OpenMP workers spin on cores their neighbours' timing
    tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def secret_corpus(seed: int = 5, n_files: int = 16,
                  sizes=(200, 2000, CHUNK + 500, 3 * CHUNK)):
    """The shape of tests/test_secret_nfa.py's corpus: word soup with
    planted secrets of every tier, file sizes drawn from `sizes` (around
    the chunk size by default), plus an empty, a binary and a clean
    file."""
    rng = random.Random(seed)
    words = [b"lorem", b"ipsum", b"export", b"import", b"password",
             b"token", b"config", b"value", b"key"]
    files = []
    for i in range(n_files):
        parts = []
        n = 0
        size = rng.choice(sizes)
        while n < size:
            w = rng.choice(words)
            parts += [w, b" "]
            n += len(w) + 1
            if rng.random() < 0.08:
                s = rng.choice(SECRETS)[1]
                parts += [s, b"\n"]
                n += len(s) + 1
            if rng.random() < 0.3:
                parts.append(b"\n")
                n += 1
        files.append((f"src/file{i}.txt", b"".join(parts)))
    files.append(("empty.txt", b""))
    files.append(("binary.bin", b"\x00\x01\x02" * 100))
    files.append(("clean.py", b"print('hello world')\n" * 50))
    return files


def norm(secrets):
    return [(s.file_path, f.rule_id, f.start_line, f.end_line, f.match,
             f.offset) for s in secrets for f in s.findings]


def nf(secret):
    return None if secret is None else norm([secret])


@pytest.fixture(scope="module", autouse=True)
def _small_batches(tmp_path_factory):
    """Screen batches of eight chunks in both packages (the JAX package
    pads every batch to its size, so its default of 256 would screen
    mostly padding here; in the port it makes several launches per
    scan), and the JAX package's compiled-NFA cache kept out of the home
    directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRIVY_TPU_SECRET_PACK_MB", "0.125")
        mp.setenv("TRIVY_TPU_CACHE_DIR",
                  str(tmp_path_factory.mktemp("nfa-cache")))
        yield


@pytest.fixture(autouse=True)
def _fresh_probe():
    """A clean hybrid-probe verdict in both packages."""
    jsc.reset_hybrid_probe()
    tsc.reset_hybrid_probe()
    yield
    jsc.reset_hybrid_probe()
    tsc.reset_hybrid_probe()


@pytest.fixture(scope="module")
def corpus():
    return secret_corpus()


@pytest.fixture(scope="module")
def port():
    """One port scanner for the module: its rule program compiles once."""
    return tsc.SecretScanner(device="cpu")


@pytest.fixture(scope="module")
def js():
    s = jsc.SecretScanner()
    yield s
    s.close()


@pytest.fixture(scope="module")
def jax_host(corpus, js):
    out = norm(js.scan_files(corpus, use_device=False))
    assert out, "corpus produced no findings at all"
    return out


@pytest.mark.parametrize("mode", [False, True, "hybrid"])
def test_scan_files_equals_jax(corpus, port, js, jax_host, mode):
    """Every use_device mode of the port equals the JAX package's host
    path and the same mode there (on the CPU, hybrid takes the host)."""
    port.device_stats = tsc._new_device_stats()
    got = norm(port.scan_files(corpus, use_device=mode))
    assert got == jax_host
    assert got == norm(js.scan_files(corpus, use_device=mode))
    if mode is True:
        st = port.device_stats
        assert st["chunks"] > 8 and st["files"] == len(corpus) - 1
        tiers = port._tiers
        kinds = {k for _cr, _lo, _hi, k in tiers["anchor_rules"]}
        assert kinds == {"seq", "lit"} and tiers["file_rules"]
        assert isinstance(tiers["bank"], tn.AnchorBank)


def _force_hybrid(monkeypatch):
    """The hybrid split on the CPU, forced as the JAX package's tests
    force it."""
    monkeypatch.setattr(tsc.SecretScanner, "_accel_backend",
                        lambda self: True)


@pytest.mark.parametrize("probe", ["0", "1"])
def test_hybrid_split_equals_jax(corpus, port, jax_host, monkeypatch, probe):
    """The hybrid split itself, with the one-shot probe skipped or run."""
    monkeypatch.setenv("TRIVY_TPU_SECRET_PROBE", probe)
    _force_hybrid(monkeypatch)
    calls = []
    real = tsc.SecretScanner._scan_files_hybrid
    monkeypatch.setattr(tsc.SecretScanner, "_scan_files_hybrid",
                        lambda self, e: calls.append(1) or real(self, e))
    assert norm(port.scan_files(corpus, use_device="hybrid")) == jax_host
    state = tsc.hybrid_probe_state()
    if probe == "0":
        assert calls and state is None
    else:
        assert set(state) == {"device", "reason", "device_s", "host_s",
                              "corpus_mb"}
        assert bool(calls) == state["device"]


@pytest.mark.parametrize("share", ["1.0", "0.0", "0.3x"])
def test_hybrid_share_env(corpus, port, jax_host, monkeypatch, share):
    """All on the device, all on the host, and an invalid share (the
    default split)."""
    monkeypatch.setenv("TRIVY_TPU_SECRET_PROBE", "0")
    monkeypatch.setenv("TRIVY_TPU_SECRET_DEVICE_SHARE", share)
    _force_hybrid(monkeypatch)
    assert norm(port.scan_files(corpus, use_device="hybrid")) == jax_host


def test_conv_bank_equals_jax(js, monkeypatch):
    """The port forced onto the conv bank, as tests/test_secret_nfa.py
    forces the JAX package, against the JAX package's findings. (The
    plain conv version equals the JAX conv kernel bit for bit in
    test_torch_secret_nfa.py.) Small files: they pack into few chunks,
    and one straddles a chunk cut."""
    corpus = secret_corpus(seed=9, n_files=6, sizes=(200, 2000))
    corpus.append(secret_corpus(seed=10, n_files=1, sizes=(CHUNK + 500,))[0])
    monkeypatch.setattr(tn, "make_anchor_bank",
                        lambda rows, device: tn.ConvAnchorBank(rows))
    port = tsc.SecretScanner(device="cpu")
    got = norm(port.scan_files(corpus, use_device=True))
    assert isinstance(port._tiers["bank"], tn.ConvAnchorBank)
    assert port.device_stats["chunks"] <= 4
    assert got == norm(js.scan_files(corpus, use_device=False))
    assert got == norm(port.scan_files(corpus, use_device=False))
    assert got


CUSTOM_YAML = """\
rules:
  - id: corp-token
    category: general
    title: corp token
    severity: HIGH
    regex: corp_[0-9a-f]{16}
    keywords: [corp_]
  - id: long-kw
    category: general
    title: long keyword rule
    severity: HIGH
    regex: tok_(?P<secret>[0-9a-f]{8})
    secret-group-name: secret
    keywords: [dockerconfigjson]
  - id: ini-only
    category: general
    title: ini file key
    severity: LOW
    regex: inikey=[A-Z]{6}
    path: "*.ini"
allow-rules:
  - id: allow-examples
    regex: corp_0{16}
  - id: allow-vendor
    path: vendor/.*
disable-rules: [slack-webhook-url]
"""


def test_custom_and_allow_rules_equal_jax(tmp_path):
    """A config with custom, keyword-gated, path-gated and allow rules:
    both port paths against the JAX package's host path."""
    cfg = tmp_path / "secret.yaml"
    cfg.write_text(CUSTOM_YAML)
    corpus = [
        ("a.txt", b"x corp_0123456789abcdef y"),
        ("b.txt", b"corp_nothex"),
        ("c.txt", b"corp_0000000000000000 allowed by value"),
        ("vendor/d.txt", b"corp_0123456789abcdef allowed by path"),
        ("prefix.txt", b"dockercompose: tok_0123abcd"),
        ("full.txt", b"dockerconfigjson: tok_0123abcd"),
        ("e.ini", b"inikey=ABCDEF"),
        ("e.txt", b"inikey=ABCDEF"),
    ] + secret_corpus(seed=7, n_files=4)
    port = tsc.SecretScanner(tsc.SecretConfig.load(str(cfg)), device="cpu")
    js = jsc.SecretScanner(jsc.SecretConfig.load(str(cfg)))
    want = norm(js.scan_files(corpus, use_device=False))
    js.close()
    for mode in (False, True):
        assert norm(port.scan_files(corpus, use_device=mode)) == want
    found = {(p, r) for p, r, *_ in want}
    assert ("a.txt", "corp-token") in found
    assert ("full.txt", "long-kw") in found
    assert ("prefix.txt", "long-kw") not in found
    assert ("e.ini", "ini-only") in found and ("e.txt", "ini-only") \
        not in found
    assert not {p for p, _r in found} & {"c.txt", "vendor/d.txt"}
    assert all(r != "slack-webhook-url" for _p, r in found)


def test_scan_file_and_straddle_equal_jax(port, js):
    secret = b"ghp_" + b"Q" * 36
    content = (b"pad " * 5000)[: CHUNK - 2] + secret + b" tail" * 100
    for mode in (False, True):
        got = norm(port.scan_files([("big.txt", content)], use_device=mode))
        assert got == norm(js.scan_files([("big.txt", content)],
                                         use_device=mode))
        assert any(r == "github-pat" for _p, r, *_ in got)
    assert nf(port.scan_file("big.txt", content)) \
        == nf(js.scan_file("big.txt", content))


# ------------------------------------------------------------ streaming


@pytest.fixture
def small_stream(monkeypatch):
    """The stream step lowered to its 64 KiB floor."""
    monkeypatch.setenv("TRIVY_TPU_SECRET_STREAM_CHUNK_MB", "0.0625")


@pytest.mark.parametrize("device", [False, True])
def test_stream_equals_jax(port, js, small_stream, device):
    """The shape of tests/test_secret_engine.py's streaming tests: the
    port's stream path against the JAX package's whole-file scan."""
    content = _big_file(64 * 1024)
    whole = nf(js.scan_file("cfg/prod.txt", content))
    assert whole is not None and len(whole) >= 3
    assert nf(port.scan_stream("cfg/prod.txt", content,
                               use_device=device)) == whole
    assert nf(port.scan_stream("cfg/prod.txt", io.BytesIO(content),
                               use_device=device)) == whole
    # a keyword only at EOF enables a match at the start
    body = bytearray(b'secret_key = "' + b"A" * 39 + b'1"\n')
    while len(body) < 3 * 64 * 1024:
        body += b"y" * 40 + b"\n"
    body += b"# aws config follows\n"
    assert nf(port.scan_stream("conf/x.txt", bytes(body),
                               use_device=device)) \
        == nf(js.scan_file("conf/x.txt", bytes(body)))


def test_stream_custom_rule_straddle_equals_jax(small_stream):
    kw = dict(id="corp-token", category="Corp", title="Corp token",
              severity="HIGH", regex=r"corptok-[0-9a-f]{16}",
              keywords=["corptok-"])
    port = tsc.SecretScanner(tsc.SecretConfig(custom_rules=[Rule(**kw)]),
                             device="cpu")
    js = jsc.SecretScanner(jsc.SecretConfig(custom_rules=[JaxRule(**kw)]))
    body = bytearray()
    while len(body) < 64 * 1024 - 12:
        body += b"z" * 31 + b"\n"
    body += b"corptok-0123456789abcdef\n"  # straddles the step boundary
    while len(body) < 160 * 1024:
        body += b"z" * 31 + b"\n"
    whole = nf(js.scan_file("w/cfg.ini", bytes(body)))
    js.close()
    assert whole is not None
    for device in (False, True):
        assert nf(port.scan_stream("w/cfg.ini", bytes(body),
                                   use_device=device)) == whole


def test_scan_files_routes_big_files_to_stream(port, js, small_stream,
                                               monkeypatch):
    """Files over STREAM_THRESHOLD (lowered here) go through scan_stream
    in both port paths, with the JAX package's findings for the batch."""
    monkeypatch.setattr(tsc, "STREAM_THRESHOLD", 100_000)
    monkeypatch.setattr(jsc, "STREAM_THRESHOLD", 100_000)
    streamed = []
    real = tsc.SecretScanner.scan_stream
    monkeypatch.setattr(tsc.SecretScanner, "scan_stream",
                        lambda self, p, c, use_device: streamed.append(p)
                        or real(self, p, c, use_device=use_device))
    batch = [("a/big.txt", _big_file(64 * 1024)),
             ("a/small.txt", b'token = "ghp_' + b"A1b2" * 9 + b'"\n')]
    want = norm(js.scan_files(batch, use_device=False))
    assert {p for p, *_ in want} == {"a/big.txt", "a/small.txt"}
    for mode in (False, True):
        assert norm(port.scan_files(batch, use_device=mode)) == want
    assert streamed == ["a/big.txt", "a/big.txt"]


# ------------------------------------------------------- no fallback


class DeviceGone(RuntimeError):
    pass


def _boom(*_a, **_k):
    raise DeviceGone("device gone")


@pytest.mark.parametrize("where", ["dispatch", "collect"])
def test_device_failure_raises_from_scan_files(port, monkeypatch, where):
    monkeypatch.setattr(
        tn.AnchorMatcher,
        "dispatch_chunks" if where == "dispatch" else "collect_chunks",
        _boom)
    corpus = secret_corpus(seed=13, n_files=4)
    with pytest.raises(DeviceGone):
        port.scan_files(corpus, use_device=True)
    monkeypatch.setenv("TRIVY_TPU_SECRET_PROBE", "0")
    _force_hybrid(monkeypatch)
    with pytest.raises(DeviceGone):
        port.scan_files(corpus, use_device="hybrid")
    # the host path stays the caller's explicit choice
    assert norm(port.scan_files(corpus, use_device=False))


def test_device_failure_raises_from_the_hybrid_probe(port, monkeypatch):
    _force_hybrid(monkeypatch)
    monkeypatch.setattr(tn.AnchorMatcher, "dispatch_chunks", _boom)
    with pytest.raises(DeviceGone):
        port.scan_files(secret_corpus(seed=14, n_files=4),
                        use_device="hybrid")
    assert tsc.hybrid_probe_state() is None


def test_device_failure_raises_from_scan_stream(port, small_stream,
                                                monkeypatch):
    monkeypatch.setattr(tn.AnchorMatcher, "dispatch_chunks", _boom)
    content = _big_file(64 * 1024)
    with pytest.raises(DeviceGone):
        port.scan_stream("lib/blob.txt", content, use_device=True)
    monkeypatch.setattr(tsc, "STREAM_THRESHOLD", 100_000)
    with pytest.raises(DeviceGone):
        port.scan_files([("lib/blob.txt", content)], use_device=True)
    assert nf(port.scan_stream("lib/blob.txt", content, use_device=False)) \
        == nf(port.scan_file("lib/blob.txt", content))


def test_device_policy(monkeypatch):
    """cuda:0 unless asked for the CPU; without a card the device path
    raises and the host path still runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = tsc.SecretScanner()
    corpus = secret_corpus(seed=15, n_files=4, sizes=(200, 2000))
    assert norm(port.scan_files(corpus, use_device=False))
    for mode in (True, "hybrid"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port.scan_files(corpus, use_device=mode)
    with pytest.raises(ValueError, match="expected True, False"):
        port.scan_files(corpus, use_device="device")
    assert tsc.SecretScanner(device="cpu").device == torch.device("cpu")
