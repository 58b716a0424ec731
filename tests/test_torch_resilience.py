"""Port parity, the circuit breaker and the degraded fallback:
trivy_tpu_torch's resilience/breaker.py and resilience/fallback.py and
the scan commands' `--fallback`, against the JAX package's.

The breaker and fallback shapes of tests/test_resilience.py run in both
packages (the port's local leg on device="cpu": the match kernel's plain
version; the reference's on its host path) and what each observes
(breaker states, degraded reasons, the vulnerability JSON, the degraded
report) must be equal. The CLI's `--fallback` against a dead server
writes a report that carries Metadata.Degraded, whose findings equal the
direct scan's and whose bytes equal the reference's; its local leg runs
on the CLI's device, so without a card and without `--device cpu` it
fails with one line naming CUDA: the fallback degrades from the server
to this process, never from the card to the CPU.
"""

from __future__ import annotations

import json
import threading
import time

import pytest
from test_torch_fleet import PKGS, PORT, engine_of, same
from test_torch_fleet import _one_thread  # noqa: F401 — fixture

import torch


@pytest.fixture(autouse=True)
def _clean_faults():
    for P in PKGS:
        P.faults.reset()
    yield
    for P in PKGS:
        P.faults.reset()


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _fast_retry(P, attempts: int = 3):
    return P.retry.RetryPolicy(attempts=attempts, base_s=0.001,
                               cap_s=0.005, seed=7, sleep=lambda s: None)


def _db(P):
    db = P.store.AdvisoryDB()
    db.put_advisory("npm::ghsa", "lodash", P.model.Advisory(
        vulnerability_id="CVE-2019-10744",
        vulnerable_versions=["<4.17.12"],
    ))
    db.put_meta(P.model.VulnerabilityMeta.from_json("CVE-2019-10744", {
        "Title": "prototype pollution", "Severity": "CRITICAL",
    }))
    return db


def _blob() -> dict:
    return {
        "schema_version": 2,
        "applications": [{
            "type": "npm",
            "file_path": "package-lock.json",
            "packages": [{
                "id": "lodash@4.17.4", "name": "lodash",
                "version": "4.17.4",
                "identifier": {"purl": "pkg:npm/lodash@4.17.4"},
            }],
        }],
    }


class _Server:
    def __init__(self, P):
        self.srv = P.server.Server(engine_of(P, _db(P)),
                                   P.cache.MemoryCache(),
                                   host="localhost", port=0)

    def __enter__(self):
        self.srv.start()
        return self.srv

    def __exit__(self, *exc):
        self.srv.shutdown()


def _vuln_json(results) -> str:
    return json.dumps([r.to_dict() for r in results], sort_keys=True)


# ------------------------------------------------------------- breaker


def _state_machine(P):
    clk = FakeClock()
    br = P.breaker.CircuitBreaker(failure_threshold=3, recovery_s=10.0,
                                  clock=clk, name="t")
    seen = [br.state, br.allow()]
    br.record_failure()
    br.record_failure()
    seen.append(br.state)
    br.record_failure()                     # 3rd consecutive -> open
    seen += [br.state, br.allow(), br.retry_in()]
    assert seen[3:5] == ["open", False]
    assert br.retry_in() == pytest.approx(10.0)
    clk.advance(9.9)
    seen.append(br.allow())                 # still open
    clk.advance(0.2)
    seen += [br.state, br.allow(), br.allow()]  # one trial admitted
    br.record_failure()                     # trial failed -> open again
    seen.append(br.state)
    clk.advance(10.1)
    seen.append(br.allow())                 # half-open trial
    br.record_success()                     # trial passed -> closed
    seen += [br.state, br.allow()]
    # success resets the consecutive-failure count
    br.record_failure()
    br.record_failure()
    br.record_success()
    br.record_failure()
    br.record_failure()
    seen.append(br.state)
    assert seen[-1] == "closed"
    assert seen[7:10] == ["half-open", True, False]
    return seen


def test_breaker_state_machine():
    same(_state_machine)


def _half_open_concurrent(P):
    clk = FakeClock()
    br = P.breaker.CircuitBreaker(failure_threshold=1, recovery_s=5.0,
                                  clock=clk, name="half-open")
    br.record_failure()                     # open
    clk.advance(5.0)                        # -> half-open on next tick
    n = 8
    barrier = threading.Barrier(n)
    admitted, shed_fast = [], []

    def probe():
        barrier.wait()
        start = time.monotonic()
        if br.allow():
            admitted.append(threading.get_ident())
        else:
            shed_fast.append(time.monotonic() - start)

    threads = [threading.Thread(target=probe) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(5)
    assert len(admitted) == 1               # one trial slot, ever
    assert len(shed_fast) == n - 1
    assert all(dt < 1.0 for dt in shed_fast)
    assert not br.allow()
    with pytest.raises(P.breaker.BreakerOpen) as exc:
        br.call(lambda: "ok")
    br.record_failure()                     # re-opens, timer restarts
    states = [br.state, br.allow()]
    clk.advance(5.0)
    states.append(br.allow())               # fresh half-open, one slot
    br.record_success()
    states += [br.state, all(br.allow() for _ in range(4))]
    assert states == ["open", False, True, "closed", True]
    return len(admitted), str(exc.value), states


def test_breaker_half_open_concurrent_probes():
    same(_half_open_concurrent)


def _call_raises(P):
    clk = FakeClock()
    br = P.breaker.CircuitBreaker(failure_threshold=1, recovery_s=5.0,
                                  clock=clk)
    with pytest.raises(ValueError):
        br.call(lambda: (_ for _ in ()).throw(ValueError("boom")))
    with pytest.raises(P.breaker.BreakerOpen) as exc:
        br.call(lambda: "ok")
    clk.advance(5.0)
    assert br.call(lambda: "ok") == "ok"
    assert br.state == "closed"
    return str(exc.value), exc.value.retry_in


def test_breaker_call_raises_when_open():
    same(_call_raises)


def test_breaker_gauge_and_transitions_equal_the_reference():
    """The breaker publishes its state gauge and transition counter
    under the reference's names and values."""
    def run(P):
        name = "parity-breaker"
        clk = FakeClock()
        br = P.breaker.CircuitBreaker(failure_threshold=1, recovery_s=1.0,
                                      clock=clk, name=name)
        t0 = P.metrics.BREAKER_TRANSITIONS.value(name=name, state="open")
        br.record_failure()
        gauge_open = P.metrics.BREAKER_STATE.value(name=name)
        clk.advance(1.0)
        _ = br.state
        gauge_half = P.metrics.BREAKER_STATE.value(name=name)
        br.record_success()
        return (gauge_open, gauge_half,
                P.metrics.BREAKER_STATE.value(name=name),
                P.metrics.BREAKER_TRANSITIONS.value(name=name,
                                                    state="open") - t0)
    assert same(run) == (2, 1, 0, 1)


# ------------------------------------------------------------ fallback


def _degrades(P):
    with _Server(P) as server:
        P.faults.install_spec("rpc.scan:drop")   # every remote scan dies
        breaker = P.breaker.CircuitBreaker(failure_threshold=3,
                                           recovery_s=30.0)
        local_cache = P.cache.MemoryCache()
        cache = P.fallback.FallbackCache(
            P.client.RemoteCache(server.address, retry=_fast_retry(P)),
            local_cache, breaker=breaker)
        cache.put_blob("sha256:b", _blob())      # mirrored local + remote
        engine = engine_of(P, _db(P))
        driver = P.fallback.FallbackDriver(
            P.client.RemoteDriver(server.address,
                                  retry=_fast_retry(P, attempts=2)),
            lambda: P.local.LocalDriver(engine, cache), breaker=breaker)
        results, _os = driver.scan("myapp", "", ["sha256:b"],
                                   P.scan.ScanOptions())
        assert "remote scan failed" in driver.degraded_reason
        pure = P.local.LocalDriver(engine_of(P, _db(P)), local_cache)
        pure_results, _ = pure.scan("myapp", "", ["sha256:b"],
                                    P.scan.ScanOptions())
        assert _vuln_json(results) == _vuln_json(pure_results)
        reason = driver.degraded_reason.replace(server.address, "URL")
        return _vuln_json(results), reason, breaker.state


def test_fallback_driver_degrades_and_matches_local():
    same(_degrades)


class _NeverDriver:
    def scan(self, *a):
        raise AssertionError("must not reach the remote")


def _open_breaker(P):
    clk = FakeClock()
    breaker = P.breaker.CircuitBreaker(failure_threshold=1,
                                       recovery_s=60.0, clock=clk)
    breaker.record_failure()                     # open
    cache = P.cache.MemoryCache()
    cache.put_blob("sha256:b", _blob())
    driver = P.fallback.FallbackDriver(
        _NeverDriver(),
        lambda: P.local.LocalDriver(engine_of(P, _db(P)), cache),
        breaker=breaker)
    results, _ = driver.scan("myapp", "", ["sha256:b"],
                             P.scan.ScanOptions())
    assert "circuit breaker open" in driver.degraded_reason
    assert results[0].vulnerabilities
    return _vuln_json(results), driver.degraded_reason


def test_fallback_driver_open_breaker_skips_remote():
    same(_open_breaker)


def _deadline_gone(P):
    cache = P.cache.MemoryCache()
    cache.put_blob("sha256:b", _blob())
    driver = P.fallback.FallbackDriver(
        _NeverDriver(),
        lambda: P.local.LocalDriver(engine_of(P, _db(P)), cache))
    clk = FakeClock()
    d = P.retry.Deadline.after(1.0, clock=clk)
    clk.advance(2.0)
    with P.retry.deadline_scope(d):          # budget already gone
        results, _ = driver.scan("myapp", "", ["sha256:b"],
                                 P.scan.ScanOptions())
    assert "deadline budget" in driver.degraded_reason
    assert results[0].vulnerabilities        # local completion
    assert driver.breaker.state == "closed"  # says nothing of the remote
    return _vuln_json(results), driver.degraded_reason


def test_fallback_driver_deadline_exhausted_goes_local():
    same(_deadline_gone)


def _mid_dispatch_deadline(P):
    cache = P.cache.MemoryCache()
    cache.put_blob("sha256:b", _blob())

    class DeadlineDriver:
        def scan(self, *a):
            raise P.retry.DeadlineExceeded(
                "deadline of 1.000s exhausted", budget_s=1.0)

    driver = P.fallback.FallbackDriver(
        DeadlineDriver(),
        lambda: P.local.LocalDriver(engine_of(P, _db(P)), cache))
    results, _ = driver.scan("myapp", "", ["sha256:b"],
                             P.scan.ScanOptions())
    assert "exhausted" in driver.degraded_reason
    assert results[0].vulnerabilities
    assert driver.breaker.state == "closed"  # no failure recorded
    return _vuln_json(results), driver.degraded_reason


def test_fallback_mid_dispatch_deadline_does_not_trip_breaker():
    same(_mid_dispatch_deadline)


def _degraded_report(P):
    class StubArtifact:
        def __init__(self, cache):
            self.cache = cache

        def inspect(self):
            self.cache.put_blob("sha256:b", _blob())
            return P.art_base.ArtifactReference(
                name="myapp", type="container_image", id="sha256:a",
                blob_ids=["sha256:b"])

        def clean(self, ref):
            pass

    with _Server(P) as server:
        P.faults.install_spec("rpc.scan:drop")
        breaker = P.breaker.CircuitBreaker(failure_threshold=3,
                                           recovery_s=30.0)
        local_cache = P.cache.MemoryCache()
        cache = P.fallback.FallbackCache(
            P.client.RemoteCache(server.address, retry=_fast_retry(P)),
            local_cache, breaker=breaker)
        driver = P.fallback.FallbackDriver(
            P.client.RemoteDriver(server.address,
                                  retry=_fast_retry(P, attempts=2)),
            lambda: P.local.LocalDriver(engine_of(P, _db(P)), cache),
            breaker=breaker)
        degraded = P.scanner.Scanner(driver, StubArtifact(cache)) \
            .scan_artifact(P.scan.ScanOptions())
        assert degraded.metadata.degraded
        assert "Degraded" in degraded.to_dict()["Metadata"]
        P.faults.reset()
        pure = P.scanner.Scanner(
            P.local.LocalDriver(engine_of(P, _db(P)), local_cache),
            StubArtifact(local_cache)).scan_artifact(P.scan.ScanOptions())
        assert not pure.metadata.degraded
        assert "Degraded" not in pure.to_dict().get("Metadata", {})
        assert _vuln_json(degraded.results) == _vuln_json(pure.results)
        meta = dict(degraded.to_dict()["Metadata"])
        meta["Degraded"] = meta["Degraded"].replace(server.address, "URL")
        return _vuln_json(degraded.results), meta


def test_degraded_report_stamped_and_zero_cve_diff():
    same(_degraded_report)


def test_fallback_driver_stats_follow_the_answering_driver():
    """The port's FallbackDriver exposes the answering driver's phase
    seconds, which the CLI folds into run.STATS: the local leg's on a
    degraded scan, none for a remote one (they ran on the server)."""
    cache = PORT.cache.MemoryCache()
    cache.put_blob("sha256:b", _blob())

    class Remote:
        stats: dict = {}

        def scan(self, *a):
            return [], None

    driver = PORT.fallback.FallbackDriver(
        Remote(), lambda: PORT.local.LocalDriver(engine_of(PORT, _db(PORT)),
                                                 cache))
    driver.scan("myapp", "", ["sha256:b"], PORT.scan.ScanOptions())
    assert driver.stats == {}
    driver.breaker.record_failure()
    driver.breaker.record_failure()
    driver.breaker.record_failure()          # open: goes local
    driver.scan("myapp", "", ["sha256:b"], PORT.scan.ScanOptions())
    assert set(driver.stats) >= {"apply_s", "detect_s"}


# ------------------------------------------------------ --fallback CLI


SBOM = {
    "bomFormat": "CycloneDX", "specVersion": "1.5", "version": 1,
    "metadata": {"component": {"type": "application", "name": "app"}},
    "components": [
        {"type": "library", "name": "lodash", "version": "4.17.4",
         "purl": "pkg:npm/lodash@4.17.4", "bom-ref": "lodash"},
        {"type": "library", "name": "left-pad", "version": "1.0.0",
         "purl": "pkg:npm/left-pad@1.0.0", "bom-ref": "left-pad"}],
}
DEAD = "http://127.0.0.1:9"


@pytest.fixture()
def cli_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", "2024-01-01T00:00:00+00:00")
    # no retry sleeps against the dead server
    monkeypatch.setenv("TRIVY_TPU_FLEET_HEDGE_MS", "0")
    bom = tmp_path / "bom.json"
    bom.write_text(json.dumps(SBOM))
    db = tmp_path / "db"
    _db(PORT).save(str(db))
    yield {"bom": str(bom), "db": str(db), "tmp": tmp_path}
    for P in PKGS:
        P.run._ENGINE_CACHE.clear()
        with P.client._CONN_POOL_LOCK:
            for c in P.client._CONN_POOL.values():
                c.close()
            P.client._CONN_POOL.clear()


def _cli_fallback(P, env, capsys):
    dev = ["--device", "cpu"] if P.port else ["--no-tpu"]
    common = ["--quiet", "--format", "json", "--db-path", env["db"],
              "--cache-dir", str(env["tmp"] / f"c-{P.name}")]
    assert P.cli.main(["sbom", env["bom"], *common, *dev]) == 0
    direct = json.loads(capsys.readouterr().out)
    assert P.cli.main(["sbom", env["bom"], "--server", DEAD, "--fallback",
                       "--scan-timeout", "20s", *common, *dev]) == 0
    out = capsys.readouterr().out
    degraded = json.loads(out)
    assert degraded["Metadata"]["Degraded"]
    assert degraded["Results"] == direct["Results"]
    assert degraded["Results"][0]["Vulnerabilities"]
    meta = {k: v for k, v in degraded["Metadata"].items()
            if k != "Degraded"}
    stripped = {k: v for k, v in degraded.items() if k != "Metadata"}
    if meta:
        stripped["Metadata"] = meta
    assert stripped == direct
    return out


def test_fallback_cli_report_is_degraded_and_equals_the_direct_scan(
        cli_env, capsys):
    """`sbom --server <dead> --fallback`: the report carries
    Metadata.Degraded and the direct scan's findings, byte for byte the
    reference's; the port's local leg launched its match kernel (the
    plain version on the CPU here)."""
    from trivy_tpu_torch.ops import match as m

    calls = []
    orig = m.match_words

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    m.match_words = counted
    try:
        same(_cli_fallback, cli_env, capsys)
    finally:
        m.match_words = orig
    # the direct scan's launches and the fallback's local leg's
    assert len(calls) >= 2


def test_fallback_local_leg_needs_a_card_unless_device_cpu(
        cli_env, capsys, monkeypatch):
    """No fallback hides the card: without a card and without `--device
    cpu` (or `--no-tpu`) the local leg fails with one line naming CUDA,
    after the remote failed; with `--device cpu` it completes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["sbom", cli_env["bom"], "--server", DEAD, "--fallback",
            "--format", "json", "--db-path", cli_env["db"],
            "--cache-dir", str(cli_env["tmp"] / "c")]
    assert PORT.cli.main(argv) == 1
    captured = capsys.readouterr()
    errors = [ln for ln in captured.err.splitlines() if "ERROR" in ln]
    assert captured.out == "" and len(errors) == 1
    assert "CUDA" in errors[0] and "--device" in errors[0]
    assert PORT.cli.main(argv + ["--device", "cpu", "--quiet"]) == 0
    assert json.loads(capsys.readouterr().out)["Metadata"]["Degraded"]


def test_fallback_is_no_longer_refused():
    """`--fallback` is on the port's scan parsers and off the list of
    options refused from the environment or a config file."""
    from trivy_tpu_torch.cli import config
    from trivy_tpu_torch.cli.main import build_parser

    assert "fallback" not in config.UNPORTED
    args = build_parser().parse_args(["sbom", "b.json", "--fallback"])
    assert args.fallback is True
