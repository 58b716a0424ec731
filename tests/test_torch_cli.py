"""Port parity, the `sbom` scan path end to end: trivy_tpu_torch's CLI
(`python -m trivy_tpu_torch sbom ...`, here with `--device cpu`, so the
match kernel's plain version answers) against the golden report of
tests/test_sbom_e2e.py and against the JAX package's CLI on the same DB
directory, byte for byte, over CycloneDX and SPDX input, json and table
output, and the device and host-oracle (`--no-tpu`) match paths. Plus
the CLI's device policy and the flags it refuses.

Reports are compared as bytes: the tolerance is exact equality.
"""

import inspect
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import test_sbom_e2e
import torch

from trivy_tpu.cli import main as jax_main
from trivy_tpu.cli import run as jax_run
from trivy_tpu_torch.cli import config, run
from trivy_tpu_torch.cli.main import main
from trivy_tpu_torch.db import Advisory, AdvisoryDB, VulnerabilityMeta
from trivy_tpu_torch.db.model import DataSourceInfo
from trivy_tpu_torch.tensorize.synth import synth_sbom, synth_trivy_db

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "sbom_cdx.json.golden"
SEED = 20261017
FAKE_TIME = "2024-01-01T00:00:00+00:00"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and idle OpenMP workers spin on cores their neighbours' timing
    tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_engines(monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", FAKE_TIME)
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()
    yield
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()


def fixture_db() -> AdvisoryDB:
    """tests/test_sbom_e2e.py's five advisories and their metadata,
    built with the port's own types."""
    ns = {"Advisory": Advisory, "AdvisoryDB": AdvisoryDB,
          "VulnerabilityMeta": VulnerabilityMeta,
          "DataSourceInfo": DataSourceInfo}
    exec(inspect.getsource(test_sbom_e2e._fixture_db), ns)
    return ns["_fixture_db"]()


@pytest.fixture()
def golden_env(tmp_path):
    fixture_db().save(str(tmp_path / "db"))
    (tmp_path / "bom.json").write_text(json.dumps(test_sbom_e2e.CDX_DOC))
    return {"sbom": str(tmp_path / "bom.json"), "db": str(tmp_path / "db"),
            "cache": str(tmp_path / "cache")}


def port_argv(env, *extra) -> list[str]:
    return ["sbom", env["sbom"], "--db-path", env["db"], "--cache-dir",
            env["cache"], "--quiet", "--device", "cpu", *extra]


def test_golden_json(golden_env, capsys):
    rc = main(port_argv(golden_env, "--format", "json"))
    assert rc == 0
    assert capsys.readouterr().out == GOLDEN.read_text()
    assert run.STATS["compile_cache"] == "miss"
    engine = next(iter(run._ENGINE_CACHE.values()))
    assert engine.device == torch.device("cpu")


def test_golden_table(golden_env, capsys):
    rc = main(port_argv(golden_env, "--format", "table"))
    assert rc == 0
    out = capsys.readouterr().out
    assert "Total: 2" in out
    assert "CVE-2019-10744" in out and "lodash" in out


def test_golden_severity_filter_and_exit_code(golden_env, capsys):
    rc = main(port_argv(golden_env, "--format", "json", "--severity",
                        "CRITICAL", "--exit-code", "5"))
    assert rc == 5
    doc = json.loads(capsys.readouterr().out)
    sevs = {v["Severity"] for r in doc["Results"]
            for v in r.get("Vulnerabilities", [])}
    assert sevs == {"CRITICAL"}


def test_golden_no_tpu_equals_device_path(golden_env, capsys):
    assert main(port_argv(golden_env, "--format", "json")) == 0
    device = capsys.readouterr().out
    run._ENGINE_CACHE.clear()
    assert main(port_argv(golden_env, "--format", "json", "--no-tpu")) == 0
    assert capsys.readouterr().out == device == GOLDEN.read_text()
    # the warm start loaded the compiled entry the first run saved
    assert run.STATS["compile_cache"] == "hit"


# ------------------------------------------- port vs the JAX package's CLI


@pytest.fixture(scope="module")
def synth_env(tmp_path_factory):
    """A seeded ~20,000-advisory synthetic trivy-db with metadata for a
    share of its vulnerabilities (mixed severities), saved once, and a
    seeded 300-component image SBOM in both formats."""
    tmp = tmp_path_factory.mktemp("synth")
    db = synth_trivy_db(n_advisories=20_000, seed=SEED)
    rng = random.Random(SEED)
    sevs = ["LOW", "MEDIUM", "HIGH", "CRITICAL", "UNKNOWN"]
    ids = sorted({a.vulnerability_id for pkgs in db.buckets.values()
                  for advs in pkgs.values() for a in advs})
    for vid in ids[::3]:
        db.put_meta(VulnerabilityMeta(
            id=vid, title=f"title of {vid}",
            severity=sevs[rng.randrange(5)],
            vendor_severity={"nvd": rng.randint(0, 4)}
            if rng.random() < 0.5 else {}))
    db.save(str(tmp / "db"))
    paths = {}
    for fmt in ("cyclonedx", "spdx"):
        p = tmp / f"{fmt}.json"
        p.write_text(json.dumps(synth_sbom(db, 100, 150, 50, seed=SEED,
                                           fmt=fmt)))
        paths[fmt] = str(p)
    return {"db": str(tmp / "db"), "sbom": paths, "tmp": tmp}


@pytest.mark.parametrize("no_tpu", [False, True], ids=["device", "no-tpu"])
@pytest.mark.parametrize("sbom_fmt", ["cyclonedx", "spdx"])
@pytest.mark.parametrize("out_fmt", ["json", "table"])
def test_port_cli_equals_jax_cli(synth_env, capsys, out_fmt, sbom_fmt,
                                 no_tpu):
    common = ["sbom", synth_env["sbom"][sbom_fmt], "--format", out_fmt,
              "--db-path", synth_env["db"], "--quiet"]
    if out_fmt == "json":
        common.append("--list-all-pkgs")  # the packages render too
    if no_tpu:
        common.append("--no-tpu")
    tmp = synth_env["tmp"]
    assert jax_main.main(common + ["--cache-dir", str(tmp / "jcache")]) == 0
    want = capsys.readouterr().out
    assert main(common + ["--cache-dir", str(tmp / "pcache"), "--device",
                          "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    if out_fmt == "json":
        doc = json.loads(got)
        classes = {r["Class"] for r in doc["Results"]}
        assert classes == {"os-pkgs", "lang-pkgs"}
        assert sum(len(r.get("Vulnerabilities", []))
                   for r in doc["Results"]) > 50
    engine = next(iter(run._ENGINE_CACHE.values()))
    assert engine.use_device is not no_tpu


def test_scan_stats_split(synth_env, capsys):
    """run.STATS splits the scan's wall seconds by phase."""
    argv = ["sbom", synth_env["sbom"]["cyclonedx"], "--format", "json",
            "--db-path", synth_env["db"], "--quiet", "--device", "cpu",
            "--cache-dir", str(synth_env["tmp"] / "stats")]
    assert main(argv) == 0
    capsys.readouterr()
    for key in ("db_load_s", "engine_build_s", "compile_s", "upload_s",
                "apply_s", "detect_s", "render_s", "wall_s"):
        assert run.STATS[key] >= 0.0, key
    assert run.STATS["compile_cache"] in ("hit", "miss")
    assert main(argv) == 0  # the process's engine answers again
    assert run.STATS["engine_build_s"] == 0.0


# ---------------------------------------------------- device and flags


def test_no_card_fails_and_names_cuda(golden_env, monkeypatch, capsys):
    """Without a card and without --device cpu the CLI refuses, with
    one error line naming CUDA; --no-tpu needs no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["sbom", golden_env["sbom"], "--format", "json", "--db-path",
            golden_env["db"], "--cache-dir", golden_env["cache"]]
    assert main(argv) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    errors = [ln for ln in captured.err.splitlines() if "ERROR" in ln]
    assert len(errors) == 1 and "CUDA" in errors[0]
    assert main(argv + ["--no-tpu", "--quiet"]) == 0
    assert capsys.readouterr().out == GOLDEN.read_text()


# every option of the reference's scan parsers is ported now
# (cli/config.py UNPORTED is empty): each gives the reference's bytes;
# --generate-default-config writes the reference's file and exits
@pytest.mark.parametrize("flag", [["--license-full"],
                                  ["--module-dir", "modules"],
                                  ["--generate-default-config"],
                                  ["--report", "all"],
                                  ["--compliance", "docker-cis-1.6.0"]])
def test_unported_flags_are_refused(golden_env, capsys, tmp_path,
                                    monkeypatch, flag):
    assert flag[0].lstrip("-").replace("-", "_") not in config.UNPORTED
    argv = port_argv(golden_env, "--format", "json", *flag)
    i = argv.index("--device")
    ref_argv = argv[:i] + argv[i + 2:] + ["--no-tpu"]
    if flag[0] == "--generate-default-config":
        written = []
        for entry, args in ((main, argv), (jax_main.main, ref_argv)):
            d = tmp_path / f"cwd-{len(written)}"
            d.mkdir()
            monkeypatch.chdir(d)
            rc = entry(args)
            written.append((rc, capsys.readouterr().out,
                            (d / "trivy-tpu.yaml").read_bytes()))
        assert written[0] == written[1]
        assert written[0][:2] == (0, "written: trivy-tpu.yaml\n")
        return
    assert main(argv) == 0
    got = capsys.readouterr().out
    assert jax_main.main(ref_argv) == 0
    assert got == capsys.readouterr().out
    if flag[0] == "--compliance":
        assert json.loads(got)["ID"] == "docker-cis-1.6.0"
    else:  # read only by a license scan, a compliance report or a
        # module directory that does not exist
        assert got == GOLDEN.read_text()


@pytest.mark.parametrize("flag", [
    ["--redis-tls"], ["--ignore-policy", "{policy}"],
    ["--ignore-policy", "{policy}", "--cache-backend", "memory"]])
def test_ported_flags_equal_reference(golden_env, tmp_path, capsys, flag):
    """--redis-tls (read only with a redis:// backend) and
    --ignore-policy on the golden SBOM: the reference's report."""
    policy = tmp_path / "policy.yaml"
    policy.write_text("ignore:\n  - path: VulnerabilityID\n"
                      "    equals: CVE-2019-10744\n")
    extra = [a.format(policy=policy) for a in flag]
    assert main(port_argv(golden_env, "--format", "json", *extra)) == 0
    got = capsys.readouterr().out
    argv = port_argv(golden_env, "--format", "json", *extra)
    i = argv.index("--device")
    assert jax_main.main(argv[:i] + argv[i + 2:] + ["--no-tpu"]) == 0
    assert got == capsys.readouterr().out
    if "--ignore-policy" in flag:
        assert "CVE-2019-10744" not in got and got != GOLDEN.read_text()
    else:
        assert got == GOLDEN.read_text()


@pytest.mark.parametrize("extra,message", [
    (["--scanners", "vuln,misconfig,license"], None),
    (["--scanners", "vuln,license"], None),
    (["--scanners", "vuln,bogus"], "'bogus' is not a valid Scanner"),
    (["--cache-backend", "memcached://localhost:11211"],
     "unknown cache backend"),
    (["--timeout", "5parsecs"], "invalid --timeout"),
    (["--device", "meta"], "--device"),
    (["--cache-backend", "redis://127.0.0.1:1"], "redis cache backend"),
])
def test_errors_are_one_line_and_rc_1(golden_env, capsys, extra, message):
    """A bad option value: one error line and rc 1. The license scanner
    (message None) is ported: the reference's report and rc 0."""
    argv = port_argv(golden_env, *extra)
    if message is None:
        assert main(argv + ["--format", "json"]) == 0
        got = capsys.readouterr().out
        i = argv.index("--device")
        assert jax_main.main(argv[:i] + argv[i + 2:]
                             + ["--format", "json", "--no-tpu"]) == 0
        assert got == capsys.readouterr().out
        return
    argv.remove("--quiet")
    assert main(argv) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    errors = [ln for ln in captured.err.splitlines() if "ERROR" in ln]
    assert len(errors) == 1 and message in errors[0], captured.err


def test_attestation_sbom_is_refused(golden_env, tmp_path, capsys):
    """An attestation whose statement holds no SBOM is refused with the
    reference's message (an attestation that wraps one is scanned:
    tests/test_torch_report.py)."""
    att = tmp_path / "att.json"
    att.write_text(json.dumps({"payloadType": "application/vnd.in-toto+json",
                               "payload": "e30=", "signatures": []}))
    argv = port_argv(golden_env, "--format", "json")
    argv[1] = str(att)
    argv.remove("--quiet")
    assert main(argv) == 1
    port_err = capsys.readouterr().err
    i = argv.index("--device")
    assert jax_main.main(argv[:i] + argv[i + 2:] + ["--no-tpu"]) == 1
    ref_err = capsys.readouterr().err
    assert "unsupported SBOM format" in port_err
    assert port_err.split("unsupported")[1] == ref_err.split("unsupported")[1]


def test_memory_cache_backend_and_output_file(golden_env, tmp_path,
                                              capsys):
    out = tmp_path / "report.json"
    rc = main(port_argv(golden_env, "--format", "json", "--cache-backend",
                        "memory", "--output", str(out)))
    assert rc == 0 and capsys.readouterr().out == ""
    assert out.read_text() == GOLDEN.read_text()
    assert not os.path.exists(os.path.join(golden_env["cache"], "fanal"))


def test_version_and_module_entry_point():
    """`python -m trivy_tpu_torch version` prints the port's version."""
    from trivy_tpu_torch import __version__

    out = subprocess.run([sys.executable, "-m", "trivy_tpu_torch",
                          "version"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == f"Version: {__version__}\n"
