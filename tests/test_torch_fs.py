"""Port parity, the `filesystem` / `fs` and `rootfs` scan paths end to
end: trivy_tpu_torch's CLI (here with `--device cpu`, so the match
kernel's and the secret screens' plain versions answer, or `--no-tpu`,
the host paths) against the JAX package's CLI on the same tree and DB
directory, byte for byte and with equal exit codes, over json and table
output and the flags these commands read. Plus the CLI's device policy
and the options it refuses from argv, the environment and a config
file.

Blob ids of a filesystem scan come from a uuid: both packages run under
TRIVY_TPU_DETERMINISTIC_UUID=1 with their counters reset before each
scan. Reports are compared as bytes: the tolerance is exact equality.
"""

import argparse
import json
import os

import pytest
import test_fanal
import torch
from test_cli_e2e import fs_dir, rootfs_dir  # noqa: F401  (fixtures)
from test_torch_fanal import seeded_db, seeded_tree

from trivy_tpu.cli import main as jax_main
from trivy_tpu.cli import run as jax_run
from trivy_tpu.utils import uuid as jax_uuid
from trivy_tpu_torch.cli import config, run
from trivy_tpu_torch.cli.main import build_parser, main
from trivy_tpu_torch.fanal.analyzers import secret_analyzer
from trivy_tpu_torch.secret import scanner as sc
from trivy_tpu_torch.utils import uuid as port_uuid

FAKE_TIME = "2024-01-01T00:00:00+00:00"
SECRET_KNOBS = ("TRIVY_TPU_SECRET_PACK_MB",
                "TRIVY_TPU_SECRET_STREAM_CHUNK_MB")


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
def _fresh(monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", FAKE_TIME)
    monkeypatch.setenv("TRIVY_TPU_DETERMINISTIC_UUID", "1")
    for knob in SECRET_KNOBS:  # the CLI's sizing flags export these
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setattr(secret_analyzer, "USE_DEVICE", "hybrid")
    monkeypatch.setattr(secret_analyzer, "DEVICE", None)
    monkeypatch.setattr(sc, "_CACHE_DIR_OVERRIDE", None)
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()
    yield
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """The reference tests' fixture DB and the seeded tree's DB, saved
    once (either package reads the other's directory)."""
    tmp = tmp_path_factory.mktemp("dbs")
    test_fanal._fixture_db().save(str(tmp / "fixture"))
    seeded_db().save(str(tmp / "seeded"))
    return {"fixture": str(tmp / "fixture"), "seeded": str(tmp / "seeded")}


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    root = tmp_path_factory.mktemp("seeded") / "tree"
    info = seeded_tree(root)
    return {"root": str(root), **info}


@pytest.fixture()
def mk_rootfs(tmp_path):
    root = tmp_path / "rootfs"
    test_fanal._mk_rootfs(root)
    return str(root)


def tree_and_db(request, dbs, tree: str) -> tuple[str, str]:
    if tree == "seeded":
        return request.getfixturevalue("seeded")["root"], dbs["seeded"]
    return request.getfixturevalue(tree), dbs["fixture"]


def scan(entry, argv: list[str], capsys, uuid_mod) -> tuple[int, str]:
    uuid_mod.reset()
    rc = entry(argv)
    return rc, capsys.readouterr().out


def both(argv: list[str], tmp_path, capsys, port_extra=("--device", "cpu"),
         jax_extra=()) -> tuple:
    """(rc, stdout) of the reference's CLI and of the port's, each on a
    cache directory of its own."""
    want = scan(jax_main.main, argv + list(jax_extra)
                + ["--cache-dir", str(tmp_path / "jcache")], capsys,
                jax_uuid)
    got = scan(main, argv + list(port_extra)
               + ["--cache-dir", str(tmp_path / "pcache")], capsys,
               port_uuid)
    return want, got


TREES = ["mk_rootfs", "fs_dir", "rootfs_dir", "seeded"]


@pytest.mark.parametrize("no_tpu", [False, True], ids=["device", "no-tpu"])
@pytest.mark.parametrize("fmt", ["json", "table"])
@pytest.mark.parametrize("cmd", ["fs", "filesystem", "rootfs"])
@pytest.mark.parametrize("tree", TREES)
def test_port_cli_equals_jax_cli(request, dbs, tmp_path, capsys, tree, cmd,
                                 fmt, no_tpu):
    root, db = tree_and_db(request, dbs, tree)
    argv = [cmd, root, "--format", fmt, "--db-path", db, "--quiet"]
    if fmt == "json":
        argv.append("--list-all-pkgs")
    if no_tpu:
        argv.append("--no-tpu")
    want, got = both(argv, tmp_path, capsys)
    assert got == want
    assert want[0] == 0 and want[1]
    if fmt == "json":
        doc = json.loads(got[1])
        assert doc["ArtifactType"] == "filesystem"
        # a rootfs scan reads no lockfile: fs_dir holds nothing else
        assert bool(doc.get("Results")) is not (
            tree == "fs_dir" and cmd == "rootfs")
    engine = next(iter(run._ENGINE_CACHE.values()))
    assert engine.use_device is not no_tpu
    assert secret_analyzer.USE_DEVICE == (False if no_tpu else "hybrid")


# the seeded tree under the flags fs and rootfs read; "{root}" is the
# scan root (absolute skip paths are rebased onto it)
FLAG_CASES = [
    ("fs", ["--skip-files", "tools/gen.py", "--skip-dirs", "thirdparty"]),
    ("fs", ["--skip-files", "{root}/tools/gen.py",
            "--skip-dirs", "{root}/thirdparty", "--skip-dirs", "src"]),
    ("rootfs", ["--skip-dirs", "usr/lib/node_modules", "--skip-files",
                "var/lib/rpm/rpmdb.sqlite"]),
    ("fs", ["--file-patterns", r"pip:requirements-prod\.txt$"]),
    ("fs", ["--include-dev-deps", "--list-all-pkgs"]),
    ("fs", ["--pkg-types", "library"]),
    ("rootfs", ["--pkg-types", "os", "--list-all-pkgs"]),
    ("fs", ["--scanners", "vuln"]),
    ("rootfs", ["--scanners", "secret"]),
    ("fs", ["--exit-code", "3"]),
    ("fs", ["--exit-code", "3", "--scanners", "vuln", "--severity",
            "CRITICAL", "--skip-dirs", "app"]),
    ("fs", ["--secret-config", "{root}/trivy-secret.yaml"]),
    ("rootfs", ["--secret-config", "{root}/trivy-secret.yaml",
                "--format", "table"]),
    ("fs", ["--severity", "HIGH,CRITICAL", "--ignore-unfixed",
            "--format", "table"]),
    ("fs", ["--parallel", "2", "--secret-pack-mb", "0.25",
            "--secret-stream-chunk-mb", "1"]),
]


@pytest.mark.parametrize("no_tpu", [False, True], ids=["device", "no-tpu"])
@pytest.mark.parametrize("cmd,flags", FLAG_CASES,
                         ids=[f"{c}-{i}" for i, (c, _f) in
                              enumerate(FLAG_CASES)])
def test_flags_equal_jax_cli(dbs, seeded, tmp_path, capsys, cmd, flags,
                             no_tpu):
    flags = [f.replace("{root}", seeded["root"]) for f in flags]
    argv = [cmd, seeded["root"], "--db-path", dbs["seeded"], "--quiet"]
    if "--format" not in flags:
        argv += ["--format", "json"]
    if no_tpu:
        argv.append("--no-tpu")
    want, got = both(argv + flags, tmp_path, capsys)
    assert got == want
    assert want[0] == (3 if "--exit-code" in flags else 0)


def _json_secrets(out: str) -> dict:
    return {(r["Target"], s["RuleID"], s["StartLine"])
            for r in json.loads(out)["Results"] if r["Class"] == "secret"
            for s in r["Secrets"]}


def test_custom_rules_and_skips_change_the_findings(dbs, seeded, tmp_path,
                                                    capsys):
    """The flags really act: the custom rule finds its tokens except
    under its allow rule and in the root config itself; skips drop
    their files."""
    base = ["fs", seeded["root"], "--format", "json", "--db-path",
            dbs["seeded"], "--quiet", "--device", "cpu", "--cache-dir",
            str(tmp_path / "c")]
    plain = _json_secrets(scan(main, base, capsys, port_uuid)[1])
    custom = _json_secrets(scan(main, base + [
        "--secret-config", seeded["root"] + "/trivy-secret.yaml"],
        capsys, port_uuid)[1])
    skipped = _json_secrets(scan(main, base + [
        "--skip-dirs", "thirdparty", "--skip-files", "tools/gen.py"],
        capsys, port_uuid)[1])
    rules = lambda found: {r for _t, r, _l in found}  # noqa: E731
    assert "acme-deploy-token" not in rules(plain)
    acme = {t for t, r, _l in custom if r == "acme-deploy-token"}
    assert "conf/trivy-secret.yaml" in acme
    assert not any(t.startswith("fixtures/") or t == "trivy-secret.yaml"
                   for t in acme)
    assert {t for t, _r, _l in plain} - {t for t, _r, _l in skipped} == \
        {"thirdparty/keys.py", "tools/gen.py"}
    planted = seeded["planted"]
    assert sum(1 for _t, r, _l in custom if r == "acme-deploy-token") == \
        planted["acme-deploy-token"] + 1  # + the nested config's token
    for kind in ("aws-access-key-id", "github-pat", "gitlab-pat",
                 "generic-password-assignment"):
        assert sum(1 for t, r, _l in skipped if r == kind) == \
            planted[kind], kind


def _force_device_screen(monkeypatch):
    """Make the secret analyzer take the device path (use_device=True)
    whatever the CLI set: on the CPU that is the screens' plain
    versions."""
    orig = secret_analyzer.SecretAnalyzer.post_analyze

    def forced(self, files):
        secret_analyzer.USE_DEVICE = True
        return orig(self, files)

    monkeypatch.setattr(secret_analyzer.SecretAnalyzer, "post_analyze",
                        forced)


@pytest.mark.parametrize("config", [False, True], ids=["builtin", "custom"])
def test_device_screen_on_the_cli_path(dbs, seeded, tmp_path, capsys,
                                       monkeypatch, config):
    """With the analyzer's USE_DEVICE = True the port on the CPU (the
    plain screens) equals the reference's report and its own host
    path."""
    argv = ["fs", seeded["root"], "--format", "json", "--db-path",
            dbs["seeded"], "--quiet", "--list-all-pkgs",
            "--secret-pack-mb", "0.25"]
    if config:
        argv += ["--secret-config", seeded["root"] + "/trivy-secret.yaml"]
    want = scan(jax_main.main, argv + ["--cache-dir", str(tmp_path / "j")],
                capsys, jax_uuid)
    host = scan(main, argv + ["--no-tpu", "--cache-dir",
                              str(tmp_path / "p")], capsys, port_uuid)
    _force_device_screen(monkeypatch)
    got = scan(main, argv + ["--device", "cpu", "--cache-dir",
                             str(tmp_path / "p")], capsys, port_uuid)
    assert got == want == host
    stats = run.STATS["secret_device_stats"]
    assert stats["chunks"] > 0 and stats["files"] > 0
    assert _json_secrets(got[1])


def test_hybrid_split_on_the_cli_path(dbs, seeded, tmp_path, capsys,
                                      monkeypatch):
    """The CLI's default "hybrid" mode as it runs on a card (the probe
    skipped by its own knob): a device share through the plain screen,
    the rest on the host; the report equals the reference's."""
    monkeypatch.setattr(sc.SecretScanner, "_accel_backend", lambda s: True)
    monkeypatch.setenv("TRIVY_TPU_SECRET_PROBE", "0")
    argv = ["fs", seeded["root"], "--format", "json", "--db-path",
            dbs["seeded"], "--quiet"]
    want, got = both(argv, tmp_path, capsys)
    assert got == want
    assert run.STATS["secret_device_stats"]["chunks"] > 0
    assert run.STATS["secret_probe"] is None  # the knob skipped it


def test_stream_path_file_over_the_threshold(dbs, tmp_path, capsys,
                                             monkeypatch):
    """A file just over the 10 MiB stream threshold, with secrets across
    its 1 MiB cuts: the port's host path equals the reference's report,
    and so does its device path (the plain screens) with 1 MiB stream
    chunks, so that the stream cuts the file ten times."""
    root = tmp_path / "tree"
    planted = seeded_tree(root, big=True)["planted"]
    argv = ["fs", str(root), "--format", "json", "--db-path",
            dbs["seeded"], "--quiet", "--scanners", "secret"]
    want, got = both(argv, tmp_path, capsys, port_extra=("--no-tpu",))
    assert got == want
    found = _json_secrets(got[1])
    assert sum(1 for t, _r, _l in found if t == "data/dump.sql") == 10
    # every builtin-kind plant, and the two in thirdparty/ and tools/
    del planted["acme-deploy-token"]
    assert len(found) == sum(planted.values()) + 2
    _force_device_screen(monkeypatch)
    dev = scan(main, argv + ["--secret-stream-chunk-mb", "1", "--device",
                             "cpu", "--cache-dir", str(tmp_path / "p")],
               capsys, port_uuid)
    assert dev == want
    assert run.STATS["secret_device_stats"]["chunks"] > 0


def test_scan_stats_split(dbs, seeded, tmp_path, capsys):
    argv = ["fs", seeded["root"], "--format", "json", "--db-path",
            dbs["seeded"], "--quiet", "--device", "cpu", "--cache-dir",
            str(tmp_path / "c")]
    assert main(argv) == 0
    capsys.readouterr()
    for key in ("db_load_s", "engine_build_s", "walk_s", "post_analyze_s",
                "secret_s", "apply_s", "detect_s", "render_s", "wall_s"):
        assert run.STATS[key] >= 0.0, key
    assert run.STATS["post_analyze_s"] >= run.STATS["secret_s"]
    assert set(run.STATS["secret_device_stats"]) >= {"files", "chunks"}
    assert "secret_probe" in run.STATS
    assert main(argv + ["--scanners", "vuln"]) == 0
    assert "secret_s" not in run.STATS


# ---------------------------------------------------- device and flags


@pytest.mark.parametrize("cmd", ["fs", "rootfs"])
def test_no_card_fails_and_names_cuda(dbs, mk_rootfs, tmp_path, capsys,
                                      monkeypatch, cmd):
    """Without a card and without --device cpu / --no-tpu the scan
    refuses at once, with one error line naming CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [cmd, mk_rootfs, "--format", "json", "--db-path",
            dbs["fixture"], "--cache-dir", str(tmp_path / "c")]
    assert main(argv) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    errors = [ln for ln in captured.err.splitlines() if "ERROR" in ln]
    assert len(errors) == 1 and "CUDA" in errors[0]
    assert main(argv + ["--no-tpu", "--quiet"]) == 0
    assert json.loads(capsys.readouterr().out)["Results"]


@pytest.mark.parametrize("cmd", ["sbom", "fs"])
@pytest.mark.parametrize("flag", ["--skip-db-update", "--offline-scan"])
def test_db_update_flags_change_no_report_byte(dbs, mk_rootfs, tmp_path,
                                               capsys, cmd, flag):
    """--skip-db-update and --offline-scan are accepted and ignored, as
    in the reference (whose parser takes the same argv and whose code
    reads neither): the report equals the run without the flag, and the
    reference's report with it."""
    import test_sbom_e2e

    target = mk_rootfs
    if cmd == "sbom":
        target = str(tmp_path / "bom.json")
        with open(target, "w") as f:
            json.dump(test_sbom_e2e.CDX_DOC, f)
    argv = [cmd, target, "--format", "json", "--db-path", dbs["fixture"],
            "--quiet"]
    args = jax_main.build_parser().parse_args(argv + [flag])
    assert getattr(args, flag[2:].replace("-", "_")) is True
    plain = scan(main, argv + ["--device", "cpu", "--cache-dir",
                               str(tmp_path / "c0")], capsys, port_uuid)
    (jrc, jout), (rc, out) = both(argv + [flag], tmp_path, capsys)
    assert rc == jrc == plain[0] == 0
    assert out == plain[1] == jout
    assert json.loads(out)["Results"]


def _scan_defaults(parser, cmd) -> dict:
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {a.dest: a.default for a in sub.choices[cmd]._actions
            if a.dest and a.dest != "help"}


@pytest.mark.parametrize("cmd", ["sbom", "filesystem", "fs", "rootfs",
                                 "repository", "repo", "vm"])
def test_unported_list_is_reference_dests_minus_ports(cmd):
    ref = _scan_defaults(jax_main.build_parser(), cmd)
    port = _scan_defaults(build_parser(), cmd)
    assert sorted(config.UNPORTED) == sorted(set(ref) - set(port))
    assert set(port) - set(ref) == {"device"}
    # each option's first unset value is the reference parser's default
    assert {d: v[0] for d, v in config.UNPORTED.items()} == \
        {d: ref[d] for d in config.UNPORTED}


@pytest.mark.parametrize("cmd", ["sbom", "fs", "rootfs"])
@pytest.mark.parametrize("dest,value", [("compliance", "docker-cis-1.6.0"),
                                        ("ignore_policy", "p.yaml"),
                                        ("license_full", "true"),
                                        ("module_dir", "modules"),
                                        ("redis_tls", "1"),
                                        ("report", "all")])
def test_unported_option_from_env_is_refused(dbs, mk_rootfs, tmp_path,
                                             capsys, monkeypatch, cmd,
                                             dest, value):
    """An option still unported is refused from the environment with one
    line. `compliance`, `ignore_policy`, `license_full`, `redis_tls` and
    `report` are ported now: from the environment they give the
    reference's report (`p.yaml` an ignore policy in the working
    directory; `redis_tls` read only with a redis:// backend;
    `license_full` and `report` read only by a license scan and a
    compliance report)."""
    monkeypatch.setenv("TRIVY_TPU_" + dest.upper(), value)
    target = mk_rootfs if cmd != "sbom" else str(tmp_path / "bom.json")
    if dest not in config.UNPORTED:
        monkeypatch.chdir(tmp_path)
        (tmp_path / value).write_text(
            "ignore:\n  - path: PkgName\n    equals: lodash\n")
        if cmd == "sbom":
            import test_sbom_e2e

            (tmp_path / "bom.json").write_text(
                json.dumps(test_sbom_e2e.CDX_DOC))
        argv = [cmd, target, "--db-path", dbs["fixture"], "--format",
                "json", "--quiet"]
        want, got = both(argv, tmp_path, capsys)
        assert got == want and got[0] == 0
        if dest == "ignore_policy":
            assert "lodash" not in got[1] or cmd == "rootfs"
        if dest == "compliance":
            assert json.loads(got[1])["ID"] == value
        return
    rc = main([cmd, target, "--db-path", dbs["fixture"], "--device", "cpu",
               "--cache-dir", str(tmp_path / "c")])
    assert rc == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    lines = captured.err.strip().splitlines()
    assert len(lines) == 1 and "not ported yet" in lines[0]
    assert dest.replace("_", "-") in lines[0]


@pytest.mark.parametrize("cmd", ["sbom", "fs", "rootfs"])
@pytest.mark.parametrize("doc", ["compliance: docker-cis-1.6.0\n",
                                 "scan:\n  license-full: true\n",
                                 "report: all\n",
                                 "module-dir: modules\n"])
def test_unported_option_from_config_file_is_refused(dbs, mk_rootfs,
                                                     tmp_path, capsys, cmd,
                                                     doc):
    """An option still unported (`module-dir`) is refused from the config
    file with one line; `compliance`, `license-full` and `report` are
    ported and give the reference's report."""
    cfg = tmp_path / "trivy-tpu.yaml"
    cfg.write_text(doc)
    target = mk_rootfs if cmd != "sbom" else str(tmp_path / "bom.json")
    key = doc.split(":")[0].split()[-1].replace("-", "_")
    if key not in config.UNPORTED:
        if cmd == "sbom":
            import test_sbom_e2e

            (tmp_path / "bom.json").write_text(
                json.dumps(test_sbom_e2e.CDX_DOC))
        argv = [cmd, target, "--config", str(cfg), "--db-path",
                dbs["fixture"], "--format", "json", "--quiet"]
        want, got = both(argv, tmp_path, capsys)
        assert got == want and got[0] == 0
        if key == "compliance":
            assert json.loads(got[1])["ID"] == "docker-cis-1.6.0"
        return
    rc = main([cmd, target, "--config", str(cfg), "--db-path",
               dbs["fixture"], "--device", "cpu", "--cache-dir",
               str(tmp_path / "c")])
    assert rc == 1
    captured = capsys.readouterr()
    lines = captured.err.strip().splitlines()
    assert captured.out == "" and len(lines) == 1
    assert "not ported yet" in lines[0]


@pytest.mark.parametrize("cmd", ["fs", "rootfs"])
@pytest.mark.parametrize("env,doc", [
    ({"TRIVY_TPU_RESUME": ""}, ""),
    ({"TRIVY_TPU_MESH": ""}, ""),
    ({"TRIVY_TPU_MESH": "off"}, ""),
    ({"TRIVY_TPU_VEX": "", "TRIVY_TPU_FLEET_PARALLEL": "1"}, ""),
    ({"TRIVY_TPU_SKIP_DB_UPDATE": "false"}, "scan:\n  dependency-tree: "
                                            "false\n"),
    ({}, "vex: []\nserver: ''\nlog-format: text\n"),
    # the environment wins over the config file, as for every option
    ({"TRIVY_TPU_SHOW_SUPPRESSED": "0"}, "show-suppressed: true\n"),
], ids=["resume-empty", "mesh-empty", "mesh-off", "vex-empty", "false",
        "config-defaults", "env-over-config"])
def test_unset_values_of_unported_options_are_accepted(
        dbs, mk_rootfs, tmp_path, capsys, monkeypatch, cmd, env, doc):
    """A value that leaves the reference's scan as it is (its parser's
    default, or a spelling its code reads as unset) is no reason to
    refuse: the port writes the reference's report."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = [cmd, mk_rootfs, "--format", "json", "--db-path", dbs["fixture"],
            "--quiet"]
    if doc:
        cfg = tmp_path / "trivy-tpu.yaml"
        cfg.write_text(doc)
        argv += ["--config", str(cfg)]
    want, got = both(argv, tmp_path, capsys)
    assert got == want and want[0] == 0 and json.loads(got[1])["Results"]


def test_uncoercible_unported_option_is_an_error_as_in_reference(
        dbs, mk_rootfs, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_FLEET_PARALLEL", "many")
    argv = ["fs", mk_rootfs, "--db-path", dbs["fixture"], "--quiet"]
    errors = []
    for entry, extra in ((jax_main.main, []), (main, ["--device", "cpu"])):
        assert entry(argv + extra + ["--cache-dir",
                                     str(tmp_path / "c")]) == 1
        captured = capsys.readouterr()
        assert captured.out == ""
        errors.append([ln for ln in captured.err.splitlines()
                       if "invalid value for 'fleet-parallel'" in ln])
    assert all(len(e) == 1 for e in errors)


def test_sizing_flags_last_for_their_scan_only(dbs, mk_rootfs, tmp_path,
                                               capsys, monkeypatch):
    """--secret-pack-mb and --secret-stream-chunk-mb reach the scanner
    through their environment knobs during the scan, and the knobs are
    as they were once it ends."""
    seen = {}
    scan_files = sc.SecretScanner.scan_files

    def spy(self, batch, use_device=True):
        seen.update({k: os.environ.get(k) for k in SECRET_KNOBS})
        return scan_files(self, batch, use_device=use_device)

    monkeypatch.setattr(sc.SecretScanner, "scan_files", spy)
    monkeypatch.setenv("TRIVY_TPU_SECRET_PACK_MB", "3")
    assert main(["fs", mk_rootfs, "--db-path", dbs["fixture"], "--quiet",
                 "--device", "cpu", "--cache-dir", str(tmp_path / "c"),
                 "--secret-pack-mb", "0.25", "--secret-stream-chunk-mb",
                 "1"]) == 0
    capsys.readouterr()
    assert seen == {"TRIVY_TPU_SECRET_PACK_MB": "0.25",
                    "TRIVY_TPU_SECRET_STREAM_CHUNK_MB": "1.0"}
    assert os.environ["TRIVY_TPU_SECRET_PACK_MB"] == "3"
    assert "TRIVY_TPU_SECRET_STREAM_CHUNK_MB" not in os.environ


def test_ported_options_from_env_and_config_equal_reference(
        dbs, seeded, tmp_path, capsys, monkeypatch):
    """Options this slice ports apply from the environment and the
    config file as the reference applies them."""
    cfg = tmp_path / "trivy-tpu.yaml"
    cfg.write_text("scan:\n  skip-files:\n    - tools/gen.py\n"
                   f"secret-config: {seeded['root']}/trivy-secret.yaml\n")
    monkeypatch.setenv("TRIVY_TPU_SKIP_DIRS", "thirdparty")
    argv = ["fs", seeded["root"], "--format", "json", "--db-path",
            dbs["seeded"], "--quiet", "--config", str(cfg)]
    want, got = both(argv, tmp_path, capsys)
    assert got == want
    found = _json_secrets(got[1])
    targets = {t for t, _r, _l in found}
    assert "thirdparty/keys.py" not in targets and "tools/gen.py" not in targets
    assert any(r == "acme-deploy-token" for _t, r, _l in found)


@pytest.mark.parametrize("flag", [["--compliance", "docker-cis-1.6.0"],
                                  ["--report", "all"],
                                  ["--license-full"],
                                  ["--module-dir", "modules"]])
def test_unported_flags_are_refused_on_argv(dbs, mk_rootfs, tmp_path,
                                            capsys, flag):
    """Every one is ported: `--compliance`, `--report`, `--license-full`
    and `--module-dir` (a directory that does not exist loads no
    module) give the reference's report."""
    argv = ["fs", mk_rootfs, "--db-path", dbs["fixture"], "--format",
            "json", "--quiet", "--scanners", "vuln,license", *flag]
    want, got = both(argv, tmp_path, capsys)
    assert got == want and got[0] == 0


@pytest.mark.parametrize("extra,message", [
    (["--scanners", "vuln,misconfig,license"], None),
    (["--file-patterns", "pip"], "invalid file pattern"),
    (["--scanners", "vuln,license"], None),
])
def test_errors_are_one_line_and_rc_1(dbs, mk_rootfs, tmp_path, capsys,
                                      extra, message):
    """A bad option value: one error line and rc 1. The license scanner
    (message None) is ported: the reference's report and rc 0."""
    if message is None:
        want, got = both(["rootfs", mk_rootfs, "--db-path", dbs["fixture"],
                          "--format", "json", "--quiet", *extra],
                         tmp_path, capsys)
        assert got == want and got[0] == 0
        return
    assert main(["rootfs", mk_rootfs, "--db-path", dbs["fixture"],
                 "--device", "cpu", "--cache-dir", str(tmp_path / "c"),
                 *extra]) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    errors = [ln for ln in captured.err.splitlines() if "ERROR" in ln]
    assert len(errors) == 1 and message in errors[0], captured.err


def test_secret_config_file_is_the_reference_default():
    args = build_parser().parse_args(["fs", "."])
    want = jax_main.build_parser().parse_args(["fs", "."])
    for dest in ("secret_config", "skip_files", "skip_dirs", "parallel",
                 "file_patterns", "include_dev_deps", "secret_pack_mb",
                 "secret_stream_chunk_mb"):
        assert getattr(args, dest) == getattr(want, dest), dest
    assert args.secret_config == "trivy-secret.yaml"


def test_fs_scan_imports_no_jax_in_a_fresh_process(dbs, mk_rootfs,
                                                    tmp_path):
    """An fs scan through the port's CLI, in a process of its own,
    loads the walker, the analyzers and the secret analyzer and never
    jax or the JAX package."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "from trivy_tpu_torch.cli.main import main\n"
        f"rc = main(['fs', {mk_rootfs!r}, '--format', 'json', "
        f"'--db-path', {dbs['fixture']!r}, '--cache-dir', "
        f"{str(tmp_path / 'c')!r}, '--quiet', '--device', 'cpu'])\n"
        "assert rc == 0, rc\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'trivy_tpu.')) or m == 'trivy_tpu']\n"
        "assert not bad, bad\n"
        "for m in ('trivy_tpu_torch.fanal.walker', "
        "'trivy_tpu_torch.fanal.analyzers.secret_analyzer', "
        "'trivy_tpu_torch.artifact.local_fs'):\n"
        "    assert m in sys.modules, m\n")
    env = {k: v for k, v in __import__("os").environ.items()
           if not k.startswith("TRIVY_TPU_")}
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parents[1], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout)["ArtifactType"] == "filesystem"
