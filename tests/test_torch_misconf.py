"""Port parity, misconfiguration scanning (trivy_tpu_torch/iac/,
misconf/, fanal/analyzers/config_analyzer.py and the `config` command)
against the JAX package's on the CPU: the 253 built-in checks, each
failing on `chip_smoke.iac_monorepo`'s seeded corpus (seed 20261023) at
a small scale, `scan_config` and the Terraform module scan per file
type, `#trivy:ignore` comments on cloud resources, the `fs`, `rootfs`,
`repo`, `image`, `vm` and `config` CLIs byte for byte in four formats,
Helm overrides and IaC file patterns, image blob keys, the report under
two hash seeds, the check-engine options and a cached check bundle
(the custom checks themselves are tests/test_torch_policy.py's) and
the device-error rule.

The port scans with `--device cpu` (the match kernel's and the secret
screens' plain versions) or `--no-tpu`; the reference runs its JAX
engine on the CPU. Reports embed the clock and uuids, pinned here in
both packages.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import test_fanal
import torch
from test_terraform_ref_parity import IGNORE_CASES

import chip_smoke
from trivy_tpu.cli import main as jax_main
from trivy_tpu.cli import run as jax_run
from trivy_tpu.fanal import analyzer as jax_analyzer
from trivy_tpu.iac import check as jax_check
from trivy_tpu.iac import detection as jax_detection
from trivy_tpu.misconf import scanner as jax_misconf
from trivy_tpu.utils import uuid as jax_uuid
from trivy_tpu_torch.cli import config, run
from trivy_tpu_torch.cli.main import build_parser, main
from trivy_tpu_torch.device import DeviceError
from trivy_tpu_torch.fanal import analyzer as port_analyzer
from trivy_tpu_torch.fanal.analyzers import secret_analyzer
from trivy_tpu_torch.iac import check as port_check
from trivy_tpu_torch.iac import detection as port_detection
from trivy_tpu_torch.misconf import scanner as port_misconf
from trivy_tpu_torch.secret import scanner as sc
from trivy_tpu_torch.utils import uuid as port_uuid

FAKE_TIME = "2024-01-01T00:00:00+00:00"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference tests' lockfile package with an advisory in their
# fixture DB, so the vulnerability half of a scan has a finding
LOCKFILES = [("app/package-lock.json", json.dumps({
    "name": "app", "lockfileVersion": 3, "packages": {
        "": {"name": "app", "version": "1.0.0"},
        "node_modules/lodash": {"version": "4.17.4"}}})),
    ("app/requirements.txt", "django==2.2.0\n")]
HELM_VALUES = chip_smoke.IAC_HELM_VALUES
HELM_SET = chip_smoke.IAC_HELM_SET
# the options of the reference's check engine and its ignore policy,
# each with a value the scan acts on ({checks}, {data} and {policy} are
# chip_smoke.py phase 21's; nothing listens on port 1 of localhost, so
# a bundle update fails there and the scan goes on)
CUSTOM_CHECK_OPTIONS = {
    "config_check": "{checks}", "config_data": "{data}",
    "check_namespaces": "user", "include_deprecated_checks": "true",
    "ignore_policy": "{policy}",
    "checks_bundle_repository": "127.0.0.1:1/checks:1",
    "skip_check_update": "true"}


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
    for key in list(os.environ):
        if key.startswith("TRIVY_TPU_") and key not in (
                "TRIVY_TPU_FAKE_TIME", "TRIVY_TPU_DETERMINISTIC_UUID"):
            monkeypatch.delenv(key)
    monkeypatch.setattr(secret_analyzer, "USE_DEVICE", "hybrid")
    monkeypatch.setattr(secret_analyzer, "DEVICE", torch.device("cpu"))
    monkeypatch.setattr(sc, "_CACHE_DIR_OVERRIDE", None)
    # a CLI scan leaves its --secret-config path on the process-wide
    # secret analyzer: start each test with none in both packages
    for registry in (jax_analyzer._POST_ANALYZERS,
                     port_analyzer._POST_ANALYZERS):
        for a in registry:
            if a.type == "secret":
                a.configure(None)
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()
    yield
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The seeded monorepo with every check's fixtures (one service),
    a small one without them (two services) for the CLI runs, the
    --helm-values file, the fixture DB saved, the small tree as a
    docker-save archive and as an ext4 disk."""
    tmp = tmp_path_factory.mktemp("iac")
    full, small = tmp / "full", tmp / "small"
    info = chip_smoke.iac_monorepo(str(full), 1, LOCKFILES)
    chip_smoke.iac_monorepo(str(small), 2, LOCKFILES, conformance=False)
    test_fanal._fixture_db().save(str(tmp / "db"))
    values = tmp / "values.yaml"
    values.write_text(HELM_VALUES)
    files = []
    for d, _dirs, names in os.walk(small):
        for n in sorted(names):
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                files.append((os.path.relpath(p, small), f.read()))
    tar = str(tmp / "image.tar")
    chip_smoke.write_image(
        tar, [chip_smoke.layer_tar([("etc/os-release",
                                     test_fanal.OS_RELEASE),
                                    ("lib/apk/db/installed",
                                     test_fanal.APK_INSTALLED)]),
              chip_smoke.layer_tar([(f"srv/{p}", b) for p, b in files])],
        [{"created_by": "base"}, {"created_by": "COPY . /srv"}], "docker")
    disk = None
    if os.path.exists("/usr/sbin/mkfs.ext4") or os.path.exists(
            "/sbin/mkfs.ext4"):
        disk = str(tmp / "disk.raw")
        subprocess.run(["mkfs.ext4", "-q", "-F", "-d", str(small), disk,
                        "16m"], check=True, capture_output=True,
                       env={**os.environ, "PATH": os.environ.get(
                           "PATH", "") + ":/usr/sbin:/sbin"})
    return {"full": str(full), "small": str(small), "db": str(tmp / "db"),
            "values": str(values), "tar": tar, "disk": disk, **info}


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


def as_data(misconfs) -> list:
    return [dataclasses.asdict(m) for m in misconfs]


# ------------------------------------------------------------- registry


def registry(mod, file_type: str) -> list:
    return [(c.id, c.avd_id, c.title, c.description, c.resolution,
             c.severity, c.file_types, c.provider, c.service, c.url,
             c.namespace, c.deprecated) for c in mod.checks_for(file_type)]


@pytest.mark.parametrize("file_type", [
    "dockerfile", "terraform", "terraformplan", "cloudformation",
    "azure-arm", "kubernetes", "helm"])
def test_check_registry_equals_the_reference(file_type):
    got = registry(port_check, file_type)
    assert got == registry(jax_check, file_type) and got
    assert [c.id for c in port_check.all_checks()] == \
        [c.id for c in jax_check.all_checks()]
    assert len(port_check.all_checks()) == 253


# -------------------------------------------------------------- corpus


def failed_ids(doc: dict) -> set:
    return {m["ID"] for r in doc.get("Results") or []
            for m in r.get("Misconfigurations") or []
            if m["Status"] == "FAIL"}


def test_every_builtin_check_fails_on_the_corpus(corpus, tmp_path, capsys):
    """`config` on the seeded corpus: every one of the 253 built-in
    checks fails at least once, in both packages' byte-equal reports.
    No check is exempt: each has a failing fixture."""
    argv = ["config", corpus["full"], "--format", "json", "--db-path",
            corpus["db"], "--quiet"]
    want, got = both(argv, tmp_path, capsys)
    assert got == want and want[0] == 0
    ids = {c.id for c in port_check.all_checks()}
    assert ids - failed_ids(json.loads(got[1])) == set()


def case_fails(mod_pkg, ftype: str, body) -> set:
    """The ids one fixture fails, through the scan path of `mod_pkg`
    ("jax" or "port")."""
    misconf, det = ((jax_misconf, jax_detection) if mod_pkg == "jax"
                    else (port_misconf, port_detection))
    if ftype == "terraform":
        found = misconf.scan_terraform_modules({"main.tf": body.encode()})
        return {f.id for m in found for f in m.failures}
    if ftype == "azure-arm":
        body = {"resources": [body]}
    name, data = {
        "dockerfile": ("Dockerfile", body),
        "kubernetes": ("pod.yaml", body),
        "cloudformation": ("template.json", json.dumps(body)),
        "azure-arm": ("azuredeploy.json", json.dumps(body)),
    }[ftype]
    m = misconf.scan_config(name, data.encode(), file_type={
        "dockerfile": det.DOCKERFILE, "kubernetes": det.KUBERNETES,
        "cloudformation": det.CLOUDFORMATION,
        "azure-arm": det.AZURE_ARM}[ftype])
    return {f.id for f in m.failures} if m else set()


CASE_TYPES = ["terraform", "cloudformation", "azure-arm", "dockerfile",
              "kubernetes"]


@pytest.mark.parametrize("ftype", CASE_TYPES)
def test_each_fixture_fails_and_passes_its_check(ftype):
    """Each check's failing fixture fails it and its passing fixture
    does not, in both packages alike."""
    cases = [c for c in chip_smoke.breadth_cases()
             + chip_smoke.IAC_EXTRA_CASES if c[1] == ftype]
    assert cases
    for cid, _t, bad, good in cases:
        bad_ids = case_fails("port", ftype, bad)
        good_ids = case_fails("port", ftype, good)
        assert bad_ids == case_fails("jax", ftype, bad), cid
        assert good_ids == case_fails("jax", ftype, good), cid
        assert cid in bad_ids and cid not in good_ids, cid


# --------------------------------------------------------- scan_config


def files_of(root: str, pred) -> dict:
    out = {}
    for d, _dirs, names in os.walk(root):
        for n in sorted(names):
            p = os.path.join(d, n)
            rel = os.path.relpath(p, root)
            if pred(rel):
                with open(p, "rb") as f:
                    out[rel] = f.read()
    return dict(sorted(out.items()))


KINDS = {
    "dockerfile": lambda p: p.endswith("Dockerfile"),
    "terraformplan": lambda p: p.endswith(".tfplan.json"),
    "cloudformation-yaml": lambda p: p.startswith("infra/cloudformation/")
    and p.endswith(".yaml"),
    "cloudformation-json": lambda p: p.startswith("infra/cloudformation/")
    and p.endswith(".json"),
    "azure-arm": lambda p: p.startswith("infra/arm/"),
    "kubernetes": lambda p: p.endswith("k8s/pod.yaml"),
}


@pytest.mark.parametrize("kind", [*KINDS, "terraform", "helm"])
def test_scan_config_equals_the_reference(corpus, kind):
    """The port's successes and failures, with their causes, lines and
    code, equal the reference's: `scan_config` detecting each file's
    type itself, the Terraform module scan over the tree's stacks and
    modules, and the config analyzer's chart rendering with overrides."""
    if kind == "terraform":
        files = files_of(corpus["small"], lambda p: p.endswith(".tf"))
        got = port_misconf.scan_terraform_modules(files)
        want = jax_misconf.scan_terraform_modules(files)
        assert {m.file_path for m in got} >= {
            p for p in files if "/live/" in p and "/dev/" not in p}
    elif kind == "helm":
        from trivy_tpu.fanal.analyzers.config_analyzer import (
            ConfigAnalyzer as JaxConfig,
        )
        from trivy_tpu_torch.fanal.analyzers.config_analyzer import (
            ConfigAnalyzer as PortConfig,
        )

        files = files_of(corpus["small"], lambda p: "/deploy/" in p)
        overrides = {"securityContext": {"privileged": True},
                     "hostNetwork": True}
        runs = []
        for pkg, cls in (("trivy_tpu", JaxConfig),
                         ("trivy_tpu_torch", PortConfig)):
            inp = sys.modules[f"{pkg}.fanal.analyzer"].AnalysisInput
            a = cls()
            a.helm_overrides = overrides
            res = a.post_analyze({p: inp(p, c) for p, c in files.items()})
            runs.append(res.misconfigurations)
        want, got = runs
        assert {m.file_type for m in got} == {"helm"}
        assert any(":templates/" in m.file_path for m in got)  # the .tgz
    else:
        files = files_of(corpus["small"], KINDS[kind])
        got = [port_misconf.scan_config(p, c) for p, c in files.items()]
        want = [jax_misconf.scan_config(p, c) for p, c in files.items()]
        assert all(m is not None for m in got)
    assert got and as_data(got) == as_data(want)
    assert any(m.failures for m in got) and any(m.successes for m in got)


@pytest.mark.parametrize("name,source,suppressed", IGNORE_CASES,
                         ids=[c[0] for c in IGNORE_CASES])
def test_ignores_on_cloud_resources(name, source, suppressed):
    """Inline, above-block and parameterized `#trivy:ignore` comments on
    a Terraform resource, through the module scan and `scan_config`,
    as in the reference."""
    files = {"main.tf": source.encode()}
    got = port_misconf.scan_terraform_modules(files)
    assert as_data(got) == as_data(
        jax_misconf.scan_terraform_modules(files))
    single = port_misconf.scan_config("main.tf", source.encode())
    assert as_data([single]) == as_data(
        [jax_misconf.scan_config("main.tf", source.encode())])
    failed = {f.id for m in got for f in m.failures}
    assert ("AVD-AWS-0092" not in failed) is suppressed


# ------------------------------------------------------------------ CLI


def target_argv(corpus, cmd: str) -> list[str]:
    if cmd == "image":
        return ["image", "--input", corpus["tar"]]
    if cmd == "vm":
        if corpus["disk"] is None:
            pytest.skip("mkfs.ext4 unavailable")
        return ["vm", corpus["disk"]]
    return [cmd, corpus["small"]]


FORMATS = [["--format", "json"], ["--format", "table"],
           ["--format", "sarif"],
           ["--format", "template", "--template",
            "@contrib/gitlab-codequality.tpl"]]


@pytest.mark.parametrize("scanners", ["misconfig", "vuln,secret,misconfig"])
@pytest.mark.parametrize("cmd", ["fs", "rootfs", "repo", "image", "vm",
                                 "config"])
def test_port_cli_equals_jax_cli(corpus, tmp_path, capsys, cmd, scanners):
    """Each scan command in json, table, sarif and a template, with
    `--device cpu` and `--no-tpu`: the report bytes of the reference's
    CLI."""
    base = [*target_argv(corpus, cmd), "--db-path", corpus["db"],
            "--quiet", "--scanners", scanners]
    for fmt in FORMATS:
        for device in (["--device", "cpu"], ["--no-tpu"]):
            want, got = both(base + fmt, tmp_path, capsys,
                             port_extra=device,
                             jax_extra=device[:1] if device == ["--no-tpu"]
                             else ())
            assert got == want, (fmt, device)
            assert want[0] == 0 and want[1]
            if fmt[1] == "json":
                doc = json.loads(got[1])
                assert any(r["Class"] == "config"
                           for r in doc.get("Results") or [])
                secrets = any(r.get("Secrets") for r in doc["Results"])
                assert secrets is ("secret" in scanners
                                   and cmd != "config")


@pytest.mark.parametrize("flags", [
    ["--helm-set", HELM_SET],
    ["--helm-values", "VALUES"],
    ["--helm-set", "image.tag=2.0,replicas=1", "--helm-set",
     "securityContext.privileged=true", "--helm-values", "VALUES"],
    ["--file-patterns", r"dockerfile:\.env$"],
    ["--file-patterns", r"cloudformation:\.tfplan\.json$"],
], ids=["helm-set", "helm-values", "helm-both", "patterns-dockerfile",
        "patterns-cloudformation"])
@pytest.mark.parametrize("cmd", ["fs", "config"])
def test_helm_and_file_patterns_equal_the_reference(corpus, tmp_path,
                                                    capsys, cmd, flags):
    flags = [corpus["values"] if f == "VALUES" else f for f in flags]
    argv = [cmd, corpus["small"], "--format", "json", "--db-path",
            corpus["db"], "--quiet", "--scanners", "misconfig", *flags]
    want, got = both(argv, tmp_path, capsys)
    assert got == want and want[0] == 0
    plain = scan(main, argv[:9] + ["--device", "cpu", "--cache-dir",
                                   str(tmp_path / "plain")], capsys,
                 port_uuid)
    assert got[1] != plain[1]  # the flag changed the report


def test_helm_set_errors_are_one_line(corpus, tmp_path, capsys):
    for flags, message in ((["--helm-set", "novalue"], "key=value"),
                           (["--helm-values", str(tmp_path / "none")],
                            "--helm-values")):
        assert main(["fs", corpus["small"], "--scanners", "misconfig",
                     "--device", "cpu", "--cache-dir", str(tmp_path),
                     *flags]) == 1
        captured = capsys.readouterr()
        errors = [ln for ln in captured.err.splitlines() if "ERROR" in ln]
        assert captured.out == "" and len(errors) == 1
        assert message in errors[0]


@pytest.mark.parametrize("scanners", ["misconfig", "vuln,misconfig"])
def test_image_blob_keys_equal_the_reference(corpus, tmp_path, capsys,
                                             scanners):
    """With misconfig on, an image's blob and artifact keys are the
    reference's, so a cache written by one package serves the other: the
    port's scan over the reference's cache reports what its own does."""
    from trivy_tpu.artifact.image import ImageArtifact as JaxImage
    from trivy_tpu.cache.cache import MemoryCache as JaxCache
    from trivy_tpu_torch.artifact.image import ImageArtifact
    from trivy_tpu_torch.cache.cache import MemoryCache

    disabled = {"secret", "license-file"}
    refs = [cls(corpus["tar"], cache(), from_tar=True,
                disabled_analyzers=disabled).inspect()
            for cls, cache in ((JaxImage, JaxCache),
                               (ImageArtifact, MemoryCache))]
    assert refs[0].id == refs[1].id
    assert refs[0].blob_ids == refs[1].blob_ids
    argv = ["image", "--input", corpus["tar"], "--format", "json",
            "--db-path", corpus["db"], "--quiet", "--scanners", scanners]
    shared = str(tmp_path / "shared")
    assert scan(jax_main.main, argv + ["--cache-dir", shared], capsys,
                jax_uuid)[0] == 0
    over_ref = scan(main, argv + ["--device", "cpu", "--cache-dir",
                                  shared], capsys, port_uuid)
    own = scan(main, argv + ["--device", "cpu", "--cache-dir",
                             str(tmp_path / "own")], capsys, port_uuid)
    assert over_ref == own and own[0] == 0
    assert failed_ids(json.loads(own[1]))


def test_report_is_the_same_under_two_hash_seeds(corpus, tmp_path):
    """String hashes (an `Expr`'s among them) change with the process's
    hash seed; no ordering that reaches the report may."""
    outs = []
    for seed in ("1", "2"):
        env = {**os.environ, "PYTHONHASHSEED": seed,
               "TRIVY_TPU_FAKE_TIME": FAKE_TIME,
               "TRIVY_TPU_DETERMINISTIC_UUID": "1"}
        proc = subprocess.run(
            [sys.executable, "-m", "trivy_tpu_torch", "fs",
             corpus["full"], "--scanners", "misconfig", "--format", "json",
             "--quiet", "--device", "cpu", "--db-path", corpus["db"],
             "--cache-dir", str(tmp_path / seed)],
            cwd=REPO, env=env, capture_output=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs.append(proc.stdout)
    assert outs[0] == outs[1] and failed_ids(json.loads(outs[0]))


# ------------------------------------------------------------- refusals


def test_unported_list_of_config_is_reference_dests_minus_ports():
    import argparse

    def dests(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {a.dest: a.default for a in sub.choices["config"]._actions
                if a.dest and a.dest != "help"}

    ref, port = dests(jax_main.build_parser()), dests(build_parser())
    assert sorted(config.UNPORTED) == sorted(set(ref) - set(port))
    ported = {*CUSTOM_CHECK_OPTIONS, "helm_set", "helm_values"}
    assert not ported & set(config.UNPORTED)
    assert {d: ref[d] for d in ported} == {d: port[d] for d in ported}


@pytest.mark.parametrize("cmd", ["fs", "config"])
@pytest.mark.parametrize("dest", sorted(CUSTOM_CHECK_OPTIONS))
def test_custom_check_options_are_refused(corpus, tmp_path, capsys,
                                          monkeypatch, cmd, dest):
    """Each check-engine option, taken from the environment, is no
    longer refused: the scan writes the reference's report."""
    paths = chip_smoke.write_custom_checks(str(tmp_path / "custom"))
    monkeypatch.setenv("TRIVY_TPU_" + dest.upper(),
                       CUSTOM_CHECK_OPTIONS[dest].format(**paths))
    argv = [cmd, corpus["small"], "--scanners", "misconfig", "--format",
            "json", "--quiet", "--db-path", corpus["db"]]
    want, got = both(argv, tmp_path, capsys)
    assert got == want and want[0] == 0
    assert chip_smoke.config_results(json.loads(got[1]))


@pytest.mark.parametrize("cmd,scanners", [("fs", "misconfig"),
                                          ("config", "vuln,secret"),
                                          ("image", "vuln,misconfig")])
def test_a_cached_check_bundle_is_refused(corpus, tmp_path, capsys, cmd,
                                          scanners):
    """A bundle cached under <cache>/policy/content is loaded as the
    reference loads it, with no option set but the namespace that
    enables its checks: the reference's report, the bundle's Rego and
    YAML checks in it, its Python check refused. Without misconfig the
    bundle is not read, and the scan runs."""
    argv = [*target_argv(corpus, cmd), "--scanners", scanners, "--db-path",
            corpus["db"], "--format", "json", "--quiet",
            "--check-namespaces", "user"]
    for pkg in ("jcache", "pcache"):
        chip_smoke.place_bundle(str(tmp_path / pkg))
    want, got = both(argv, tmp_path, capsys)
    assert got == want and want[0] == 0
    ids = failed_ids(json.loads(got[1]))
    assert "USR-BUNDLE-001" in ids
    assert chip_smoke.IAC_BUNDLE_REFUSED not in ids
    if cmd != "config":
        argv[argv.index(scanners)] = "vuln"
        want, got = both(argv, tmp_path, capsys)
        assert got == want and json.loads(got[1])["Results"]
        assert not failed_ids(json.loads(got[1]))


def test_device_error_in_the_screen_ends_the_run(corpus, tmp_path, capsys,
                                                 monkeypatch):
    """A DeviceError in the anchor screen, during a scan that also runs
    the config analyzer, gives rc 1, one error line and no report."""
    from trivy_tpu_torch.ops import secret_nfa

    orig = secret_analyzer.SecretAnalyzer.post_analyze

    def forced(self, files):
        secret_analyzer.USE_DEVICE = True
        return orig(self, files)

    def fail(self, *a, **kw):
        raise DeviceError("anchor kernel launch failed: CUDA error 700")

    monkeypatch.setattr(secret_analyzer.SecretAnalyzer, "post_analyze",
                        forced)
    monkeypatch.setattr(secret_nfa.AnchorMatcher, "dispatch_chunks", fail)
    argv = ["fs", corpus["small"], "--scanners", "secret,misconfig",
            "--device", "cpu", "--cache-dir", str(tmp_path),
            "--format", "json", "--output", str(tmp_path / "out.json")]
    assert main(argv) == 1
    out, err = capsys.readouterr()
    assert out == "" and not os.path.exists(tmp_path / "out.json")
    assert len([ln for ln in err.splitlines()
                if "CUDA error 700" in ln and "\tWARNING\t" not in ln]) == 1


# -------------------------------------------------------------- on a card


@pytest.mark.cuda
def test_cuda_fs_with_misconfig_equals_device_cpu(corpus, tmp_path,
                                                  capsys):
    """On a card: `fs --scanners vuln,secret,misconfig` with the match
    kernel and the secret screen on cuda:0 writes the report of
    `--device cpu`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    from trivy_tpu_torch.ops import match

    argv = ["fs", corpus["small"], "--scanners", "vuln,secret,misconfig",
            "--format", "json", "--db-path", corpus["db"], "--quiet",
            "--helm-set", HELM_SET]
    want = scan(main, argv + ["--device", "cpu", "--cache-dir",
                              str(tmp_path / "cpu")], capsys, port_uuid)
    match.match_words.launches = 0
    got = scan(main, argv + ["--cache-dir", str(tmp_path / "cuda")],
               capsys, port_uuid)
    assert got == want and want[0] == 0
    assert match.match_words.launches > 0
    assert failed_ids(json.loads(got[1]))
