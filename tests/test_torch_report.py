"""Port parity, the report side: every writer of trivy_tpu_torch/report
(sarif, cyclonedx, spdx-json, github, cosign-vuln, the template engine
and its builtins, the table's dependency tree and suppressed section)
against the JAX package's on the same report built in each package's
types; the port's CLI against `trivy_tpu.cli.main` in every format, for
`sbom`, `fs`, `convert` and attestation-wrapped SBOMs; the attestation
and rekor modules and `--sbom-sources rekor` against an in-process fake
rekor.

Reports embed the clock, uuids and `GITHUB_*` variables: both packages
run under TRIVY_TPU_FAKE_TIME and TRIVY_TPU_DETERMINISTIC_UUID=1 with
their uuid counters reset before each render, and the GitHub variables
pinned. Reports are compared as bytes: the tolerance is exact equality.
"""

import base64
import hashlib
import importlib
import json
import os
import random
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest
import torch
from test_torch_cli import fixture_db
from test_torch_fanal import seeded_db, seeded_tree

from trivy_tpu.cli import main as jax_main
from trivy_tpu.cli import run as jax_run
from trivy_tpu.utils import uuid as jax_uuid
from trivy_tpu_torch.cli import run
from trivy_tpu_torch.cli.main import main
from trivy_tpu_torch.db import VulnerabilityMeta
from trivy_tpu_torch.fanal.analyzers import secret_analyzer
from trivy_tpu_torch.secret import scanner as sc
from trivy_tpu_torch.tensorize.synth import synth_sbom, synth_trivy_db
from trivy_tpu_torch.utils import uuid as port_uuid

FAKE_TIME = "2024-01-01T00:00:00+00:00"
SEED = 20261018
PACKAGES = ("trivy_tpu", "trivy_tpu_torch")
UUIDS = {"trivy_tpu": jax_uuid, "trivy_tpu_torch": port_uuid}
GITHUB_ENV = {"GITHUB_REF": "refs/heads/main", "GITHUB_SHA": "0" * 40,
              "GITHUB_WORKFLOW": "scan", "GITHUB_JOB": "trivy",
              "GITHUB_RUN_ID": "42"}
# every format of the writer dispatch, the template through each builtin
FORMATS = [("sarif", None), ("cyclonedx", None), ("spdx-json", None),
           ("github", None), ("cosign-vuln", None), ("json", None),
           ("table", None), ("template", "@contrib/junit.tpl"),
           ("template", "@contrib/gitlab-codequality.tpl"),
           ("template", "@contrib/html.tpl")]
FORMAT_IDS = [f if t is None else t.split("/")[-1] for f, t in FORMATS]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and idle OpenMP workers spin on cores their neighbours' timing
    tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()
    yield
    torch.set_num_threads(n)
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", FAKE_TIME)
    monkeypatch.setenv("TRIVY_TPU_DETERMINISTIC_UUID", "1")
    for k, v in GITHUB_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(secret_analyzer, "USE_DEVICE", "hybrid")
    monkeypatch.setattr(secret_analyzer, "DEVICE", None)
    monkeypatch.setattr(sc, "_CACHE_DIR_OVERRIDE", None)


def _types(pkg: str):
    return (importlib.import_module(f"{pkg}.types.artifact"),
            importlib.import_module(f"{pkg}.types.enums"),
            importlib.import_module(f"{pkg}.types.report"))


def fixture_report(pkg: str, variant: str = "fixture"):
    """tests/test_report_formats.py's report fixture, built in `pkg`'s
    types. The "graph" variant adds a lockfile dependency graph under a
    vulnerable npm package and a VEX-suppressed finding, so the table's
    dependency tree and suppressed section render."""
    A, E, R = _types(pkg)
    os_pkg = A.Package(
        name="musl", version="1.1.22", release="r3", id="musl@1.1.22-r3",
        identifier=A.PkgIdentifier(purl="pkg:apk/alpine/musl@1.1.22-r3"),
        src_name="musl", src_version="1.1.22", src_release="r3",
        licenses=["MIT"],
    )
    app_pkg = A.Package(
        name="lodash", version="4.17.4", id="lodash@4.17.4",
        identifier=A.PkgIdentifier(purl="pkg:npm/lodash@4.17.4"),
        depends_on=[],
    )
    vuln = R.DetectedVulnerability(
        vulnerability_id="CVE-2019-14697",
        pkg_id="musl@1.1.22-r3",
        pkg_name="musl",
        installed_version="1.1.22-r3",
        fixed_version="1.1.22-r4",
        primary_url="https://avd.aquasec.com/nvd/cve-2019-14697",
        layer=A.Layer(diff_id="sha256:beee"),
        info=R.VulnerabilityInfo(
            title="musl x87 overflow",
            description="stack underflow in math code",
            severity="CRITICAL",
            references=["https://nvd.example/CVE-2019-14697"],
            cwe_ids=["CWE-787"],
        ),
    )
    misconf = R.DetectedMisconfiguration(
        type="dockerfile", id="DS002", avd_id="AVD-DS-0002",
        title="root user", description="runs as root",
        message="Specify USER", severity="HIGH", status="FAIL",
    )
    secret = R.DetectedSecret(
        rule_id="aws-access-key-id", category="AWS", severity="CRITICAL",
        title="AWS Access Key ID", start_line=3, end_line=3,
        match="AKIA****************",
    )
    lang = R.Result(target="package-lock.json",
                    result_class=E.ResultClass.LANG_PKGS, type="npm",
                    packages=[app_pkg])
    if variant == "graph":
        lang.packages = [
            A.Package(id="demo@1.0.0", name="demo", version="1.0.0",
                      depends_on=["express@4.0.0"]),
            A.Package(id="express@4.0.0", name="express", version="4.0.0",
                      depends_on=["lodash@4.17.4"]),
            app_pkg,
        ]
        lang.vulnerabilities = [R.DetectedVulnerability(
            vulnerability_id="CVE-2019-10744", pkg_id="lodash@4.17.4",
            pkg_name="lodash", installed_version="4.17.4",
            fixed_version="4.17.12",
            pkg_identifier=A.PkgIdentifier(purl="pkg:npm/lodash@4.17.4"),
            info=R.VulnerabilityInfo(severity="CRITICAL", title="pp"))]
        lang.modified_findings = [{
            "Type": "vulnerability", "Status": "not_affected",
            "Statement": "vulnerable_code_not_in_execute_path",
            "Source": "OpenVEX (vex.json)",
            "Finding": {"VulnerabilityID": "CVE-2019-1010266",
                        "PkgName": "lodash", "Severity": "MEDIUM"}}]
    return R.Report(
        artifact_name="alpine:3.10",
        artifact_type="container_image",
        metadata=R.Metadata(
            os=A.OS(family="alpine", name="3.10.2"),
            image_id="sha256:abcd",
            repo_tags=["alpine:3.10"],
            repo_digests=["alpine@sha256:feed"],
            diff_ids=["sha256:beee"],
        ),
        results=[
            R.Result(target="alpine:3.10 (alpine 3.10.2)",
                     result_class=E.ResultClass.OS_PKGS, type="alpine",
                     packages=[os_pkg], vulnerabilities=[vuln]),
            lang,
            R.Result(target="Dockerfile", result_class=E.ResultClass.CONFIG,
                     type="dockerfile", misconfigurations=[misconf]),
            R.Result(target="config.py", result_class=E.ResultClass.SECRET,
                     secrets=[secret]),
        ],
    )


def render(pkg: str, report, tmp_path, fmt: str, template=None,
           dependency_tree=False) -> str:
    writer = importlib.import_module(f"{pkg}.report.writer")
    out = tmp_path / f"{pkg}.out"
    UUIDS[pkg].reset()
    writer.write_report(report, fmt=fmt, output=str(out), template=template,
                        dependency_tree=dependency_tree)
    return out.read_text()


# ----------------------------------------------------------------- writers


@pytest.mark.parametrize("variant", ["fixture", "graph"])
@pytest.mark.parametrize("fmt,template", FORMATS, ids=FORMAT_IDS)
def test_writer_equals_reference(tmp_path, fmt, template, variant):
    want, got = (render(pkg, fixture_report(pkg, variant), tmp_path, fmt,
                        template) for pkg in PACKAGES)
    assert got == want and got
    if fmt not in ("table", "template"):
        json.loads(got)


@pytest.mark.parametrize("variant", ["fixture", "graph"])
def test_table_dependency_tree_and_suppressed(tmp_path, variant):
    want, got = (render(pkg, fixture_report(pkg, variant), tmp_path,
                        "table", dependency_tree=True) for pkg in PACKAGES)
    assert got == want
    graph = variant == "graph"
    assert ("Dependency Origin Tree" in got) is graph
    assert ("└── express@4.0.0" in got) is graph
    assert ("Suppressed Vulnerabilities (Total: 1)" in got) is graph


def test_writer_formats_and_errors_equal_reference(tmp_path):
    from trivy_tpu.report import writer as jax_writer
    from trivy_tpu_torch.report import writer

    assert writer.FORMATS == jax_writer.FORMATS
    for w, pkg in ((jax_writer, "trivy_tpu"), (writer, "trivy_tpu_torch")):
        report = fixture_report(pkg)
        with pytest.raises(ValueError, match="requires --template"):
            w.write_report(report, fmt="template", output=str(tmp_path / "x"))
        with pytest.raises(ValueError, match="unknown format"):
            w.write_report(report, fmt="xml", output=str(tmp_path / "x"))
    path = tmp_path / "r.json"
    path.write_text(json.dumps({"SchemaVersion": 2}))
    assert writer.read_report_json(str(path)) == \
        jax_writer.read_report_json(str(path))


# ---------------------------------------------------------------- template

TEMPLATE_CASES = [
    ("{{ range .Results }}{{ .Target }}:"
     "{{ range $i, $v := .Vulnerabilities }}"
     "{{ if gt $i 0 }},{{ end }}{{ $v.VulnerabilityID }}"
     "{{ if eq $v.Severity \"HIGH\" }}(!){{ end }}"
     "{{ end }}{{ end }}",
     {"Results": [{"Target": "a", "Vulnerabilities": [
         {"VulnerabilityID": "CVE-1", "Severity": "HIGH"},
         {"VulnerabilityID": "CVE-2", "Severity": "LOW"}]}]}),
    ('{{ "HeLLo" | toLower }}', {}),
    ('{{ printf "%s-%s" "a" "b" }}', {}),
    ('{{ "<x>" | escapeXML }}', {}),
    ("{{ len .Items }}", {"Items": [1, 2, 3]}),
    ("{{ if .Missing }}y{{ else }}n{{ end }}", {}),
    ('{{ $x := "v" }}{{ $x }}', {}),
    ('a {{- "b" -}} c', {}),
    ("{{ .Missing | len }}", {}),
    ('{{ substr 0 4 "abcdefg" }}', {}),
    ('{{ sha1sum "x" }}', {}),
    ("{{ range .Items }}{{ .N }}={{ $.Tag }};{{ end }}",
     {"Tag": "v1", "Items": [{"N": "a"}, {"N": "b"}]}),
    ("{{ $ }}", "root"),
    ("{{ $f := true }}{{ range . }}"
     "{{ if $f }}F{{ $f = false }}{{ else }},{{ end }}{{ . }}{{ end }}",
     [1, 2, 3]),
    ('{{ now | date "2006-01-02T15:04:05Z07:00" }} {{ appVersion }} '
     '{{ getEnv "GITHUB_SHA" }} {{ env "GITHUB_REF" }}', {}),
    ('{{ list 1 2 | toJson }} {{ "a,b" | splitList "," | join "+" }} '
     '{{ "x.tpl" | trimSuffix ".tpl" }} {{ "abc" | regexFind "b." }}', {}),
]


@pytest.mark.parametrize("tpl,data", TEMPLATE_CASES,
                         ids=[f"case{i}" for i in range(len(TEMPLATE_CASES))])
def test_template_engine_equals_reference(tpl, data):
    from trivy_tpu.report import template as jax_template
    from trivy_tpu_torch.report import template

    want = jax_template.render_template_str(tpl, data)
    assert template.render_template_str(tpl, data) == want


@pytest.mark.parametrize("tpl", ['{{ "x" | toLowr }}', '{{ lt "a" 1 }}'])
def test_template_errors_as_in_reference(tpl):
    from trivy_tpu.report import template as jax_template
    from trivy_tpu_torch.report import template

    with pytest.raises(ValueError) as want:
        jax_template.render_template_str(tpl, {})
    with pytest.raises(ValueError) as got:
        template.render_template_str(tpl, {})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["junit", "gitlab-codequality.tpl",
                                  "@builtin/html.tpl", "inline", "file"])
def test_template_addressing_equals_reference(tmp_path, name):
    """A builtin by bare name, `name.tpl` or `@builtin/...`, an inline
    template and `@/path` to a file (CRLF kept) render as in the
    reference."""
    from trivy_tpu.report import template as jax_template
    from trivy_tpu_torch.report import template

    spec = name
    if name == "inline":
        spec = "{{ range . }}{{ .Target }}\n{{ end }}"
    elif name == "file":
        path = tmp_path / "t.tpl"
        path.write_bytes(b"{{ range . }}{{ .Type }}\r\n{{ end }}")
        spec = f"@{path}"
    assert jax_template._BUILTIN == template._BUILTIN
    want = jax_template.render_template(fixture_report("trivy_tpu"), spec)
    got = template.render_template(fixture_report("trivy_tpu_torch"), spec)
    assert got == want and got


# --------------------------------------------- port CLI vs reference CLI


@pytest.fixture(scope="module")
def synth_env(tmp_path_factory):
    """test_torch_cli.py's seeded 20,000-advisory synthetic trivy-db with
    metadata for a share of its vulnerabilities, and a 300-component
    image SBOM, saved once; the SBOM also wrapped in a cosign DSSE
    envelope (an in-toto statement whose predicate Data is the SBOM)."""
    tmp = tmp_path_factory.mktemp("synth")
    db = synth_trivy_db(n_advisories=20_000, seed=SEED)
    rng = random.Random(SEED)
    sevs = ["LOW", "MEDIUM", "HIGH", "CRITICAL", "UNKNOWN"]
    ids = sorted({a.vulnerability_id for pkgs in db.buckets.values()
                  for advs in pkgs.values() for a in advs})
    for vid in ids[::3]:
        db.put_meta(VulnerabilityMeta(
            id=vid, title=f"title of {vid}", description=f"about {vid}",
            severity=sevs[rng.randrange(5)],
            vendor_severity={"nvd": rng.randint(0, 4)}
            if rng.random() < 0.5 else {}))
    db.save(str(tmp / "db"))
    bom = synth_sbom(db, 100, 150, 50, seed=SEED, fmt="cyclonedx")
    (tmp / "bom.json").write_text(json.dumps(bom))
    (tmp / "bom.att.json").write_text(json.dumps(envelope(bom)))
    return {"db": str(tmp / "db"), "sbom": str(tmp / "bom.json"),
            "att": str(tmp / "bom.att.json"), "tmp": tmp}


def envelope(sbom: dict, predicate_type="https://cyclonedx.org/bom") -> dict:
    """A cosign SBOM attestation: DSSE envelope -> in-toto statement ->
    predicate.Data (tests/test_attestation.py's shape)."""
    statement = {
        "_type": "https://in-toto.io/Statement/v0.1",
        "predicateType": predicate_type,
        "subject": [{"name": "img", "digest": {"sha256": "ab" * 32}}],
        "predicate": {"Data": sbom},
    }
    return {"payloadType": "application/vnd.in-toto+json",
            "payload": base64.b64encode(
                json.dumps(statement).encode()).decode(),
            "signatures": [{"keyid": "", "sig": "x"}]}


def both(argv, cache_root, capsys, port_extra=("--device", "cpu")):
    """(rc, stdout) of the reference's CLI and of the port's, each on a
    cache directory of its own, uuid counters reset."""
    jax_uuid.reset()
    want = (jax_main.main(argv + ["--cache-dir", str(cache_root / "j")]),
            capsys.readouterr().out)
    port_uuid.reset()
    got = (main(argv + list(port_extra)
                + ["--cache-dir", str(cache_root / "p")]),
           capsys.readouterr().out)
    return want, got


def fmt_argv(fmt, template) -> list[str]:
    return ["--format", fmt] + (["--template", template] if template else [])


@pytest.mark.parametrize("fmt,template", FORMATS, ids=FORMAT_IDS)
def test_sbom_cli_every_format_equals_reference(synth_env, capsys, fmt,
                                                template):
    argv = ["sbom", synth_env["sbom"], *fmt_argv(fmt, template),
            "--db-path", synth_env["db"], "--quiet"]
    want, got = both(argv, synth_env["tmp"], capsys)
    assert got == want and want[0] == 0 and want[1]
    if fmt in ("cyclonedx", "spdx-json", "github"):
        # normalize_args: SBOM-shaped formats list every package
        assert run.STATS["render_s"] > 0
        doc = json.loads(got[1])
        n = len(doc.get("components") or doc.get("packages")
                or doc.get("manifests"))
        assert n > 1
    if fmt == "sarif":
        assert json.loads(got[1])["runs"][0]["results"]


@pytest.mark.parametrize("no_tpu", [False, True], ids=["device", "no-tpu"])
def test_sbom_cli_dependency_tree_equals_reference(synth_env, capsys,
                                                   no_tpu):
    argv = ["sbom", synth_env["sbom"], "--format", "table",
            "--dependency-tree", "--db-path", synth_env["db"], "--quiet"]
    if no_tpu:
        argv.append("--no-tpu")
    want, got = both(argv, synth_env["tmp"], capsys)
    assert got == want and want[0] == 0


@pytest.fixture(scope="module")
def saved_report(synth_env):
    """The port's json report of the synthetic SBOM, packages included,
    saved for `convert`."""
    out = synth_env["tmp"] / "report.json"
    assert main(["sbom", synth_env["sbom"], "--format", "json",
                 "--list-all-pkgs", "--db-path", synth_env["db"], "--quiet",
                 "--device", "cpu", "--output", str(out), "--cache-dir",
                 str(synth_env["tmp"] / "p")]) == 0
    return str(out)


@pytest.mark.parametrize("fmt,template", FORMATS, ids=FORMAT_IDS)
def test_convert_every_format_equals_reference(saved_report, tmp_path,
                                               capsys, fmt, template):
    argv = ["convert", saved_report, *fmt_argv(fmt, template), "--quiet"]
    want, got = both(argv, tmp_path, capsys, port_extra=())
    assert got == want and want[0] == 0 and want[1]


def test_convert_severity_and_output_file(saved_report, tmp_path, capsys):
    outs = []
    for entry, uuid_mod, name in ((jax_main.main, jax_uuid, "j"),
                                  (main, port_uuid, "p")):
        out = tmp_path / f"{name}.sarif"
        uuid_mod.reset()
        assert entry(["convert", saved_report, "--format", "sarif",
                      "--severity", "HIGH,CRITICAL", "--output", str(out),
                      "--quiet"]) == 0
        assert capsys.readouterr().out == ""
        outs.append(out.read_text())
    assert outs[0] == outs[1]
    levels = {r["level"] for r in json.loads(outs[1])["runs"][0]["results"]}
    assert levels <= {"error"}


@pytest.mark.parametrize("env", [{"TRIVY_TPU_COMPLIANCE": "k8s-cis"},
                                 {"TRIVY_TPU_SERVER": "http://h:1",
                                  "TRIVY_TPU_FORMAT": "github"}],
                         ids=["compliance", "server"])
def test_convert_ignores_scan_options_as_in_reference(saved_report,
                                                      tmp_path, capsys,
                                                      monkeypatch, env):
    """`convert` has none of the scan options: one given from the
    environment is ignored there, as in the reference."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want, got = both(["convert", saved_report, "--quiet"], tmp_path, capsys,
                     port_extra=())
    assert got == want and want[0] == 0 and want[1]


@pytest.mark.parametrize("env,doc", [
    ({"TRIVY_TPU_FORMAT": "template",
      "TRIVY_TPU_TEMPLATE": "@contrib/junit.tpl"}, ""),
    ({}, "format: table\nscan:\n  dependency-tree: true\n"),
    ({"TRIVY_TPU_FORMAT": "cyclonedx"}, "template: '{{ . }}'\n"),
], ids=["template-env", "dependency-tree-config", "template-unused"])
def test_report_options_from_env_and_config_act_as_in_reference(
        synth_env, tmp_path, capsys, monkeypatch, env, doc):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = tmp_path / "trivy-tpu.yaml"
    cfg.write_text(doc)
    argv = ["sbom", synth_env["sbom"], "--db-path", synth_env["db"],
            "--quiet", "--config", str(cfg)]
    want, got = both(argv, synth_env["tmp"], capsys)
    assert got == want and want[0] == 0 and want[1]


@pytest.fixture(scope="module")
def fs_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fs")
    seeded_tree(tmp / "tree")
    seeded_db().save(str(tmp / "db"))
    # a lockfile whose dependency graph leads to a vulnerable package
    dep = tmp / "deptree"
    (dep / "app").mkdir(parents=True)
    (dep / "app" / "package-lock.json").write_text(json.dumps({
        "name": "demo", "lockfileVersion": 3, "packages": {
            "": {"name": "demo", "version": "1.0.0",
                 "dependencies": {"express": "^4.0.0"}},
            "node_modules/express": {"version": "4.0.0",
                                     "dependencies": {"lodash": "^4.17.0"}},
            "node_modules/lodash": {"version": "4.17.4"}}}))
    fixture_db().save(str(tmp / "fixture_db"))
    return {"tree": str(tmp / "tree"), "db": str(tmp / "db"),
            "deptree": str(dep), "fixture_db": str(tmp / "fixture_db")}


@pytest.mark.parametrize("no_tpu", [False, True], ids=["device", "no-tpu"])
@pytest.mark.parametrize("fmt", ["sarif", "cyclonedx"])
def test_fs_cli_equals_reference(fs_env, tmp_path, capsys, fmt, no_tpu):
    argv = ["fs", fs_env["tree"], "--format", fmt, "--db-path",
            fs_env["db"], "--quiet"]
    if no_tpu:
        argv.append("--no-tpu")
    want, got = both(argv, tmp_path, capsys)
    assert got == want and want[0] == 0
    doc = json.loads(got[1])
    if fmt == "sarif":
        rules = {r["id"] for r in doc["runs"][0]["tool"]["driver"]["rules"]}
        assert any(r.startswith("CVE-") for r in rules)
        assert "aws-access-key-id" in rules  # the planted secrets
    else:
        assert doc["vulnerabilities"] and len(doc["components"]) > 20


def test_fs_dependency_tree_equals_reference(fs_env, tmp_path, capsys):
    argv = ["fs", fs_env["deptree"], "--format", "table",
            "--dependency-tree", "--db-path", fs_env["fixture_db"],
            "--quiet", "--scanners", "vuln"]
    want, got = both(argv, tmp_path, capsys)
    assert got == want and want[0] == 0
    assert "lodash@4.17.4 (vulnerable)" in got[1]
    assert "└── express@4.0.0" in got[1]


# ------------------------------------------------------------ attestation


STATEMENT = {
    "_type": "https://in-toto.io/Statement/v0.1",
    "predicateType": "https://cyclonedx.org/bom",
    "subject": [{"name": "alpine:3.10", "digest": {"sha256": "ab" * 32}}],
    "predicate": {"Data": {"bomFormat": "CycloneDX", "specVersion": "1.5",
                           "components": []}},
}


def _dsse(statement, payload_type="application/vnd.in-toto+json"):
    return {"payloadType": payload_type,
            "payload": base64.b64encode(
                json.dumps(statement).encode()).decode(),
            "signatures": [{"keyid": "", "sig": "x"}]}


@pytest.mark.parametrize("case", ["cosign", "plain", "bad-type",
                                  "bad-payload", "not-object", "not-json"])
def test_statement_equals_reference(case):
    """tests/test_attestation.py's statement shapes through both
    packages: the same statement, predicate, or error message."""
    import trivy_tpu.attestation as jax_att
    import trivy_tpu_torch.attestation as att

    if case == "cosign":
        data = json.dumps(_dsse(STATEMENT))
    elif case == "plain":
        data = json.dumps(_dsse(dict(STATEMENT, predicate={"plain": 1})))
    elif case == "bad-type":
        data = json.dumps(_dsse(STATEMENT, "application/json"))
    elif case == "bad-payload":
        data = json.dumps(dict(_dsse(STATEMENT),
                               payload="!!not-base64-json!!"))
    elif case == "not-object":
        data = "[1]"
    else:
        data = "{"
    results = []
    for mod in (jax_att, att):
        try:
            s = mod.parse_statement(data)
            results.append((s.type, s.predicate_type, s.subject,
                            mod.unwrap_cosign_predicate(s)))
        except mod.AttestationError as exc:
            results.append(("error", str(exc)))
    assert results[1] == results[0]
    assert (results[0][0] == "error") is (case not in ("cosign", "plain"))
    assert att.is_attestation(json.loads(json.dumps(_dsse(STATEMENT))))
    assert not att.is_attestation({"bomFormat": "CycloneDX"})


@pytest.mark.parametrize("data_as", ["object", "string"])
def test_attestation_sbom_decodes_as_reference(tmp_path, data_as):
    from trivy_tpu.sbom.decode import decode_sbom_file as jax_decode
    from trivy_tpu_torch.sbom.decode import decode_sbom_file

    cdx = {
        "bomFormat": "CycloneDX", "specVersion": "1.5",
        "metadata": {"component": {"name": "alpine:3.10"}},
        "components": [{"type": "library", "name": "musl",
                        "version": "1.1.22-r3",
                        "purl": "pkg:apk/alpine/musl@1.1.22-r3"}],
    }
    data = json.dumps(cdx) if data_as == "string" else cdx
    p = tmp_path / "sbom.att.json"
    p.write_text(json.dumps(_dsse(dict(STATEMENT, predicate={"Data": data}))))
    (jb, jm), (pb, pm) = jax_decode(str(p)), decode_sbom_file(str(p))
    assert pm.artifact_name == jm.artifact_name == "alpine:3.10"
    assert json.dumps(pb.to_dict()) == json.dumps(jb.to_dict())
    assert "musl" in {pkg.name for pi in pb.package_infos
                      for pkg in pi.packages}


@pytest.mark.parametrize("fmt", ["json", "table"])
def test_attestation_sbom_cli_equals_reference(synth_env, capsys, fmt):
    """`sbom` on the cosign-wrapped SBOM writes the reference's report,
    and its results are those of the bare SBOM."""
    base = ["--format", fmt, "--db-path", synth_env["db"], "--quiet"]
    want, got = both(["sbom", synth_env["att"], *base], synth_env["tmp"],
                     capsys)
    assert got == want and want[0] == 0
    if fmt == "json":
        port_uuid.reset()
        assert main(["sbom", synth_env["sbom"], *base, "--device", "cpu",
                     "--cache-dir", str(synth_env["tmp"] / "p")]) == 0
        bare = json.loads(capsys.readouterr().out)
        wrapped = json.loads(got[1])
        assert bare["Results"]
        assert without_blob_id(wrapped) == without_blob_id(bare)


def without_blob_id(doc: dict) -> list:
    """A report's Results with the SBOM's blob id taken out: an SBOM
    scan names each finding's layer by the blob id, a hash of the file's
    bytes (artifact/sbom.py, in both packages), so a wrapped SBOM's
    findings name another layer than the bare SBOM's."""
    ids = {v["Layer"]["DiffID"] for r in doc["Results"]
           for v in r.get("Vulnerabilities", [])}
    assert len(ids) == 1
    return json.loads(json.dumps(doc["Results"]).replace(ids.pop(), ""))


# ------------------------------------------------------------------ rekor

CDX_NPM = {"bomFormat": "CycloneDX", "specVersion": "1.5",
           "components": [{"type": "library", "name": "lodash",
                           "version": "4.17.4",
                           "purl": "pkg:npm/lodash@4.17.4"}]}


class _FakeRekor(BaseHTTPRequestHandler):
    """The rekor REST API of the reference's tests: one entry for
    `known_hash`, whose attestation wraps CDX_NPM."""

    known_hash = ""

    def log_message(self, *a):
        pass

    def do_POST(self):
        body = json.loads(self.rfile.read(
            int(self.headers.get("Content-Length", 0))))
        if self.path == "/api/v1/index/retrieve":
            found = body.get("hash") == f"sha256:{self.known_hash}"
            self._reply(["1" * 16 + "c" * 64] if found else [])
        elif self.path == "/api/v1/log/entries/retrieve":
            att = base64.b64encode(json.dumps(_dsse(dict(
                STATEMENT, predicate={"Data": CDX_NPM}))).encode()).decode()
            self._reply([{u: {"attestation": {"data": att}, "body": ""}}
                         for u in body.get("entryUUIDs", [])])
        else:
            self.send_response(404)
            self.end_headers()

    def _reply(self, doc):
        raw = json.dumps(doc).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)


ELF = b"\x7fELF" + bytes(range(256)) * 2


@pytest.fixture()
def rekor_url():
    _FakeRekor.known_hash = hashlib.sha256(ELF).hexdigest()
    srv = HTTPServer(("127.0.0.1", 0), _FakeRekor)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def test_rekor_client_equals_reference(rekor_url):
    from trivy_tpu.attestation import rekor as jax_rekor
    from trivy_tpu_torch.attestation import rekor

    for entry in ("1" * 16 + "a" * 64, "b" * 64):
        assert str(rekor.EntryID.parse(entry)) == \
            str(jax_rekor.EntryID.parse(entry)) == entry
    with pytest.raises(rekor.RekorError, match="invalid Entry ID length"):
        rekor.EntryID.parse("short")
    got, want = (mod.Client(rekor_url) for mod in (rekor, jax_rekor))
    h = f"sha256:{_FakeRekor.known_hash}"
    ids = got.search(h)
    assert [str(e) for e in ids] == [str(e) for e in want.search(h)]
    assert [e.statement for e in got.get_entries(ids)] == \
        [e.statement for e in want.get_entries(want.search(h))]
    assert got.search("sha256:nope") == []
    with pytest.raises(rekor.OverGetEntriesLimit):
        got.get_entries([rekor.EntryID.parse("d" * 64)] * 11)


def test_discover_sboms_equals_reference(rekor_url):
    from trivy_tpu.fanal.unpackaged import discover_sboms as jax_discover
    from trivy_tpu.types.artifact import ArtifactDetail as JaxDetail
    from trivy_tpu_torch.fanal.unpackaged import discover_sboms
    from trivy_tpu_torch.types.artifact import ArtifactDetail

    digests = {"usr/bin/tool": f"sha256:{_FakeRekor.known_hash}",
               "usr/bin/unknown": "sha256:" + "0" * 64}
    details = []
    for discover, cls in ((jax_discover, JaxDetail),
                          (discover_sboms, ArtifactDetail)):
        d = cls()
        d.digests = dict(digests)
        assert discover(d, rekor_url) == 1
        details.append(json.dumps(d.to_dict()))
    assert details[1] == details[0]
    assert "usr/bin/tool" in details[1] and "lodash" in details[1]


@pytest.mark.parametrize("how", ["flags", "env"])
def test_fs_sbom_sources_rekor_equals_reference(fs_env, tmp_path, capsys,
                                                monkeypatch, rekor_url,
                                                how):
    """`fs --sbom-sources rekor` on a tree with an unpackaged ELF
    executable: both CLIs look its digest up in the fake rekor, attach
    the attested npm package at the binary's path and report its
    vulnerability."""
    root = tmp_path / "tree"
    (root / "usr" / "bin").mkdir(parents=True)
    tool = root / "usr" / "bin" / "tool"
    tool.write_bytes(ELF)
    tool.chmod(0o755)
    argv = ["fs", str(root), "--format", "json", "--db-path",
            fs_env["fixture_db"], "--quiet", "--scanners", "vuln"]
    if how == "flags":
        argv += ["--sbom-sources", "rekor", "--rekor-url", rekor_url]
    else:
        monkeypatch.setenv("TRIVY_TPU_SBOM_SOURCES", "rekor")
        monkeypatch.setenv("TRIVY_TPU_REKOR_URL", rekor_url)
    want, got = both(argv, tmp_path, capsys)
    assert got == want and want[0] == 0
    doc = json.loads(got[1])
    vulns = [(r["Target"], v["VulnerabilityID"]) for r in doc["Results"]
             for v in r.get("Vulnerabilities", [])]
    assert ("usr/bin/tool", "CVE-2019-10744") in vulns


# ------------------------------------------------------------ on a card


@pytest.mark.cuda
def test_cuda_sbom_sarif_equals_no_tpu(synth_env, tmp_path, capsys):
    """On a card: `sbom --format sarif` with the match kernel on cuda:0
    writes the report of --no-tpu."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    from trivy_tpu_torch.ops import match

    argv = ["sbom", synth_env["sbom"], "--format", "sarif", "--db-path",
            synth_env["db"], "--quiet", "--cache-dir", str(tmp_path)]
    assert main(argv + ["--no-tpu"]) == 0
    want = capsys.readouterr().out
    match.match_words.launches = 0
    assert main(argv) == 0
    assert capsys.readouterr().out == want
    assert match.match_words.launches > 0
    assert os.path.isdir(os.path.join(synth_env["db"], "compiled-torch"))
