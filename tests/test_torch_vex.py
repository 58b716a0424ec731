"""Port parity, VEX: trivy_tpu_torch/vex (OpenVEX, CycloneDX VEX and
CSAF documents, the purl and alias match, the component graph's
reachability, the repository set over `<cache>/vex`, OCI-attached
attestations) against the JAX package's on the shapes of
tests/test_vex_config.py, built in each package's types; and `--vex` /
`--show-suppressed` through both CLIs, from flags, the environment and a
config file, in json and table, with a document, `repo` and `oci`
(against a fake registry on localhost).

Reports are compared as bytes: the tolerance is exact equality.
"""

import base64
import hashlib
import importlib
import json
import random
import threading
from http.server import HTTPServer

import pytest
import torch
import test_fanal
from test_image_sources import _RegistryHandler, registry  # noqa: F401
from test_torch_report import both, fs_env, synth_env  # noqa: F401

from trivy_tpu.cli import run as jax_run
from trivy_tpu_torch.cli import run
from trivy_tpu_torch.fanal.analyzers import secret_analyzer
from trivy_tpu_torch.secret import scanner as sc

FAKE_TIME = "2024-01-01T00:00:00+00:00"
PACKAGES = ("trivy_tpu", "trivy_tpu_torch")


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
    monkeypatch.setattr(secret_analyzer, "USE_DEVICE", "hybrid")
    monkeypatch.setattr(secret_analyzer, "DEVICE", None)
    monkeypatch.setattr(sc, "_CACHE_DIR_OVERRIDE", None)


def _mods(pkg: str):
    return (importlib.import_module(f"{pkg}.types.artifact"),
            importlib.import_module(f"{pkg}.types.report"),
            importlib.import_module(f"{pkg}.vex"))


def flat_report(pkg: str):
    """tests/test_vex_config.py's three-finding npm report."""
    A, R, _ = _mods(pkg)

    def vuln(vid, purl, name):
        return R.DetectedVulnerability(
            vulnerability_id=vid, pkg_name=name,
            pkg_identifier=A.PkgIdentifier(purl=purl),
            installed_version="1.0.0",
            info=R.VulnerabilityInfo(severity="HIGH"))

    return R.Report(results=[R.Result(
        target="app", result_class="lang-pkgs", type="npm",
        vulnerabilities=[
            vuln("CVE-2023-1111", "pkg:npm/aaa@1.0.0", "aaa"),
            vuln("CVE-2023-2222", "pkg:npm/bbb@1.0.0", "bbb"),
            vuln("CVE-2023-3333", "pkg:npm/ccc@1.0.0", "ccc"),
        ])])


def graph_report(pkg: str, cycle: bool = False):
    """tests/test_vex_config.py's graph: app -> lib -> zlib and
    other -> zlib, zlib vulnerable; or a detached cycle a <-> b."""
    A, R, _ = _mods(pkg)

    def p(pid, purl, deps=()):
        out = A.Package(id=pid, name=pid.split("@")[0],
                        version=pid.split("@")[1], depends_on=list(deps))
        out.identifier = A.PkgIdentifier(purl=purl, uid=pid)
        return out

    if cycle:
        pkgs = [p("a@1", "pkg:npm/a@1", ["b@1"]),
                p("b@1", "pkg:npm/b@1", ["a@1"])]
        vuln = ("CVE-9", "a", "pkg:npm/a@1", "a@1")
    else:
        pkgs = [p("app@1.0.0", "pkg:npm/app@1.0.0", ["lib@2.0.0"]),
                p("lib@2.0.0", "pkg:npm/lib@2.0.0", ["zlib@1.2.3"]),
                p("other@3.0.0", "pkg:npm/other@3.0.0", ["zlib@1.2.3"]),
                p("zlib@1.2.3", "pkg:npm/zlib@1.2.3")]
        vuln = ("CVE-2042-1", "zlib", "pkg:npm/zlib@1.2.3", "zlib@1.2.3")
    res = R.Result(
        target="app/package-lock.json", result_class="lang-pkgs",
        type="npm", packages=pkgs,
        vulnerabilities=[R.DetectedVulnerability(
            vulnerability_id=vuln[0], pkg_name=vuln[1],
            installed_version="1.2.3",
            pkg_identifier=A.PkgIdentifier(purl=vuln[2], uid=vuln[3]))])
    return R.Report(artifact_name="repo", results=[res])


def openvex(vid, products, status="not_affected", aliases=None):
    vuln = {"name": vid}
    if aliases:
        vuln["aliases"] = aliases
    st = {"vulnerability": vuln, "status": status,
          "justification": "vulnerable_code_not_in_execute_path"}
    if products is not None:
        st["products"] = products
    return {"@context": "https://openvex.dev/ns/v0.2.0",
            "statements": [st]}


# tests/test_vex_config.py:40-200, each: (document, suppressed count)
DOC_CASES = {
    "openvex": ({"@context": "https://openvex.dev/ns/v0.2.0", "statements": [
        {"vulnerability": {"name": "CVE-2023-1111"},
         "products": [{"@id": "pkg:npm/aaa@1.0.0"}],
         "status": "not_affected",
         "justification": "vulnerable_code_not_in_execute_path"},
        {"vulnerability": {"name": "CVE-2023-2222"},
         "products": [{"@id": "pkg:npm/OTHER@9.9.9"}],
         "status": "not_affected"}]}, 1),
    "cyclonedx": ({"bomFormat": "CycloneDX", "specVersion": "1.5",
                   "vulnerabilities": [
                       {"id": "CVE-2023-2222",
                        "analysis": {"state": "false_positive",
                                     "justification": "code_not_reachable"},
                        "affects": [{"ref": "pkg:npm/bbb@1.0.0"}]},
                       {"id": "CVE-2023-3333",
                        "analysis": {"state": "exploitable"},
                        "affects": [{"ref": "pkg:npm/ccc@1.0.0"}]}]}, 1),
    "csaf": ({"document": {"category": "csaf_vex", "title": "t"},
              "product_tree": {"branches": [{"branches": [{"product": {
                  "product_id": "P1",
                  "product_identification_helper": {
                      "purl": "pkg:npm/ccc@1.0.0"}}}]}]},
              "vulnerabilities": [{
                  "cve": "CVE-2023-3333",
                  "product_status": {"known_not_affected": ["P1"]}}]}, 1),
    "purl-wildcard": (openvex("CVE-2023-1111", [{"@id": "pkg:npm/aaa"}],
                              status="fixed"), 1),
    "alias": (openvex("GHSA-abcd-1234", [{"@id": "pkg:npm/aaa@1.0.0"}],
                      aliases=["CVE-2023-1111"]), 1),
    "no-products": (openvex("CVE-2023-1111", None), 0),
    "bom-ref": ({"bomFormat": "CycloneDX", "specVersion": "1.5",
                 "vulnerabilities": [{
                     "id": "CVE-2023-1111",
                     "analysis": {"state": "not_affected"},
                     "affects": [{"ref": "urn:cdx:serial/1#comp-aaa"}]}]},
                1),
    "under-investigation": (openvex("CVE-2023-2222",
                                    [{"@id": "pkg:npm/bbb@1.0.0"}],
                                    status="under_investigation"), 0),
}


def filtered(pkg, report, sources) -> tuple[int, str]:
    n = _mods(pkg)[2].filter_report_vex(report, sources)
    return n, json.dumps(report.to_dict(), sort_keys=False)


@pytest.mark.parametrize("case", list(DOC_CASES))
def test_document_shapes_equal_reference(tmp_path, case):
    doc, n_want = DOC_CASES[case]
    path = tmp_path / "vex.json"
    path.write_text(json.dumps(doc))
    out = []
    for pkg in PACKAGES:
        report = flat_report(pkg)
        if case == "bom-ref":
            report.results[0].vulnerabilities[0].pkg_identifier.bom_ref = \
                "urn:cdx:serial/1#comp-aaa"
        out.append(filtered(pkg, report,
                            [_mods(pkg)[2].load_vex(str(path))]))
    assert out[1] == out[0]
    assert out[1][0] == n_want
    assert ("ExperimentalModifiedFindings" in out[1][1]) is (n_want > 0)


@pytest.mark.parametrize("content", ["{}", "[]", "not json"])
def test_unknown_document_errors_as_in_reference(tmp_path, content):
    path = tmp_path / "x.json"
    path.write_text(content)
    errors = []
    for pkg in PACKAGES:
        with pytest.raises(Exception) as exc:
            _mods(pkg)[2].load_vex(str(path))
        errors.append((type(exc.value).__name__, str(exc.value)))
    assert errors[1] == errors[0]


REACH_CASES = {
    "one-parent-path": ([{"@id": "pkg:npm/lib@2.0.0",
                          "subcomponents": [{"@id": "pkg:npm/zlib@1.2.3"}]}],
                        0),
    "all-paths": ([{"@id": "pkg:npm/lib@2.0.0",
                    "subcomponents": [{"@id": "pkg:npm/zlib@1.2.3"}]},
                   {"@id": "pkg:npm/other@3.0.0",
                    "subcomponents": [{"@id": "pkg:npm/zlib@1.2.3"}]}], 1),
    "leaf": ([{"@id": "pkg:npm/zlib@1.2.3"}], 1),
    "subcomponent-mismatch": ([{"@id": "pkg:npm/lib@2.0.0",
                                "subcomponents": [
                                    {"@id": "pkg:npm/somethingelse@9"}]}],
                              0),
    "root": ([{"@id": "pkg:npm/app@1.0.0"}], 0),
}


@pytest.mark.parametrize("case", list(REACH_CASES))
def test_reachability_equals_reference(tmp_path, case):
    products, n_want = REACH_CASES[case]
    path = tmp_path / "vex.json"
    path.write_text(json.dumps(openvex("CVE-2042-1", products)))
    out = [filtered(pkg, graph_report(pkg),
                    [_mods(pkg)[2].load_vex(str(path))])
           for pkg in PACKAGES]
    assert out[1] == out[0] and out[1][0] == n_want


def test_detached_cycle_keeps_finding_as_in_reference():
    out = []
    for pkg in PACKAGES:
        vex = importlib.import_module(f"{pkg}.vex.vex")
        doc = vex.VexDocument(source="s", statements=[vex.VexStatement(
            vulnerability_id="CVE-OTHER", status="not_affected",
            products=["pkg:npm/zzz@1"])])
        out.append(filtered(pkg, graph_report(pkg, cycle=True), [doc]))
    assert out[1] == out[0] and out[1][0] == 0


def mk_repo(cache, name, doc, location="docs/zlib.openvex.json"):
    """A cached VEX repository under <cache>/vex (tests/test_vex_config.py
    TestRepositorySet)."""
    d = cache / "vex" / "repositories" / name / "0.1"
    (d / "docs").mkdir(parents=True, exist_ok=True)
    (d / "index.json").write_text(json.dumps({"packages": [
        {"id": "pkg:npm/zlib", "location": location, "format": "openvex"},
    ]}))
    (d / "docs" / "zlib.openvex.json").write_text(json.dumps(doc))
    with open(cache / "vex" / "repository.yaml", "a") as f:
        f.write(f"repositories:\n  - name: {name}\n"
                f"    url: https://example.com/{name}\n"
                f"    enabled: true\n")


@pytest.mark.parametrize("case", ["lookup", "missing", "escape"])
def test_repository_set_equals_reference(tmp_path, case):
    if case == "lookup":
        mk_repo(tmp_path, "corp",
                openvex("CVE-2042-1", [{"@id": "pkg:npm/zlib@1.2.3"}]))
    elif case == "escape":
        mk_repo(tmp_path, "evil", {}, location="../../../../etc/passwd")
    out = []
    for pkg in PACKAGES:
        rs = importlib.import_module(f"{pkg}.vex.repo").RepositorySet(
            str(tmp_path))
        hits = [(src, st.vulnerability_id, st.status, st.products)
                for src, st in rs.candidate_statements("pkg:npm/zlib@1.2.3")]
        absent = rs.candidate_statements("pkg:npm/absent@1.0.0")
        out.append((bool(rs), hits, absent,
                    filtered(pkg, graph_report(pkg), [rs])))
    assert out[1] == out[0]
    assert out[1][3][0] == (1 if case == "lookup" else 0)
    assert bool(out[1][1]) is (case == "lookup")


@pytest.mark.parametrize("shape", ["raw", "dsse", "predicate-only",
                                   "garbage", "no-statements"])
def test_oci_attestation_decode_equals_reference(shape):
    doc = openvex("CVE-2042-1", [{"@id": "pkg:npm/zlib@1.2.3"}])
    statement = {"_type": "https://in-toto.io/Statement/v0.1",
                 "predicateType": "https://openvex.dev/ns/v0.2.0",
                 "predicate": doc}
    raw = {
        "raw": json.dumps(doc),
        "dsse": json.dumps({"payloadType": "application/vnd.in-toto+json",
                            "payload": base64.b64encode(json.dumps(
                                statement).encode()).decode(),
                            "signatures": []}),
        "predicate-only": json.dumps(statement),
        "garbage": "\x00\x01",
        "no-statements": json.dumps({"a": 1}),
    }[shape].encode()
    out = []
    for pkg in PACKAGES:
        oci = importlib.import_module(f"{pkg}.vex.oci")
        got = oci._decode_attestation(raw, "oci")
        out.append(None if got is None else
                   (got.source, [(s.vulnerability_id, s.status, s.products)
                                 for s in got.statements]))
        assert oci.load_oci_vex(graph_report(pkg)) is None  # not an image
    assert out[1] == out[0]
    assert (out[1] is None) is (shape in ("garbage", "no-statements"))


# ------------------------------------------ --vex through both CLIs


@pytest.fixture(scope="module")
def vex_env(synth_env, tmp_path_factory):
    """The synthetic SBOM's bare report (port, json) and an OpenVEX doc
    marking `not_affected` a seeded 20 of its (vulnerability, purl)
    pairs, with the number of findings those pairs name."""
    from trivy_tpu_torch.cli.main import main

    tmp = tmp_path_factory.mktemp("vex")
    out = tmp / "bare.json"
    assert main(["sbom", synth_env["sbom"], "--format", "json", "--db-path",
                 synth_env["db"], "--quiet", "--device", "cpu", "--output",
                 str(out), "--cache-dir", str(tmp / "p")]) == 0
    bare = json.loads(out.read_text())
    findings = [(v["VulnerabilityID"], v["PkgIdentifier"]["PURL"])
                for r in bare["Results"] for v in r.get("Vulnerabilities", [])]
    pairs = random.Random(7).sample(sorted(set(findings)), 20)
    doc = {"@context": "https://openvex.dev/ns/v0.2.0",
           "@id": "https://example.com/vex/1", "author": "vendor",
           "statements": [{"vulnerability": {"name": vid},
                           "products": [{"@id": purl}],
                           "status": "not_affected",
                           "justification": "component_not_present"}
                          for vid, purl in pairs]}
    (tmp / "vex.json").write_text(json.dumps(doc))
    named = sum(1 for f in findings if f in set(pairs))
    return {"vex": str(tmp / "vex.json"), "bare": bare, "named": named,
            "tmp": tmp}


def sbom_argv(synth_env, *extra):
    return ["sbom", synth_env["sbom"], "--db-path", synth_env["db"],
            "--quiet", *extra]


def n_vulns(doc):
    return sum(len(r.get("Vulnerabilities", [])) for r in doc["Results"])


def n_modified(doc):
    return sum(len(r.get("ExperimentalModifiedFindings", []))
               for r in doc["Results"])


@pytest.mark.parametrize("no_tpu", [False, True], ids=["device", "no-tpu"])
@pytest.mark.parametrize("show", [False, True],
                         ids=["hidden", "show-suppressed"])
@pytest.mark.parametrize("fmt", ["json", "table"])
def test_vex_cli_equals_reference(synth_env, vex_env, capsys, fmt, show,
                                  no_tpu):
    argv = sbom_argv(synth_env, "--format", fmt, "--vex", vex_env["vex"])
    if show:
        argv.append("--show-suppressed")
    if no_tpu:
        argv.append("--no-tpu")
    want, got = both(argv, synth_env["tmp"], capsys)
    assert got == want and want[0] == 0
    if fmt == "json":
        doc = json.loads(got[1])
        assert n_vulns(vex_env["bare"]) - n_vulns(doc) == vex_env["named"]
        assert n_modified(doc) == (vex_env["named"] if show else 0)
    else:
        assert ("Suppressed Vulnerabilities" in got[1]) is show


def test_vex_before_severity_filter_as_in_reference(synth_env, vex_env,
                                                    capsys):
    """VEX runs first, then the severity filter, then package stripping:
    the suppressed list keeps findings the severity filter would drop."""
    argv = sbom_argv(synth_env, "--format", "json", "--vex", vex_env["vex"],
                     "--show-suppressed", "--severity", "CRITICAL",
                     "--vex", vex_env["vex"])
    want, got = both(argv, synth_env["tmp"], capsys)
    assert got == want and want[0] == 0
    doc = json.loads(got[1])
    assert n_modified(doc) >= vex_env["named"]
    assert {v["Severity"] for r in doc["Results"]
            for v in r.get("Vulnerabilities", [])} <= {"CRITICAL"}


@pytest.mark.parametrize("env,doc", [
    ({"TRIVY_TPU_SHOW_SUPPRESSED": "true"}, "vex:\n  - {vex}\n"),
    ({"TRIVY_TPU_VEX": "{vex}"}, "show-suppressed: true\n"),
    ({"TRIVY_TPU_VEX": "{vex}", "TRIVY_TPU_SHOW_SUPPRESSED": "0"},
     "show-suppressed: true\n"),
], ids=["vex-config", "vex-env", "env-over-config"])
def test_vex_options_from_env_and_config_act_as_in_reference(
        synth_env, vex_env, tmp_path, capsys, monkeypatch, env, doc):
    for k, v in env.items():
        monkeypatch.setenv(k, v.format(vex=vex_env["vex"]))
    cfg = tmp_path / "trivy-tpu.yaml"
    cfg.write_text(doc.format(vex=vex_env["vex"]))
    argv = sbom_argv(synth_env, "--format", "json", "--config", str(cfg))
    want, got = both(argv, synth_env["tmp"], capsys)
    assert got == want and want[0] == 0
    out = json.loads(got[1])
    assert n_vulns(vex_env["bare"]) - n_vulns(out) == vex_env["named"]
    assert bool(n_modified(out)) is (env.get(
        "TRIVY_TPU_SHOW_SUPPRESSED") != "0")


@pytest.mark.parametrize("fmt", ["json", "table"])
def test_vex_repo_cli_equals_reference(fs_env, tmp_path, capsys, fmt):
    """`fs --vex repo` reads the repositories cached under each CLI's
    own --cache-dir; the statement on the lockfile's express with
    lodash as its subcomponent covers the only path to lodash."""
    doc = openvex("CVE-2019-10744", [
        {"@id": "pkg:npm/express@4.0.0",
         "subcomponents": [{"@id": "pkg:npm/lodash@4.17.4"}]}])
    for cache in ("j", "p"):
        d = tmp_path / cache / "vex" / "repositories" / "corp" / "0.1"
        d.mkdir(parents=True)
        (d / "index.json").write_text(json.dumps({"packages": [
            {"id": "pkg:npm/express", "location": "express.json"}]}))
        (d / "express.json").write_text(json.dumps(doc))
        (tmp_path / cache / "vex" / "repository.yaml").write_text(
            "repositories:\n  - name: corp\n    url: https://example.com\n")
    argv = ["fs", fs_env["deptree"], "--format", fmt, "--db-path",
            fs_env["fixture_db"], "--quiet", "--scanners", "vuln",
            "--vex", "repo", "--show-suppressed"]
    want, got = both(argv, tmp_path, capsys)
    assert got == want and want[0] == 0
    assert "CVE-2019-10744" in got[1]
    if fmt == "json":
        out = json.loads(got[1])
        assert n_modified(out) >= 1
        assert "CVE-2019-10744" not in {
            v["VulnerabilityID"] for r in out["Results"]
            for v in r.get("Vulnerabilities", [])}


# ------------------------------------------- --vex oci, fake registry


class _VexRegistry(_RegistryHandler):
    """tests/test_image_sources.py's registry, which also serves an
    OpenVEX attestation for the image: through the referrers API, or
    (referrers off) under the cosign `sha256-<hex>.att` tag."""

    referrers = True
    vex_manifest = b""
    vex_manifest_digest = ""

    def do_GET(self):
        if self._authed():
            if "/referrers/" in self.path:
                if not self.referrers:
                    self._reply(404, b"{}")
                    return
                index = {"schemaVersion": 2, "manifests": [
                    {"digest": self.vex_manifest_digest,
                     "artifactType": "application/vnd.openvex+json"}]}
                self._reply(200, json.dumps(index).encode(),
                            ctype="application/vnd.oci.image.index.v1+json")
                return
            ref = self.path.rsplit("/", 1)[1]
            if "/manifests/" in self.path and (
                    ref == self.vex_manifest_digest or ref.endswith(".att")):
                self._reply(200, self.vex_manifest,
                            ctype="application/vnd.oci.image.manifest.v1+json")
                return
        super().do_GET()


def _plain_http(client_cls):
    class PlainClient(client_cls):
        def __init__(self, registry, insecure=False, **kw):
            super().__init__(registry, True, **kw)

    return PlainClient


@pytest.fixture()
def vex_registry(registry, monkeypatch):  # noqa: F811
    """The fake registry (plain HTTP on localhost) with an attestation
    marking flask's advisories not_affected. `--vex oci` builds a
    RegistryClient without --insecure, so both packages' clients are
    pointed at plain HTTP here."""
    doc = {"@context": "https://openvex.dev/ns/v0.2.0", "statements": [
        {"vulnerability": {"name": vid}, "products": [
            {"@id": "pkg:pypi/flask@1.0"}], "status": "not_affected"}
        for vid in ("CVE-2018-1000656", "CVE-2019-1010083",
                    "CVE-2023-30861")]}
    statement = {"_type": "https://in-toto.io/Statement/v0.1",
                 "predicateType": "https://openvex.dev/ns/v0.2.0",
                 "predicate": doc}
    blob = json.dumps({"payloadType": "application/vnd.in-toto+json",
                       "payload": base64.b64encode(
                           json.dumps(statement).encode()).decode(),
                       "signatures": []}).encode()
    blob_digest = "sha256:" + hashlib.sha256(blob).hexdigest()
    _RegistryHandler.blobs[blob_digest] = blob
    manifest = json.dumps({"schemaVersion": 2, "layers": [
        {"mediaType": "application/vnd.dsse.envelope+json",
         "digest": blob_digest, "size": len(blob)}]}).encode()
    monkeypatch.setattr(_VexRegistry, "vex_manifest", manifest)
    monkeypatch.setattr(_VexRegistry, "vex_manifest_digest",
                        "sha256:" + hashlib.sha256(manifest).hexdigest())
    for pkg in PACKAGES:
        mod = importlib.import_module(f"{pkg}.artifact.image_source")
        monkeypatch.setattr(mod, "RegistryClient",
                            _plain_http(mod.RegistryClient))
    srv = HTTPServer(("127.0.0.1", 0), _VexRegistry)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


@pytest.mark.parametrize("referrers", [True, False],
                         ids=["referrers", "att-tag"])
def test_vex_oci_cli_equals_reference(vex_registry, tmp_path, capsys,
                                      monkeypatch, referrers):
    monkeypatch.setattr(_VexRegistry, "referrers", referrers)
    monkeypatch.setenv("DOCKER_HOST", f"unix://{tmp_path}/none.sock")
    db = test_fanal._fixture_db()
    for vid, below in (("CVE-2018-1000656", "1.0.1"),
                       ("CVE-2019-1010083", "1.0"),
                       ("CVE-2023-30861", "2.2.5")):
        db.put_advisory("pip::g", "flask", test_fanal.Advisory(
            vulnerability_id=vid, vulnerable_versions=[f"<{below}"]))
    db.save(str(tmp_path / "db"))
    base = ["image", f"{vex_registry}/team/app:1.0", "--image-src",
            "remote", "--insecure", "--format", "json", "--db-path",
            str(tmp_path / "db"), "--quiet"]
    want, got = both(base + ["--vex", "oci", "--show-suppressed"],
                     tmp_path, capsys)
    assert got == want and want[0] == 0
    bare = both(base, tmp_path, capsys)[1]
    doc, bare_doc = json.loads(got[1]), json.loads(bare[1])
    assert n_modified(doc) > 0
    assert n_vulns(bare_doc) - n_vulns(doc) == n_modified(doc)
