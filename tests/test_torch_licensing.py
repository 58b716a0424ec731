"""Port parity, license scanning (`--scanners license`, `--license-full`):
trivy_tpu_torch's licensing/ (SPDX expressions, name normalization, the
category tables, both trigram engines of the full-text classifier),
fanal/analyzers/license_file.py and the CLI's license scans against the
JAX package's on the CPU. The port's CLI runs with `--device cpu` (the
match kernel's and the secret screens' plain versions); the reference
runs its JAX engine on the CPU.

Covered: expressions, normalization and categories over the cases of
tests/test_licensing.py; every corpus text classified by both engines
(TRIVY_TPU_VECTOR_ANALYZERS at 1 and 0) and both packages, and the
packed engine's fall-back on a vocabulary past `_PACK_MAX`; the
analyzer's `required` / `analyze`; `fs`, `rootfs`, `image`, `sbom` and
`repo` reports with `--scanners vuln,license` and with `--license-full`
in json, table, sarif and cyclonedx; the blob keys with the license
analyzer on; `--license-full`, which is not in a blob key, reusing a
blob a plain license scan cached (in both packages); and a Scan request
naming `license` over either wire, from each package's client, to each
package's server.

Module state that both packages keep (`LicenseFileAnalyzer.full`, the
classifier's vocabulary and compiled grams) is saved and restored
around every test that changes it. The tolerance is exact equality of
bytes and of confidences.
"""

from __future__ import annotations

import contextlib
import copy
import json
from pathlib import Path

import pytest
import test_fanal
import test_sbom_e2e
import torch
from test_torch_server import _twirp_post, close_clients, live

import chip_smoke
from trivy_tpu.cache.cache import MemoryCache as JaxMemoryCache
from trivy_tpu.cli import main as jax_main
from trivy_tpu.cli import run as jax_run
from trivy_tpu.db import AdvisoryDB as JaxAdvisoryDB
from trivy_tpu.detector.engine import MatchEngine as JaxEngine
from trivy_tpu.fanal import analyzer as jax_analyzer
from trivy_tpu.fanal.analyzer import AnalysisInput as JaxInput
from trivy_tpu.fanal.analyzers import license_file as jax_lf
from trivy_tpu.licensing import classifier as jax_cls
from trivy_tpu.licensing import expression as jax_expr
from trivy_tpu.licensing import normalize as jax_norm
from trivy_tpu.licensing import scanner as jax_lscan
from trivy_tpu.licensing.corpus import TEXTS
from trivy_tpu.rpc.server import Server as JaxServer
from trivy_tpu.utils import uuid as jax_uuid
from trivy_tpu_torch.artifact.image import ImageArtifact
from trivy_tpu_torch.cache.cache import MemoryCache
from trivy_tpu_torch.cli import run
from trivy_tpu_torch.cli.main import main
from trivy_tpu_torch.db import AdvisoryDB
from trivy_tpu_torch.detector.engine import MatchEngine
from trivy_tpu_torch.fanal import analyzer
from trivy_tpu_torch.fanal.analyzer import AnalysisInput
from trivy_tpu_torch.fanal.analyzers import license_file, secret_analyzer
from trivy_tpu_torch.licensing import classifier, expression, normalize
from trivy_tpu_torch.licensing import scanner as lscan
from trivy_tpu_torch.rpc import twirp
from trivy_tpu_torch.rpc.server import Server
from trivy_tpu_torch.secret import scanner as sc
from trivy_tpu_torch.utils import uuid as port_uuid

FAKE_TIME = "2024-01-01T00:00:00+00:00"
CLASSIFIER_STATE = ("_VOCAB", "_PACKED", "_GRAM_SETS", "_EXTRA_VARIANTS",
                    "_FINGERPRINTS", "_pack_disabled", "_corpus_loaded")


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
    for knob in ("TRIVY_TPU_VECTOR_ANALYZERS", "TRIVY_TPU_SECRET_PACK_MB",
                 "TRIVY_TPU_SECRET_STREAM_CHUNK_MB"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setattr(secret_analyzer, "USE_DEVICE", "hybrid")
    monkeypatch.setattr(secret_analyzer, "DEVICE", None)
    monkeypatch.setattr(sc, "_CACHE_DIR_OVERRIDE", None)
    # the CLIs set it per license scan; put back whatever a test left
    for mod in (license_file, jax_lf):
        monkeypatch.setattr(mod.LicenseFileAnalyzer, "full", False)
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()
    yield
    close_clients()
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()


@pytest.fixture()
def own_classifiers(monkeypatch):
    """Both packages' classifier module state copied for the test and
    put back after it (a corpus extension or an overflow sticks)."""
    for mod in (classifier, jax_cls):
        for name in CLASSIFIER_STATE:
            monkeypatch.setattr(mod, name, copy.deepcopy(getattr(mod, name)))


# ------------------------------------------------------ expressions


EXPRESSIONS = ["MIT", "Apache-2.0+", "GPL-2.0", "GPL-2.0+",
               "(MIT OR ISC) AND Apache-2.0", "MIT OR ISC AND Apache-2.0",
               "GPL-2.0 WITH Classpath-exception-2.0", "MIT or ISC",
               "LGPL-2.1-only OR (BSD-3-Clause AND MIT)",
               "MIT Apache-2.0", "(MIT", "", "MIT AND", "AND MIT"]


@pytest.mark.parametrize("text", EXPRESSIONS)
def test_expression_parse_and_render(text):
    def outcome(mod):
        try:
            e = mod.parse(text)
        except mod.LicenseParseError as err:
            return ("error", str(err))
        return (repr(e), str(e))

    assert outcome(expression) == outcome(jax_expr)


@pytest.mark.parametrize("name,plus", [("GPL-2.0", False), ("GPL-2.0", True),
                                       ("MIT", True), ("LGPL-3.0", False)])
def test_simple_expression_rendering(name, plus):
    assert str(expression.SimpleExpr(name, plus)) == \
        str(jax_expr.SimpleExpr(name, plus))


# -------------------------------------------------- normalization


NAMES = ["apache 2", "Apache License, Version 2.0",
         "The Apache Software License, Version 2.0", "APACHE-2.0",
         "MIT License", "Expat", "BSD", "New BSD License", "GPLv2+",
         "GPL-2.0-only", "GPL2", "GPL", "LGPL v3", "ISC License",
         "Public Domain", "Zlib/libpng", "Totally Unknown License",
         "MPL 2.0", "GNU Affero General Public License v3"]


@pytest.mark.parametrize("raw", NAMES)
def test_normalize(raw):
    assert normalize.normalize(raw) == jax_norm.normalize(raw)


@pytest.mark.parametrize("fn,arg", [
    ("normalize_spdx_expression", "MIT OR Apache-2.0"),
    ("normalize_spdx_expression", "Expat OR ASL-2.0"),
    ("split_licenses", "GPL-1+,GPL-2"),
    ("split_licenses", "GPL-1+ or Artistic or Artistic-dist"),
    ("split_licenses", "BSD 3-Clause License or Apache License, Version 2.0"),
    ("split_licenses",
     "GNU Lesser General Public License v2 or later (LGPLv2+)"),
    ("split_licenses", "Permission is hereby granted; see https://x"),
    ("lax_split_licenses", "MPL 2.0 GPL2+"),
])
def test_normalize_helpers(fn, arg):
    assert getattr(normalize, fn)(arg) == getattr(jax_norm, fn)(arg)


@pytest.mark.parametrize("name,custom", [
    ("MIT", None), ("GPL-3.0-only", None), ("AGPL-3.0", None),
    ("Apache License, Version 2.0", None), ("GPLv3+", None),
    ("MPL-2.0", None), ("CC0-1.0", None), ("proprietary", None),
    ("MIT", {"forbidden": ["MIT"]}), ("ISC", {"permissive": ["ISC"]})])
def test_categorize(name, custom):
    assert lscan.categorize(name, custom) == jax_lscan.categorize(name,
                                                                  custom)


# ------------------------------------------------------------ classifier


def findings(lf) -> list | None:
    if lf is None:
        return None
    return [lf.type, lf.file_path, [(f.name, f.confidence, f.link)
                                    for f in lf.findings]]


@pytest.mark.parametrize("engine", ["1", "0"], ids=["packed", "sets"])
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_corpus_text_self_classifies(monkeypatch, name, engine):
    """Each corpus text classifies as itself at >= 0.99 in the engine
    TRIVY_TPU_VECTOR_ANALYZERS picks, with the reference's confidences,
    and the other engine gives the same."""
    outs = {}
    for eng in ("1", "0"):
        monkeypatch.setenv("TRIVY_TPU_VECTOR_ANALYZERS", eng)
        outs[eng] = [findings(mod.classify("LICENSE", TEXTS[name]))
                     for mod in (classifier, jax_cls)]
    got, want = outs[engine]
    assert got == want
    assert outs["1"] == outs["0"]
    assert got[2][0][0] == name and got[2][0][1] >= 0.99


MIT_TEXT = ("MIT License\n\nCopyright (c) 2024 Example\n\n"
            "Permission is hereby granted, free of charge, to any person "
            "obtaining a\ncopy of this software and associated documentation "
            "files (the \"Software\"),\nto deal in the Software without "
            "restriction, subject to the following\nconditions:\n\n"
            "THE SOFTWARE IS PROVIDED \"AS IS\", WITHOUT WARRANTY OF ANY "
            "KIND.\n")
CLASSIFY_CASES = [
    ("LICENSE", MIT_TEXT, 0.75),
    ("main.go", "// SPDX-License-Identifier: BSD-3-Clause\n", 0.75),
    ("lib.c", "/* SPDX-License-Identifier: MIT OR (Apache-2.0 AND "
              "ISC) */\n", 0.75),
    ("LICENSE.txt", "Apache License\nVersion 2.0, January 2004\n"
                    "http://www.apache.org/licenses/\nUnless required by "
                    "applicable law or agreed to in writing, software "
                    "distributed under the License is distributed on an "
                    "\"AS IS\" BASIS", 0.4),
    ("README.md", "hello world", 0.75),
    ("LICENSE", "Permission is hereby granted, free of charge, to any\n"
                "person obtaining one copy of this software and associated\n"
                "documentation, subject to the following conditions apply.\n"
                "THE SOFTWARE IS PROVIDED 'AS IS', WITHOUT WARRANTY OF ANY\n"
                "KIND, express or implied.\n", 0.5),
    ("LICENSE.txt", "Copyright (c) 2023 Example Industries, Inc.\n\n"
                    + " ".join(TEXTS["MIT"].split()), 0.75),
    ("COPYING", TEXTS["GPL-3.0"], 0.75),
    ("COPYING", TEXTS["LGPL-2.1"], 0.75),
    ("LICENSE", TEXTS["BSD-2-Clause"], 0.75),
    ("NOTICE", "This product includes software developed by the OpenSSL "
               "Project for use in the OpenSSL Toolkit.", 0.75),
    ("README", "just a readme about nothing with many ordinary words " * 10,
     0.75),
]


@pytest.mark.parametrize("engine", ["1", "0"], ids=["packed", "sets"])
@pytest.mark.parametrize("case", range(len(CLASSIFY_CASES)))
def test_classify_equals_reference(monkeypatch, case, engine):
    monkeypatch.setenv("TRIVY_TPU_VECTOR_ANALYZERS", engine)
    path, text, level = CLASSIFY_CASES[case]
    for content in (text, text.encode()):
        assert findings(classifier.classify(path, content, level)) == \
            findings(jax_cls.classify(path, content, level))


def test_custom_corpus_extension(own_classifiers):
    body = ("the corp proprietary license version one grants the receiving "
            "party a limited revocable right to evaluate this software "
            "within corp premises only")
    for mod in (classifier, jax_cls):
        mod.add_license_text("Corp-1.0", body)
    doc = body.replace("corp", "Corp").encode() + b"."
    got = findings(classifier.classify("LICENSE", doc))
    assert got == findings(jax_cls.classify("LICENSE", doc))
    assert "Corp-1.0" in [f[0] for f in got[2]]


def test_vocabulary_overflow_falls_back_to_the_set_engine(own_classifiers,
                                                          monkeypatch):
    """Past `_PACK_MAX` corpus words the packed engine turns itself off
    (`_pack_disabled`) and the set engine answers, in both packages,
    with the confidences the packed engine gives below the limit."""
    want = [findings(classifier.classify("COPYING", TEXTS[n]))
            for n in ("GPL-2.0", "MIT")]
    for mod in (classifier, jax_cls):
        monkeypatch.setattr(mod, "_VOCAB", {})
        monkeypatch.setattr(mod, "_PACKED", {})
        monkeypatch.setattr(mod, "_PACK_MAX", 64)
    for n, w in zip(("GPL-2.0", "MIT"), want):
        got = findings(classifier.classify("COPYING", TEXTS[n]))
        assert got == findings(jax_cls.classify("COPYING", TEXTS[n])) == w
    assert classifier._pack_disabled and jax_cls._pack_disabled


# ------------------------------------------------------------- analyzer


PATHS = ["LICENSE", "pkg/COPYING.txt", "LICENSE-MIT.txt", "main.py",
         "LICENSE.Apache-2.0", "license-checker.py", "NOTICE", "EULA.md",
         "docs/licence.rst", "src/lib.rs", "src/app.ts", "Makefile",
         "COPYING.LESSER", "UNLICENSE", "vendor/x/Patents", "readme.txt"]


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("path", PATHS)
def test_license_file_analyzer_required(monkeypatch, path, full):
    for mod in (license_file, jax_lf):
        monkeypatch.setattr(mod.LicenseFileAnalyzer, "full", full)
    for size in (100, 2 << 20):
        assert license_file.LicenseFileAnalyzer().required(path, size) == \
            jax_lf.LicenseFileAnalyzer().required(path, size)


@pytest.mark.parametrize("path,content", [
    ("LICENSE", MIT_TEXT.encode()),
    ("src/main.go", b"// SPDX-License-Identifier: AGPL-3.0-only\n"),
    ("LICENSE", b"\x00\x01binary" + MIT_TEXT.encode()),
    ("NOTICE", b"nothing to see"),
    ("COPYING", TEXTS["MPL-2.0"].encode())],
    ids=["mit", "header", "binary", "nothing", "mpl"])
def test_license_file_analyzer_analyze(path, content):
    def out(res):
        return None if res is None else [findings(lf) for lf in res.licenses]

    got = license_file.LicenseFileAnalyzer().analyze(
        AnalysisInput(path, content))
    want = jax_lf.LicenseFileAnalyzer().analyze(JaxInput(path, content))
    assert out(got) == out(want)


# ------------------------------------------------------------ CLI scans


def license_tree(root) -> None:
    """The reference tests' rootfs (apk packages declaring MIT and
    GPL-2.0-only, a vulnerable lodash lockfile, a secret) plus license
    files (exact, reflowed, an OpenSSL NOTICE), source files with and
    without an SPDX header, a composer.lock, an installed npm package
    and a python dist declaring their licenses."""
    test_fanal._mk_rootfs(root)
    files = {
        "LICENSE": TEXTS["MIT"],
        "COPYING": TEXTS["GPL-3.0"],
        "vendor/libz/LICENSE-BSD.txt": "Copyright (c) 2020 libz\n\n"
        + " ".join(TEXTS["BSD-3-Clause"].split()),
        "vendor/ssl/NOTICE": "This product includes software developed by "
        "the OpenSSL Project for use in the OpenSSL Toolkit.\n",
        "src/main.go": "// SPDX-License-Identifier: AGPL-3.0-only\n"
        "package main\n",
        "src/lib.rs": "// SPDX-License-Identifier: MIT OR Apache-2.0\n",
        "src/util.py": "import os\nprint(os.getcwd())\n",
        "php/composer.lock": json.dumps({"packages": [
            {"name": "monolog/monolog", "version": "2.9.1",
             "license": ["MIT"]},
            {"name": "acme/sdk", "version": "1.0.0",
             "license": ["proprietary"]}]}),
        "app/node_modules/left-pad/package.json": json.dumps(
            {"name": "left-pad", "version": "1.3.0", "license": "WTFPL"}),
        "usr/lib/python3/site-packages/requests-2.31.0.dist-info/METADATA":
        "Metadata-Version: 2.1\nName: requests\nVersion: 2.31.0\n"
        "License: Apache 2.0\n",
    }
    for path, body in files.items():
        full = root / path
        full.parent.mkdir(parents=True, exist_ok=True)
        full.write_text(body)


def license_bom() -> dict:
    """The reference tests' CycloneDX document with declared licenses on
    its components."""
    doc = copy.deepcopy(test_sbom_e2e.CDX_DOC)
    names = ["MIT", "GPL-2.0-only", "Apache-2.0", "AGPL-3.0"]
    for k, comp in enumerate(doc.get("components", [])):
        comp["licenses"] = [{"license": {"id": names[k % len(names)]}}]
    return doc


@pytest.fixture(scope="module")
def lic_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("licenses")
    tree = tmp / "tree"
    license_tree(tree)
    test_fanal._fixture_db().save(str(tmp / "db"))
    members = sorted(p for p in tree.rglob("*") if p.is_file())
    layer = chip_smoke.layer_tar([(str(p.relative_to(tree)), p.read_bytes())
                                  for p in members])
    chip_smoke.write_image(str(tmp / "img.tar"), [layer],
                           [{"created_by": "COPY . /"}], "docker")
    (tmp / "bom.json").write_text(json.dumps(license_bom()))
    return {"tree": str(tree), "db": str(tmp / "db"),
            "tar": str(tmp / "img.tar"), "bom": str(tmp / "bom.json")}


def scan(entry, argv, capsys, uuid_mod) -> tuple[int, str]:
    uuid_mod.reset()
    rc = entry(argv)
    return rc, capsys.readouterr().out


def both(argv, tmp_path, capsys, port_extra=("--device", "cpu")) -> tuple:
    """(rc, stdout) of the reference's CLI and of the port's, each on a
    cache directory of its own."""
    want = scan(jax_main.main, argv + ["--cache-dir", str(tmp_path / "j")],
                capsys, jax_uuid)
    got = scan(main, argv + [*port_extra, "--cache-dir",
                             str(tmp_path / "p")], capsys, port_uuid)
    return want, got


def target(env, cmd) -> list[str]:
    if cmd == "image":
        return ["image", "--input", env["tar"]]
    if cmd == "sbom":
        return ["sbom", env["bom"]]
    return [cmd, env["tree"]]


@pytest.mark.parametrize("fmt", ["json", "table", "sarif", "cyclonedx"])
@pytest.mark.parametrize("full", [False, True], ids=["license",
                                                     "license-full"])
@pytest.mark.parametrize("cmd", ["fs", "rootfs", "image", "sbom", "repo"])
def test_cli_equals_the_reference(lic_env, tmp_path, capsys, cmd, full,
                                  fmt):
    argv = [*target(lic_env, cmd), "--db-path", lic_env["db"], "--format",
            fmt, "--quiet", "--scanners", "vuln,license"]
    if full:
        argv.append("--license-full")
    want, got = both(argv, tmp_path, capsys)
    assert got == want and got[0] == 0
    if fmt == "json":
        doc = json.loads(got[1])
        names = {lic["Name"] for r in doc["Results"]
                 for lic in r.get("Licenses") or []}
        assert names  # every target declares or holds licenses
        if cmd in ("fs", "rootfs", "image", "repo"):
            assert {"MIT", "GPL-3.0"} <= names
            assert ("AGPL-3.0-only" in names) == full  # a source header


def test_license_findings_by_class(lic_env, tmp_path, capsys):
    """`rootfs` reads the installed npm and python packages' licenses and
    the apk database's, `fs` the composer lockfile's; both classify the
    loose files."""
    docs = {}
    for cmd in ("fs", "rootfs"):
        want, got = both([cmd, lic_env["tree"], "--db-path", lic_env["db"],
                          "--format", "json", "--quiet", "--scanners",
                          "license", "--license-full"], tmp_path / cmd,
                         capsys)
        assert got == want
        docs[cmd] = {(r["Target"], lic.get("PkgName", ""), lic["Name"],
                      lic["Category"])
                     for r in json.loads(got[1])["Results"]
                     for lic in r.get("Licenses") or []}
    assert ("php/composer.lock", "acme/sdk", "proprietary", "unknown") in \
        docs["fs"]
    assert ("OS Packages", "busybox", "GPL-2.0-only", "restricted") in \
        docs["rootfs"]
    assert any(t[1] == "left-pad" and t[2] == "WTFPL" for t in
               docs["rootfs"])
    loose = {(t[2], t[3]) for t in docs["fs"]
             if t[0] == "Loose File License(s)"}
    assert {("MIT", "notice"), ("GPL-3.0", "restricted"),
            ("OpenSSL", "notice"), ("AGPL-3.0-only", "forbidden"),
            ("BSD-3-Clause", "notice")} <= loose


@pytest.mark.parametrize("engine", ["1", "0"], ids=["packed", "sets"])
def test_cli_engines_give_one_report(lic_env, tmp_path, capsys,
                                     monkeypatch, engine):
    monkeypatch.setenv("TRIVY_TPU_VECTOR_ANALYZERS", engine)
    want, got = both(["fs", lic_env["tree"], "--db-path", lic_env["db"],
                      "--format", "json", "--quiet", "--scanners",
                      "vuln,license", "--license-full"], tmp_path, capsys)
    assert got == want and got[0] == 0


@pytest.mark.parametrize("full", [False, True], ids=["license",
                                                     "license-full"])
def test_fleet_license_scan_equals_reference(lic_env, tmp_path, capsys,
                                             full):
    """`image --targets --journal` over the license image and a variant
    with one more layer, with `--scanners vuln,license`: the merged
    report and the journal byte for byte."""
    extra = chip_smoke.layer_tar([("srv/COPYING", TEXTS["LGPL-3.0"]),
                                  ("srv/main.c", "/* SPDX-License-"
                                   "Identifier: EPL-2.0 */\n")])
    variant = str(tmp_path / "variant.tar")
    members = sorted(p for p in Path(lic_env["tree"]).rglob("*")
                     if p.is_file())
    base = chip_smoke.layer_tar([(str(m.relative_to(lic_env["tree"])),
                                  m.read_bytes()) for m in members])
    chip_smoke.write_image(variant, [base, extra],
                           [{"created_by": "COPY . /"},
                            {"created_by": "COPY srv /srv"}], "docker")
    listing = tmp_path / "targets.txt"
    listing.write_text(f"{lic_env['tar']}\n{variant}\n")
    outs = {}
    for pkg, entry, uuid_mod, dev in (
            ("ref", jax_main.main, jax_uuid, []),
            ("port", main, port_uuid, ["--device", "cpu"])):
        run._ENGINE_CACHE.clear()
        jax_run._ENGINE_CACHE.clear()
        argv = ["image", lic_env["tar"], "--targets", str(listing),
                "--journal", str(tmp_path / f"j-{pkg}.jsonl"), "--output",
                str(tmp_path / f"{pkg}.json"), "--format", "json",
                "--quiet", "--db-path", lic_env["db"], "--scanners",
                "vuln,license", "--cache-dir", str(tmp_path / f"c-{pkg}"),
                *dev, *(["--license-full"] if full else [])]
        assert scan(entry, argv, capsys, uuid_mod)[0] == 0
        outs[pkg] = ((tmp_path / f"{pkg}.json").read_bytes(),
                     (tmp_path / f"j-{pkg}.jsonl").read_bytes())
    assert outs["port"] == outs["ref"]
    doc = json.loads(outs["port"][0])
    names = {lic["Name"] for rep in doc["Reports"]
             for r in rep.get("Results") or []
             for lic in r.get("Licenses") or []}
    assert "LGPL-3.0" in names and ("EPL-2.0" in names) == full


# ---------------------------------------------------------- cache keys


@pytest.mark.parametrize("full", [False, True])
def test_blob_keys_equal_the_reference_with_license(lic_env, monkeypatch,
                                                    full):
    """With the license analyzer on, `license-file` (version 1) is in
    every blob and artifact key of both packages, and the keys are
    equal; `--license-full` is not in them."""
    from trivy_tpu.artifact.image import ImageArtifact as JaxImageArtifact

    for mod in (license_file, jax_lf):
        monkeypatch.setattr(mod.LicenseFileAnalyzer, "full", full)
    disabled = {"config"}
    got = ImageArtifact(lic_env["tar"], MemoryCache(), from_tar=True,
                        disabled_analyzers=disabled).inspect()
    want = JaxImageArtifact(lic_env["tar"], JaxMemoryCache(), from_tar=True,
                            disabled_analyzers=disabled).inspect()
    assert (got.id, got.blob_ids) == (want.id, want.blob_ids)
    without = ImageArtifact(lic_env["tar"], MemoryCache(), from_tar=True,
                            disabled_analyzers=disabled | {"license-file"}
                            ).inspect()
    assert without.blob_ids != got.blob_ids
    groups = [m.AnalyzerGroup.build(disabled_types=disabled).versions()
              for m in (analyzer, jax_analyzer)]
    assert groups[0] == groups[1] and groups[0]["license-file"] == 1


def test_license_full_reuses_a_plain_license_blob(lic_env, tmp_path, capsys):
    """`--license-full` is a class attribute, not in the blob key: an
    image scan with it on a cache a plain license scan filled reads
    that blob, so its source-file headers are missing, in both packages
    alike; on an empty cache it finds them."""
    argv = ["image", "--input", lic_env["tar"], "--db-path", lic_env["db"],
            "--format", "json", "--quiet", "--scanners", "vuln,license"]
    plain = both(argv, tmp_path, capsys)
    warm = both(argv + ["--license-full"], tmp_path, capsys)
    cold = both(argv + ["--license-full"], tmp_path / "cold", capsys)
    assert plain[1] == plain[0] and warm[1] == warm[0] and \
        cold[1] == cold[0]
    assert warm[1] == plain[1]
    assert cold[1] != warm[1]
    assert "AGPL-3.0-only" in cold[1][1] and \
        "AGPL-3.0-only" not in warm[1][1]


# ------------------------------------------------------------ the wire


LICENSED_BLOB = {"schema_version": 2, "applications": [{
    "type": "npm", "file_path": "package-lock.json", "packages": [
        {"id": "lodash@4.17.4", "name": "lodash", "version": "4.17.4",
         "licenses": ["MIT"],
         "identifier": {"purl": "pkg:npm/lodash@4.17.4"}},
        {"id": "left-pad@1.3.0", "name": "left-pad", "version": "1.3.0",
         "licenses": ["WTFPL", "AGPL-3.0"],
         "identifier": {"purl": "pkg:npm/left-pad@1.3.0"}}]}],
    "licenses": [{"type": "license-file", "file_path": "LICENSE",
                  "findings": [{"name": "GPL-3.0", "confidence": 0.98,
                                "link": "https://spdx.org/licenses/"
                                        "GPL-3.0.html"}]}]}


@contextlib.contextmanager
def two_servers(db: str):
    """A live port server and a live reference server on DB directory
    `db`, each on a cache of its own."""
    with live(Server, MatchEngine(AdvisoryDB.load(db), device="cpu"),
              MemoryCache()) as port, \
            live(JaxServer, JaxEngine(JaxAdvisoryDB.load(db),
                                      use_device=False),
                 JaxMemoryCache()) as ref:
        yield port, ref


@pytest.mark.parametrize("ctype", [twirp.PROTO_CT, twirp.JSON_CT],
                         ids=["proto", "json"])
def test_twirp_scan_naming_license_equals_reference(lic_env, ctype):
    """A hand-rolled Twirp client puts a blob with declared and loose
    licenses and asks for `vuln,license`: a port server answers with the
    reference server's bytes, license results included."""
    def enc(name, doc):
        if ctype == twirp.PROTO_CT:
            return twirp.encode_message(name, doc)
        return json.dumps(twirp.to_json_obj(name, doc)).encode()

    calls = [
        ("/twirp/trivy.cache.v1.Cache/PutBlob",
         enc("PutBlobRequest", {"diff_id": "sha256:l1",
                                "blob_info": LICENSED_BLOB})),
        ("/twirp/trivy.scanner.v1.Scanner/Scan",
         enc("ScanRequest", {"target": "app", "artifact_id": "sha256:a",
                             "blob_ids": ["sha256:l1"],
                             "options": {"scanners": ["vuln", "license"]}})),
    ]
    with two_servers(lic_env["db"]) as (port, ref):
        for path, body in calls:
            got = _twirp_post(port.address, path, body, ctype)
            want = _twirp_post(ref.address, path, body, ctype)
            assert got == want, path
    assert got[0] == 200
    reply = twirp.decode_message("ScanResponse", got[2]) \
        if ctype == twirp.PROTO_CT else json.loads(got[2])
    text = json.dumps(reply)
    assert "AGPL-3.0" in text and "GPL-3.0" in text and "WTFPL" in text


@pytest.mark.parametrize("pair", ["ref-client-port-server",
                                  "port-client-ref-server",
                                  "port-client-port-server"])
@pytest.mark.parametrize("full", [False, True], ids=["license",
                                                     "license-full"])
def test_client_server_license_scan_equals_reference(lic_env, tmp_path,
                                                     capsys, pair, full):
    """`fs --server` with `--scanners vuln,license`: each package's client
    against the other's server, and the port's against its own, print
    the reference client's report from the reference server."""
    common = ["fs", lic_env["tree"], "--format", "json", "--quiet",
              "--scanners", "vuln,secret,license"]
    if full:
        common.append("--license-full")
    with two_servers(lic_env["db"]) as (port, ref):
        want = scan(jax_main.main, common + [
            "--server", ref.address, "--cache-dir", str(tmp_path / "w")],
            capsys, jax_uuid)
        client, server = pair.split("-client-")
        addr = (port if server == "port-server" else ref).address
        if client == "ref":
            got = scan(jax_main.main, common + [
                "--server", addr, "--cache-dir", str(tmp_path / "g")],
                capsys, jax_uuid)
        else:
            got = scan(main, common + [
                "--server", addr, "--device", "cpu", "--cache-dir",
                str(tmp_path / "g")], capsys, port_uuid)
    assert got == want and want[0] == 0
    doc = json.loads(got[1])
    assert any(r["Class"] == "license-file" for r in doc["Results"])
    assert any(r["Class"] == "license" for r in doc["Results"])


# ------------------------------------------------------------ on a card


@pytest.mark.cuda
def test_cuda_license_scan_equals_cpu(lic_env, tmp_path, capsys):
    """On a card: `fs --scanners vuln,secret,license --license-full` with
    the match kernel and the secret screen on cuda:0 writes the report
    of `--device cpu`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    from trivy_tpu_torch.ops import match

    argv = ["fs", lic_env["tree"], "--db-path", lic_env["db"], "--format",
            "json", "--quiet", "--scanners", "vuln,secret,license",
            "--license-full"]
    want = scan(main, argv + ["--device", "cpu", "--cache-dir",
                              str(tmp_path / "c")], capsys, port_uuid)
    match.match_words.launches = 0
    got = scan(main, argv + ["--cache-dir", str(tmp_path / "g")], capsys,
               port_uuid)
    assert got == want and got[0] == 0
    assert match.match_words.launches > 0
    assert '"Class": "license-file"' in got[1]
