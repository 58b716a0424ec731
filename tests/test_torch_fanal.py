"""Port parity of the analysis engine under `fs` / `rootfs`: the port's
directory walker, analyzers, handlers, parsers, java-DB lookup and
compiled secret-NFA cache against the JAX package's, on the same
inputs. Nothing here needs a device, so every comparison is exact:
equal package lists, equal blobs, equal findings.

The seeded tree builder (`seeded_tree`, `seeded_db`) is shared with
tests/test_torch_fs.py.
"""

import dataclasses
import io
import json
import os
import sqlite3
import struct
import zipfile
import zlib
from pathlib import Path

import numpy as np
import pytest
import test_fanal
import test_misc_analyzers
import test_parsers_extra
import torch

from trivy_tpu.fanal import analyzer as jax_analyzer
from trivy_tpu.fanal import analyzers as jax_analyzers  # noqa: F401
from trivy_tpu.fanal import handlers as jax_handlers
from trivy_tpu.fanal import walker as jax_walker
from trivy_tpu.fanal.analyzers import misc as jax_misc
from trivy_tpu.fanal.analyzers import pkg_rpm as jax_rpm
from trivy_tpu.fanal.analyzers import secret_analyzer as jax_secret_an
from trivy_tpu.parsers import golang as jax_golang
from trivy_tpu.parsers import java_pom as jax_java_pom
from trivy_tpu.parsers import misc_lang as jax_misc_lang
from trivy_tpu.parsers import nodejs as jax_nodejs
from trivy_tpu.parsers import python as jax_python
from trivy_tpu.parsers import toml_compat as jax_toml
from trivy_tpu_torch.fanal import analyzer, handlers, walker
from trivy_tpu_torch.fanal import analyzers  # noqa: F401
from trivy_tpu_torch.fanal.analyzers import lang, misc, pkg_rpm
from trivy_tpu_torch.fanal.analyzers import secret_analyzer
from trivy_tpu_torch.parsers import golang, java_pom, misc_lang, nodejs
from trivy_tpu_torch.parsers import python as pyparse
from trivy_tpu_torch.parsers import toml_compat

SEED = 20261018
CHUNK = 16384  # the secret screen's chunk; plants straddle its cuts


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and idle OpenMP workers spin on cores their neighbours' timing
    tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_dicts(objs) -> list:
    return [dataclasses.asdict(o) if o is not None else None for o in objs]


# ------------------------------------------------------ rpm databases


RPM_STRING, RPM_INT32, RPM_STRING_ARRAY = 6, 4, 8


def rpm_header(name: str, version: str, release: str, arch: str = "x86_64",
               epoch: int | None = None, srpm: str | None = None,
               license: str = "MIT", files: tuple = ()) -> bytes:
    """An rpm header blob as an rpmdb stores it: index entries, then the
    data section (pkg_rpm.py's layout)."""
    entries = [(1000, RPM_STRING, name), (1001, RPM_STRING, version),
               (1002, RPM_STRING, release), (1022, RPM_STRING, arch),
               (1014, RPM_STRING, license)]
    if epoch is not None:
        entries.append((1003, RPM_INT32, [epoch]))
    if srpm:
        entries.append((1044, RPM_STRING, srpm))
    if files:
        dirs = sorted({os.path.dirname(f) + "/" for f in files})
        entries += [
            (1116, RPM_INT32,
             [dirs.index(os.path.dirname(f) + "/") for f in files]),
            (1117, RPM_STRING_ARRAY, [os.path.basename(f) for f in files]),
            (1118, RPM_STRING_ARRAY, dirs)]
    index, data = b"", b""
    for tag, typ, value in entries:
        if typ == RPM_INT32:
            data += b"\x00" * (-len(data) % 4)
            blob = struct.pack(f">{len(value)}i", *value)
            count = len(value)
        elif typ == RPM_STRING_ARRAY:
            blob = b"".join(v.encode() + b"\x00" for v in value)
            count = len(value)
        else:
            blob, count = value.encode() + b"\x00", 1
        index += struct.pack(">IIII", tag, typ, len(data), count)
        data += blob
    return struct.pack(">II", len(entries), len(data)) + index + data


def rpmdb_sqlite(tmp: Path, headers: list[bytes]) -> bytes:
    path = tmp / "rpmdb-build.sqlite"
    con = sqlite3.connect(path)
    con.execute("CREATE TABLE Packages (hnum INTEGER PRIMARY KEY, "
                "blob BLOB NOT NULL)")
    con.executemany("INSERT INTO Packages (blob) VALUES (?)",
                    [(h,) for h in headers])
    con.commit()
    con.close()
    raw = path.read_bytes()
    path.unlink()
    return raw


def rpmdb_bdb(headers: list[bytes], pagesize: int = 4096) -> bytes:
    """A BerkeleyDB hash file of one key/data pair per page (the layout
    pkg_rpm.read_bdb_rpmdb walks)."""
    meta = bytearray(pagesize)
    struct.pack_into("<I", meta, 12, 0x061561)
    struct.pack_into("<I", meta, 20, pagesize)
    pages = [bytes(meta)]
    for i, h in enumerate(headers):
        page = bytearray(pagesize)
        struct.pack_into("<H", page, 20, 2)  # two entries: key, data
        page[25] = 13  # P_HASH
        key_at = pagesize - 8
        data_at = key_at - 1 - len(h)
        struct.pack_into("<HH", page, 26, key_at, data_at)
        page[key_at] = 1
        struct.pack_into("<I", page, key_at + 1, i + 1)
        page[data_at] = 1  # H_KEYDATA
        page[data_at + 1: key_at] = h
        pages.append(bytes(page))
    return b"".join(pages)


RPM_HEADERS = [
    rpm_header("openssl-libs", "1.1.1k", "7.el8_6", epoch=1,
               srpm="openssl-1.1.1k-7.el8_6.src.rpm",
               files=("/usr/lib64/libssl.so.1.1",
                      "/usr/lib64/libcrypto.so.1.1")),
    rpm_header("bash", "4.4.20", "4.el8_6", srpm="bash-4.4.20-4.el8_6.src.rpm",
               license="GPLv3+", files=("/usr/bin/bash",)),
    rpm_header("tzdata", "2022a", "1.el8", arch="noarch"),
]


@pytest.mark.parametrize("flavor", ["sqlite", "bdb"])
def test_rpm_analyzer_both_rpmdb_formats(tmp_path, flavor):
    if flavor == "sqlite":
        path, raw = ("var/lib/rpm/rpmdb.sqlite",
                     rpmdb_sqlite(tmp_path, RPM_HEADERS))
    else:
        path, raw = "var/lib/rpm/Packages", rpmdb_bdb(RPM_HEADERS)
    want = jax_rpm.RpmAnalyzer().analyze(
        jax_analyzer.AnalysisInput(path, raw))
    got = pkg_rpm.RpmAnalyzer().analyze(analyzer.AnalysisInput(path, raw))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    names = [p.name for p in got.package_infos[0].packages]
    assert sorted(names) == ["bash", "openssl-libs", "tzdata"]
    assert "/usr/bin/bash" in got.system_installed_files


# ---------------------------------------------------------- parsers


PACKAGE_LOCK_V1 = json.dumps({"lockfileVersion": 1, "dependencies": {
    "express": {"version": "4.17.1", "requires": {"qs": "6.7.0"},
                "dependencies": {"qs": {"version": "6.7.0"}}},
    "mocha": {"version": "8.0.0", "dev": True}}}).encode()
YARN_LOCK = b'''# yarn lockfile v1

"lodash@^4.17.4", lodash@^4.17.5:
  version "4.17.4"
  resolved "https://registry.yarnpkg.com/lodash/-/lodash-4.17.4.tgz"

"@babel/core@^7.0.0":
  version "7.1.0"
  dependencies:
    lodash "^4.17.5"
'''
PNPM_LOCK = b"""lockfileVersion: '6.0'
packages:
  /lodash@4.17.4:
    dev: false
  /@types/node@18.0.0:
    dev: true
"""
PIPFILE_LOCK = json.dumps({"default": {"requests": {"version": "==2.19.0"}},
                           "develop": {"pytest": {"version": "==6.0.0"}}}
                          ).encode()
POETRY_LOCK = b'''[[package]]
name = "flask"
version = "2.0.0"
category = "main"

[package.dependencies]
jinja2 = ">=3.0"

[[package]]
name = "Jinja2"
version = "3.0.1"
category = "main"
'''
UV_LOCK = b'''version = 1

[[package]]
name = "app"
version = "0.1.0"
source = { editable = "." }
dependencies = [{ name = "idna" }]

[[package]]
name = "idna"
version = "3.4"
source = { registry = "https://pypi.org/simple" }
'''
GO_MOD = b"""module example.com/app

go 1.21

require (
\tgithub.com/pkg/errors v0.9.1
\tgolang.org/x/net v0.7.0 // indirect
)

replace golang.org/x/net => golang.org/x/net v0.8.0
"""
CARGO_LOCK = b'''[[package]]
name = "serde"
version = "1.0.160"
source = "registry+https://github.com/rust-lang/crates.io-index"

[[package]]
name = "app"
version = "0.1.0"
dependencies = ["serde"]
'''
COMPOSER_LOCK = json.dumps({
    "packages": [{"name": "guzzlehttp/guzzle", "version": "7.4.0",
                  "license": ["MIT"]}],
    "packages-dev": [{"name": "phpunit/phpunit", "version": "9.5.0"}],
}).encode()
GEMFILE_LOCK = b"""GEM
  remote: https://rubygems.org/
  specs:
    rack (2.2.3)
    rails (6.1.4)
      rack (~> 2.0)

PLATFORMS
  ruby
"""
DIST_METADATA = b"Metadata-Version: 2.1\nName: requests\nVersion: 2.19.0\n" \
    b"License: Apache 2.0\n"
NODE_PACKAGE_JSON = json.dumps({"name": "left-pad", "version": "1.3.0",
                                "license": "WTFPL"}).encode()
RUST_AUDIT = (b"\x7fELF" + b"\x00" * 32 + b".dep-v0\x00" + b"\x00" * 24
              + zlib.compress(json.dumps({"packages": [
                  {"name": "myapp", "version": "0.1.0", "root": True},
                  {"name": "serde", "version": "1.0.160"}]}).encode())
              + b"\x00" * 32)
NUGET_CONFIG = b"""<?xml version="1.0"?>
<packages>
  <package id="Newtonsoft.Json" version="13.0.1" />
  <package id="NUnit" version="3.13.3" developmentDependency="true" />
</packages>"""
NUGET_PROPS = b"""<Project><ItemGroup>
  <PackageVersion Include="Serilog" Version="3.0.1" />
  <PackageVersion Include="Skipped" Version="$(SerilogVersion)" />
</ItemGroup></Project>"""
CONDA_ENV = b"name: app\ndependencies:\n  - numpy=1.24.0\n  - pip:\n" \
    b"    - requests==2.19.0\n"

PARSER_CASES = [
    ("nodejs", "parse_package_lock", test_fanal.PACKAGE_LOCK.encode()),
    ("nodejs", "parse_package_lock", PACKAGE_LOCK_V1),
    ("nodejs", "parse_yarn_lock", YARN_LOCK),
    ("nodejs", "parse_pnpm_lock", PNPM_LOCK),
    ("nodejs", "parse_package_json", NODE_PACKAGE_JSON),
    ("python", "parse_requirements", test_fanal.REQUIREMENTS.encode()),
    ("python", "parse_pipfile_lock", PIPFILE_LOCK),
    ("python", "parse_poetry_lock", POETRY_LOCK),
    ("python", "parse_uv_lock", UV_LOCK),
    ("python", "parse_dist_metadata", DIST_METADATA),
    ("golang", "parse_go_mod", GO_MOD),
    ("golang", "parse_go_sum", b"github.com/pkg/errors v0.9.1 h1:abc=\n"
     b"golang.org/x/text v0.3.7/go.mod h1:xxx=\n"),
    ("java_pom", "parse_pom", test_parsers_extra.POM),
    ("java_pom", "parse_pom", b"garbage <<<"),
    ("misc_lang", "parse_cargo_lock", CARGO_LOCK),
    ("misc_lang", "parse_composer_lock", COMPOSER_LOCK),
    ("misc_lang", "parse_gemfile_lock", GEMFILE_LOCK),
    ("misc_lang", "parse_julia_manifest", test_parsers_extra.JULIA_17),
    ("misc_lang", "parse_wordpress_version",
     b"<?php\n$wp_version = '6.4.2';\n"),
    ("misc_lang", "parse_rust_binary", RUST_AUDIT),
    ("misc_lang", "parse_nuget_packages_config", NUGET_CONFIG),
    ("misc_lang", "parse_nuget_packages_props", NUGET_PROPS),
    ("misc_lang", "parse_conda_environment", CONDA_ENV),
]
PORT_PARSERS = {"nodejs": nodejs, "python": pyparse, "golang": golang,
                "java_pom": java_pom, "misc_lang": misc_lang}
JAX_PARSERS = {"nodejs": jax_nodejs, "python": jax_python,
               "golang": jax_golang, "java_pom": jax_java_pom,
               "misc_lang": jax_misc_lang}


@pytest.mark.parametrize(
    "module,func,content", PARSER_CASES,
    ids=[f"{m}.{f}-{i}" for i, (m, f, _c) in enumerate(PARSER_CASES)])
def test_parser_equals_reference(module, func, content):
    want = getattr(JAX_PARSERS[module], func)(content)
    got = getattr(PORT_PARSERS[module], func)(content)
    if not isinstance(want, list):
        want, got = [want], [got]
    assert as_dicts(got) == as_dicts(want)


def test_parser_shapes_of_reference_tests():
    """tests/test_parsers_extra.py's assertions, on the port's copies."""
    pkgs = {p.name: p.version for p in java_pom.parse_pom(
        test_parsers_extra.POM)}
    assert pkgs["com.example:myapp"] == "2.1.0"
    assert pkgs["org.springframework:spring-core"] == "5.3.20"
    assert pkgs["io.netty:netty-all"] == "4.1.77.Final"
    assert "junit:junit" not in pkgs and "com.unresolved:thing" not in pkgs
    byname = {p.name: p for p in misc_lang.parse_julia_manifest(
        test_parsers_extra.JULIA_17)}
    assert byname["JSON"].version == "0.21.4"
    assert byname["Dates"].version == "1.9.0"
    assert [(p.name, p.version) for p in
            misc_lang.parse_rust_binary(RUST_AUDIT)] == [("serde",
                                                          "1.0.160")]
    assert {p.name: p.dev for p in misc_lang.parse_nuget_packages_config(
        NUGET_CONFIG)} == {"Newtonsoft.Json": False, "NUnit": True}


@pytest.mark.parametrize("go_version,supplement", [("1.16", True),
                                                    ("1.21", False)])
def test_gomod_sum_supplement(go_version, supplement):
    gomod = (f"module example.com/app\n\ngo {go_version}\n\n"
             "require github.com/pkg/errors v0.9.1\n").encode()
    gosum = (b"github.com/pkg/errors v0.9.1 h1:a=\n"
             b"golang.org/x/text v0.3.7/go.mod h1:b=\n")

    def run(mod, an):
        files = {p: mod.AnalysisInput(p, c) for p, c in
                 (("app/go.mod", gomod), ("app/go.sum", gosum))}
        return an.GoModAnalyzer().post_analyze(files)

    from trivy_tpu.fanal.analyzers import lang as jax_lang

    want, got = run(jax_analyzer, jax_lang), run(analyzer, lang)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    names = {p.name for p in got.applications[0].packages}
    assert ("golang.org/x/text" in names) is supplement


TOML_DOCS = [
    '[[package]]\nname = "a"\nversion = "1.0"\n[package.dependencies]\n'
    'b = ">=2"\n[[package]]\nname = "b"\n'
    '[tool.poetry.group.dev.dependencies]\npytest = "^8.0"\n',
    "n = 42\nf = 1.5\nneg = -3\nok = true\narr = [\n  \"x\",  # c\n  'y',\n]"
    "\ntbl = { version = \"^1\", optional = true }\n"
    "esc = \"a\\tb\\u0041\"\nlit = 'c:\\path'\n",
    'a = """\nline1\nline2"""\n' "b = '''raw\n'quoted'\n'''\n",
]


@pytest.mark.parametrize("doc", TOML_DOCS)
def test_toml_compat_equals_reference(doc):
    assert toml_compat.loads(doc) == jax_toml.loads(doc)


@pytest.mark.parametrize("bad", ["key = ", "key", "[unclosed\n",
                                 'x = "open', "x = [1, 2", "d = 2024-01-01"])
def test_toml_compat_decode_errors(bad):
    with pytest.raises(jax_toml.TOMLDecodeError):
        jax_toml.loads(bad)
    with pytest.raises(toml_compat.TOMLDecodeError):
        toml_compat.loads(bad)


# ---------------------------------------------------- misc analyzers


MISC_CASES = [
    ("RpmqaAnalyzer", "var/lib/rpmmanifest/container-manifest-2",
     test_misc_analyzers.TestRpmqa.LINE.encode() + b"\nmalformed line\n", 0),
    ("ContentManifestAnalyzer",
     "root/buildinfo/content_manifests/ubi8.json",
     json.dumps({"content_sets": ["rhel-8-for-x86_64-baseos-rpms"]})
     .encode(), 0),
    ("RedHatDockerfileAnalyzer", "root/buildinfo/Dockerfile-ubi8-8.4-211",
     b'FROM sha256:123\nLABEL maintainer="Red Hat" \\\n'
     b'      com.redhat.component="ubi8-container" \\\n'
     b'      architecture="x86_64"\n', 0),
    ("RedHatDockerfileAnalyzer", "root/buildinfo/Dockerfile-x-1-1",
     b"FROM scratch\n", 0),
    ("ExecutableAnalyzer", "usr/bin/app", b"\x7fELF" + b"\x00" * 100,
     0o755),
    ("ExecutableAnalyzer", "usr/bin/script", b"#!/bin/sh\necho hi\n",
     0o755),
    ("SbomAnalyzer", "opt/bitnami/postgresql/.sbom.cdx.json",
     json.dumps(test_misc_analyzers.TestSbomInImage.CDX).encode(), 0),
    ("SbomAnalyzer", "x.cdx.json", b"{nope", 0),
]


@pytest.mark.parametrize("cls,path,content,mode", MISC_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(MISC_CASES)])
def test_misc_analyzer_equals_reference(cls, path, content, mode):
    """tests/test_misc_analyzers.py's shapes: required() and analyze()
    of the port's copy equal the reference's."""
    ref, port = getattr(jax_misc, cls)(), getattr(misc, cls)()
    for p, size in ((path, len(content)), ("etc/config.json", 10),
                    ("var/lib/rpm/Packages", 10)):
        assert port.required(p, size, mode) == ref.required(p, size, mode)
    want = ref.analyze(jax_analyzer.AnalysisInput(path, content,
                                                  len(content), mode))
    got = port.analyze(analyzer.AnalysisInput(path, content, len(content),
                                              mode))
    assert (got is None) == (want is None)
    if want is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ------------------------------------------------------ java DB lookup


@pytest.fixture()
def java_dbs(tmp_path):
    """The same sha1 -> GAV index in the reference's own schema (built
    with its JavaDB.create) and in the upstream trivy-java-db schema."""
    from trivy_tpu.db.javadb import JavaDB as JaxJavaDB

    entries = [
        {"groupId": "org.apache.logging.log4j", "artifactId": "log4j-core",
         "version": "2.14.1", "sha1": "A" * 40},
        {"groupId": "com.a", "artifactId": "dup", "version": "1.0",
         "sha1": "b" * 40},
        {"groupId": "com.b", "artifactId": "dup", "version": "1.0",
         "sha1": "c" * 40},
    ]
    own = str(tmp_path / "own" / "javadb.sqlite")
    db = JaxJavaDB.create(own)
    db.import_entries(entries)
    db.close()
    up = str(tmp_path / "upstream.sqlite")
    con = sqlite3.connect(up)
    con.executescript(
        "CREATE TABLE artifacts (id INTEGER PRIMARY KEY, group_id TEXT, "
        "artifact_id TEXT);"
        "CREATE TABLE indices (artifact_id INTEGER, version TEXT, "
        "sha1 BLOB, archive_type TEXT);")
    for i, e in enumerate(entries, 1):
        con.execute("INSERT INTO artifacts VALUES (?, ?, ?)",
                    (i, e["groupId"], e["artifactId"]))
        con.execute("INSERT INTO indices VALUES (?, ?, ?, 'jar')",
                    (i, e["version"], bytes.fromhex(e["sha1"])))
    con.commit()
    con.close()
    return {"own": own, "upstream": up}


@pytest.mark.parametrize("schema", ["own", "upstream"])
def test_javadb_lookup_equals_reference(java_dbs, schema):
    from trivy_tpu.db.javadb import JavaDB as JaxJavaDB
    from trivy_tpu_torch.db.javadb import JavaDB

    ref, port = JaxJavaDB(java_dbs[schema]), JavaDB(java_dbs[schema])
    for sha1 in ("a" * 40, "b" * 40, "d" * 40):
        want = ref.search_by_sha1(sha1)
        got = port.search_by_sha1(sha1)
        assert (got and dataclasses.astuple(got)) == \
            (want and dataclasses.astuple(want))
    for aid, ver in (("log4j-core", "2.14.1"), ("dup", "1.0"),
                     ("none", "1.0")):
        assert port.search_by_artifact_id(aid, ver) == \
            ref.search_by_artifact_id(aid, ver)
    assert port.stats() == ref.stats() == {"artifacts": 3}
    assert port.search_by_sha1("a" * 40).name == \
        "org.apache.logging.log4j:log4j-core"
    assert JavaDB(None).search_by_sha1("a" * 40) is None


def test_javadb_client_configure(java_dbs, tmp_path):
    from trivy_tpu_torch.db import javadb

    assert javadb.default_path(str(tmp_path)) == str(
        tmp_path / "javadb" / "javadb.sqlite")
    javadb.configure(java_dbs["own"])
    try:
        assert javadb.client().search_by_sha1("a" * 40).version == "2.14.1"
    finally:
        javadb.configure(None)
    assert javadb.client() is None


def _jar(entries: dict[str, bytes]) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, content in entries.items():
            zf.writestr(name, content)
    return buf.getvalue()


INNER_JAR = _jar({"META-INF/maven/org.dep/inner/pom.properties":
                  b"groupId=org.dep\nartifactId=inner\nversion=0.1\n"})
JAR_CASES = [  # tests/test_javadb.py's jar-identification shapes
    ("lib-1.2.3.jar", _jar({"META-INF/maven/org.example/lib/pom.properties":
                            b"groupId=org.example\nartifactId=lib\n"
                            b"version=1.2.3\n"})),
    ("unknown.jar", _jar({"x.class": b"\xca\xfe\xba\xbe"})),
    ("whatever.jar", _jar({"META-INF/MANIFEST.MF":
                           b"Manifest-Version: 1.0\nImplementation-Title: "
                           b"cool-lib\nImplementation-Version: 4.5.6\n"
                           b"Implementation-Vendor-Id: com.vendor\n"})),
    ("neat-2.0.jar", _jar({"x.class": b"zz"})),
    ("plain-3.1.4.jar", _jar({"x.class": b"zz"})),
    ("fat-1.0.jar", _jar({"META-INF/maven/org.app/fat/pom.properties":
                          b"groupId=org.app\nartifactId=fat\nversion=1.0\n",
                          "BOOT-INF/lib/inner-0.1.jar": INNER_JAR})),
]


@pytest.mark.parametrize("with_db", [False, True], ids=["no-db", "db"])
def test_jar_identification_equals_reference(tmp_path, with_db):
    """parse_jar and the jar analyzer over the java DB: sha1 lookup, the
    artifact-id heuristic, pom.properties, the manifest, the file name
    and inner jars, as the reference identifies them."""
    import hashlib

    from trivy_tpu.db import javadb as jax_javadb
    from trivy_tpu.fanal.analyzers import lang as jax_lang
    from trivy_tpu_torch.db import javadb

    path = str(tmp_path / "javadb.sqlite")
    db = jax_javadb.JavaDB.create(path)
    db.import_entries([
        {"groupId": "org.found", "artifactId": "via-sha1", "version": "9.9",
         "sha1": hashlib.sha1(JAR_CASES[1][1]).hexdigest()},
        {"groupId": "org.heuristic", "artifactId": "neat", "version": "2.0",
         "sha1": "9" * 40}])
    db.close()
    ref_client = jax_javadb.JavaDB(path) if with_db else None
    port_client = javadb.JavaDB(path) if with_db else None
    for name, jar in JAR_CASES:
        want = jax_misc_lang.parse_jar(jar, name, client=ref_client)
        got = misc_lang.parse_jar(jar, name, client=port_client)
        assert as_dicts(got) == as_dicts(want), name
    jax_javadb.configure(path if with_db else None)
    javadb.configure(path if with_db else None)
    try:
        for name, jar in JAR_CASES:
            p = f"app/lib/{name}"
            want = jax_lang.JarAnalyzer().analyze(
                jax_analyzer.AnalysisInput(p, jar, len(jar)))
            got = lang.JarAnalyzer().analyze(
                analyzer.AnalysisInput(p, jar, len(jar)))
            assert as_dicts([got]) == as_dicts([want]), name
    finally:
        jax_javadb.configure(None)
        javadb.configure(None)
    names = {p.name for _n, jar in JAR_CASES[1:2]
             for p in misc_lang.parse_jar(jar, "unknown.jar",
                                          client=port_client)}
    assert ("org.found:via-sha1" in names) is with_db


# --------------------------------------------------- walker, handlers


def _walk_keys(w, root) -> list:
    return [(i.path, i.size, i.read()) for i in w.walk(str(root))]


def test_walker_root_dotfiles_and_skips(tmp_path):
    """test_fanal.py::test_walker_root_dotfiles_and_whiteouts' shape on
    the directory walk: a root-level dotfile keeps its leading dot, a
    `.wh.` name is an ordinary file outside a layer, and the skip globs
    and default skip dirs prune alike."""
    root = tmp_path / "tree"
    for rel, content in [(".env", b"A=1"), (".wh.config", b""),
                         ("dir/.wh..wh..opq", b""), ("dir/a.txt", b"a"),
                         (".git/config", b"x"), ("sub/.git/HEAD", b"x"),
                         ("proc/1", b"x"), ("skip/me.py", b"x"),
                         ("keep/skip.py", b"x"), ("keep/ok.py", b"ok")]:
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(content)
    os.symlink("dir/a.txt", root / "link.txt")
    for skips in ({}, {"skip_files": ["keep/skip.py"], "skip_dirs": ["skip"]},
                  {"skip_files": ["*.txt"], "skip_dirs": ["**/dir"]}):
        want = _walk_keys(jax_walker.FSWalker(**skips), root)
        got = _walk_keys(walker.FSWalker(**skips), root)
        assert got == want
    paths = [p for p, _s, _c in _walk_keys(walker.FSWalker(), root)]
    assert paths[0] == ".env" and ".wh.config" in paths
    assert "link.txt" not in paths and not any(
        ".git" in p or p.startswith("proc/") for p in paths)


def test_system_file_filter_equals_reference():
    from trivy_tpu.types.artifact import Application as JaxApp
    from trivy_tpu.types.artifact import Package as JaxPkg
    from trivy_tpu_torch.types.artifact import Application, Package

    def build(mod, app_cls, pkg_cls):
        res = mod.AnalysisResult()
        res.system_installed_files = ["/usr/lib/node/x/package.json",
                                      "usr/lib/python3/requirements.txt"]
        res.applications = [
            app_cls(type="node-pkg", file_path="", packages=[
                pkg_cls(name="x", version="1", file_path=
                        "usr/lib/node/x/package.json"),
                pkg_cls(name="y", version="1", file_path="app/y.json")]),
            app_cls(type="pip", file_path="usr/lib/python3/requirements.txt",
                    packages=[pkg_cls(name="z", version="1")]),
            app_cls(type="npm", file_path="app/package-lock.json",
                    packages=[pkg_cls(name="w", version="1")]),
        ]
        return res

    want = build(jax_analyzer, JaxApp, JaxPkg)
    got = build(analyzer, Application, Package)
    jax_handlers.system_file_filter(want)
    handlers.system_file_filter(got)
    assert as_dicts(got.applications) == as_dicts(want.applications)
    assert [a.type for a in got.applications] == ["node-pkg", "npm"]


def test_uuid_source_is_deterministic_under_the_env(monkeypatch):
    from trivy_tpu_torch.utils import uuid as uuid_util

    monkeypatch.setenv("TRIVY_TPU_DETERMINISTIC_UUID", "1")
    uuid_util.reset()
    assert [uuid_util.new() for _ in range(2)] == [
        "00000000-0000-0000-0000-000000000001",
        "00000000-0000-0000-0000-000000000002"]
    monkeypatch.delenv("TRIVY_TPU_DETERMINISTIC_UUID")
    assert uuid_util.new() != uuid_util.new()


# ---------------------------------------------- the seeded scan tree


OS_RELEASE_DEBIAN = ('PRETTY_NAME="Debian GNU/Linux 11 (bullseye)"\n'
                     'NAME="Debian GNU/Linux"\nVERSION_ID="11"\n'
                     'VERSION="11 (bullseye)"\nID=debian\n')
UPPER_DIGITS = b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
ALNUM = UPPER_DIGITS + b"abcdefghijklmnopqrstuvwxyz"
CUSTOM_SECRET_CONFIG = """\
rules:
  - id: acme-deploy-token
    category: Custom
    title: ACME deploy token
    severity: HIGH
    regex: 'acme_dt_[0-9a-f]{24}'
    keywords: [acme_dt_]
allow-rules:
  - id: allow-fixtures
    description: planted fixture keys
    path: '.*fixtures/.*'
"""


def _tok(rng, alphabet: bytes, n: int) -> bytes:
    return bytes(alphabet[i] for i in rng.integers(0, len(alphabet), n))


def planted_secret(rng, n: int) -> bytes:
    kind = n % 4
    if kind == 0:
        return b"AKIA" + _tok(rng, UPPER_DIGITS, 16)
    if kind == 1:
        return b"ghp_" + _tok(rng, ALNUM, 36)
    if kind == 2:
        return b"glpat-" + _tok(rng, ALNUM, 20)
    return b"acme_dt_" + _tok(rng, b"0123456789abcdef", 24)


def source_text(rng, size: int) -> bytes:
    words = [b"buf", b"ctx", b"req", b"cfg", b"node", b"item", b"conn",
             b"user", b"value", b"path", b"size", b"data", b"client"]
    lines = []
    n = 0
    while n < size:
        w = [words[i] for i in rng.integers(0, len(words), 3)]
        line = b"    %s = %s.get_%s()" % tuple(w)
        lines.append(line)
        n += len(line) + 1
    return b"\n".join(lines)[:size]


def seeded_db(seed: int = SEED):
    """Advisories for the seeded tree's OS and lockfile packages (each
    name gets one or two; a share stays clean), with severities."""
    from trivy_tpu_torch.db import Advisory, AdvisoryDB, VulnerabilityMeta

    rng = np.random.default_rng(seed)
    db = AdvisoryDB()
    sevs = ["LOW", "MEDIUM", "HIGH", "CRITICAL"]
    n = 0

    def put(bucket, name, **kw):
        nonlocal n
        n += 1
        vid = f"CVE-2024-{10000 + n}"
        db.put_advisory(bucket, name, Advisory(vulnerability_id=vid, **kw))
        db.put_meta(VulnerabilityMeta(id=vid, title=f"{name} flaw",
                                      severity=sevs[n % 4]))

    for i in range(12):
        put("debian 11", f"deb-pkg-{i}",
            fixed_version=f"1.{i + int(rng.integers(0, 3))}.0-1")
    put("alpine 3.18", "musl", fixed_version="1.2.5-r0")
    for i in range(10):
        put("npm::g", f"npm-lib-{i}",
            vulnerable_versions=[f"<{1 + int(rng.integers(0, 3))}.5.0"])
    for i in range(8):
        put("pip::g", f"pip-lib-{i}",
            vulnerable_versions=[f"<={int(rng.integers(1, 4))}.1.0"])
    put("npm::g", "lodash", vulnerable_versions=["<4.17.12"])
    put("pip::g", "requests", vulnerable_versions=["<=2.19.1"])
    put("go::g", "github.com/pkg/errors", vulnerable_versions=["<0.9.2"])
    put("maven::g", "io.netty:netty-all",
        vulnerable_versions=["<4.1.86.Final"])
    put("cargo::g", "serde", vulnerable_versions=["<1.0.170"])
    put("composer::g", "guzzlehttp/guzzle", vulnerable_versions=["<7.4.5"])
    return db


def _dpkg_status(rng, n: int) -> str:
    out = []
    for i in range(n):
        ver = f"1.{int(rng.integers(0, 4))}.0-1"
        out.append(f"Package: deb-pkg-{i}\nStatus: install ok installed\n"
                   f"Architecture: amd64\nVersion: {ver}\n"
                   + (f"Source: deb-src-{i}\n" if i % 3 == 0 else "")
                   + "Maintainer: Debian <debian@example.org>\n")
    return "\n".join(out)


def _package_lock(rng, n: int) -> str:
    pkgs = {"": {"name": "app", "version": "1.0.0"}}
    for i in range(n):
        ver = f"{int(rng.integers(0, 4))}.{int(rng.integers(0, 9))}.0"
        pkgs[f"node_modules/npm-lib-{i}"] = {"version": ver,
                                             **({"dev": True} if i % 4 == 3
                                                else {})}
    pkgs["node_modules/lodash"] = {"version": "4.17.4"}
    return json.dumps({"name": "app", "lockfileVersion": 3,
                       "packages": pkgs}, indent=2)


def seeded_tree(root: Path, seed: int = SEED, big: bool = False) -> dict:
    """A seeded scan tree: a debian 11 root with apk, dpkg and rpm
    (sqlite) databases, one lockfile of each parser family, individual
    node and python packages, and source files with planted secrets,
    some across a 16 KiB chunk cut. With `big`, one file over the
    10 MiB stream threshold holds secrets across its 1 MiB cuts.
    -> {"planted": secrets per rule kind outside skipped places}."""
    rng = np.random.default_rng(seed)
    files: dict[str, bytes] = {
        "etc/os-release": OS_RELEASE_DEBIAN.encode(),
        "var/lib/dpkg/status": _dpkg_status(rng, 16).encode(),
        "lib/apk/db/installed": test_fanal.APK_INSTALLED.encode(),
        "app/package-lock.json": _package_lock(rng, 14).encode(),
        "app/yarn.lock": YARN_LOCK,
        "app/requirements-prod.txt": b"requests==2.19.1\n",
        "app/requirements.txt": "".join(
            f"pip-lib-{i}=={int(rng.integers(1, 4))}.{int(rng.integers(0, 3))}"
            f".0\n" for i in range(10)).encode() + b"requests==2.19.0\n",
        "py/poetry.lock": POETRY_LOCK,
        "go/go.mod": GO_MOD,
        "java/pom.xml": test_parsers_extra.POM,
        "rust/Cargo.lock": CARGO_LOCK,
        "php/composer.lock": COMPOSER_LOCK,
        "usr/lib/node_modules/left-pad/package.json": NODE_PACKAGE_JSON,
        "usr/lib/python3/site-packages/requests-2.19.0.dist-info/METADATA":
            DIST_METADATA,
        "trivy-secret.yaml": CUSTOM_SECRET_CONFIG.encode(),
        "conf/trivy-secret.yaml": b"token: acme_dt_" + b"ab" * 12 + b"\n",
    }
    planted: dict[str, int] = {}
    kinds = ["aws-access-key-id", "github-pat", "gitlab-pat",
             "acme-deploy-token"]
    n = 0
    for i in range(24):
        size = int(rng.integers(2_000, 40_000))
        body = bytearray(source_text(rng, size))
        spots = [int(rng.integers(0, size - 80))]
        if size > CHUNK + 100:
            spots.append(CHUNK - 20)  # across the first chunk cut
        for pos in spots:
            secret = planted_secret(rng, n)
            body[pos: pos + len(secret) + 2] = b"\n" + secret + b"\n"
            planted[kinds[n % 4]] = planted.get(kinds[n % 4], 0) + 1
            n += 1
        files[f"src/m{i:02d}.py"] = bytes(body)
    files["app/.env"] = test_fanal.SECRET_FILE.encode()
    planted["aws-access-key-id"] += 1
    planted["generic-password-assignment"] = 1
    # outside the count: skipped by --skip-dirs / --skip-files, or by an
    # allow rule of the custom config
    files["thirdparty/keys.py"] = b"k = 'AKIA" + _tok(rng, UPPER_DIGITS, 16) + \
        b"'\n"
    files["tools/gen.py"] = b"t = 'ghp_" + _tok(rng, ALNUM, 36) + b"'\n"
    files["fixtures/acme.txt"] = b"acme_dt_" + b"cd" * 12 + b"\n"
    if big:
        size = (10 << 20) + 300_000
        body = bytearray(source_text(rng, size))
        for k in range(1, 11):  # builtin kinds only, across each cut
            secret = planted_secret(rng, k % 3)
            pos = (k << 20) - len(secret) // 2
            body[pos - 1: pos + len(secret) + 1] = b"\n" + secret + b"\n"
            planted[kinds[k % 3]] += 1
        files["data/dump.sql"] = bytes(body)
    for rel, content in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(content)
    sqlite_path = root / "var/lib/rpm/rpmdb.sqlite"
    sqlite_path.parent.mkdir(parents=True, exist_ok=True)
    sqlite_path.write_bytes(rpmdb_sqlite(root, RPM_HEADERS))
    return {"planted": planted}


# ----------------------------------------------- the analyzer group


def _group_blob(mod_analyzer, mod_handlers, mod_walker, root, disabled,
                patterns=()) -> dict:
    group = mod_analyzer.AnalyzerGroup.build(
        disabled_types=disabled, file_patterns=list(patterns))
    for a in group.post_analyzers:
        if a.type == "secret":  # the CLI's default, as FSArtifact sets it
            a.configure("trivy-secret.yaml")
    result = mod_analyzer.AnalysisResult()
    post: dict = {}
    for inp in mod_walker.FSWalker().walk(str(root)):
        group.analyze_file(result, inp, post)
    group.post_analyze(result, post)
    mod_handlers.system_file_filter(result)
    return dataclasses.asdict(result.to_blob())


@pytest.mark.parametrize("kind", ["fs", "rootfs"])
def test_analyzer_group_equals_reference(tmp_path, monkeypatch, kind):
    """The whole walk + analyzer group + system-file filter over the
    seeded tree, with each command's gating: the port's blob equals the
    reference's (secrets on both packages' host paths)."""
    monkeypatch.setattr(secret_analyzer, "USE_DEVICE", False)
    monkeypatch.setattr(jax_secret_an, "USE_DEVICE", False)
    seeded_tree(tmp_path)
    disabled = {"config", "license-file"}
    if kind == "fs":
        disabled |= analyzer.TYPE_INDIVIDUAL_PKGS | {"sbom"}
    else:
        disabled |= analyzer.TYPE_LOCKFILES
    want = _group_blob(jax_analyzer, jax_handlers, jax_walker, tmp_path,
                       disabled, [r"pip:requirements\.txt$"])
    got = _group_blob(analyzer, handlers, walker, tmp_path, disabled,
                      [r"pip:requirements\.txt$"])
    assert got == want
    apps = {a["type"] for a in got["applications"]}
    if kind == "fs":
        assert {"npm", "yarn", "pip", "poetry", "gomod", "pom", "cargo",
                "composer"} <= apps
    else:
        assert {"node-pkg", "python-pkg"} <= apps
    assert {pi["file_path"] for pi in got["package_infos"]} == {
        "lib/apk/db/installed", "var/lib/dpkg/status",
        "var/lib/rpm/rpmdb.sqlite"}
    assert got["os"]["family"] == "debian" and got["secrets"]


def test_analyzer_versions_equal_reference():
    """The analyzer versions that feed blob-cache keys, the secret
    analyzer's among them (1000 + KERNEL_VERSION), equal the
    reference's: the port registers every type the reference does, the
    license-file analyzer included."""
    port = analyzer.AnalyzerGroup.build().versions()
    ref = jax_analyzer.AnalyzerGroup.build().versions()
    assert port["secret"] == ref["secret"] == 1003
    assert set(ref) - set(port) == set()
    assert port["license-file"] == ref["license-file"] == 1
    assert port == {t: v for t, v in ref.items() if t in port}
    assert analyzer.TYPE_LOCKFILES == jax_analyzer.TYPE_LOCKFILES
    assert analyzer.TYPE_OSES == jax_analyzer.TYPE_OSES
    assert analyzer.TYPE_INDIVIDUAL_PKGS == jax_analyzer.TYPE_INDIVIDUAL_PKGS


def test_secret_analyzer_keeps_a_scanner_per_device(monkeypatch):
    """A scanner built for one device never answers a scan on another;
    an unchanged device and config keep the warm scanner."""
    an = secret_analyzer.SecretAnalyzer()
    monkeypatch.setattr(secret_analyzer, "DEVICE", torch.device("cpu"))
    first = an.scanner
    assert an.scanner is first and first.device == torch.device("cpu")
    monkeypatch.setattr(secret_analyzer, "DEVICE", "cuda:0")
    second = an.scanner
    assert second is not first and second._device_arg == "cuda:0"
    an.configure(None)
    assert an.scanner is second
    an.configure("other.yaml")
    assert an.scanner is not second


def test_secret_analyzer_skips_root_config_and_skip_dirs():
    an, ref = secret_analyzer.SecretAnalyzer(), jax_secret_an.SecretAnalyzer()
    for a in (an, ref):
        a.configure("/somewhere/trivy-secret.yaml")
    for path in ("trivy-secret.yaml", "conf/trivy-secret.yaml",
                 "node_modules/.cache/x.js", "app/package-lock.json",
                 "img/logo.png", "src/a.py", "usr/share/doc/x/README"):
        assert an.required(path, 10) == ref.required(path, 10), path
    assert not an.required("trivy-secret.yaml", 10)
    assert an.required("conf/trivy-secret.yaml", 10)


# --------------------------------------------- compiled-NFA cache


def _secret_corpus(seed: int = SEED) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(6):
        body = bytearray(source_text(rng, 20_000))
        secret = planted_secret(rng, i)
        body[CHUNK - 10: CHUNK - 8 + len(secret)] = b"\n" + secret + b"\n"
        out.append((f"src/f{i}.py", bytes(body)))
    return out


def _keys(secrets) -> list:
    return [(s.file_path, f.rule_id, f.start_line, f.match)
            for s in secrets for f in s.findings]


def test_compiled_nfa_cache_hit_miss_and_corrupt_entry(tmp_path,
                                                       monkeypatch):
    from trivy_tpu_torch.secret import scanner as sc
    from trivy_tpu_torch.secret.scanner import SecretConfig, SecretScanner
    from trivy_tpu_torch.tensorize import cache

    monkeypatch.setattr(sc, "_CACHE_DIR_OVERRIDE", None)
    sc.set_cache_dir(str(tmp_path))
    corpus = _secret_corpus()
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(CUSTOM_SECRET_CONFIG)
    cfg = SecretConfig.load(str(cfg_path))

    first = SecretScanner(cfg, device="cpu")
    want = first.scan_files(corpus, use_device=True)
    assert first.program_source == "compiled" and len(_keys(want)) == 6
    digest = first._ruleset_digest()
    entry = Path(cache.nfa_entry_path(str(tmp_path), digest))
    assert entry.exists()
    assert entry.parent == tmp_path / "compiled-torch"

    warm = SecretScanner(cfg, device="cpu")
    hits = cache.NFA_COUNTS["hits"]
    assert warm.scan_files(corpus, use_device=True) == want
    assert warm.program_source == "cache"
    assert cache.NFA_COUNTS["hits"] == hits + 1
    # the build's seconds, a compile and save or a load, are recorded
    assert first.device_stats["program_s"] > 0
    assert warm.device_stats["program_s"] > 0
    assert warm._tiers["anchor_rules"] == first._tiers["anchor_rules"]
    assert warm._tiers["kw_ids"] == first._tiers["kw_ids"]

    # a corrupt entry is quarantined, counted a miss and recompiled
    entry.write_bytes(entry.read_bytes()[:-7] + b"garbage")
    misses = cache.NFA_COUNTS["misses"]
    again = SecretScanner(cfg, device="cpu")
    assert again.scan_files(corpus, use_device=True) == want
    assert again.program_source == "compiled"
    assert cache.NFA_COUNTS["misses"] == misses + 1
    assert list(tmp_path.glob("compiled-torch/*.quarantine"))
    assert entry.exists()  # the recompiled program was saved again

    # another ruleset keys another entry
    assert SecretScanner(device="cpu")._ruleset_digest() != digest
    sc.set_cache_dir(None)


def test_compiled_nfa_program_equals_reference_program(tmp_path,
                                                       monkeypatch):
    """The port's program round trip through its own entry gives the
    reference's compiled program; the two packages never read each
    other's entries."""
    from trivy_tpu.secret import scanner as jax_sc
    from trivy_tpu_torch.secret import scanner as sc

    monkeypatch.setattr(sc, "_CACHE_DIR_OVERRIDE", str(tmp_path))
    monkeypatch.setattr(jax_sc, "_CACHE_DIR_OVERRIDE", str(tmp_path))
    port = sc.SecretScanner(device="cpu")
    ref = jax_sc.SecretScanner()
    digest = port._ruleset_digest()
    assert digest == ref._ruleset_digest()
    port._save_program(digest, port._compile_program())
    loaded = port._load_program(digest)
    want = ref._compile_program()
    assert loaded["anchors"] == want["anchors"]
    assert loaded["kw_order"] == want["kw_order"]
    assert loaded["file_idx"] == want["file_idx"]
    assert loaded["always_idx"] == want["always_idx"]
    assert [[c.tolist() for c in r] for r in loaded["rows"]] == \
        [[c.tolist() for c in r] for r in want["rows"]]
    assert ref._load_program(digest) is None  # no entry under compiled/
    assert sorted(p.name for p in tmp_path.iterdir()) == ["compiled-torch"]
