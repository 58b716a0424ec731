"""Port parity, the advisory DB's BoltDB reader and the `db` subcommand:
trivy_tpu_torch's `db/bolt.py`, `db/trivydb.py`, `AdvisoryDB.load` of a
`trivy.db` directory, and `python -m trivy_tpu_torch db
import|stats|import-java|download` against the JAX package's, on the
same seeded inputs. A DB imported by either package's CLI (from a JSON
dump, a BoltDB `trivy.db` or a DB directory) loads in the other with
equal stats and payloads; a java DB imported by the port answers the
jar lookups as the reference's does; `db download` installs a verified
generation (the layer fetched through a replaced `_fetch_layer`, or
from an in-process registry on localhost).

Payloads, advisories and lookups are compared exactly.
"""

import dataclasses
import gzip
import hashlib
import io
import json
import os
import random
import tarfile
import threading
import zipfile
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from trivy_tpu.cli import main as jax_main
from trivy_tpu.db import AdvisoryDB as JaxDB
from trivy_tpu.db import bolt as jax_bolt
from trivy_tpu.db import javadb as jax_javadb
from trivy_tpu.db import trivydb as jax_trivydb
from trivy_tpu.parsers import misc_lang as jax_misc
from trivy_tpu_torch.cli.main import main
from trivy_tpu_torch.db import AdvisoryDB, bolt, generations, javadb, oci
from trivy_tpu_torch.db import trivydb
from trivy_tpu_torch.parsers import misc_lang

SEED = 20261018
DB_FILE = "trivy_tpu.db.json.gz"


def seeded_tree(seed: int = SEED, n_pkgs: int = 120) -> dict:
    """A trivy-db shaped BoltDB tree: OS and language advisory buckets
    (fixed versions, vulnerable / patched ranges), vulnerability
    metadata, data sources, and the Red Hat CPE-entry buckets."""
    rng = np.random.default_rng(seed)
    os_buckets = ["alpine 3.18", "debian 11", "ubuntu 22.04"]
    lang_buckets = ["npm::GitHub Security Advisory npm",
                    "pip::GitHub Security Advisory pip"]
    tree: dict = {b: {} for b in os_buckets + lang_buckets}
    vulns: dict = {}
    for i in range(n_pkgs):
        bucket = (os_buckets + lang_buckets)[int(rng.integers(5))]
        pkg = f"pkg{i:03d}"
        advs = {}
        for _ in range(int(rng.integers(1, 4))):
            vid = f"CVE-2024-{int(rng.integers(10_000, 99_999))}"
            major, minor = int(rng.integers(0, 5)), int(rng.integers(0, 20))
            if "::" in bucket:
                doc = {"VulnerableVersions": [f"<{major}.{minor}.0"],
                       "PatchedVersions": [f"{major}.{minor}.0"]}
            else:
                doc = {"FixedVersion": f"{major}.{minor}-r{i % 7}"}
                if rng.random() < 0.2:
                    doc["Status"] = 3
            advs[vid] = json.dumps(doc).encode()
            vulns[vid] = json.dumps({
                "Title": f"issue {vid}",
                "Severity": ["LOW", "MEDIUM", "HIGH", "CRITICAL"][
                    int(rng.integers(4))],
                "CweIDs": [f"CWE-{int(rng.integers(1, 900))}"],
                "References": [f"https://example.com/{vid}"],
            }).encode()
        tree[bucket][pkg] = advs
    tree["vulnerability"] = vulns
    tree["data-source"] = {b: json.dumps({"ID": b.split("::")[0].split()[0],
                                          "Name": b, "URL": "https://x"}
                                         ).encode()
                           for b in lang_buckets + os_buckets[:1]}
    tree["Red Hat CPE"] = {
        "repository": {"rhel-8-for-x86_64-baseos-rpms": b"[0]"},
        "nvr": {"bash-4.4.20-1.el8": b"[0]"},
        "cpe": {"0": b'"cpe:/o:redhat:enterprise_linux:8::baseos"'},
    }
    tree["Red Hat"] = {"bash": {"RHSA-2024:0001": json.dumps({"Entries": [{
        "Affected": [0], "FixedVersion": "0:4.4.20-5.el8", "Status": 3,
        "Arches": ["x86_64"],
        "Cves": [{"ID": "CVE-2024-0042", "Severity": 2}]}]}).encode()}}
    # an unreadable advisory value is skipped, as trivy-db readers do
    tree["alpine 3.18"]["broken"] = {"CVE-2024-00001": b"not json"}
    return tree


def dump(db) -> dict:
    """Everything a DB holds, in one comparable document."""
    return {
        "stats": db.stats(),
        "buckets": {b: {n: [a.to_json() for a in advs]
                        for n, advs in sorted(pkgs.items())}
                    for b, pkgs in sorted(db.buckets.items())},
        "meta": {k: db.get_meta(k).to_json()
                 for k in sorted(db.metadata_bucket)},
        "redhat_cpe": db.redhat_cpe,
        "redhat_entries": db.redhat_entries,
    }


def payload(root: str) -> bytes:
    with open(os.path.join(root, DB_FILE), "rb") as f:
        return gzip.decompress(f.read())


# ------------------------------------------------------------ BoltDB


@pytest.mark.parametrize("page_size", [4096, 16384])
def test_bolt_writer_and_reader_equal_reference(tmp_path, page_size):
    tree = seeded_tree()
    ours, theirs = str(tmp_path / "p.db"), str(tmp_path / "j.db")
    bolt.write_bolt(ours, tree, page_size=page_size)
    jax_bolt.write_bolt(theirs, tree, page_size=page_size)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()

    def walk(db):
        out = {}
        for name, b in db.buckets():
            out[name] = ({k: v for k, v in b.pairs()},
                         {k: dict(s.pairs()) for k, s in b.sub_buckets()})
        return out

    for path in (ours, theirs):
        got, want = bolt.BoltDB(path), jax_bolt.BoltDB(path)
        assert got.page_size == want.page_size == page_size
        assert walk(got) == walk(want)
        assert got.bucket(b"alpine 3.18", b"broken").get(
            b"CVE-2024-00001") == b"not json"


def test_bolt_rejects_what_the_reference_rejects(tmp_path):
    path = tmp_path / "x.db"
    path.write_bytes(b"\0" * 8192)
    with pytest.raises(jax_bolt.BoltError):
        jax_bolt.BoltDB(str(path))
    with pytest.raises(bolt.BoltError):
        bolt.BoltDB(str(path))
    assert not trivydb.is_boltdb(str(path))
    assert trivydb.try_load(str(path)) is None


def test_load_trivy_db_equals_reference(tmp_path):
    path = str(tmp_path / "trivy.db")
    bolt.write_bolt(path, seeded_tree())
    assert trivydb.is_boltdb(path) and jax_trivydb.is_boltdb(path)
    got, want = trivydb.load_trivy_db(path), jax_trivydb.load_trivy_db(path)
    assert dump(got) == dump(want)
    assert got.stats()["advisories"] > 200
    # the Red Hat CPE entries expand into a plain bucket on load
    assert got.get_advisories("redhat 8", "bash")
    lang = got.get_advisories_prefix("npm::", next(iter(
        got.buckets["npm::GitHub Security Advisory npm"])))
    assert lang[0].data_source.id == "npm"


def test_advisory_db_load_reads_a_trivy_db_directory(tmp_path):
    """The port's AdvisoryDB.load reads a directory holding a BoltDB
    trivy.db and its metadata.json, as the reference's does."""
    root = tmp_path / "db"
    root.mkdir()
    bolt.write_bolt(str(root / "trivy.db"), seeded_tree())
    (root / "metadata.json").write_text(json.dumps({
        "Version": 2, "NextUpdate": "2024-01-02T00:00:00Z",
        "UpdatedAt": "2024-01-01T00:00:00Z"}))
    got, want = AdvisoryDB.load(str(root)), JaxDB.load(str(root))
    assert dump(got) == dump(want)
    assert got.meta.updated_at == want.meta.updated_at == \
        "2024-01-01T00:00:00Z"


# ----------------------------------------------------------- db import


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """One seeded advisory set in the three forms `db import` takes: a
    BoltDB trivy.db, a JSON dump (gzipped), and a saved DB directory."""
    tmp = tmp_path_factory.mktemp("sources")
    bolt_path = str(tmp / "trivy.db")
    bolt.write_bolt(bolt_path, seeded_tree())
    db = trivydb.load_trivy_db(bolt_path)
    blob = {"buckets": {b: {n: [a.to_json() for a in advs]
                            for n, advs in pkgs.items()}
                        for b, pkgs in db.buckets.items()},
            "vulnerability": {k: db.get_meta(k).to_json()
                              for k in db.metadata_bucket}}
    json_path = str(tmp / "dump.json.gz")
    with gzip.open(json_path, "wb") as f:
        f.write(json.dumps(blob).encode())
    db.save(str(tmp / "dir"))
    return {"bolt": bolt_path, "json": json_path, "dir": str(tmp / "dir")}


ENTRIES = {"jax": jax_main.main, "port": main}


def run_cli(entry, argv, capsys) -> tuple[int, str]:
    rc = ENTRIES[entry](argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("source", ["bolt", "json", "dir"])
def test_db_import_loads_in_both_packages(sources, tmp_path, capsys,
                                          source):
    roots = {}
    for entry in ENTRIES:
        roots[entry] = str(tmp_path / entry / "db")
        rc, _ = run_cli(entry, ["db", "import", sources[source],
                                "--db-path", roots[entry], "--quiet",
                                "--cache-dir", str(tmp_path / "c")], capsys)
        assert rc == 0
    # the two imports wrote the same payload ...
    assert payload(roots["port"]) == payload(roots["jax"])
    # ... and each loads in the other package alike
    docs = [dump(load(roots[e])) for e in ENTRIES
            for load in (AdvisoryDB.load, JaxDB.load)]
    assert all(d == docs[0] for d in docs)
    assert docs[0]["stats"]["advisories"] > 200
    # db stats prints the same document from either package
    outs = {e: run_cli(e, ["db", "stats", "--db-path", roots["port"],
                           "--quiet"], capsys) for e in ENTRIES}
    assert outs["port"] == outs["jax"]
    assert json.loads(outs["port"][1]) == docs[0]["stats"]


def test_db_import_defaults_to_the_cache_dir(sources, tmp_path, capsys):
    cache = str(tmp_path / "cache")
    assert main(["db", "import", sources["bolt"], "--cache-dir", cache,
                 "--quiet"]) == 0
    assert main(["db", "stats", "--cache-dir", cache, "--quiet"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats == JaxDB.load(os.path.join(cache, "db")).stats()


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_db_import_drops_the_last_good_link(sources, tmp_path, capsys,
                                            entry):
    """An import is the new truth: the last-good link a download left is
    removed, so readers load the imported DB (both packages alike)."""
    root = tmp_path / "db"
    old = root / "generations" / "sha256-old"
    old.mkdir(parents=True)
    JaxDB().save(str(old))
    os.symlink(os.path.relpath(old, root), root / "last-good")
    assert generations.resolve(str(root)) != str(root)
    rc, _ = run_cli(entry, ["db", "import", sources["json"], "--db-path",
                            str(root), "--quiet"], capsys)
    assert rc == 0
    assert not os.path.lexists(root / "last-good")
    assert generations.resolve(str(root)) == str(root)
    assert AdvisoryDB.load(str(root)).stats()["advisories"] > 200


def test_db_without_a_command_is_one_error_line(tmp_path, capsys):
    assert main(["db", "--cache-dir", str(tmp_path)]) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    errors = [ln for ln in captured.err.splitlines() if "ERROR" in ln]
    assert len(errors) == 1 and "usage" in errors[0]


def test_db_ignores_unported_scan_options_in_the_environment(
        sources, tmp_path, capsys, monkeypatch):
    """The refusal of unported scan options is for scans: `db` reads
    none of them, in the reference too."""
    monkeypatch.setenv("TRIVY_TPU_JOURNAL", "j.jsonl")
    monkeypatch.setenv("TRIVY_TPU_SERVER", "http://localhost:1")
    assert main(["db", "import", sources["json"], "--db-path",
                 str(tmp_path / "db"), "--quiet"]) == 0


# ---------------------------------------------------------- import-java


def _jar(entries: dict[str, bytes]) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, content in entries.items():
            zf.writestr(name, content)
    return buf.getvalue()


@pytest.fixture()
def java_dump(tmp_path):
    """Seeded jars and a JSONL sha1 -> GAV dump that knows most of them
    (one artifact id published by two groups; a few jars unknown)."""
    rng = random.Random(SEED)
    jars, lines = [], []
    for i in range(40):
        body = _jar({"META-INF/MANIFEST.MF":
                     f"Manifest-Version: 1.0\nBuilt-By: n{i}\n".encode(),
                     f"com/x/C{i}.class": rng.randbytes(64)})
        jars.append((f"lib/art{i % 30}-1.{i}.jar", body))
        if i % 8 != 7:
            lines.append({"groupId": f"org.g{i % 5}",
                          "artifactId": f"art{i % 30}",
                          "version": f"1.{i}",
                          "sha1": hashlib.sha1(body).hexdigest().upper()})
    lines.append({"groupId": "org.other", "artifactId": "art3",
                  "version": "1.3", "sha1": "0" * 40})
    lines.append({"groupId": "", "artifactId": "skipped", "version": "1",
                  "sha1": "1" * 40})  # incomplete rows are not imported
    path = tmp_path / "java.jsonl.gz"
    with gzip.open(path, "wt") as f:
        for e in lines:
            f.write(json.dumps(e) + "\n")
            f.write("\n")
    return {"path": str(path), "jars": jars}


def test_import_java_answers_jar_lookups_as_the_reference(
        java_dump, tmp_path, capsys):
    caches = {e: str(tmp_path / e) for e in ENTRIES}
    for e in ENTRIES:
        assert run_cli(e, ["db", "import-java", java_dump["path"],
                           "--cache-dir", caches[e], "--quiet"],
                       capsys)[0] == 0
    paths = {e: javadb.default_path(caches[e]) for e in ENTRIES}
    for e in ENTRIES:
        with open(os.path.join(os.path.dirname(paths[e]),
                               "metadata.json")) as f:
            assert json.load(f) == {"Version": javadb.SCHEMA_VERSION}
    port = javadb.JavaDB(paths["port"])
    ref = jax_javadb.JavaDB(paths["jax"])
    assert port.stats() == ref.stats() == {"artifacts": 36}
    found = 0
    for path, body in java_dump["jars"]:
        want = [dataclasses.asdict(p)
                for p in jax_misc.parse_jar(body, path, client=ref)]
        got = [dataclasses.asdict(p)
               for p in misc_lang.parse_jar(body, path, client=port)]
        # the reference reading the port's import answers alike too
        cross = [dataclasses.asdict(p) for p in jax_misc.parse_jar(
            body, path, client=jax_javadb.JavaDB(paths["port"]))]
        assert got == want == cross, path
        found += want[0]["name"].startswith("org.g")
    assert found == 35
    assert port.search_by_artifact_id("art3", "1.3") == \
        ref.search_by_artifact_id("art3", "1.3")


# ------------------------------------------------------------ download


def _db_layer_tgz(tmp_path, sources) -> bytes:
    d = tmp_path / "artifact"
    AdvisoryDB.load(sources["dir"]).save(str(d))
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name in sorted(os.listdir(d)):
            tf.add(str(d / name), arcname=name)
    return gzip.compress(buf.getvalue(), mtime=0)


def test_db_download_through_a_replaced_fetch(sources, tmp_path, capsys,
                                              monkeypatch):
    data = _db_layer_tgz(tmp_path, sources)
    digest = "sha256:" + hashlib.sha256(data).hexdigest()
    monkeypatch.setattr(oci, "_fetch_layer", lambda *a, **k: (data, digest))
    root = str(tmp_path / "db")  # download takes no --db-path
    assert main(["db", "download", "--cache-dir", str(tmp_path), "--quiet",
                 "--db-repository", "reg.invalid/db:2"]) == 0
    gen = os.path.join(root, "generations", generations.gen_name(digest))
    assert os.path.realpath(generations.resolve(root)) == \
        os.path.realpath(gen)
    assert dump(AdvisoryDB.load(root)) == dump(JaxDB.load(root))
    assert payload(gen) == payload(str(tmp_path / "artifact"))
    # a second download of the same digest is an idempotent promote
    assert oci.install_artifact("reg.invalid/db:2", root) == gen
    # an import then supersedes the downloaded generation
    assert main(["db", "import", sources["json"], "--db-path", root,
                 "--quiet"]) == 0
    assert not os.path.lexists(os.path.join(root, "last-good"))


def test_db_download_refuses_a_torn_blob(sources, tmp_path, monkeypatch,
                                         capsys):
    data = _db_layer_tgz(tmp_path, sources)
    layer = {"digest": "sha256:" + hashlib.sha256(data).hexdigest(),
             "size": len(data)}
    for torn in (data[:-1], data + b"x"):
        with pytest.raises(oci.OCIError):
            oci.verify_layer(layer, torn, ref="r")
    with pytest.raises(oci.OCIError, match="digest mismatch"):
        oci.verify_layer({"digest": layer["digest"]}, data + b"x")
    # an empty DB is never promoted
    empty = tmp_path / "empty"
    AdvisoryDB().save(str(empty))
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name in sorted(os.listdir(empty)):
            tf.add(str(empty / name), arcname=name)
    bad = gzip.compress(buf.getvalue(), mtime=0)
    monkeypatch.setattr(oci, "_fetch_layer", lambda *a, **k: (
        bad, "sha256:" + hashlib.sha256(bad).hexdigest()))
    root = str(tmp_path / "db")
    assert main(["db", "download", "--cache-dir", str(tmp_path)]) == 1
    assert "failed validation" in capsys.readouterr().err
    assert not os.path.lexists(os.path.join(root, "last-good"))


class _Registry(BaseHTTPRequestHandler):
    blobs: dict = {}
    manifest = b""

    def log_message(self, *a):
        pass

    def do_GET(self):
        if "/manifests/" in self.path:
            body, ctype = self.manifest, \
                "application/vnd.oci.image.manifest.v1+json"
        else:
            body = self.blobs.get(self.path.rsplit("/", 1)[1])
            ctype = "application/octet-stream"
        if body is None:
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_db_download_from_a_local_registry_equals_reference(
        sources, tmp_path, capsys):
    """The whole download path, the port's RegistryClient included,
    against an in-process registry on localhost: both packages install
    the same generation."""
    data = _db_layer_tgz(tmp_path, sources)
    digest = "sha256:" + hashlib.sha256(data).hexdigest()
    _Registry.blobs = {digest: data}
    _Registry.manifest = json.dumps({
        "schemaVersion": 2, "config": {"digest": "sha256:" + "0" * 64},
        "layers": [{"mediaType": oci.DB_MEDIA_TYPE, "digest": digest,
                    "size": len(data)}]}).encode()
    srv = HTTPServer(("127.0.0.1", 0), _Registry)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        ref = f"127.0.0.1:{srv.server_address[1]}/trivy-db:2"
        roots = {}
        for entry in ENTRIES:
            roots[entry] = str(tmp_path / entry / "db")
            rc, _ = run_cli(entry, ["db", "download", "--db-repository",
                                    ref, "--insecure", "--cache-dir",
                                    str(tmp_path / entry), "--quiet"],
                            capsys)
            assert rc == 0
    finally:
        srv.shutdown()
        srv.server_close()
    assert dump(AdvisoryDB.load(roots["port"])) == \
        dump(JaxDB.load(roots["jax"]))
    assert os.path.basename(os.path.realpath(
        generations.resolve(roots["port"]))) == generations.gen_name(digest)
