"""Plugins, modules and the host commands of the port (`plugin/`,
`module/`, `cli/run.py` `run_plugin`, `run_module`, `run_registry`,
`run_clean`, plugin mode and `--generate-default-config` in
`cli/main.py`) against the reference on the CPU.

The first part holds a counterpart for each case of
tests/test_plugin_module.py. The rest crosses the packages: a module
installed by either package's `module install` changes the other
package's scan in the same way (the JSON is equal), blob keys with a
module loaded equal the reference's, the registries are empty after a
scan that raised, a plugin installed by one package is listed and run by
the other, and `registry`, `clean` and `--generate-default-config` leave
the reference's bytes and trees. No test writes a real home: the trust
store, `DOCKER_CONFIG` and the cache directory point into `tmp_path`.
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import io
import json
import os
import shutil
import stat
import zipfile

import pytest
import test_fanal
import torch

import chip_smoke
from trivy_tpu.artifact.image import ImageArtifact as JaxImageArtifact
from trivy_tpu.cache.cache import MemoryCache as JaxMemoryCache
from trivy_tpu.cli import config as jax_config
from trivy_tpu.cli import main as jax_main
from trivy_tpu.cli import run as jax_run
from trivy_tpu.fanal import analyzer as jax_analyzer
from trivy_tpu.module import ModuleManager as JaxModuleManager
from trivy_tpu.plugin import PluginManager as JaxPluginManager
from trivy_tpu.scanner import post as jax_post
from trivy_tpu.utils import uuid as jax_uuid
from trivy_tpu_torch.artifact.image import ImageArtifact
from trivy_tpu_torch.artifact.image_source import _docker_config_auth
from trivy_tpu_torch.cache.cache import MemoryCache
from trivy_tpu_torch.cli import config, run
from trivy_tpu_torch.cli.main import KNOWN_COMMANDS, build_parser, main
from trivy_tpu_torch.fanal import analyzer
from trivy_tpu_torch.fanal.analyzer import AnalysisInput
from trivy_tpu_torch.fanal.analyzers import secret_analyzer
from trivy_tpu_torch.module import ModuleManager
from trivy_tpu_torch.plugin import PluginError, PluginManager
from trivy_tpu_torch.scanner import post
from trivy_tpu_torch.utils import uuid as port_uuid

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
def _isolated(tmp_path, monkeypatch):
    """Every shared file of both packages under tmp_path, and both
    packages' process-global registries checked empty after each test."""
    monkeypatch.setenv("TRIVY_TPU_TRUST_STORE",
                       str(tmp_path / "trust" / "modules.trust"))
    monkeypatch.setenv("DOCKER_CONFIG", str(tmp_path / "docker"))
    monkeypatch.setenv("TRIVY_TPU_CACHE_DIR", str(tmp_path / "home-cache"))
    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", FAKE_TIME)
    monkeypatch.setenv("TRIVY_TPU_DETERMINISTIC_UUID", "1")
    monkeypatch.setattr(secret_analyzer, "USE_DEVICE", "hybrid")
    monkeypatch.setattr(secret_analyzer, "DEVICE", None)
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()
    yield
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()
    assert registries_empty()


def registries_empty() -> bool:
    return not any(
        a.type.startswith("module:")
        for mod in (analyzer, jax_analyzer)
        for a in mod._ANALYZERS + mod._POST_ANALYZERS) \
        and post._HOOKS == [] and jax_post._HOOKS == []


# ------------------------------------------------ counterparts of the
# reference's cases (tests/test_plugin_module.py)

MANIFEST = """\
name: echo-plugin
version: "0.1.0"
summary: prints its arguments
platforms:
  - selector:
      os: linux
    uri: ./echo.sh
    bin: ./echo.sh
"""

SCRIPT = "#!/bin/sh\necho plugin-ran \"$@\" > \"$PLUGIN_OUT\"\n"


def _mk_plugin_dir(tmp_path):
    src = tmp_path / "src-plugin"
    src.mkdir(exist_ok=True)
    (src / "plugin.yaml").write_text(MANIFEST)
    (src / "echo.sh").write_text(SCRIPT)
    os.chmod(src / "echo.sh", 0o755)
    return str(src)


def _plugin_zip(tmp_path, manifest=MANIFEST, name="plugin.zip"):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("plugin.yaml", manifest)
        zf.writestr("echo.sh", SCRIPT)
    zpath = tmp_path / name
    zpath.write_bytes(buf.getvalue())
    return str(zpath)


class TestPluginManager:
    def test_install_from_dir_and_run(self, tmp_path, monkeypatch):
        mgr = PluginManager(str(tmp_path / "cache"))
        p = mgr.install(_mk_plugin_dir(tmp_path))
        assert p.name == "echo-plugin"
        assert [pl.name for pl in mgr.list()] == ["echo-plugin"]
        out = tmp_path / "out.txt"
        monkeypatch.setenv("PLUGIN_OUT", str(out))
        assert mgr.run("echo-plugin", ["hello", "world"]) == 0
        assert out.read_text().strip() == "plugin-ran hello world"

    def test_install_from_zip(self, tmp_path):
        mgr = PluginManager(str(tmp_path / "cache"))
        p = mgr.install(_plugin_zip(tmp_path))
        assert p.name == "echo-plugin"
        assert mgr.get("echo-plugin") is not None

    def test_zip_slip_rejected(self, tmp_path):
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as zf:
            zf.writestr("../evil.txt", "boom")
        zpath = tmp_path / "evil.zip"
        zpath.write_bytes(buf.getvalue())
        mgr = PluginManager(str(tmp_path / "cache"))
        with pytest.raises(PluginError, match="unsafe path"):
            mgr.install(str(zpath))
        assert not (tmp_path / "evil.txt").exists()

    def test_traversal_manifest_name_rejected(self, tmp_path):
        """A manifest name like ../../x must not escape the plugin
        root."""
        victim = tmp_path / "victim"
        victim.mkdir()
        (victim / "keep.txt").write_text("data")
        zpath = _plugin_zip(
            tmp_path, MANIFEST.replace("echo-plugin", "../../victim"),
            "evil-name.zip")
        mgr = PluginManager(str(tmp_path / "cache"))
        with pytest.raises(PluginError, match="invalid plugin name"):
            mgr.install(zpath)
        assert (victim / "keep.txt").exists()
        with pytest.raises(PluginError, match="invalid plugin name"):
            mgr.uninstall("../../victim")

    def test_dot_name_rejected(self, tmp_path):
        """'.' would resolve to the plugin root and remove every
        installed plugin; 'my..plugin' is a legal single component."""
        mgr = PluginManager(str(tmp_path / "cache"))
        mgr.install(_mk_plugin_dir(tmp_path))
        for bad in (".", ".."):
            with pytest.raises(PluginError, match="invalid plugin name"):
                mgr.uninstall(bad)
        assert [p.name for p in mgr.list()] == ["echo-plugin"]
        assert mgr.get("my..plugin") is None

    def test_uninstall(self, tmp_path):
        mgr = PluginManager(str(tmp_path / "cache"))
        mgr.install(_mk_plugin_dir(tmp_path))
        assert mgr.uninstall("echo-plugin") is True
        assert mgr.uninstall("echo-plugin") is False
        assert mgr.list() == []

    def test_platform_selector_mismatch(self, tmp_path):
        src = tmp_path / "p"
        src.mkdir()
        (src / "plugin.yaml").write_text(
            "name: winonly\nversion: '1'\nplatforms:\n"
            "  - selector: {os: windows}\n    uri: ./x.exe\n"
            "    bin: ./x.exe\n")
        mgr = PluginManager(str(tmp_path / "cache"))
        mgr.install(str(src))
        with pytest.raises(PluginError, match="does not support"):
            mgr.run("winonly", [])

    def test_cli_plugin_as_subcommand(self, tmp_path, monkeypatch):
        cache = tmp_path / "cache"
        monkeypatch.setenv("TRIVY_TPU_CACHE_DIR", str(cache))
        PluginManager(str(cache)).install(_mk_plugin_dir(tmp_path))
        out = tmp_path / "out.txt"
        monkeypatch.setenv("PLUGIN_OUT", str(out))
        assert main(["echo-plugin", "via-cli"]) == 0
        assert "plugin-ran via-cli" in out.read_text()


GOOD_MODULE = '''\
name = "spring4shell"
version = 1

def required(path):
    return path.endswith(".jar")

def analyze(path, content):
    if b"JndiLookup" in content:
        return {"vulnerable": True, "path": path}
    return None

def post_scan(results, options):
    for r in results:
        for v in getattr(r, "vulnerabilities", []):
            if v.vulnerability_id == "CVE-0000-0001":
                v.severity_source = "module"
    return results
'''


class TestModuleManager:
    def test_load_registers_and_unload_removes(self, tmp_path):
        mdir = tmp_path / "modules"
        mdir.mkdir()
        (mdir / "spring4shell.py").write_text(GOOD_MODULE)
        mgr = ModuleManager(str(mdir))
        assert mgr.load() == 1
        try:
            group = analyzer.AnalyzerGroup.build()
            assert any(a.type == "module:spring4shell"
                       for a in group.analyzers)
            assert len(post._HOOKS) == 1
        finally:
            mgr.unload()
        group = analyzer.AnalyzerGroup.build()
        assert not any(a.type.startswith("module:")
                       for a in group.analyzers)

    def test_module_analyze_emits_custom_resource(self, tmp_path):
        mdir = tmp_path / "modules"
        mdir.mkdir()
        (mdir / "spring4shell.py").write_text(GOOD_MODULE)
        mgr = ModuleManager(str(mdir))
        mgr.load()
        try:
            a = mgr._analyzers[0]
            assert a.required("lib/log4j.jar")
            assert not a.required("readme.md")
            res = a.analyze(AnalysisInput("lib/log4j.jar",
                                          b"...JndiLookup..."))
            assert res.custom_resources[0].data == {
                "vulnerable": True, "path": "lib/log4j.jar"}
            assert res.custom_resources[0].type == "module:spring4shell"
            assert a.analyze(AnalysisInput("lib/ok.jar", b"clean")) is None
        finally:
            mgr.unload()

    def test_broken_module_skipped(self, tmp_path):
        mdir = tmp_path / "modules"
        mdir.mkdir()
        (mdir / "broken.py").write_text("this is ( not python")
        (mdir / "good.py").write_text(GOOD_MODULE)
        mgr = ModuleManager(str(mdir))
        try:
            assert mgr.load() == 1
        finally:
            mgr.unload()

    def test_post_scan_hook_runs_in_scan(self, tmp_path, capsys):
        """A module's post_scan hook that injects a result is in the
        port CLI's report."""
        mdir = tmp_path / "modules"
        mdir.mkdir()
        (mdir / "injector.py").write_text('''\
name = "injector"
version = 1

def post_scan(results, options):
    from trivy_tpu_torch.types.report import Result
    results.append(Result(target="module-injected", result_class="custom"))
    return results
''')
        root = tmp_path / "scan-root"
        (root / "app").mkdir(parents=True)
        (root / "app" / "requirements.txt").write_text("flask==1.0\n")
        rc = main(["filesystem", str(root), "--format", "json",
                   "--cache-dir", str(tmp_path / "cache"),
                   "--module-dir", str(mdir), "--device", "cpu",
                   "--scanners", "vuln", "--quiet", "--list-all-pkgs"])
        assert rc == 0
        doc = json.loads(capsys.readouterr().out)
        assert "module-injected" in {r["Target"] for r in doc["Results"]}

    def test_cli_module_install_list_uninstall(self, tmp_path, capsys):
        src = tmp_path / "mymod.py"
        src.write_text(GOOD_MODULE)
        cache = str(tmp_path / "cache")
        assert main(["module", "install", str(src),
                     "--cache-dir", cache]) == 0
        capsys.readouterr()
        assert main(["module", "list", "--cache-dir", cache]) == 0
        assert "mymod.py" in capsys.readouterr().out
        assert main(["module", "uninstall", "mymod",
                     "--cache-dir", cache]) == 0
        assert not os.path.exists(os.path.join(cache, "modules",
                                               "mymod.py"))


INDEX_YAML = (
    "plugins:\n"
    "  - name: referrer\n"
    "    repository: localhost:5000/plugins/referrer:latest\n"
    "    summary: look up referrers\n"
    "  - name: count\n"
    "    repository: ghcr.io/org/count:1.0\n"
    "    summary: count findings\n")


class TestPluginIndexAndOCI:
    def test_index_search_and_resolution(self, tmp_path):
        mgr = PluginManager(str(tmp_path))
        assert mgr.index() == []
        os.makedirs(mgr.root, exist_ok=True)
        with open(mgr.index_path, "w") as f:
            f.write(INDEX_YAML)
        assert [p["name"] for p in mgr.index()] == ["referrer", "count"]
        assert [p["name"] for p in mgr.search("count")] == ["count"]
        assert mgr._resolve_index_name("referrer") == \
            "localhost:5000/plugins/referrer:latest"
        assert mgr._resolve_index_name("unknown") == "unknown"
        ref = JaxPluginManager(str(tmp_path))
        assert ref.search("") == mgr.search("")

    def test_oci_install_from_fake_registry(self, tmp_path):
        import gzip
        import http.server
        import tarfile
        import threading

        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tf:
            manifest_y = (
                "name: hello\nversion: 0.1.0\nsummary: test plugin\n"
                "platforms:\n  - selector: {os: linux, arch: amd64}\n"
                "    uri: ''\n    bin: ./hello.sh\n").encode()
            for fn, data in (("plugin.yaml", manifest_y),
                             ("hello.sh", b"#!/bin/sh\necho hi\n")):
                info = tarfile.TarInfo(fn)
                info.size = len(data)
                info.mode = 0o755
                tf.addfile(info, io.BytesIO(data))
        layer = gzip.compress(buf.getvalue())
        layer_digest = "sha256:" + hashlib.sha256(layer).hexdigest()
        manifest = json.dumps({
            "schemaVersion": 2,
            "layers": [{
                "mediaType": "application/vnd.oci.image.layer.v1.tar+gzip",
                "digest": layer_digest, "size": len(layer)}],
        }).encode()

        class H(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path.endswith("/manifests/latest"):
                    body, ctype = manifest, \
                        "application/vnd.oci.image.manifest.v1+json"
                elif self.path.endswith(f"/blobs/{layer_digest}"):
                    body, ctype = layer, "application/octet-stream"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        srv = http.server.ThreadingHTTPServer(("localhost", 0), H)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        try:
            port = srv.server_address[1]
            mgr = PluginManager(str(tmp_path))
            plugin = mgr.install(f"localhost:{port}/tools/hello:latest",
                                 insecure=True)
            assert plugin.name == "hello"
            assert os.path.exists(os.path.join(mgr._dir("hello"),
                                               "hello.sh"))
            assert mgr.get("hello") is not None
            # the staging directory is gone
            assert sorted(os.listdir(mgr.root)) == ["hello"]
        finally:
            srv.shutdown()
            srv.server_close()
            t.join(5)


class TestModuleTrustManifest:
    """The default cache-dir location executes only modules recorded in
    the operator trust store by `module install`; planted or tampered
    files are skipped. The store lives outside the module directory."""

    MOD = ("name = 'probe'\nversion = 1\n"
           "def post_scan(results, options):\n    return results\n")

    def test_manifest_in_module_dir_is_not_honored(self, tmp_path):
        mdir = tmp_path / "modules"
        mdir.mkdir()
        (mdir / "planted.py").write_text(self.MOD)
        digest = hashlib.sha256(self.MOD.encode()).hexdigest()
        (mdir / "TRUSTED").write_text(f"{digest} {mdir / 'planted.py'}\n")
        mgr = ModuleManager(str(mdir), require_manifest=True)
        try:
            assert mgr.load() == 0
        finally:
            mgr.unload()

    def test_planted_module_is_not_loaded(self, tmp_path):
        mdir = tmp_path / "modules"
        mdir.mkdir()
        (mdir / "planted.py").write_text(self.MOD)
        mgr = ModuleManager(str(mdir), require_manifest=True)
        try:
            assert mgr.load() == 0
        finally:
            mgr.unload()

    def test_installed_module_loads_until_tampered(self, tmp_path):
        mdir = tmp_path / "modules"
        mdir.mkdir()
        (mdir / "good.py").write_text(self.MOD)
        ModuleManager.record_trust(str(mdir), "good.py")
        mgr = ModuleManager(str(mdir), require_manifest=True)
        try:
            assert mgr.load() == 1
        finally:
            mgr.unload()
        (mdir / "good.py").write_text(self.MOD + "# changed\n")
        mgr2 = ModuleManager(str(mdir), require_manifest=True)
        try:
            assert mgr2.load() == 0
        finally:
            mgr2.unload()

    def test_revoke_trust(self, tmp_path):
        mdir = tmp_path / "modules"
        mdir.mkdir()
        (mdir / "good.py").write_text(self.MOD)
        ModuleManager.record_trust(str(mdir), "good.py")
        ModuleManager.revoke_trust(str(mdir), "good.py")
        mgr = ModuleManager(str(mdir), require_manifest=True)
        try:
            assert mgr.load() == 0
        finally:
            mgr.unload()

    def test_explicit_dir_loads_without_manifest(self, tmp_path):
        mdir = tmp_path / "dev-modules"
        mdir.mkdir()
        (mdir / "dev.py").write_text(self.MOD)
        mgr = ModuleManager(str(mdir))
        try:
            assert mgr.load() == 1
        finally:
            mgr.unload()


# ------------------------------------------------- across the packages

# a module either package runs: its post_scan builds results of the
# package that called it
PROBE_MODULE = '''\
import sys

name = "probe-mod"
version = 3
_SEEN = []

def required(path):
    return path.endswith(".ini")

def analyze(path, content):
    if b"token" in content:
        _SEEN.append(path)
        return {"path": path, "bytes": len(content)}
    return None

def post_scan(results, options):
    if not results:
        return results
    rep = sys.modules[type(results[0]).__module__]
    for r in results:
        for v in r.vulnerabilities:
            v.severity_source = "probe-mod"
    results.append(rep.Result(
        target="module:probe-mod", result_class="custom",
        custom_resources=[rep.CustomResource(
            type="module:probe-mod", file_path=p, data={"seen": True})
            for p in sorted(_SEEN)]))
    return results
'''

# planted beside it, never installed: must have no effect
UNTRUSTED_MODULE = '''\
name = "planted"
version = 1

def post_scan(results, options):
    results.clear()
    return results
'''

PKGS = {
    "ref": (jax_main.main, jax_uuid, []),
    "port": (main, port_uuid, ["--device", "cpu"]),
}


def scan(pkg, argv, capsys) -> tuple[int, str]:
    """(rc, stdout) of one package's CLI; the port's scans run on the
    CPU."""
    entry, uuid_mod, extra = PKGS[pkg]
    uuid_mod.reset()
    rc = entry(argv + (extra if argv[0] in ("fs", "image") else []))
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A small tree (an alpine root, npm and pip lockfiles, a secret,
    two .ini files the probe module reads) and the fixture DB."""
    tmp = tmp_path_factory.mktemp("modules")
    root = tmp / "tree"
    (root / "etc").mkdir(parents=True)
    (root / "etc" / "os-release").write_text(test_fanal.OS_RELEASE)
    (root / "lib" / "apk" / "db").mkdir(parents=True)
    (root / "lib" / "apk" / "db" / "installed").write_text(
        test_fanal.APK_INSTALLED)
    (root / "app").mkdir()
    (root / "app" / "package-lock.json").write_text(test_fanal.PACKAGE_LOCK)
    (root / "app" / "requirements.txt").write_text(test_fanal.REQUIREMENTS)
    (root / "app" / ".env").write_text(test_fanal.SECRET_FILE)
    (root / "app" / "settings.ini").write_text("[auth]\ntoken = abc\n")
    (root / "app" / "plain.ini").write_text("[ui]\ncolor = red\n")
    test_fanal._fixture_db().save(str(tmp / "db"))
    layer = chip_smoke.layer_tar([
        ("etc/os-release", test_fanal.OS_RELEASE),
        ("lib/apk/db/installed", test_fanal.APK_INSTALLED),
        ("app/settings.ini", "[auth]\ntoken = abc\n")])
    chip_smoke.write_image(str(tmp / "img.tar"), [layer],
                           [{"created_by": "COPY . /"}], "docker")
    src = tmp / "probe_mod.py"
    src.write_text(PROBE_MODULE)
    return {"root": str(root), "db": str(tmp / "db"),
            "tar": str(tmp / "img.tar"), "module": str(src)}


def fs_argv(env, cache) -> list[str]:
    return ["fs", env["root"], "--db-path", env["db"], "--format", "json",
            "--quiet", "--list-all-pkgs", "--scanners", "vuln,secret",
            "--cache-dir", str(cache)]


@pytest.mark.parametrize("installer", ["ref", "port"])
def test_module_installed_by_either_package_changes_both_scans(
        env, tmp_path, capsys, installer):
    """`module install` by one package into a shared cache and trust
    store, an untrusted module planted beside it: both packages' scans
    carry the trusted module's effect and not the planted one's, and
    their JSON is equal."""
    cache = tmp_path / "cache"
    bare = {pkg: scan(pkg, fs_argv(env, tmp_path / f"bare-{pkg}"), capsys)
            for pkg in PKGS}
    assert bare["port"] == bare["ref"] and bare["ref"][0] == 0
    assert scan(installer, ["module", "install", env["module"],
                            "--cache-dir", str(cache)], capsys)[0] == 0
    (cache / "modules" / "planted.py").write_text(UNTRUSTED_MODULE)
    got = {}
    for pkg in PKGS:
        got[pkg] = scan(pkg, fs_argv(env, cache), capsys)
        # the next package analyzes afresh: the blobs are not shared
        assert scan(pkg, ["clean", "--scan-cache", "--cache-dir",
                          str(cache)], capsys)[0] == 0
    assert got["port"] == got["ref"] and got["port"][0] == 0
    doc = json.loads(got["port"][1])
    mod = [r for r in doc["Results"] if r["Target"] == "module:probe-mod"]
    assert len(mod) == 1
    assert [c["FilePath"] for c in mod[0]["CustomResources"]] == \
        ["app/settings.ini"]
    sources = [v.get("SeveritySource") for r in doc["Results"]
               for v in r.get("Vulnerabilities") or []]
    assert sources and set(sources) == {"probe-mod"}
    assert got["port"][1] != bare["port"][1]
    # uninstalled by the other package: both scans are the bare ones
    other = "port" if installer == "ref" else "ref"
    assert scan(other, ["module", "uninstall", "probe_mod", "--cache-dir",
                        str(cache)], capsys)[0] == 0
    assert open(os.environ["TRIVY_TPU_TRUST_STORE"]).read() == ""
    for pkg in PKGS:
        shutil.rmtree(cache / "fanal", ignore_errors=True)
        assert scan(pkg, fs_argv(env, cache), capsys) == bare[pkg]


def test_module_dir_loads_both_modules_in_both_packages(env, tmp_path,
                                                       capsys):
    """`--module-dir` is operator intent: the untrusted module loads too
    (it clears the results), in both packages alike."""
    mdir = tmp_path / "mods"
    mdir.mkdir()
    shutil.copy(env["module"], mdir / "probe_mod.py")
    (mdir / "planted.py").write_text(UNTRUSTED_MODULE)
    got = {pkg: scan(pkg, fs_argv(env, tmp_path / pkg)
                     + ["--module-dir", str(mdir)], capsys)
           for pkg in PKGS}
    assert got["port"] == got["ref"] and got["port"][0] == 0
    assert json.loads(got["port"][1]).get("Results") in (None, [])


def _inspect(tar, with_module, mdir):
    out = {}
    for pkg, Art, Cache, Mgr in (
            ("port", ImageArtifact, MemoryCache, ModuleManager),
            ("ref", JaxImageArtifact, JaxMemoryCache, JaxModuleManager)):
        mgr = Mgr(str(mdir))
        if with_module:
            assert mgr.load() == 1
        try:
            ref = Art(tar, Cache(), from_tar=True,
                      disabled_analyzers={"config"}).inspect()
            out[pkg] = (ref.id, ref.blob_ids)
        finally:
            mgr.unload()
    return out


def test_blob_keys_equal_the_reference_with_a_module(env, tmp_path):
    """A loaded module's `module:<name>` analyzer and its version are in
    every blob and artifact key of both packages, and the keys are
    equal."""
    mdir = tmp_path / "mods"
    mdir.mkdir()
    shutil.copy(env["module"], mdir / "probe_mod.py")
    with_mod = _inspect(env["tar"], True, mdir)
    without = _inspect(env["tar"], False, mdir)
    assert with_mod["port"] == with_mod["ref"]
    assert without["port"] == without["ref"]
    assert with_mod["port"] != without["port"]
    groups = []
    for mod, Mgr in ((analyzer, ModuleManager),
                     (jax_analyzer, JaxModuleManager)):
        mgr = Mgr(str(mdir))
        mgr.load()
        try:
            groups.append(mod.AnalyzerGroup.build(
                disabled_types={"config"}).versions())
        finally:
            mgr.unload()
    assert groups[0] == groups[1] and groups[0]["module:probe-mod"] == 3


RAISING = '''\
name = "raiser"
version = 1

def required(path):
    return path.endswith(".ini")

def analyze(path, content):
    {analyze}

def post_scan(results, options):
    {post}
'''


@pytest.mark.parametrize("where", ["analyze", "post"])
def test_device_error_in_a_module_ends_the_scan(env, tmp_path, capsys,
                                                where):
    """A device error raised inside a module's hook is not swallowed by
    its wrapper: the scan ends with rc 1 and one ERROR line, and the
    registries are empty afterwards (checked by the autouse fixture).
    The reference logs and goes on (ROADMAP queue 3)."""
    mdir = tmp_path / "mods"
    mdir.mkdir()
    body = {"analyze": "return None", "post": "return results"}
    body[where] = ("from trivy_tpu_torch.device import DeviceError; "
                   "raise DeviceError('card lost')")
    (mdir / "raiser.py").write_text(RAISING.format(**body))
    rc, out = scan("port", fs_argv(env, tmp_path / "c")
                   + ["--module-dir", str(mdir)], capsys)
    assert rc == 1 and out == ""
    assert registries_empty()


@pytest.mark.parametrize("where", ["analyze", "post"])
def test_failing_module_is_logged_as_the_reference_does(env, tmp_path,
                                                        capsys, where):
    """Any other exception in a module's hook is logged and the scan
    goes on, in both packages alike."""
    mdir = tmp_path / "mods"
    mdir.mkdir()
    body = {"analyze": "return None", "post": "return results"}
    body[where] = "raise RuntimeError('module bug')"
    (mdir / "raiser.py").write_text(RAISING.format(**body))
    got = {pkg: scan(pkg, fs_argv(env, tmp_path / pkg)
                     + ["--module-dir", str(mdir)], capsys)
           for pkg in PKGS}
    assert got["port"] == got["ref"] and got["port"][0] == 0


def test_registries_empty_after_a_scan_that_raised(env, tmp_path, capsys,
                                                   monkeypatch):
    """A scan that raises past `run_scan` (here from the scanner itself)
    still unloads its modules."""
    mdir = tmp_path / "mods"
    mdir.mkdir()
    shutil.copy(env["module"], mdir / "probe_mod.py")

    def boom(args, compliance_spec):
        assert not registries_empty()
        raise RuntimeError("scan failed")

    monkeypatch.setattr(run, "_run_scan_core", boom)
    rc, out = scan("port", fs_argv(env, tmp_path / "c")
                   + ["--module-dir", str(mdir)], capsys)
    assert rc == 1 and out == ""
    assert registries_empty()


@pytest.mark.parametrize("installer", ["ref", "port"])
def test_plugin_installed_by_one_package_runs_in_the_other(
        tmp_path, capsys, monkeypatch, installer):
    cache = tmp_path / "cache"
    monkeypatch.setenv("TRIVY_TPU_CACHE_DIR", str(cache))
    other = "port" if installer == "ref" else "ref"
    src = _mk_plugin_dir(tmp_path) if installer == "ref" \
        else _plugin_zip(tmp_path)
    assert scan(installer, ["plugin", "install", src], capsys) == \
        (0, "installed echo-plugin 0.1.0\n")
    lists = {pkg: scan(pkg, ["plugin", "list"], capsys) for pkg in PKGS}
    assert lists["port"] == lists["ref"] == \
        (0, "echo-plugin\t0.1.0\tprints its arguments\n")
    infos = {pkg: scan(pkg, ["plugin", "info", "echo-plugin"], capsys)
             for pkg in PKGS}
    assert infos["port"] == infos["ref"] and infos["port"][0] == 0
    out = tmp_path / "out.txt"
    monkeypatch.setenv("PLUGIN_OUT", str(out))
    for pkg in PKGS:
        assert scan(pkg, ["plugin", "run", "echo-plugin", "a", "b"],
                    capsys)[0] == 0
        assert out.read_text() == "plugin-ran a b\n"
        out.unlink()
        # plugin mode: the plugin's name as the subcommand
        assert scan(pkg, ["echo-plugin", "--flag", "x"], capsys)[0] == 0
        assert out.read_text() == "plugin-ran --flag x\n"
        out.unlink()
    assert scan(other, ["plugin", "uninstall", "echo-plugin"],
                capsys)[0] == 0
    assert PluginManager(str(cache)).list() == []
    for pkg in PKGS:
        assert scan(pkg, ["plugin", "uninstall", "echo-plugin"],
                    capsys)[0] == 1


def test_plugin_mode_leaves_the_subcommands_alone(tmp_path, capsys,
                                                  monkeypatch):
    """A plugin named like a subcommand never shadows it, and a first
    argument that names neither goes to argparse as in the reference."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("TRIVY_TPU_CACHE_DIR", str(cache))
    src = tmp_path / "version-plugin"
    src.mkdir()
    (src / "plugin.yaml").write_text(MANIFEST.replace("echo-plugin",
                                                      "version"))
    (src / "echo.sh").write_text(SCRIPT)
    PluginManager(str(cache)).install(str(src))
    for pkg in PKGS:
        rc, out = scan(pkg, ["version"], capsys)
        assert rc == 0 and out.startswith("Version: ")
        with pytest.raises(SystemExit) as exc:
            scan(pkg, ["no-such-plugin"], capsys)
        assert exc.value.code == 2


def _subcommands(parser) -> set[str]:
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return set(sub.choices)


def test_parser_has_every_subcommand_of_the_reference():
    assert _subcommands(build_parser()) == \
        _subcommands(jax_main.build_parser())
    assert KNOWN_COMMANDS == _subcommands(build_parser())
    assert {"plugin", "module", "registry", "clean", "lint"} <= \
        KNOWN_COMMANDS
    assert config.UNPORTED == {} and config.K8S_UNPORTED == {}
    # the merged defaults the config layer reads equal the reference's
    ref = jax_config._all_defaults(jax_main.build_parser())
    port = config._all_defaults(build_parser())
    assert set(port) - set(ref) == {"device"}
    assert {k: port[k] for k in ref} == ref


# ------------------------------------------------ registry, clean and
# --generate-default-config


@pytest.mark.parametrize("how", ["flag", "stdin"])
def test_registry_login_logout_equal_the_reference(tmp_path, capsys,
                                                   monkeypatch, how):
    files = {}
    for pkg in PKGS:
        cfg = tmp_path / f"docker-{pkg}"
        monkeypatch.setenv("DOCKER_CONFIG", str(cfg))
        # an entry logged in before is kept
        assert scan(pkg, ["registry", "login", "-u", "x", "--password",
                          "y", "other.io"], capsys)[0] == 0
        argv = ["registry", "login", "--username", "alice"]
        if how == "flag":
            argv += ["--password", "s3cret"]
        else:
            argv += ["--password-stdin"]
            monkeypatch.setattr("sys.stdin", io.StringIO("s3cret\n"))
        assert scan(pkg, argv + ["ghcr.io"], capsys)[0] == 0
        path = cfg / "config.json"
        assert stat.S_IMODE(os.stat(path).st_mode) == 0o600
        login = path.read_bytes()
        if pkg == "port":
            assert _docker_config_auth("ghcr.io") == "Basic " + \
                base64.b64encode(b"alice:s3cret").decode()
        assert scan(pkg, ["registry", "logout", "ghcr.io"], capsys)[0] == 0
        logout = path.read_bytes()
        if pkg == "port":
            assert _docker_config_auth("ghcr.io") is None
            assert _docker_config_auth("other.io") == "Basic " + \
                base64.b64encode(b"x:y").decode()
        # a second logout warns and succeeds
        assert scan(pkg, ["registry", "logout", "ghcr.io"], capsys)[0] == 0
        files[pkg] = (login, logout, path.read_bytes())
    assert files["port"] == files["ref"]


def test_registry_login_without_password_fails(tmp_path, capsys,
                                               monkeypatch):
    for pkg in PKGS:
        monkeypatch.setattr("sys.stdin", io.StringIO(""))
        rc = scan(pkg, ["registry", "login", "-u", "bob", "ghcr.io"],
                  capsys)[0]
        assert rc == 1
        assert not os.path.exists(tmp_path / "docker" / "config.json")


def _cache_tree(root):
    for rel in ("fanal/blob/x.json", "db/trivy.json", "db/compiled/a.npz",
                "db/compiled-torch/a.npz", "javadb/javadb.sqlite",
                "modules/m.py", "plugin/p/plugin.yaml",
                "compiled-torch/nfa.npz"):
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(rel)


def _tree(root) -> list[str]:
    if not root.exists():
        return ["<gone>"]
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


@pytest.mark.parametrize("flags", [[], ["--scan-cache"], ["--vuln-db"],
                                   ["--java-db"], ["--vuln-db",
                                                   "--java-db"],
                                   ["--vuln-db", "--scan-cache"],
                                   ["--all"], ["-a", "--vuln-db"]],
                         ids=lambda f: " ".join(f) or "none")
def test_clean_leaves_the_reference_tree(tmp_path, capsys, flags):
    trees = {}
    for pkg in PKGS:
        root = tmp_path / pkg
        _cache_tree(root)
        entry = PKGS[pkg][0]
        assert entry(["clean", *flags, "--cache-dir", str(root)]) == 0
        trees[pkg] = _tree(root)
    assert trees["port"] == trees["ref"]
    if not flags or flags == ["--scan-cache"]:
        assert "fanal" not in trees["port"] and "db" in trees["port"]
    if "--vuln-db" in flags and "--all" not in flags:
        assert "db" not in trees["port"]


@pytest.mark.parametrize("config_flag", [[], ["--config", "my.yaml"]])
def test_generate_default_config_equals_the_reference(tmp_path, capsys,
                                                      monkeypatch,
                                                      config_flag):
    got = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        entry = PKGS[pkg][0]
        first = entry(["--generate-default-config", *config_flag])
        out = capsys.readouterr()
        second = entry(["--generate-default-config", *config_flag])
        again = capsys.readouterr()
        name = config_flag[1] if config_flag else "trivy-tpu.yaml"
        got[pkg] = (first, out.out, second, again.out, again.err,
                    sorted(os.listdir(d)), (d / name).read_bytes())
    assert got["port"] == got["ref"]
    assert got["port"][0] == 0 and got["port"][2] == 1
    assert "already exists" in got["port"][4]
    assert config.DEFAULT_CONFIG == jax_config.DEFAULT_CONFIG
