"""Subprocess plugin system (reference pkg/plugin):

- a plugin is a directory under <cache>/plugin/<name>/ with a
  `plugin.yaml` manifest {name, version, summary, platforms:
  [{selector: {os, arch}, uri, bin}]} (plugin.go:23-54)
- install from a local directory, a zip archive, or a URL
  (manager.go:99 install sources; the OCI source is network-gated)
- `trivy-tpu <plugin-name> args…` and `trivy-tpu plugin run` execute
  the selected platform binary as a subprocess (plugin.go:101)

Copy of trivy_tpu/plugin/manager.py: the same `<cache>/plugin/<name>`
layout and manifest, so a plugin installed by either package is listed
and run by the other. An OCI reference is pulled through the port's
own `artifact/image_source.py`.
"""

from __future__ import annotations

import os
import platform as _platform
import re
import shutil
import stat
import subprocess
import sys
import urllib.request
import zipfile
from dataclasses import dataclass, field

import yaml

from trivy_tpu_torch.durability import atomic_write
from trivy_tpu_torch.log import logger

_log = logger("plugin")


class PluginError(Exception):
    pass


@dataclass
class Platform:
    os: str = ""
    arch: str = ""
    uri: str = ""
    bin: str = ""


@dataclass
class Plugin:
    name: str = ""
    version: str = ""
    repository: str = ""
    summary: str = ""
    description: str = ""
    platforms: list[Platform] = field(default_factory=list)
    dir: str = ""

    @classmethod
    def from_manifest(cls, path: str) -> "Plugin":
        with open(path, "rb") as f:
            doc = yaml.safe_load(f) or {}
        plats = []
        for p in doc.get("platforms") or []:
            sel = p.get("selector") or {}
            plats.append(Platform(
                os=sel.get("os", ""), arch=sel.get("arch", ""),
                uri=p.get("uri", ""), bin=p.get("bin", "")))
        return cls(
            name=doc.get("name", ""),
            version=str(doc.get("version", "")),
            repository=doc.get("repository", ""),
            summary=doc.get("summary", "") or doc.get("usage", ""),
            description=doc.get("description", ""),
            platforms=plats,
            dir=os.path.dirname(path),
        )

    def select_platform(self) -> Platform:
        """First platform whose selector matches this host; empty
        selector fields are wildcards (reference plugin.go selector)."""
        host_os = sys.platform.replace("linux2", "linux")
        if host_os.startswith("linux"):
            host_os = "linux"
        host_arch = _platform.machine().lower()
        host_arch = {"x86_64": "amd64", "aarch64": "arm64"}.get(
            host_arch, host_arch)
        for p in self.platforms:
            if p.os and p.os != host_os:
                continue
            if p.arch and p.arch != host_arch:
                continue
            return p
        raise PluginError(
            f"plugin {self.name!r} does not support {host_os}/{host_arch}")

    def run(self, args: list[str], stdin=None) -> int:
        plat = self.select_platform()
        bin_path = os.path.join(self.dir, plat.bin)
        if not os.path.exists(bin_path):
            raise PluginError(f"plugin binary missing: {bin_path}")
        st = os.stat(bin_path)
        if not st.st_mode & stat.S_IXUSR:
            os.chmod(bin_path, st.st_mode | stat.S_IXUSR)
        proc = subprocess.run([bin_path, *args], stdin=stdin)
        return proc.returncode


_SAFE_NAME = re.compile(r"^[A-Za-z0-9._-]+$")


class PluginManager:
    def __init__(self, cache_dir: str):
        self.root = os.path.join(cache_dir, "plugin")

    def _dir(self, name: str) -> str:
        # the name may come from an untrusted zip/URL manifest; a name like
        # "../../target" would rmtree/copytree outside the plugin root
        if not _SAFE_NAME.match(name) or name in (".", ".."):
            raise PluginError(f"invalid plugin name {name!r}")
        return os.path.join(self.root, name)

    # ------------------------------------------------------------- list

    def list(self) -> list[Plugin]:
        out = []
        if not os.path.isdir(self.root):
            return out
        for name in sorted(os.listdir(self.root)):
            manifest = os.path.join(self.root, name, "plugin.yaml")
            if os.path.exists(manifest):
                try:
                    out.append(Plugin.from_manifest(manifest))
                except Exception as e:
                    _log.warn("bad plugin manifest", plugin=name, err=str(e))
        return out

    def get(self, name: str) -> Plugin | None:
        manifest = os.path.join(self._dir(name), "plugin.yaml")
        if not os.path.exists(manifest):
            return None
        return Plugin.from_manifest(manifest)

    # ---------------------------------------------------------- install

    DEFAULT_INDEX_URL = ("https://aquasecurity.github.io/"
                         "trivy-plugin-index/v1/index.yaml")

    @property
    def index_path(self) -> str:
        return os.path.join(self.root, "index.yaml")

    def update_index(self, url: str = "") -> None:
        """Download the plugin index (reference manager.go index.yaml)."""
        url = url or self.DEFAULT_INDEX_URL
        with urllib.request.urlopen(url, timeout=60) as resp:
            data = resp.read()
        os.makedirs(self.root, exist_ok=True)
        atomic_write(self.index_path, data)
        _log.info("plugin index updated", url=url)

    def index(self) -> list[dict]:
        """Cached index entries: [{name, repository, summary, ...}]."""
        if not os.path.exists(self.index_path):
            return []
        with open(self.index_path, encoding="utf-8") as f:
            doc = yaml.safe_load(f) or {}
        return doc.get("plugins") or []

    def search(self, keyword: str = "") -> list[dict]:
        kw = keyword.lower()
        return [p for p in self.index()
                if kw in (p.get("name", "") + p.get("summary", "")).lower()]

    def _resolve_index_name(self, name: str) -> str:
        """Bare plugin name -> its repository via the cached index
        (reference tryIndex, manager.go:101)."""
        for p in self.index():
            if p.get("name") == name and p.get("repository"):
                _log.info("plugin found in the index", name=name,
                          repository=p["repository"])
                return p["repository"]
        return name

    def install(self, source: str, insecure: bool = False) -> Plugin:
        """source: local dir with plugin.yaml, local .zip, http(s) URL to
        a zip, an OCI reference (registry/repo:tag), or a bare index name
        (reference manager.go:99)."""
        if os.path.isdir(source):
            return self._install_dir(source)
        if source.endswith(".zip") and os.path.exists(source):
            return self._install_zip(source)
        if source.startswith(("http://", "https://")):
            with urllib.request.urlopen(source, timeout=120) as resp:
                data = resp.read()
            tmp = os.path.join(self.root, ".download.zip")
            os.makedirs(self.root, exist_ok=True)
            # lint: allow[atomic-write] transient download buffer, consumed and unlinked in this call
            with open(tmp, "wb") as f:
                f.write(data)
            try:
                return self._install_zip(tmp)
            finally:
                os.unlink(tmp)
        if re.fullmatch(r"[A-Za-z0-9][A-Za-z0-9._-]*", source):
            source = self._resolve_index_name(source)
        if "/" in source:  # OCI reference
            return self._install_oci(source, insecure=insecure)
        raise PluginError(
            f"unsupported plugin source {source!r} "
            "(local dir, .zip, http(s) URL, OCI ref, or index name)")

    def _install_oci(self, ref: str, insecure: bool = False) -> Plugin:
        """Pull a plugin OCI artifact: every tar(.gz) layer unpacks into
        the staging dir, which must yield a plugin.yaml."""
        from trivy_tpu_torch.artifact.image_source import (
            RegistryClient,
            SourceError,
            parse_reference,
        )

        registry, repo, tag, digest = parse_reference(ref)
        tmp = os.path.join(self.root, ".oci-unpack")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        try:
            client = RegistryClient(registry, insecure=insecure)
            try:
                manifest, _ = client.manifest(repo, digest or tag)
            except SourceError as e:
                raise PluginError(f"plugin OCI manifest {ref}: {e}")
            import gzip as _gzip
            import io
            import tarfile

            for layer in manifest.get("layers") or []:
                try:
                    data = client.blob(repo, layer.get("digest", ""))
                except SourceError as e:
                    raise PluginError(f"plugin OCI blob {ref}: {e}")
                if data[:2] == b"\x1f\x8b":
                    data = _gzip.decompress(data)
                if not tarfile.is_tarfile(io.BytesIO(data)):
                    continue
                with tarfile.open(fileobj=io.BytesIO(data)) as tf:
                    try:
                        # the "data" filter rejects absolute paths, ..
                        # traversal and escaping links member-by-member
                        tf.extractall(tmp, filter="data")
                    except tarfile.TarError as e:
                        raise PluginError(
                            f"unsafe path in plugin layer: {e}")
            return self._install_dir(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def _install_dir(self, source: str) -> Plugin:
        manifest = os.path.join(source, "plugin.yaml")
        if not os.path.exists(manifest):
            raise PluginError(f"no plugin.yaml in {source}")
        plugin = Plugin.from_manifest(manifest)
        if not plugin.name:
            raise PluginError("plugin manifest has no name")
        dest = self._dir(plugin.name)
        if os.path.exists(dest):
            shutil.rmtree(dest)
        shutil.copytree(source, dest)
        plugin.dir = dest
        _log.info("installed plugin", name=plugin.name,
                  version=plugin.version)
        return plugin

    def _install_zip(self, source: str) -> Plugin:
        tmp = os.path.join(self.root, ".unpack")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        try:
            with zipfile.ZipFile(source) as zf:
                for info in zf.infolist():
                    # zip-slip guard
                    dest = os.path.realpath(os.path.join(tmp, info.filename))
                    if not dest.startswith(os.path.realpath(tmp) + os.sep):
                        raise PluginError(
                            f"unsafe path in plugin zip: {info.filename}")
                zf.extractall(tmp)
            # manifest may live at the top or in a single subdirectory
            root = tmp
            if not os.path.exists(os.path.join(root, "plugin.yaml")):
                entries = [e for e in os.listdir(root)
                           if os.path.isdir(os.path.join(root, e))]
                if len(entries) == 1:
                    root = os.path.join(root, entries[0])
            return self._install_dir(root)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def uninstall(self, name: str) -> bool:
        dest = self._dir(name)
        if not os.path.exists(dest):
            return False
        shutil.rmtree(dest)
        _log.info("uninstalled plugin", name=name)
        return True

    # --------------------------------------------------------------- run

    def run(self, name: str, args: list[str], stdin=None) -> int:
        plugin = self.get(name)
        if plugin is None:
            raise PluginError(f"plugin {name!r} is not installed")
        return plugin.run(args, stdin=stdin)
