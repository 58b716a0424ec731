"""Module extension system (reference pkg/module: wazero-hosted WASM
custom analyzers/post-scanners, module.go:15-17, api/).

The reference embeds a WASM runtime because Go cannot hot-load Go; a
Python host hot-loads Python, so modules here are plain .py files in
<cache>/modules (or --module-dir).  The ABI mirrors the reference's
(api/module.go): a module exposes

    name = "happy-module"          # module identity
    version = 1                    # bumps invalidate analysis caches

    def required(path) -> bool          # which files it wants (optional)
    def analyze(path, content) -> dict | None
        # -> custom-resource payload attached to the blob (optional)
    def post_scan(results, options) -> results
        # -> mutate/extend scan results (optional)

Modules with `analyze` register a custom analyzer (type
"module:<name>"); modules with `post_scan` register a post-scan hook —
the same two registries the reference wires modules into
(module.go RegisterPostScanner + analyzer registration).

Copy of trivy_tpu/module/manager.py. The trust store, the manifest
format and `<cache>/modules` are the reference's, so a module installed
by either package loads in the other. One departure: where a module's
hook raises, the wrapper logs and goes on as the reference's does, but
a device error (`device.is_device_error`) passes up and ends the scan,
as it does from every other analyzer of the port.
"""

from __future__ import annotations

import hashlib
import os
import types

from trivy_tpu_torch.durability import atomic_write


def trust_store_path() -> str:
    """Operator-owned manifest location. Deliberately OUTSIDE the
    cache/modules directory: the threat model is an attacker who can
    write the shared cache, so a manifest living next to the modules
    would be forgeable (docs/adr/0001-module-sandboxing.md). Override
    with TRIVY_TPU_TRUST_STORE (tests, unusual homes)."""
    env = os.environ.get("TRIVY_TPU_TRUST_STORE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".config",
                        "trivy-tpu", "modules.trust")


def _read_manifest(path: str) -> dict[str, str]:
    """module absolute path -> expected sha256. Lines are
    '<sha256> <path>' where the path may contain spaces."""
    out: dict[str, str] = {}
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split(" ", 1)
                if len(parts) == 2 and parts[0] and parts[1]:
                    out[parts[1]] = parts[0]
    return out


def _write_manifest(path: str, entries: dict[str, str]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    body = "".join(f"{entries[name]} {name}\n" for name in sorted(entries))
    atomic_write(path, body.encode("utf-8"))

from trivy_tpu_torch.device import is_device_error
from trivy_tpu_torch.fanal.analyzer import (
    AnalysisResult,
    Analyzer,
    register,
    unregister,
)
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.scanner import post
from trivy_tpu_torch.types.artifact import CustomResource

_log = logger("module")


class _ModuleAnalyzer(Analyzer):
    """Wraps a module's analyze() as a fanal analyzer emitting
    CustomResources (reference serialize.AnalysisResult custom)."""

    def __init__(self, mod):
        self.mod = mod
        self.type = f"module:{mod.name}"
        self.version = getattr(mod, "version", 1)

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        fn = getattr(self.mod, "required", None)
        if fn is None:
            return False
        try:
            return bool(fn(path))
        except Exception as e:
            if is_device_error(e):
                raise
            _log.warn("module required() failed", module=self.mod.name,
                      err=str(e))
            return False

    def analyze(self, inp):
        try:
            data = self.mod.analyze(inp.path, inp.read())
        except Exception as e:
            if is_device_error(e):
                raise
            _log.warn("module analyze() failed", module=self.mod.name,
                      path=inp.path, err=str(e))
            return None
        if data is None:
            return None
        res = AnalysisResult()
        res.custom_resources = [CustomResource(
            type=self.type, file_path=inp.path, data=data)]
        return res


class ModuleManager:
    """Loads modules and registers their hooks; unload() reverses both
    (the reference keeps one wazero runtime per scan — here the
    registries are process-global, so tests must unload)."""

    def __init__(self, module_dir: str, require_manifest: bool = False):
        """require_manifest=True (the default cache-dir location) loads
        only modules recorded with a matching sha256 in the TRUSTED
        manifest written by `module install` — the cache directory is
        writable by more than the operator, so presence there is not
        consent to execute (docs/adr/0001-module-sandboxing.md). An
        explicit --module-dir is operator intent and loads as-is."""
        self.module_dir = module_dir
        self.require_manifest = require_manifest
        self.modules: list = []
        self._analyzers: list[_ModuleAnalyzer] = []
        self._hooks: list = []

    def load(self) -> int:
        if not os.path.isdir(self.module_dir):
            return 0
        trusted = _read_manifest(trust_store_path()) \
            if self.require_manifest else None
        for fname in sorted(os.listdir(self.module_dir)):
            if not fname.endswith(".py") or fname.startswith("_"):
                continue
            path = os.path.join(self.module_dir, fname)
            try:
                # read ONCE: the same bytes are hashed and executed, so
                # a file swapped mid-scan cannot pass the hash check
                # with different code (no TOCTOU window)
                with open(path, "rb") as f:
                    source = f.read()
                if trusted is not None:
                    digest = hashlib.sha256(source).hexdigest()
                    if trusted.get(os.path.abspath(path)) != digest:
                        _log.warn(
                            "skipping untrusted module (not recorded "
                            "in the trust store; use `module install`)",
                            path=path, store=trust_store_path())
                        continue
                mod = self._load_bytes(path, source)
            except Exception as e:
                _log.warn("module load failed", path=path, err=str(e))
                continue
            if not getattr(mod, "name", ""):
                mod.name = os.path.splitext(fname)[0]
            self.modules.append(mod)
            if callable(getattr(mod, "analyze", None)):
                analyzer = _ModuleAnalyzer(mod)
                register(analyzer)
                self._analyzers.append(analyzer)
            if callable(getattr(mod, "post_scan", None)):
                hook = self._wrap_post_scan(mod)
                post.register_post_scanner(hook)
                self._hooks.append(hook)
            _log.info("loaded module", name=mod.name,
                      version=getattr(mod, "version", 1))
        return len(self.modules)

    @staticmethod
    def record_trust(module_dir: str, filename: str) -> None:
        """Record a module's sha256 in the operator trust store
        (called by `module install`)."""
        store = trust_store_path()
        entries = _read_manifest(store)
        path = os.path.abspath(os.path.join(module_dir, filename))
        with open(path, "rb") as f:
            entries[path] = hashlib.sha256(f.read()).hexdigest()
        _write_manifest(store, entries)

    @staticmethod
    def revoke_trust(module_dir: str, filename: str) -> None:
        store = trust_store_path()
        entries = _read_manifest(store)
        path = os.path.abspath(os.path.join(module_dir, filename))
        if entries.pop(path, None) is not None:
            _write_manifest(store, entries)

    @staticmethod
    def _load_bytes(path: str, source: bytes):
        """Execute already-read module bytes (the ones that were
        hashed) in a fresh module namespace."""
        name = "trivy_tpu_module_" + \
            os.path.splitext(os.path.basename(path))[0]
        mod = types.ModuleType(name)
        mod.__file__ = path
        exec(compile(source, path, "exec"), mod.__dict__)
        return mod

    @staticmethod
    def _wrap_post_scan(mod):
        def hook(results, options):
            try:
                out = mod.post_scan(results, options)
                return results if out is None else out
            except Exception as e:
                if is_device_error(e):
                    raise
                _log.warn("module post_scan() failed", module=mod.name,
                          err=str(e))
                return results
        hook.__name__ = f"module:{mod.name}"
        return hook

    def unload(self) -> None:
        for a in self._analyzers:
            unregister(a)
        for h in self._hooks:
            post.unregister_post_scanner(h)
        self._analyzers.clear()
        self._hooks.clear()
        self.modules.clear()
