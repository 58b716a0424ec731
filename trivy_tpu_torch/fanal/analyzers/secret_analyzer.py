"""Secret analyzer (reference pkg/fanal/analyzer/secret/secret.go), as a
BATCH post-analyzer: files are collected during the walk and scanned in one
device anchor-screen pass + host regex on candidates, instead of the
reference's per-file loop.

Copy of trivy_tpu/fanal/analyzers/secret_analyzer.py. The scanner runs
on the torch device the CLI publishes in `DEVICE` (``cuda:0`` unless
``--device`` names another), and the warm scanner is kept per (config
path, device), so a scanner built for one device never answers a scan
on another.

The analyzer is one instance per process, so the walk lanes of an image
scan call `post_analyze` on it at once: its scanner is built under a
lock, and what each call spent (`last_scan()`) is kept per thread, so
each lane reads its own call's seconds and device stats.
"""

from __future__ import annotations

import os
import threading
import time

from trivy_tpu_torch.fanal.analyzer import (
    AnalysisInput,
    AnalysisResult,
    PostAnalyzer,
    register_post,
)
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.ops.secret_nfa import KERNEL_VERSION
from trivy_tpu_torch.secret.scanner import SecretConfig, SecretScanner

_log = logger("secret")

WARN_SIZE = 10 * 1024 * 1024  # reference secret.go:110

_SKIP_DIRS = ("node_modules/.cache/", ".git/", "usr/share/doc/")
_SKIP_FILES = {"go.sum", "package-lock.json", "yarn.lock", "pnpm-lock.yaml",
               "Pipfile.lock", "poetry.lock", "Cargo.lock", "composer.lock"}

# module-level toggles set by the CLI per invocation. USE_DEVICE: False
# under --no-tpu (the host path), else "hybrid" (device batches dispatch
# first, async, then the host AC path scans the rest while the card
# computes; host-only when the device is the CPU or the one-shot probe
# finds the device share slower than it repays — see
# SecretScanner._scan_files_hybrid). DEVICE: the torch device of the
# screen (None = the scanner's default, cuda:0).
USE_DEVICE = "hybrid"
DEVICE = None


# bump on host-side semantic changes (rules, scanner behavior); the
# kernel component below covers device-screen changes
_ANALYZER_BASE = 1


@register_post
class SecretAnalyzer(PostAnalyzer):
    type = "secret"
    # the cache key must change when EITHER the host scanner or the
    # device screen's semantics do (reference invalidates on analyzer
    # version, cache/key.go; here the "analyzer" includes the anchor
    # kernel)
    version = _ANALYZER_BASE * 1000 + KERNEL_VERSION

    def __init__(self, config_path: str | None = None):
        self._scanner = None
        self._device = None
        self._config_path = config_path
        self._lock = threading.Lock()
        # per thread: the last post_analyze's seconds and what its scan
        # added to the scanner's device_stats
        self._last = threading.local()

    def _drop_scanner(self) -> None:
        """Forget the scanner (caller holds the lock), stopping its
        secret-lane scheduler thread."""
        if self._scanner is not None:
            self._scanner.close()
            self._scanner = None

    def close(self) -> None:
        """Stop the scanner's secret-lane thread (tests, embedding); the
        next scan builds a fresh scanner."""
        with self._lock:
            self._drop_scanner()

    @property
    def scanner(self) -> SecretScanner:
        with self._lock:
            if self._scanner is not None and self._device != DEVICE:
                self._drop_scanner()  # built for another device
            if self._scanner is None:
                cfg = None
                if self._config_path and os.path.exists(self._config_path):
                    cfg = SecretConfig.load(self._config_path)
                self._scanner = SecretScanner(cfg, device=DEVICE)
                self._device = DEVICE
            return self._scanner

    def configure(self, config_path: str | None) -> None:
        with self._lock:
            if config_path == self._config_path:
                return  # unchanged config keeps the warm scanner (and
                # its uploaded device bank) across scans
            self._config_path = config_path
            self._drop_scanner()

    def last_scan(self) -> tuple[float, dict]:
        """(seconds, device_stats added) of this thread's last
        post_analyze; (0.0, {}) before any."""
        return (getattr(self._last, "scan_s", 0.0),
                getattr(self._last, "device_stats", {}))

    def reset_last_scan(self) -> None:
        self._last.scan_s, self._last.device_stats = 0.0, {}

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        if os.path.basename(path) in _SKIP_FILES:
            return False
        # never scan the secret config itself: only the root-level file
        # named like the config (reference secret.go:175 compares
        # base(configPath) to the walked relative path)
        if self._config_path and \
                os.path.basename(self._config_path) == path:
            return False
        if any(s in path for s in _SKIP_DIRS):
            return False
        if self.scanner.skip_file(path):
            return False
        if size > WARN_SIZE:
            # the reference warns here and scans anyway (secret.go:110);
            # scan_files routes files over the threshold through the
            # streaming chunked path (byte-identical findings, bounded
            # window memory), so no warn-and-punt
            _log.debug("large file takes the streaming secret path",
                       path=path, size=size)
        return True

    def post_analyze(self, files: dict[str, AnalysisInput]) -> AnalysisResult | None:
        t0 = time.perf_counter()
        scanner = self.scanner
        batch = [(path, inp.read()) for path, inp in sorted(files.items())]
        with scanner.stats_scope() as added:
            secrets = scanner.scan_files(batch, use_device=USE_DEVICE)
        self._last.scan_s = time.perf_counter() - t0
        self._last.device_stats = added
        if not secrets:
            return None
        res = AnalysisResult()
        res.secrets = secrets
        return res
