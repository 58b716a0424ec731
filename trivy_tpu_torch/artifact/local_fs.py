"""Filesystem / rootfs artifact (reference pkg/fanal/artifact/local/fs.go):
one walker pass, a single pseudo-blob, then the standard driver path.
Lockfile analyzers are the point for `fs`; rootfs also enables the OS
package analyzers (reference pkg/commands/artifact/run.go:179-185).

Copy of trivy_tpu/artifact/local_fs.py without the `as_rootfs` and
`parallel` arguments, which the reference stores and never reads (the
per-command gating arrives as `disabled_analyzers`; the walk is
serial). `stats` keeps the seconds of the last inspect: the walk with
the per-file analyzers, and the post-analyzers; within those, the
config analyzer's seconds (`config_s`, when it ran), the secret
analyzer's scan seconds, what its scan added to the scanner's
`device_stats`, and the hybrid probe's verdict (None until a probe
ran).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time

from trivy_tpu_torch.artifact.base import ArtifactReference
from trivy_tpu_torch.fanal import analyzers  # noqa: F401  (registers analyzers)
from trivy_tpu_torch.fanal.analyzer import AnalysisResult, AnalyzerGroup
from trivy_tpu_torch.fanal.handlers import system_file_filter
from trivy_tpu_torch.fanal.walker import FSWalker
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.secret.scanner import hybrid_probe_state
from trivy_tpu_torch.utils import uuid as uuid_util

_log = logger("fs")


class FSArtifact:
    def __init__(
        self,
        path: str,
        cache,
        skip_files=None,
        skip_dirs=None,
        misconfig_only: bool = False,
        disabled_analyzers: set[str] | None = None,
        secret_config: str | None = None,
        file_patterns: list[str] | None = None,
        helm_overrides: dict | None = None,
    ):
        self.path = path
        self.cache = cache
        # --skip-files/--skip-dirs accept paths relative to the CWD or
        # absolute (reference fanal/artifact/local/fs.go buildPathsToSkip
        # rebases them onto the scan root); the walker matches scan-root-
        # relative paths
        self.walker = FSWalker(
            self._rebase_skips(path, skip_files or []),
            self._rebase_skips(path, skip_dirs or []))
        self.misconfig_only = misconfig_only
        self.disabled = set(disabled_analyzers or set())
        self.secret_config = secret_config
        self.file_patterns = file_patterns or []
        self.helm_overrides = helm_overrides
        self.stats: dict = {}

    @staticmethod
    def _rebase_skips(root: str, entries: list) -> list:
        base = os.path.abspath(root)
        out = []
        for e in entries:
            ab = os.path.abspath(e)
            if ab != base and ab.startswith(base + os.sep):
                out.append(os.path.relpath(ab, base))
            else:
                out.append(e)  # already scan-root-relative (or a glob)
        return out

    def _group(self) -> AnalyzerGroup:
        enabled = {"config"} if self.misconfig_only else None
        group = AnalyzerGroup.build(disabled_types=self.disabled,
                                    enabled_types=enabled,
                                    file_patterns=self.file_patterns,
                                    helm_overrides=self.helm_overrides)
        for a in group.analyzers + group.post_analyzers:
            if a.type == "config":
                a.reset_last_seconds()  # this scan's alone
            if a.type == "secret":
                a.reset_last_scan()  # this scan's alone
                if self.secret_config:
                    a.configure(self.secret_config)
        return group

    def inspect(self) -> ArtifactReference:
        t0 = time.perf_counter()
        group = self._group()
        result = AnalysisResult()
        post_files: dict = {}
        for inp in self.walker.walk(self.path):
            # analyze_file lazily reads ONLY files some analyzer requires;
            # release per-file content unless a post-analyzer collected it
            group.analyze_file(result, inp, post_files)
            if not any(
                inp.path in files for files in post_files.values()
            ):
                inp.content = None
        t1 = time.perf_counter()
        group.post_analyze(result, post_files)
        system_file_filter(result)
        blob = result.to_blob()
        self.stats = {"walk_s": t1 - t0,
                      "post_analyze_s": time.perf_counter() - t1}
        for a in group.post_analyzers:
            if a.type == "config":
                self.stats["config_s"] = a.last_seconds()
            if a.type == "secret":
                scan_s, added = a.last_scan()
                self.stats.update(secret_s=scan_s,
                                  secret_device_stats=added,
                                  secret_probe=hybrid_probe_state())

        # fs artifacts are keyed by a fresh UUID (reference fs.go:175-188):
        # local trees change without content hashes, so no blob reuse
        blob_id = "sha256:" + hashlib.sha256(
            uuid_util.new().encode()
        ).hexdigest()
        self.cache.put_blob(blob_id, dataclasses.asdict(blob))
        return ArtifactReference(
            name=self.path,
            type="filesystem",
            id=blob_id,
            blob_ids=[blob_id],
        )

    def clean(self, ref: ArtifactReference) -> None:
        self.cache.delete_blobs(ref.blob_ids)
