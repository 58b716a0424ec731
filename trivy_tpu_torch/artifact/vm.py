"""VM-image artifact (reference pkg/fanal/artifact/vm): open the disk
(raw / partitioned / sparse VMDK, or an `ebs:snap-…`/`ami:ami-…`
snapshot streamed block-by-block through the EBS direct APIs), locate
supported filesystems, walk their files through the analyzer pipeline
as one pseudo-blob — same shape as the local-fs artifact but sourced
from the guest filesystem.

Copy of trivy_tpu/artifact/vm.py. `stats` keeps the seconds of the
last inspect, as the image artifact's do: the whole inspect
(`inspect_s`: the disk opened, the walks, the post-analyzers), the
guest walks with the per-file analyzers (`walk_s`), the post-analyzers
(`post_analyze_s`), the guest files analyzed (`walked_files`); within
those, the secret analyzer's scan seconds, what its scan added to the
scanner's `device_stats`, and the hybrid probe's verdict.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time

from trivy_tpu_torch.artifact.base import ArtifactReference
from trivy_tpu_torch.fanal import analyzers  # noqa: F401  (registers analyzers)
from trivy_tpu_torch.fanal.analyzer import (
    AnalysisInput,
    AnalysisResult,
    AnalyzerGroup,
)
from trivy_tpu_torch.fanal.handlers import system_file_filter
from trivy_tpu_torch.fanal.vm.disk import DiskError, find_filesystems, open_disk
from trivy_tpu_torch.fanal.vm.ext4 import Ext4, Ext4Error
from trivy_tpu_torch.fanal.vm.xfs import Xfs, XfsError
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.secret.scanner import hybrid_probe_state

_log = logger("vm")

MAX_FILE_SIZE = 256 * 1024 * 1024  # skip larger guest files

# guest filesystems we can walk: fstype -> (reader class, error class)
_FILESYSTEMS = {"ext4": (Ext4, Ext4Error), "xfs": (Xfs, XfsError)}


class VMError(Exception):
    pass


class VMArtifact:
    def __init__(
        self,
        target: str,
        cache,
        parallel: int = 5,
        disabled_analyzers: set[str] | None = None,
        secret_config: str | None = None,
        file_patterns: list[str] | None = None,
        aws_client_factory=None,
        helm_overrides: dict | None = None,
    ):
        self.target = target
        self.cache = cache
        self.parallel = parallel
        self.disabled = set(disabled_analyzers or set())
        self.secret_config = secret_config
        self.file_patterns = file_patterns or []
        self.helm_overrides = helm_overrides
        # injectable AWS client factory for ebs:/ami: targets (tests)
        self.aws_client_factory = aws_client_factory
        self.stats: dict = {}

    def _group(self) -> AnalyzerGroup:
        group = AnalyzerGroup.build(disabled_types=self.disabled,
                                    file_patterns=self.file_patterns,
                                    helm_overrides=self.helm_overrides)
        for a in group.analyzers + group.post_analyzers:
            if a.type == "secret":
                a.reset_last_scan()  # this scan's alone
                if self.secret_config:
                    a.configure(self.secret_config)
        return group

    def inspect(self) -> ArtifactReference:
        t0 = time.perf_counter()
        self.stats = {"walk_s": 0.0, "post_analyze_s": 0.0,
                      "walked_files": 0}
        try:
            if self.target.startswith(("ebs:", "ami:")):
                from trivy_tpu_torch.fanal.vm.ebs import (
                    EBSError,
                    open_ebs_target,
                )

                try:
                    fh = open_ebs_target(self.target,
                                         self.aws_client_factory)
                except EBSError as e:
                    raise VMError(str(e)) from e
            else:
                fh = open_disk(self.target)
        except DiskError as e:
            raise VMError(str(e)) from e
        except OSError as e:
            raise VMError(f"cannot open VM image {self.target}: {e}") from e
        from trivy_tpu_torch.fanal.vm.ebs import EBSError

        try:
            filesystems = find_filesystems(fh)
            if not filesystems:
                raise VMError(
                    f"no supported filesystem found in {self.target} "
                    "(ext4 and xfs are supported)")
            group = self._group()
            result = AnalysisResult()
            post_files: dict = {}
            digest = hashlib.sha256()
            for fstype, offset in filesystems:
                if fstype not in _FILESYSTEMS:
                    _log.warn("unsupported guest filesystem skipped",
                              fstype=fstype, offset=offset)
                    continue
                t1 = time.perf_counter()
                self.stats["walked_files"] += self._walk_fs(
                    fstype, fh, offset, group, result, post_files, digest)
                self.stats["walk_s"] += time.perf_counter() - t1
            t1 = time.perf_counter()
            group.post_analyze(result, post_files)
            system_file_filter(result)
            self.stats["post_analyze_s"] = time.perf_counter() - t1
            for a in group.post_analyzers:
                if a.type == "secret":
                    scan_s, added = a.last_scan()
                    self.stats.update(secret_s=scan_s,
                                      secret_device_stats=added,
                                      secret_probe=hybrid_probe_state())
        except EBSError as e:
            # block fetches during the walk can fail (throttling, expired
            # tokens) — keep the VMError contract for callers
            raise VMError(str(e)) from e
        finally:
            fh.close()
            self.stats["inspect_s"] = time.perf_counter() - t0

        blob = result.to_blob()
        blob_id = "sha256:" + digest.hexdigest()
        self.cache.put_blob(blob_id, dataclasses.asdict(blob))
        return ArtifactReference(
            name=self.target,
            type="vm",
            id=blob_id,
            blob_ids=[blob_id],
        )

    def _walk_fs(self, fstype, fh, offset, group, result, post_files,
                 digest) -> int:
        """-> the number of files analyzed."""
        fs_cls, fs_err = _FILESYSTEMS[fstype]
        try:
            fs = fs_cls(fh, offset)
        except fs_err as e:
            _log.warn("filesystem open failed", fstype=fstype,
                      offset=offset, err=str(e))
            return 0
        n = 0
        for path, inode in fs.walk():
            if inode.size > MAX_FILE_SIZE:
                _log.debug("guest file too large, skipped", path=path,
                           size=inode.size)
                continue
            inp = AnalysisInput(
                path=path, size=inode.size, mode=inode.mode,
                open=lambda fs=fs, inode=inode: fs.read_file(inode),
            )
            group.analyze_file(result, inp, post_files)
            if inp.content is not None:
                digest.update(path.encode())
                digest.update(inp.content)
                if not any(inp.path in files
                           for files in post_files.values()):
                    inp.content = None
            else:
                digest.update(path.encode())
            n += 1
        _log.info("walked guest filesystem", offset=offset, files=n)
        return n

    def clean(self, ref: ArtifactReference) -> None:
        self.cache.delete_blobs(ref.blob_ids)
