"""Git repository artifact (reference pkg/fanal/artifact/repo/git.go):
local paths walk directly; remote URLs are cloned with the system git
(shallow) into a temp dir first.

Copy of trivy_tpu/artifact/repo.py. `parallel` is accepted and not
passed on: the port's `FSArtifact` walks serially, as the reference's
does. `stats` is the walk's (`FSArtifact.stats`) of the last inspect.
One addition: a walk that fails removes the temp clone too (the
reference leaves it, as its scanner cleans only an inspected artifact).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

from trivy_tpu_torch.artifact.base import ArtifactReference
from trivy_tpu_torch.artifact.local_fs import FSArtifact
from trivy_tpu_torch.log import logger

_log = logger("repo")


class RepoArtifact:
    def __init__(self, target: str, cache, skip_files=None, skip_dirs=None,
                 parallel: int = 5, branch: str = "", tag: str = "",
                 commit: str = "", secret_config: str | None = None,
                 disabled_analyzers=None, helm_overrides: dict | None = None):
        self.target = target
        self.cache = cache
        self.skip_files = skip_files
        self.skip_dirs = skip_dirs
        self.parallel = parallel
        self.branch, self.tag, self.commit = branch, tag, commit
        self.secret_config = secret_config
        self.disabled_analyzers = disabled_analyzers
        self.helm_overrides = helm_overrides
        self.stats: dict = {}
        self._tmp: str | None = None

    def _checkout(self) -> str:
        if self.branch and self.tag:
            raise RuntimeError("--branch and --tag are mutually exclusive")
        for ref in (self.branch, self.tag, self.commit):
            if ref.startswith("-"):
                raise RuntimeError(f"invalid git ref {ref!r}")
        local = os.path.isdir(self.target)
        if local and not (self.branch or self.tag or self.commit):
            return self.target
        # A scanner must never mutate its input: a local directory with a
        # requested revision is cloned (--local shares objects, no copy) into
        # a temp dir and checked out THERE, leaving the user's HEAD alone.
        self._tmp = tempfile.mkdtemp(prefix="trivy-tpu-repo-")
        try:
            cmd = ["git", "clone"]
            if local:
                cmd += ["--local"]
            elif not self.commit:
                cmd += ["--depth", "1"]  # arbitrary commits need history
            if self.branch:
                cmd += ["--branch", self.branch]
            if self.tag:
                cmd += ["--branch", self.tag]
            cmd += ["--", self.target, self._tmp]
            _log.info("cloning repository", url=self.target)
            self._git(cmd)
            if self.commit:
                self._git(["git", "-C", self._tmp, "checkout",
                           self.commit, "--"])
        except Exception:
            self._drop_clone()
            raise
        return self._tmp

    @staticmethod
    def _git(cmd: list[str]) -> None:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"git failed ({' '.join(cmd[:3])}): {proc.stderr.strip()}"
            )

    def inspect(self) -> ArtifactReference:
        path = self._checkout()
        fs = FSArtifact(
            path, self.cache, skip_files=self.skip_files,
            skip_dirs=self.skip_dirs,
            secret_config=self.secret_config,
            disabled_analyzers=self.disabled_analyzers,
            helm_overrides=self.helm_overrides,
        )
        try:
            ref = fs.inspect()
        except BaseException:
            # no reference comes back, so no clean() follows: drop the
            # temp clone here
            self._drop_clone()
            raise
        self.stats = fs.stats
        ref.name = self.target
        ref.type = "repository"
        return ref

    def _drop_clone(self) -> None:
        if self._tmp:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None

    def clean(self, ref: ArtifactReference) -> None:
        self.cache.delete_blobs(ref.blob_ids)
        self._drop_clone()
