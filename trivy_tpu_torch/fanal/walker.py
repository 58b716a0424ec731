"""File-tree walker (reference pkg/fanal/walker/fs.go:25): directory
traversal with skip globs.

Copy of the directory walk of trivy_tpu/fanal/walker.py. The layer-tar
walk (whiteouts, opaque dirs, the native splitter) is not ported yet.
"""

from __future__ import annotations

import os
import stat
from dataclasses import dataclass, field
from typing import Iterator

from trivy_tpu_torch.fanal.analyzer import AnalysisInput, matches_any
from trivy_tpu_torch.log import logger

_log = logger("walker")

# never walked (reference walker.go defaultSkipDirs)
DEFAULT_SKIP_DIRS = [".git", "**/.git", "proc", "sys", "dev"]

MAX_FILE_SIZE = 200 * 1024 * 1024  # hard cap on single-file reads


@dataclass
class FSWalker:
    skip_files: list[str] = field(default_factory=list)
    skip_dirs: list[str] = field(default_factory=list)

    def walk(self, root: str) -> Iterator[AnalysisInput]:
        root = os.path.abspath(root)
        skip_dirs = list(self.skip_dirs) + DEFAULT_SKIP_DIRS
        for dirpath, dirnames, filenames in os.walk(root):
            rel_dir = os.path.relpath(dirpath, root)
            rel_dir = "" if rel_dir == "." else rel_dir.replace(os.sep, "/")
            # prune skipped dirs
            keep = []
            for d in dirnames:
                rel = f"{rel_dir}/{d}" if rel_dir else d
                if matches_any(rel, skip_dirs) or matches_any(d, skip_dirs):
                    continue
                keep.append(d)
            dirnames[:] = sorted(keep)
            for fname in sorted(filenames):
                rel = f"{rel_dir}/{fname}" if rel_dir else fname
                if matches_any(rel, self.skip_files):
                    continue
                full = os.path.join(dirpath, fname)
                try:
                    st = os.lstat(full)
                except OSError:
                    continue
                if not stat.S_ISREG(st.st_mode):
                    continue
                if st.st_size > MAX_FILE_SIZE:
                    _log.debug("skipping oversized file", path=rel,
                               size=st.st_size)
                    continue
                yield AnalysisInput(
                    path=rel,
                    size=st.st_size,
                    mode=st.st_mode,
                    open=lambda p=full: open(p, "rb").read(),
                )
