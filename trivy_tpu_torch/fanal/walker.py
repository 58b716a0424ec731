"""File-tree walkers (reference pkg/fanal/walker):
- FSWalker: directory traversal with skip globs (fs.go:25)
- walk_layer_tar: container layer tars with whiteout/opaque-dir handling
  (tar.go:35-60: ".wh." prefix files delete, ".wh..wh..opq" marks opaque)

Copy of trivy_tpu/fanal/walker.py without FSWalker's `only_dirs`, which
no ported scan sets. `walk_layer_tar` counts which walk produced the
members (`ops/splitter.py` `WALKS`).
"""

from __future__ import annotations

import os
import stat
import tarfile
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


@dataclass
class LayerFile:
    input: AnalysisInput | None = None
    whiteout: str | None = None  # path deleted by this layer
    opaque_dir: str | None = None


def _collect(members) -> tuple[list[AnalysisInput], list[str], list[str]]:
    """Shared whiteout/opaque/size classification over an in-order
    iterable of ``(name, is_reg, size, mode, read)`` member records —
    the one place the layer-walk semantics live, whether the records
    came from tarfile or the native splitter."""
    files: list[AnalysisInput] = []
    opaque_dirs: list[str] = []
    whiteout_files: list[str] = []
    for name, is_reg, size, mode, read in members:
        # strip only a leading "./", not dots of root-level dotfiles
        name = name.removeprefix("./").lstrip("/")
        if not name:
            continue
        base = os.path.basename(name)
        dirn = os.path.dirname(name)
        if base == ".wh..wh..opq":
            opaque_dirs.append(dirn)
            continue
        if base.startswith(".wh."):
            whiteout_files.append(
                os.path.join(dirn, base[len(".wh."):]).replace(os.sep, "/")
            )
            continue
        if not is_reg:
            continue
        if size > MAX_FILE_SIZE:
            continue
        content = read()
        if content is None:
            continue
        files.append(AnalysisInput(
            path=name, content=content, size=size, mode=mode,
        ))
    return files, opaque_dirs, whiteout_files


def walk_layer_tar(tar_src) -> tuple[list[AnalysisInput], list[str], list[str]]:
    """-> (files, opaque_dirs, whiteout_files). Accepts layer bytes, a
    path, or a readable file-like object (reference walker/tar.go).

    The native streaming splitter (ops/splitter.py) handles the fast
    path: incremental gunzip + tar framing with the GIL released. It
    declines anything outside tarfile's exact semantics, replaying the
    consumed bytes so the pure-Python walk below re-reads the layer
    from the start — results can never diverge from the tarfile path.

    The file-like form opens in tarfile *stream* mode (``r|*``), which
    gunzips compressed layers incrementally: peak RSS is one tar member
    plus the source stream, never a full decompressed layer copy. The
    walk below already consumes members strictly in order, which is the
    only constraint stream mode adds."""
    from trivy_tpu_torch.ops import splitter

    if splitter.enabled() and splitter.available():
        members, tar_src = splitter.try_split(tar_src, MAX_FILE_SIZE)
        if members is not None:
            splitter.count_walk("native")
            return _collect(members)
    splitter.count_walk("tarfile")

    if isinstance(tar_src, (bytes, bytearray)):
        import io

        tf = tarfile.open(fileobj=io.BytesIO(tar_src))
    elif hasattr(tar_src, "read"):
        tf = tarfile.open(fileobj=tar_src, mode="r|*")
    else:
        tf = tarfile.open(tar_src)

    def gen():
        for member in tf:
            yield (member.name, member.isreg(), member.size, member.mode,
                   lambda m=member: (lambda f: f.read() if f is not None
                                     else None)(tf.extractfile(m)))

    with tf:
        return _collect(gen())
