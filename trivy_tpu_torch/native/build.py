"""Build/load scaffolding for the port's C++ host helpers (ac.cpp,
collect.cpp): compile on first use with g++, cache under
~/.cache/trivy-tpu-torch/native keyed by source hash, fall back to the
caller's pure-Python path when no toolchain is available.

Copy of trivy_tpu/native/build.py with its own cache directory, so the
two packages never load each other's builds, and a per-library
`build_dir` (the layer splitter builds into the port's git-ignored
`ops/_build/`)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

from trivy_tpu_torch.analysis.witness import make_lock
from trivy_tpu_torch.log import logger

_log = logger("native")


def cache_dir() -> str:
    return os.environ.get(
        "TRIVY_TPU_TORCH_NATIVE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "trivy-tpu-torch",
                     "native"))


def build_library(src_path: str, lib_prefix: str,
                  link_flags: tuple[str, ...] = (),
                  build_dir: str | None = None) -> str | None:
    """Compile `src_path` to a cached shared library in `build_dir`
    (default `cache_dir()`); None on failure.

    `link_flags` (e.g. ("-lz",)) participate in the cache key so the
    same source built with different libraries does not collide.
    """
    build_dir = build_dir or cache_dir()
    with open(src_path, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + b"\0" +
                            " ".join(link_flags).encode()).hexdigest()[:16]
    out = os.path.join(build_dir, f"{lib_prefix}-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mktemp(suffix=".so", dir=build_dir)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src_path,
           "-o", tmp, *link_flags]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        stderr = getattr(e, "stderr", b"") or b""
        _log.warn("native build failed; using python fallback",
                  src=os.path.basename(src_path), err=str(e),
                  stderr=stderr.decode()[:500])
        return None
    # lint: allow[atomic-write] atomic-publish idiom: tmp build + rename, racing builders converge
    os.replace(tmp, out)  # atomic: concurrent builders race safely
    return out


class LazyLibrary:
    """Thread-safe once-only build+load; `configure(lib)` sets the
    ctypes signatures on first success."""

    def __init__(self, src_path: str, lib_prefix: str, configure,
                 link_flags: tuple[str, ...] = (),
                 build_dir: str | None = None):
        self._src = src_path
        self._prefix = lib_prefix
        self._configure = configure
        self._link_flags = link_flags
        self._build_dir = build_dir
        self._lock = make_lock("native.build._lock")
        self._lib: ctypes.CDLL | None = None
        self._failed = False

    def load(self) -> ctypes.CDLL | None:
        if self._lib is not None or self._failed:
            return self._lib
        with self._lock:
            if self._lib is not None or self._failed:
                return self._lib
            path = build_library(self._src, self._prefix,
                                 self._link_flags, self._build_dir)
            if path is None:
                self._failed = True
                return None
            lib = ctypes.CDLL(path)
            self._configure(lib)
            self._lib = lib
            return lib

    def available(self) -> bool:
        return self.load() is not None
