"""ctypes binding for the C++ Aho-Corasick keyword scanner (ac.cpp).

Build/load scaffolding in native/build.py (copy of trivy_tpu/native/ac.py);
when no toolchain is available the caller falls back to the
pure-Python prefilter.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from trivy_tpu_torch.native.build import LazyLibrary

_SRC = os.path.join(os.path.dirname(__file__), "ac.cpp")


def _configure(lib: ctypes.CDLL) -> None:
    lib.ac_build.restype = ctypes.c_void_p
    lib.ac_build.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    lib.ac_scan.restype = ctypes.c_int32
    lib.ac_scan.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.ac_scan_pos.restype = ctypes.c_int64
    lib.ac_scan_pos.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    lib.ac_free.restype = None
    lib.ac_free.argtypes = [ctypes.c_void_p]


_LIB = LazyLibrary(_SRC, "libac", _configure)


def available() -> bool:
    return _LIB.available()


class NativeMatcher:
    """Multi-pattern case-insensitive matcher over one byte pass."""

    def __init__(self, keywords: list[bytes]):
        lib = _LIB.load()
        if lib is None:
            raise RuntimeError("native AC library unavailable")
        self._lib = lib
        self.keywords = keywords
        n = len(keywords)
        arr = (ctypes.c_char_p * n)(*[bytes(k.lower()) for k in keywords])
        lens = (ctypes.c_int32 * n)(*[len(k) for k in keywords])
        self._handle = lib.ac_build(
            ctypes.cast(arr, ctypes.POINTER(ctypes.c_char_p)), lens, n)
        self._n = n

    def scan(self, content: bytes) -> np.ndarray:
        """-> bool[n_keywords] — which keywords occur in content.
        The hits buffer is per call, so concurrent scans (fleet lanes
        sharing one scanner) cannot tear each other's verdicts."""
        hits = (ctypes.c_uint8 * max(self._n, 1))()
        self._lib.ac_scan(self._handle, content, len(content), hits)
        return np.frombuffer(hits, dtype=np.uint8).astype(bool)

    # generous default: secret-bearing files have few candidate-window
    # anchors; a file denser than this gets the whole-buffer fallback
    POS_CAP = 16384

    def scan_positions(self, content: bytes,
                       cap: int | None = None):
        """-> (ids int32[n], end_offsets int64[n]) of every case-folded
        keyword occurrence, or None when the buffer holds more than
        `cap` occurrences (the caller must NOT trust a truncated set —
        fall back to scanning the whole buffer)."""
        cap = self.POS_CAP if cap is None else int(cap)
        ids = (ctypes.c_int32 * max(cap, 1))()
        pos = (ctypes.c_int64 * max(cap, 1))()
        n = self._lib.ac_scan_pos(self._handle, content, len(content),
                                  ids, pos, cap)
        if n < 0:
            return None
        return (np.frombuffer(ids, dtype=np.int32)[:n].copy(),
                np.frombuffer(pos, dtype=np.int64)[:n].copy())

    def __del__(self):
        lib = getattr(self, "_lib", None)
        handle = getattr(self, "_handle", None)
        if lib is not None and handle:
            try:
                lib.ac_free(handle)
            except Exception:
                pass
            self._handle = None
