"""ctypes binding for the C++ match-result decoder (collect.cpp).

Build/load scaffolding shared with ac.py via native/build.py; callers
fall back to the numpy path when no toolchain is available.

Copy of trivy_tpu/native/collect.py; the library builds into the
port's own native cache directory.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from trivy_tpu_torch.native.build import LazyLibrary

_SRC = os.path.join(os.path.dirname(__file__), "collect.cpp")


def _configure(lib: ctypes.CDLL) -> None:
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.count_bits.restype = ctypes.c_int64
    lib.count_bits.argtypes = [u32p, ctypes.c_int64]
    lib.decode_mask.restype = ctypes.c_int64
    lib.decode_mask.argtypes = [
        u32p, ctypes.c_int64, ctypes.c_int64,   # words, b, w32
        i64p, ctypes.c_int64,                   # start, n_rows
        i32p, i32p,                             # row_adv, row_flags
        i64p,                                   # adv_tok
        i64p, i32p,                             # q_tok, q_flags
        ctypes.c_int32,                         # flag_mask
        i64p, i64p, u8p,                        # out rows/ids/resc
    ]
    lib.sort_dedupe.restype = ctypes.c_int64
    lib.sort_dedupe.argtypes = [i64p, i64p, u8p, ctypes.c_int64]
    lib.group_confirmed.restype = ctypes.c_int64
    lib.group_confirmed.argtypes = [
        i64p, i64p, u8p, ctypes.c_int64, ctypes.c_int64,  # rows/ids/conf/m/nq
        i64p, i64p,                                       # out ids, bounds
    ]


_LIB = LazyLibrary(_SRC, "libcollect", _configure)


def available() -> bool:
    return _LIB.available()


def decode_mask(words: np.ndarray, start: np.ndarray, n_rows: int,
                row_adv: np.ndarray, row_flags: np.ndarray,
                adv_tok: np.ndarray, q_tok: np.ndarray,
                q_flags: np.ndarray, flag_mask: int):
    """-> (rows, ids, resc) screened candidate triples, or None when the
    native library is unavailable. Shapes: words uint32[B, W32] in the
    original query order; everything else as in collect.cpp."""
    lib = _LIB.load()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    b, w32 = words.shape
    cap = int(lib.count_bits(words.reshape(-1), words.size))
    rows = np.empty(cap, dtype=np.int64)
    ids = np.empty(cap, dtype=np.int64)
    resc = np.empty(cap, dtype=np.uint8)
    n = int(lib.decode_mask(
        words.reshape(-1), b, w32,
        np.ascontiguousarray(start, dtype=np.int64), n_rows,
        np.ascontiguousarray(row_adv, dtype=np.int32),
        np.ascontiguousarray(row_flags, dtype=np.int32),
        np.ascontiguousarray(adv_tok, dtype=np.int64),
        np.ascontiguousarray(q_tok, dtype=np.int64),
        np.ascontiguousarray(q_flags, dtype=np.int32),
        flag_mask, rows, ids, resc))
    return rows[:n], ids[:n], resc[:n].astype(bool)


def sort_dedupe(rows: np.ndarray, ids: np.ndarray, resc: np.ndarray):
    """In-place sort by (row, id, resc) + dedupe on (row, id) keeping the
    exact (non-rescreen) twin. -> (rows, ids, resc) compacted views, or
    None when the library is unavailable or the values exceed the packed
    key ranges (rows < 2^21, ids < 2^42)."""
    lib = _LIB.load()
    if lib is None or len(rows) == 0:
        return None
    if (rows.max() >= (1 << 21) or rows.min() < 0
            or ids.max() >= (1 << 42) or ids.min() < 0):
        return None  # caller falls back to np.lexsort
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    resc8 = np.ascontiguousarray(resc, dtype=np.uint8)
    m = int(lib.sort_dedupe(rows, ids, resc8, len(rows)))
    return rows[:m], ids[:m], resc8[:m].astype(bool)


def group_confirmed(rows: np.ndarray, ids: np.ndarray, conf: np.ndarray,
                    n_queries: int):
    """-> (out_ids, bounds) CSR of confirmed hits per query, or None when
    the library is unavailable. rows must be sorted ascending."""
    lib = _LIB.load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    conf8 = np.ascontiguousarray(conf, dtype=np.uint8)
    out_ids = np.empty(len(ids), dtype=np.int64)
    bounds = np.empty(n_queries + 1, dtype=np.int64)
    n = int(lib.group_confirmed(rows, ids, conf8, len(rows), n_queries,
                                out_ids, bounds))
    return out_ids[:n], bounds
