"""ctypes binding for the native streaming gunzip+tar layer splitter
(splitter.cpp) feeding the multi-lane analysis executor.

The native library inflates and frames a layer tar in one GIL-free pass
per feed() chunk, so N analysis lanes split N layers truly concurrently
instead of serializing on the interpreter.  The fallback ladder keeps
parity absolute:

1. ``TRIVY_TPU_NATIVE_SPLIT=0`` or no toolchain -> pure-Python
   ``tarfile`` walk (walker.walk_layer_tar), byte-identical by
   definition;
2. native parse rejects the stream (sparse members, pax hdrcharset,
   malformed or truncated headers, non-gzip compression) -> the
   consumed bytes are replayed and the pure-Python walk re-reads the
   layer from the start, so a native bail-out can never change results;
3. native parse succeeds -> members carry tarfile's exact field
   semantics (checksum modes, ustar prefix, GNU longname, pax path/size
   overrides, V7 directory names) and the shared classification in
   walker.py produces the same (files, opaque_dirs, whiteouts) triple.

Copy of trivy_tpu/ops/splitter.py. The library
builds with g++ into this package's git-ignored `ops/_build/`. One
addition: `WALKS` counts which walk produced each layer's members,
"native" or "tarfile" (`walker.walk_layer_tar` counts), so a run can
show that the native splitter really ran.
"""

from __future__ import annotations

import ctypes
import io
import os
import sys
import threading

from trivy_tpu_torch.log import logger
from trivy_tpu_torch.native.build import LazyLibrary
from trivy_tpu_torch.obs import tracing

_log = logger("ops.splitter")

_SRC = os.path.join(os.path.dirname(__file__), "splitter.cpp")

_ENCODING = sys.getfilesystemencoding()

# tarfile REGULAR_TYPES minus GNUTYPE_SPARSE (the native parser rejects
# sparse archives outright, so 'S' never reaches classification)
_REG_TYPES = (0, ord("0"), ord("7"))

_CHUNK = 1 << 20


def _configure(lib: ctypes.CDLL) -> None:
    lib.tsp_new.restype = ctypes.c_void_p
    lib.tsp_new.argtypes = [ctypes.c_longlong]
    lib.tsp_feed.restype = ctypes.c_int32
    lib.tsp_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.c_longlong]
    lib.tsp_finish.restype = ctypes.c_int32
    lib.tsp_finish.argtypes = [ctypes.c_void_p]
    lib.tsp_count.restype = ctypes.c_longlong
    lib.tsp_count.argtypes = [ctypes.c_void_p]
    lib.tsp_member.restype = ctypes.c_int32
    lib.tsp_member.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.tsp_name_ptr.restype = ctypes.c_void_p
    lib.tsp_name_ptr.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.POINTER(ctypes.c_longlong)]
    lib.tsp_data_ptr.restype = ctypes.c_void_p
    lib.tsp_data_ptr.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.POINTER(ctypes.c_longlong)]
    lib.tsp_error.restype = ctypes.c_char_p
    lib.tsp_error.argtypes = [ctypes.c_void_p]
    lib.tsp_free.restype = None
    lib.tsp_free.argtypes = [ctypes.c_void_p]


_LIB = LazyLibrary(_SRC, "libsplitter", _configure, link_flags=("-lz",),
                   build_dir=os.path.join(os.path.dirname(__file__),
                                          "_build"))

# layers walked per path since the last reset_walks(); "native": the
# splitter's members, "tarfile": the pure-Python walk (kill switch, no
# toolchain, or a native parse that declined)
WALKS = {"native": 0, "tarfile": 0}
_walks_lock = threading.Lock()


def count_walk(path: str) -> None:
    with _walks_lock:
        WALKS[path] += 1


def reset_walks() -> None:
    with _walks_lock:
        WALKS.update(native=0, tarfile=0)


def available() -> bool:
    return _LIB.load() is not None


def enabled() -> bool:
    """``TRIVY_TPU_NATIVE_SPLIT`` kill switch (default on; the pure
    tarfile walk is the =0 path and the no-toolchain fallback alike)."""
    return os.environ.get("TRIVY_TPU_NATIVE_SPLIT", "1") != "0"


def _decode_name(raw: bytes, from_pax: bool) -> str:
    # tarfile: pax path records decode strict-utf-8 first, then fall
    # back to the filesystem encoding; header names go straight to the
    # filesystem encoding with surrogateescape
    if from_pax:
        try:
            return raw.decode("utf-8", "strict")
        except UnicodeDecodeError:
            pass
    return raw.decode(_ENCODING, "surrogateescape")


class _Replay:
    """Re-serves the chunks the failed native attempt consumed, then
    the rest of the underlying stream — the pure-Python fallback walk
    sees the layer from byte zero even on unseekable sources."""

    def __init__(self, consumed: list[bytes], rest):
        self._head = io.BytesIO(b"".join(consumed))
        self._rest = rest

    def read(self, n: int = -1) -> bytes:
        data = self._head.read(n)
        if n is None or n < 0:
            return data + self._rest.read()
        if len(data) < n:
            data += self._rest.read(n - len(data))
        return data

    def close(self) -> None:
        close = getattr(self._rest, "close", None)
        if close is not None:
            close()


def _members(lib, handle, max_member: int):
    """Materialize (name, is_reg, size, mode, read) records for the
    shared walker classification; None -> defer to the Python walk."""
    count = lib.tsp_count(handle)
    out = []
    size = ctypes.c_longlong()
    mode = ctypes.c_longlong()
    ty = ctypes.c_int32()
    flags = ctypes.c_int32()
    nlen = ctypes.c_longlong()
    dlen = ctypes.c_longlong()
    for i in range(count):
        if lib.tsp_member(handle, i, ctypes.byref(size), ctypes.byref(mode),
                          ctypes.byref(ty), ctypes.byref(flags)) != 0:
            return None
        name_ptr = lib.tsp_name_ptr(handle, i, ctypes.byref(nlen))
        raw = ctypes.string_at(name_ptr, nlen.value) if nlen.value else b""
        name = _decode_name(raw, bool(flags.value & 2))
        is_reg = ty.value in _REG_TYPES
        stored = bool(flags.value & 1)
        if is_reg and size.value <= max_member and not stored:
            return None  # a needed body was not captured: defer
        content = b""
        if stored:
            data_ptr = lib.tsp_data_ptr(handle, i, ctypes.byref(dlen))
            content = (ctypes.string_at(data_ptr, dlen.value)
                       if dlen.value else b"")
        out.append((name, is_reg, size.value, mode.value,
                    (lambda c=content: c)))
    return out


def try_split(tar_src, max_member: int):
    """-> (members | None, fallback_src).

    ``members`` is the record list walker._collect consumes, or None
    when the native parse declined; ``fallback_src`` is what the
    pure-Python walk must read instead of the (possibly consumed)
    original source."""
    lib = _LIB.load()
    if lib is None:
        return None, tar_src

    opened = None
    consumed: list[bytes] = []
    if isinstance(tar_src, (bytes, bytearray)):
        def reader(n, _buf=io.BytesIO(bytes(tar_src))):
            return _buf.read(n)
        fallback = tar_src
        replayable = False
    elif hasattr(tar_src, "read"):
        def reader(n):
            chunk = tar_src.read(n)
            if chunk:
                consumed.append(chunk)
            return chunk
        fallback = tar_src
        replayable = True
    else:
        opened = open(tar_src, "rb")

        def reader(n, _fh=opened):
            return _fh.read(n)
        fallback = tar_src
        replayable = False

    handle = lib.tsp_new(max_member)
    if not handle:
        if opened is not None:
            opened.close()
        return None, tar_src
    try:
        with tracing.span("analysis.split"):
            ok = True
            while True:
                chunk = reader(_CHUNK)
                if not chunk:
                    ok = lib.tsp_finish(handle) == 0
                    break
                if lib.tsp_feed(handle, bytes(chunk), len(chunk)) != 0:
                    ok = False
                    break
            members = _members(lib, handle, max_member) if ok else None
        if members is None:
            err = lib.tsp_error(handle) or b""
            _log.debug("native split declined; using tarfile walk",
                       err=err.decode("utf-8", "replace")[:120])
            if replayable:
                fallback = _Replay(consumed, tar_src)
        return members, fallback
    finally:
        lib.tsp_free(handle)
        if opened is not None:
            opened.close()
