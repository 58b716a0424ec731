"""Build and bind the port's CUDA kernels.

Each kernel source under ops/csrc/ compiles with nvcc into a shared
library with a plain C interface, loaded with ctypes, at its first use
on a card (never at import: machines without a CUDA toolkit import this
module too). Libraries land in ops/_build/, named by a hash of the
source and the shared headers (csrc/*.cuh) so an edited kernel never
loads a stale build. `build` compiles several sources at once, one
nvcc process each.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# C entry points of each source: name -> (function, argtypes); every
# one returns cudaGetLastError() as an int
_ENTRY = {
    "match": ("trivy_match_words",
              [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "secret_anchor": ("trivy_anchor_words",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                      + [ctypes.c_void_p]),
    "secret_conv": ("trivy_conv_anchor_words",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                    + [ctypes.c_void_p]),
    "secret_prefilter": ("trivy_prefilter_hits",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                         + [ctypes.c_void_p]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def so_path(name: str) -> Path:
    """-> where the library of csrc/<name>.cu lands, named by a hash of
    the source, the shared headers and the flags."""
    digest = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _build_locked(names: list[str]) -> dict[str, tuple[Path, float]]:
    """Compile every csrc/<name>.cu not built yet, one nvcc process per
    source, all started together; the caller holds _lock. -> each
    source's library and the seconds until its build ended (0.0 for one
    already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    built = {name: (so_path(name), 0.0) for name in names}
    procs = {}
    for name, (so, _s) in built.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        _out, err = proc.communicate()
        so = built[name][0]
        built[name] = (so, time.perf_counter() - t0)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{err}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def build(names: list[str]) -> dict[str, float]:
    """Compile every csrc/<name>.cu not built yet, all at once. ->
    seconds until each source's build ended (0.0 for one already
    built)."""
    with _lock:
        return {name: secs for name, (_so, secs)
                in _build_locked(names).items()}


def load(name: str) -> ctypes.CDLL:
    """-> the loaded library of csrc/<name>.cu, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so, _s = _build_locked([name])[name]
            lib = ctypes.CDLL(str(so))
            fn_name, argtypes = _ENTRY[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def match_words_cuda(row_h1: torch.Tensor, h1_index: torch.Tensor,
                     table: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
                     rank: torch.Tensor, flags: torch.Tensor,
                     out: torch.Tensor, warps_per_query: int) -> None:
    """Launch csrc/match.cu on the current stream of `out`'s device, a
    query's words on `warps_per_query` warps (match.match_layout).
    Callers check shapes, dtypes and devices (ops/match.py:match_words)."""
    if table.data_ptr() % 16:
        raise ValueError("match table must be 16-byte aligned")
    _launch("match", "match", out.device, row_h1.data_ptr(),
            h1_index.data_ptr(), table.data_ptr(), h1.data_ptr(),
            h2.data_ptr(), rank.data_ptr(), flags.data_ptr(), out.data_ptr(),
            row_h1.shape[0], h1.shape[0], out.shape[1], warps_per_query)


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Raise ValueError unless `t` is a contiguous `dtype` tensor of
    `shape` on `device`: what a kernel argument must be."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype}{list(shape)} tensor on "
            f"{device}, got {t.dtype}{list(t.shape)} on {t.device}")


def _launch(name: str, what: str, device: torch.device, *args) -> None:
    """Call csrc/<name>.cu's entry point with `args` and the current
    stream of `device`; raise if the launch was refused."""
    lib = load(name)
    fn = getattr(lib, _ENTRY[name][0])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def screen_words_cuda(name: str, chunks: torch.Tensor,
                      cls_bits: torch.Tensor, taps: torch.Tensor,
                      n_taps: torch.Tensor, out: torch.Tensor, lay) -> None:
    """Launch the shared secret screen through csrc/<name>.cu
    (secret_anchor or secret_conv) into the zeroed `out`, on the grid of
    `lay` (a secret_nfa.ScreenLayout). Callers check shapes, dtypes,
    devices and alignment (ops/secret_nfa.py:_screen_words)."""
    c, length = chunks.shape
    _launch(name, name, out.device, chunks.data_ptr(), cls_bits.data_ptr(),
            taps.data_ptr(), n_taps.data_ptr(), out.data_ptr(), c, length,
            cls_bits.shape[1], taps.shape[0], out.shape[1], lay.tile_words,
            lay.tiles_per_block, lay.rules_per_slice, int(lay.tab_in_smem))


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA card `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def prefilter_hits_cuda(chunks: torch.Tensor, form, words: torch.Tensor,
                        out: torch.Tensor, lay) -> None:
    """Launch the shared secret screen through csrc/secret_prefilter.cu
    on a keyword bank's compact form (`form`, a
    secret_prefilter.KeywordTensors) into the zeroed bool `out` and
    packed `words`, on the grid of `lay` (a secret_nfa.ScreenLayout).
    Callers check shapes, dtypes and devices
    (ops/secret_prefilter.py:prefilter_hits)."""
    c, length = chunks.shape
    _launch("secret_prefilter", "prefilter", out.device, chunks.data_ptr(),
            form.cls_bits.data_ptr(), form.taps.data_ptr(),
            form.n_taps.data_ptr(), words.data_ptr(), out.data_ptr(), c,
            length, form.cls_bits.shape[1], form.taps.shape[0], form.rw,
            lay.tile_words, lay.tiles_per_block, lay.rules_per_slice,
            int(lay.tab_in_smem))
