"""Build and bind the port's CUDA kernels.

Each kernel source under ops/csrc/ compiles with nvcc into a shared
library with a plain C interface, loaded with ctypes, at its first use
on a card (never at import: machines without a CUDA toolkit import this
module too). Libraries land in ops/_build/, named by a hash of the
source so an edited kernel never loads a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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
              [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
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


def load(name: str) -> ctypes.CDLL:
    """-> the loaded library of csrc/<name>.cu, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = _CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        so = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name}:\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        fn_name, argtypes = _ENTRY[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
        return lib


def match_words_cuda(row_h1: torch.Tensor, table: torch.Tensor,
                     h1: torch.Tensor, h2: torch.Tensor, rank: torch.Tensor,
                     flags: torch.Tensor, out: torch.Tensor) -> None:
    """Launch csrc/match.cu on the current stream of `out`'s device.
    Callers check shapes, dtypes and devices (ops/match.py:match_words)."""
    if table.data_ptr() % 16:
        raise ValueError("match table must be 16-byte aligned")
    lib = load("match")
    n, b, n_words = row_h1.shape[0], h1.shape[0], out.shape[1]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.trivy_match_words(
            row_h1.data_ptr(), table.data_ptr(), h1.data_ptr(),
            h2.data_ptr(), rank.data_ptr(), flags.data_ptr(),
            out.data_ptr(), n, b, n_words, stream)
    if err != 0:
        raise RuntimeError(f"match kernel launch failed: CUDA error {err}")
