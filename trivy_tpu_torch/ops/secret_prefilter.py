"""Batched secret keyword prefilter on a CUDA card.

Port of trivy_tpu/ops/secret_prefilter.py. The reference's secret
engine prefilters each rule by substring keywords before running its
regex (pkg/fanal/secret/scanner.go:174-186), file by file on the CPU.
Here the prefilter is one device pass over a whole batch of files:

- files are lowercased and packed into a [n_chunks, CHUNK] uint8 tensor
  (chunks overlap by max-keyword-length-1 so matches never straddle)
- one kernel tests every keyword at every start position of every chunk
  (`prefilter_hits`: the hand-written kernel ops/csrc/secret_prefilter.cu
  on a CUDA tensor, the plain version `prefilter_hits_ref` on a CPU one)
- output [n_chunks, n_keywords] any-hit reduces to per-file keyword masks.

`HostPrefilter` is the same contract on the CPU (the native
Aho-Corasick matcher), the oracle the device prefilter is held to.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from trivy_tpu_torch.device import resolve_device

CHUNK = 16384
MAX_KW = 24  # keywords longer than this are truncated (still a prefilter)

_count_lock = threading.Lock()  # guards the launch counter
# bools the plain version materialises per block of chunks
_REF_BLOCK = 1 << 25


class KeywordBank:
    """Fixed keyword tensor: [n_kw, MAX_KW] uint8 + lengths."""

    def __init__(self, keywords: list[bytes]):
        self.keywords = [k[:MAX_KW].lower() for k in keywords]
        n = len(self.keywords)
        self.kw = np.zeros((n, MAX_KW), dtype=np.uint8)
        self.kw_len = np.zeros(n, dtype=np.int32)
        for i, k in enumerate(self.keywords):
            self.kw[i, : len(k)] = np.frombuffer(k, dtype=np.uint8)
            self.kw_len[i] = len(k)
        self.max_len = int(self.kw_len.max()) if n else 1


def prefilter_hits_ref(chunks: torch.Tensor, kw: torch.Tensor,
                       kw_len: torch.Tensor, max_len: int) -> torch.Tensor:
    """Plain PyTorch version of the prefilter kernel (the reference's
    _kernel): -> bool[C, K], keyword k starts at some position < L of
    chunk c.

    Chunks (already lowercased) are padded with max_len - 1 zero bytes,
    which compare equal to a keyword byte 0. Keyword k matches at i when
    ext[i + j] == kw[k, j] for every j < min(kw_len[k], max_len); a
    keyword of length 0 matches everywhere.

    chunks uint8[C, L]; kw uint8[K, >= max_len]; kw_len int32[K]."""
    c, length = chunks.shape
    k = kw.shape[0]
    dev = chunks.device
    ext = torch.cat([chunks, torch.zeros((c, max_len - 1), dtype=torch.uint8,
                                         device=dev)], dim=1)
    out = torch.zeros((c, k), dtype=torch.bool, device=dev)
    blk = max(1, _REF_BLOCK // max(length * k, 1))
    for c0 in range(0, c, blk):
        x = ext[c0: c0 + blk]
        acc = torch.ones((x.shape[0], length, k), dtype=torch.bool,
                         device=dev)
        for j in range(max_len):
            eq = x[:, j: j + length, None] == kw[None, None, :, j]
            acc &= eq | (j >= kw_len)[None, None, :]
        out[c0: c0 + blk] = acc.any(dim=1)
    return out


def prefilter_hits(chunks: torch.Tensor, kw: torch.Tensor,
                   kw_len: torch.Tensor, max_len: int) -> torch.Tensor:
    """-> bool[C, K] per-chunk keyword hits.

    On a CUDA tensor: the hand-written kernel
    (ops/csrc/secret_prefilter.cu; raises if it cannot launch). On a
    CPU tensor: `prefilter_hits_ref`."""
    if not 1 <= max_len <= MAX_KW:
        raise ValueError(f"prefilter_hits: max_len {max_len} outside "
                         f"1..{MAX_KW}")
    if chunks.device.type == "cpu":
        return prefilter_hits_ref(chunks, kw, kw_len, max_len)
    from trivy_tpu_torch.ops import kernels

    dev = chunks.device
    if chunks.dim() != 2 or kw.dim() != 2:
        raise ValueError("prefilter_hits: chunks and kw must be 2-d")
    c, length = chunks.shape
    k, width = kw.shape
    kernels.check_tensor("prefilter_hits: chunks", chunks, torch.uint8,
                         (c, length), dev)
    kernels.check_tensor("prefilter_hits: kw", kw, torch.uint8, (k, width),
                         dev)
    kernels.check_tensor("prefilter_hits: kw_len", kw_len, torch.int32, (k,),
                         dev)
    if width < max_len:
        raise ValueError(f"prefilter_hits: kw has {width} columns, fewer "
                         f"than max_len {max_len}")
    out = torch.zeros((c, k), dtype=torch.bool, device=dev)
    if c == 0 or length == 0 or k == 0:
        return out
    kernels.prefilter_hits_cuda(chunks, kw, kw_len, max_len, out)
    with _count_lock:
        prefilter_hits.launches += 1
    return out


prefilter_hits.launches = 0  # kernel launches (CUDA path only)


class DevicePrefilter:
    """Keyword presence per file, screened on `device` (``cuda:0``
    unless the caller passes ``device="cpu"``)."""

    def __init__(self, bank: KeywordBank, batch_chunks: int = 1024,
                 device=None):
        self.bank = bank
        self.batch_chunks = batch_chunks
        self.device = resolve_device(device)
        self._kw_dev = None

    def _ensure(self):
        if self._kw_dev is None:
            self._kw_dev = torch.from_numpy(self.bank.kw).to(self.device)
            self._kwlen_dev = torch.from_numpy(self.bank.kw_len).to(
                self.device)

    def keyword_hits(self, contents: list[bytes]) -> np.ndarray:
        """-> bool[n_files, n_keywords]."""
        n_kw = len(self.bank.keywords)
        out = np.zeros((len(contents), n_kw), dtype=bool)
        if not contents or n_kw == 0:
            return out
        self._ensure()
        overlap = self.bank.max_len - 1
        step = CHUNK - overlap
        # build chunk list with file ownership
        owners: list[int] = []
        chunks: list[np.ndarray] = []
        for fi, content in enumerate(contents):
            low = content.lower()
            pos = 0
            while pos == 0 or pos < len(low):
                piece = low[pos: pos + CHUNK]
                if not piece:
                    break
                arr = np.zeros(CHUNK, dtype=np.uint8)
                arr[: len(piece)] = np.frombuffer(piece, dtype=np.uint8)
                chunks.append(arr)
                owners.append(fi)
                if pos + CHUNK >= len(low):
                    break
                pos += step
        if not chunks:
            return out
        owners_a = np.array(owners)
        for start in range(0, len(chunks), self.batch_chunks):
            batch = np.stack(chunks[start: start + self.batch_chunks])
            hits = prefilter_hits(
                torch.from_numpy(batch).to(self.device), self._kw_dev,
                self._kwlen_dev, self.bank.max_len).cpu().numpy()
            np.logical_or.at(out, owners_a[start: start + len(batch)], hits)
        return out


class HostPrefilter:
    """Same contract on the CPU, the oracle of the device prefilter.
    One-pass C++ Aho-Corasick when the native library builds
    (trivy_tpu_torch.native.ac, replacing the reference's rules x
    strings.Contains loop, scanner.go:174-186); pure-Python bytes.find
    otherwise."""

    def __init__(self, bank: KeywordBank, use_native: bool = True):
        self.bank = bank
        self._native = None
        if use_native and bank.keywords:
            try:
                from trivy_tpu_torch.native.ac import NativeMatcher

                self._native = NativeMatcher(bank.keywords)
            except (RuntimeError, OSError):
                self._native = None

    def keyword_hits(self, contents: list[bytes]) -> np.ndarray:
        out = np.zeros((len(contents), len(self.bank.keywords)), dtype=bool)
        if self._native is not None:
            for fi, content in enumerate(contents):
                out[fi] = self._native.scan(content)
            return out
        for fi, content in enumerate(contents):
            low = content.lower()
            for ki, k in enumerate(self.bank.keywords):
                if k in low:
                    out[fi, ki] = True
        return out
