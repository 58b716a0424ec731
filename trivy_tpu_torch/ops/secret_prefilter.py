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

The kernel is the secret screen's (ops/csrc/secret_screen.cuh) third
user: `KeywordTensors` puts a keyword bank in the screen's compact form,
with byte values as classes and each keyword's bytes as its taps.

`HostPrefilter` is the same contract on the CPU (the native
Aho-Corasick matcher), the oracle the device prefilter is held to.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from trivy_tpu_torch.device import resolve_device
from trivy_tpu_torch.ops.secret_nfa import (ScreenTensors, _put,
                                            _rule_words, screen_layout,
                                            screen_taps)

CHUNK = 16384
MAX_KW = 24  # keywords longer than this are truncated (still a prefilter)
KW_SHIFT_BITS = 5  # a keyword tap is class << 5 | offset (offsets < 24)
# byte values from the most to the least common in lowercased source
# text (counted once over this repository's Python and Markdown); a
# keyword's taps go rarest byte first, unlisted bytes rarest of all. The
# order only lets the screen drop a keyword sooner: it changes no result
COMMON_BYTES = (b" etsraniol\ncd\"pfu_m.h)(,-g=b:yvkw0x[]1/`{}2'j#q>z\\*3+|"
                b"456;<89@7!?%^&$~")

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


def byte_rarity() -> np.ndarray:
    """-> int[256]: a byte value's rank, lower = rarer (COMMON_BYTES)."""
    rarity = np.zeros(256, dtype=np.int64)
    for i, b in enumerate(COMMON_BYTES):
        rarity[b] = len(COMMON_BYTES) - i
    return rarity


@dataclass
class KeywordTensors(ScreenTensors):
    """A keyword bank in the secret screen's compact form on one device
    (ops/secret_nfa.py screen_taps), what ops/csrc/secret_prefilter.cu
    reads: the classes are the distinct byte values among the keywords'
    first min(kw_len, max_len) bytes (byte 0 too, when a keyword holds
    it), and keyword k's taps are (class of kw[k, j]) << 5 | j for each
    such j, rarest byte first (byte_rarity). A keyword of length 0 has
    no tap and hits wherever the chunk has a start position.

    A form built by `of_bank` keeps the bank tensors it was built from
    and their version counters: prefilter_hits takes a form only with
    those very tensors, unchanged since (`is_of`)."""

    max_len: int
    kw: torch.Tensor | None = None
    kw_len: torch.Tensor | None = None
    versions: tuple = ()

    @classmethod
    def of_bank(cls, kw: torch.Tensor, kw_len: torch.Tensor,
                max_len: int) -> "KeywordTensors":
        """The compact form of the bank tensors prefilter_hits takes, on
        their device, tied to them (built from a host copy)."""
        form = cls.from_arrays(kw.cpu().numpy(), kw_len.cpu().numpy(),
                               max_len, kw.device)
        form.kw, form.kw_len = kw, kw_len
        form.versions = (kw._version, kw_len._version)
        return form

    def is_of(self, kw: torch.Tensor, kw_len: torch.Tensor,
              max_len: int) -> bool:
        """Whether of_bank built this form from these very tensors, at
        this max_len, with no in-place change to them since."""
        return (self.kw is kw and self.kw_len is kw_len
                and self.max_len == max_len
                and self.versions == (kw._version, kw_len._version))

    @classmethod
    def from_arrays(cls, kw: np.ndarray, kw_len: np.ndarray, max_len: int,
                    device) -> "KeywordTensors":
        """kw uint8[K, >= max_len]; kw_len int32[K] (the prefilter_hits
        contract), as host arrays: the form alone, tied to no tensors."""
        k = kw.shape[0]
        n = np.clip(np.asarray(kw_len, dtype=np.int64), 0, max_len)
        act = np.arange(MAX_KW)[None, :] < n[:, None]
        byte = np.zeros((k, MAX_KW), dtype=np.int64)
        byte[:, :max_len] = kw[:, :max_len]
        values = np.unique(byte[act])
        cls_of = np.zeros(256, dtype=np.int64)
        cls_of[values] = np.arange(len(values))
        cls_bits = np.zeros((256, max(1, -(-len(values) // 32))),
                            dtype=np.uint32)
        for i, b in enumerate(values.tolist()):
            cls_bits[b, i // 32] = np.uint32(1 << (i % 32))
        taps, n_taps = screen_taps(cls_bits, cls_of[byte], act,
                                   np.zeros_like(act),
                                   rarity=byte_rarity()[values],
                                   shift_bits=KW_SHIFT_BITS)
        return cls(cls_bits=_put(cls_bits.view(np.int32), device),
                   taps=_put(taps, device), n_taps=_put(n_taps, device),
                   rw=_rule_words(k), max_len=max_len)


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
                   kw_len: torch.Tensor, max_len: int,
                   form: KeywordTensors | None = None) -> torch.Tensor:
    """-> bool[C, K] per-chunk keyword hits.

    On a CUDA tensor: the hand-written kernel
    (ops/csrc/secret_prefilter.cu; raises if it cannot launch) on the
    bank's compact form: `form`, built once by the caller with
    KeywordTensors.of_bank(kw, kw_len, max_len), or else built here. On
    a CPU tensor: `prefilter_hits_ref`. A form of other tensors raises
    on either."""
    if not 1 <= max_len <= MAX_KW:
        raise ValueError(f"prefilter_hits: max_len {max_len} outside "
                         f"1..{MAX_KW}")
    if form is not None and not form.is_of(kw, kw_len, max_len):
        raise ValueError("prefilter_hits: the compact form was not built "
                         "by KeywordTensors.of_bank from this kw, kw_len "
                         "and max_len")
    if chunks.device.type == "cpu":
        return prefilter_hits_ref(chunks, kw, kw_len, max_len)
    from trivy_tpu_torch.ops import kernels

    dev = chunks.device
    if chunks.dim() != 2 or kw.dim() != 2:
        raise ValueError("prefilter_hits: chunks and kw must be 2-d")
    c, length = chunks.shape
    k, width = kw.shape
    check = kernels.check_tensor
    check("prefilter_hits: chunks", chunks, torch.uint8, (c, length), dev)
    check("prefilter_hits: kw", kw, torch.uint8, (k, width), dev)
    check("prefilter_hits: kw_len", kw_len, torch.int32, (k,), dev)
    if width < max_len:
        raise ValueError(f"prefilter_hits: kw has {width} columns, fewer "
                         f"than max_len {max_len}")
    if c == 0 or length == 0 or k == 0:
        return torch.zeros((c, k), dtype=torch.bool, device=dev)
    if form is None:
        form = KeywordTensors.of_bank(kw, kw_len, max_len)
    ncw = form.cls_bits.shape[1]
    check("prefilter_hits: cls_bits", form.cls_bits, torch.int32,
          (256, ncw), dev)
    check("prefilter_hits: taps", form.taps, torch.int32, (k, MAX_KW), dev)
    check("prefilter_hits: n_taps", form.n_taps, torch.int32, (k,), dev)
    # one zeroed buffer: the bool hits the kernel writes, then the packed
    # words the blocks of a chunk share
    off = -(-c * k // 16) * 16
    buf = torch.zeros(off + 4 * c * form.rw, dtype=torch.uint8, device=dev)
    out = buf[: c * k].view(torch.bool).view(c, k)
    words = buf[off:].view(torch.int32).view(c, form.rw)
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    lay = screen_layout(c, length, ncw, k, form.rw, kernels.sm_count(index),
                        taps=MAX_KW)
    kernels.prefilter_hits_cuda(chunks, form, words, out, lay)
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
            # the screen's compact form, once (the kernel reads it)
            self._form = KeywordTensors.of_bank(
                self._kw_dev, self._kwlen_dev, self.bank.max_len)

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
                self._kwlen_dev, self.bank.max_len,
                self._form).cpu().numpy()
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
