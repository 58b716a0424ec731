"""Stable 64-bit string hashing for the name-hash join.

The join key mixes the match-space id (bucket) with the package name so a
single sorted array serves every ecosystem/distro. 64 bits are carried as
two uint32 lanes (h1 primary sort key, h2 verifier) because TPUs prefer
32-bit integers; h1 collisions only widen the gather window and h2+host
name rescreen remove any false positives (SURVEY.md §7 hard part #3).
"""

from __future__ import annotations

import hashlib

import numpy as np

_MASK32 = 0xFFFFFFFF


def hash64(s: str) -> int:
    """Deterministic 64-bit hash (blake2b-8). Stable across processes —
    never use Python's salted hash() for DB-resident keys."""
    return int.from_bytes(hashlib.blake2b(s.encode("utf-8"), digest_size=8).digest(), "big")


def join_key(space: str, name: str) -> tuple[int, int]:
    """(h1, h2) uint32 pair for the (match-space, package-name) join."""
    h = hash64(f"{space}\x00{name}")
    return (h >> 32) & _MASK32, h & _MASK32


def join_keys_np(pairs: list[tuple[str, str]]) -> tuple[np.ndarray, np.ndarray]:
    h1 = np.empty(len(pairs), dtype=np.uint32)
    h2 = np.empty(len(pairs), dtype=np.uint32)
    for i, (space, name) in enumerate(pairs):
        a, b = join_key(space, name)
        h1[i], h2[i] = a, b
    return h1, h2
