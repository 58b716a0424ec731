"""Bytes that a cell's kernels must move, counted from the cell's own
inputs and never from the program's tensors, so that they read the same
work whatever implements the kernel."""

from __future__ import annotations

MATCH_INTERVAL_BYTES = 16  # name key, two version ranks, flags
MATCH_QUERY_IN_BYTES = 16
MATCH_QUERY_OUT_BYTES = 4
SCREEN_CHUNK = 16384


def advisory_intervals(adv: dict) -> int:
    """Version intervals of one advisory: one for an OS advisory, one
    for each `||` alternative of a language advisory's vulnerable
    ranges."""
    vuln = adv.get("VulnerableVersions") or []
    return max(1, sum(v.count("||") + 1 for v in vuln))


def match_bytes(buckets: dict, fresh_keys) -> int:
    """Least bytes the match must move for queries `fresh_keys` (each
    sent to the device once): every (space, name) group they touch read
    once, at 16 B an advisory interval, plus 16 B a query in and 4 B a
    query out."""
    groups = set()
    n = 0
    for space, name, _version, _scheme in fresh_keys:
        groups.add((space, name))
        n += 1
    read = 0
    for space, name in groups:
        if space.endswith("::"):
            advs = [a for b, names in buckets.items() if b.startswith(space)
                    for a in names.get(name, ())]
        else:
            advs = buckets.get(space, {}).get(name, ())
        read += MATCH_INTERVAL_BYTES * sum(map(advisory_intervals, advs))
    return read + n * (MATCH_QUERY_IN_BYTES + MATCH_QUERY_OUT_BYTES)


def screen_bytes(file_bytes: int, n_rules: int) -> int:
    """Least bytes the secret screen must move: the files' bytes once,
    and one bit a rule for each 16 KiB of them out."""
    chunks = -(-file_bytes // SCREEN_CHUNK)
    return file_bytes + -(-chunks * n_rules // 8)
