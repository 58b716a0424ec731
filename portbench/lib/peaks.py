"""Published peaks of the cards a cell may run on, and the card's own
name and power limit as `nvidia-smi` reads them.

A roofline share is stated against the published peak of the full
700 W part; the power limit the card was set to goes beside it."""

from __future__ import annotations

import subprocess

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, bytes per second
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def hbm_bytes_per_s(kind: str) -> float:
    """-> the card's published memory bandwidth; raises for a card the
    table does not know, rather than guess its peak."""
    try:
        return HBM_BYTES_PER_S[kind]
    except KeyError:
        raise KeyError(f"no published peak for {kind!r}") from None


def power_limit() -> str | None:
    """-> the card's power limit as `nvidia-smi` prints it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None
