"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: there
is no silent fallback. Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """-> the torch device to place tensors on.

    None means ``cuda:0``. ``"cpu"`` is honoured only when asked for.
    Raises RuntimeError when a CUDA device is wanted and absent."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", 0)
    return dev
