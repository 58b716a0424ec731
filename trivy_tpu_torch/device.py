"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: there
is no silent fallback. Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


class DeviceError(RuntimeError):
    """A device could not do its work: a CUDA error, a kernel that
    cannot build or launch, an upload onto a card that failed. Raised to
    the caller and never degraded (only an injected or real device
    *loss* degrades a path)."""


def is_device_error(exc: BaseException) -> bool:
    """Whether `exc` is the device's failure: a DeviceError, or a CUDA
    error torch raised (out of memory, an accelerator error)."""
    # torch.AcceleratorError is new in torch 2.8
    accel = getattr(torch, "AcceleratorError", DeviceError)
    return isinstance(exc, (DeviceError, torch.cuda.OutOfMemoryError, accel))


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


class DeviceGrid:
    """The serving mesh's device layout: `devices[g][d]` is the torch
    device of data group g's cell of db shard d. `shape` names the two
    axes as a jax Mesh does ({"data": dp, "db": db}), which is what
    ops/mesh.py MeshDB.from_compiled reads. A device may stand in more
    than one cell (every cell on one card, or on the CPU in tests)."""

    def __init__(self, devices: list[list[torch.device]]):
        self.devices = [list(row) for row in devices]
        self.shape = {"data": len(self.devices),
                      "db": len(self.devices[0]) if self.devices else 0}

    def __repr__(self) -> str:
        return (f"DeviceGrid({self.shape['data']}x{self.shape['db']}, "
                f"{sorted({str(d) for row in self.devices for d in row})})")


def build_mesh(dp: int, db: int, devices=None) -> DeviceGrid:
    """A (data=dp, db=db) grid over the first dp*db CUDA devices, or over
    `devices` (a list of dp*db devices, row-major by data group; a
    device may repeat). Raises ValueError when there are too few."""
    if dp < 1 or db < 1:
        raise ValueError(f"mesh axes must be >= 1, got {dp}x{db}")
    if devices is None:
        n_local = torch.cuda.device_count() \
            if torch.cuda.is_available() else 0
        if dp * db > n_local:
            raise ValueError(
                f"mesh {dp}x{db} needs {dp * db} devices, have {n_local}")
        devices = [torch.device("cuda", i) for i in range(dp * db)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != dp * db:
        raise ValueError(f"mesh {dp}x{db} needs {dp * db} devices, "
                         f"have {len(devices)}")
    return DeviceGrid([devices[g * db:(g + 1) * db] for g in range(dp)])
