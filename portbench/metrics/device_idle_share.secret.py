"""The device's idle share of the traced window: one less the union of
its kernel, copy and set intervals (torch.profiler's CUDA activity) over
the window's length. Nothing untraced or where no operation ran."""

from portbench.lib.record import idle_share as read  # noqa: F401
