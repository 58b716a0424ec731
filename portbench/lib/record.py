"""What one run of a cell hands to the metric readers and the judge."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Check:
    """One number compared for `correct`, with its limit: the run is
    correct only where every value is at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Run:
    """One run: set-up and window seconds, the work done in the window,
    each call's seconds, the program's counters over the window, the
    device trace (traced runs), the cell's inputs the rooflines count
    from, and the checks."""

    system: str
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    # work completed in the window, by kind ("packages", "file_bytes")
    done: dict = field(default_factory=dict)
    call_s: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    trace: dict | None = None
    inputs: dict = field(default_factory=dict)
    checks: list = field(default_factory=list)
    memory_peak_bytes: int = 0
    device_kind: str = ""
    notes: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def percentile(values, q: float) -> float | None:
    """The `q`-th percentile of `values` by the nearest rank, or None
    when there are none."""
    vals = sorted(values)
    if not vals:
        return None
    rank = max(1, -(-int(round(q * len(vals) * 1000)) // 100_000))
    return vals[min(rank, len(vals)) - 1]


def call_p95_ms(run: Run) -> float | None:
    """The 95th percentile of the window's call spans, in ms."""
    p = percentile(run.call_s, 95)
    return None if p is None else p * 1e3


def idle_share(run: Run) -> float | None:
    """One less the device's busy seconds over the traced window's;
    None untraced or where no operation ran on the device."""
    t = run.trace
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
