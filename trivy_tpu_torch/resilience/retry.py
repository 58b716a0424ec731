"""Retry policy with decorrelated jitter + per-scan deadline budgets.

The deadline is a *budget*, not a wall-clock timestamp: the client sends
the remaining budget (seconds, as decimal text) in the `X-Trivy-Deadline`
header, so client and server need no clock agreement. The server turns
the header back into a local Deadline and sheds work it cannot finish
(503 + Retry-After) instead of blocking the caller.

The current deadline propagates through the scan spine via a
thread-local scope (`deadline_scope`), so the RPC client and the local
driver's phase checkpoints see it without threading a parameter through
every signature. Scopes are per-thread: the CLI enters the scope inside
its scan worker thread, the server inside each request handler thread.

Copy of trivy_tpu/resilience/retry.py.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

DEADLINE_HEADER = "X-Trivy-Deadline"


class DeadlineExceeded(Exception):
    """The per-scan deadline budget ran out."""

    def __init__(self, msg: str, budget_s: float | None = None):
        super().__init__(msg)
        self.budget_s = budget_s


class Deadline:
    """A monotonic budget with an injectable clock (testable)."""

    __slots__ = ("budget_s", "_clock", "_expires")

    def __init__(self, budget_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.budget_s = float(budget_s)
        self._clock = clock
        self._expires = clock() + self.budget_s

    @classmethod
    def after(cls, budget_s: float,
              clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(budget_s, clock)

    def remaining(self) -> float:
        return self._expires - self._clock()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, what: str = "") -> None:
        if self.expired:
            where = f" during {what}" if what else ""
            raise DeadlineExceeded(
                f"deadline of {self.budget_s:.3f}s exhausted{where}",
                budget_s=self.budget_s)

    def header_value(self) -> str:
        return f"{max(self.remaining(), 0.0):.3f}"

    @classmethod
    def from_header(cls, value: str | None,
                    clock: Callable[[], float] = time.monotonic
                    ) -> "Deadline | None":
        if not value:
            return None
        try:
            budget = float(value)
        except ValueError:
            return None
        return cls(budget, clock)


_local = threading.local()


def current_deadline() -> Deadline | None:
    return getattr(_local, "deadline", None)


@contextlib.contextmanager
def deadline_scope(deadline: Deadline | None):
    """Make `deadline` ambient for this thread (None clears it — the
    degraded fallback path runs with the budget deliberately lifted)."""
    prev = current_deadline()
    _local.deadline = deadline
    try:
        yield deadline
    finally:
        _local.deadline = prev


def checkpoint(what: str = "") -> None:
    """Raise DeadlineExceeded if the ambient deadline has run out.
    Called between scan phases so a deadlined scan sheds promptly
    instead of finishing work nobody will wait for."""
    d = current_deadline()
    if d is not None:
        d.check(what)


@dataclass
class RetryPolicy:
    """Transient-failure retry with decorrelated jitter.

    delays() yields sleeps per the decorrelated-jitter recipe
    (sleep = min(cap, U(base, 3*prev))): successive waits spread out
    without the synchronized thundering herd of fixed exponential
    backoff. `sleep` and `seed` are injectable so tests are instant and
    deterministic.
    """

    attempts: int = 3
    base_s: float = 0.5
    cap_s: float = 10.0
    respect_retry_after: bool = True
    seed: int | None = None
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)

    def rng(self) -> random.Random:
        return random.Random(self.seed)

    def delays(self, rng: random.Random | None = None) -> Iterator[float]:
        rng = rng or self.rng()
        prev = self.base_s
        while True:
            prev = min(self.cap_s, rng.uniform(self.base_s, prev * 3.0))
            yield prev


def parse_retry_after(value: str | None) -> float | None:
    """HTTP Retry-After -> seconds (delta-seconds or HTTP-date)."""
    if not value:
        return None
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    try:
        from email.utils import parsedate_to_datetime
        import datetime

        when = parsedate_to_datetime(value)
        now = datetime.datetime.now(datetime.timezone.utc)
        return max(0.0, (when - now).total_seconds())
    except (TypeError, ValueError):
        return None
