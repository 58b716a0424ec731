"""Closed / open / half-open circuit breaker with an injectable clock.

State machine:

    closed    -- N consecutive failures -->        open
    open      -- recovery_s elapsed -->            half-open
    half-open -- trial success -->                 closed
    half-open -- trial failure -->                 open (timer restarts)

In half-open at most `half_open_max` trial calls are admitted until one
of them settles; everything else is shed. All transitions happen under
one lock so concurrent callers observe a consistent state.

Copy of trivy_tpu/resilience/breaker.py.
"""

from __future__ import annotations

import threading

from trivy_tpu_torch.analysis.witness import make_lock
import time
from typing import Callable

from trivy_tpu_torch.obs import metrics as obs_metrics

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

_STATE_VALUE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class BreakerOpen(Exception):
    """Call refused because the breaker is open."""

    def __init__(self, name: str, retry_in: float):
        super().__init__(
            f"circuit breaker {name!r} is open (retry in {retry_in:.1f}s)")
        self.retry_in = retry_in


class CircuitBreaker:
    def __init__(self, failure_threshold: int = 5, recovery_s: float = 30.0,
                 half_open_max: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "breaker"):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.recovery_s = recovery_s
        self.half_open_max = half_open_max
        self.name = name
        self._clock = clock
        self._lock = make_lock("resilience.breaker._lock")
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._trials = 0
        obs_metrics.BREAKER_STATE.set(0, name=name)

    def _set_state(self, state: str) -> None:
        # lock held by caller; publishes the trivy_tpu_breaker_state
        # gauge + transition counter on every actual state change
        if state == self._state:
            return
        self._state = state
        obs_metrics.BREAKER_STATE.set(_STATE_VALUE[state], name=self.name)
        obs_metrics.BREAKER_TRANSITIONS.inc(name=self.name, state=state)

    # ------------------------------------------------------------ state

    @property
    def state(self) -> str:
        with self._lock:
            self._tick()
            return self._state

    def retry_in(self) -> float:
        """Seconds until an open breaker admits a trial call (0 if it
        already would)."""
        with self._lock:
            self._tick()
            if self._state != OPEN:
                return 0.0
            return max(0.0, self._opened_at + self.recovery_s
                       - self._clock())

    def _tick(self) -> None:
        # lock held by caller
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.recovery_s:
            self._set_state(HALF_OPEN)
            self._trials = 0

    def _trip(self) -> None:
        # lock held by caller
        self._set_state(OPEN)
        self._opened_at = self._clock()
        self._failures = 0
        self._trials = 0

    # ------------------------------------------------------------ calls

    def allow(self) -> bool:
        """May a call proceed right now? Half-open admissions consume a
        trial slot; callers MUST follow up with record_success or
        record_failure."""
        with self._lock:
            self._tick()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and self._trials < self.half_open_max:
                self._trials += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._tick()
            self._set_state(CLOSED)
            self._failures = 0
            self._trials = 0

    def record_failure(self) -> None:
        with self._lock:
            self._tick()
            if self._state == HALF_OPEN:
                self._trip()  # the trial failed: back to open, timer reset
                return
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._trip()

    def call(self, fn, *args, **kwargs):
        """Run fn through the breaker; raises BreakerOpen when shed."""
        if not self.allow():
            raise BreakerOpen(self.name, self.retry_in())
        try:
            out = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out
