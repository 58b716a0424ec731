"""The device's side of a traced window, from torch.profiler.

One profiler session covers the measured window of a `--trace 1` run,
and it is the first session of the process (a later session on an H100
has been seen to lose kernel events). The window is the sum of the
calls' spans, each marked by a `portbench.call` annotation (the whole
session by `portbench.window`), so device events and the window share
the profiler's clock; what the harness does between calls (drawing the
next call) lies outside it.

`reduce` turns the session into what the readers need: the seconds in
which an operation ran on the device (the union of kernel, copy and set
intervals), the summed kernel seconds, the operations that took most
time, and the longest idle gaps named by what the host was doing.
"""

from __future__ import annotations

import bisect
import contextlib

WINDOW_MARK = "portbench.window"
CALL_MARK = "portbench.call"


def _union(intervals: list[tuple[int, int]]) -> int:
    total = 0
    end = None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def _clip(intervals: list, segs: list[tuple[int, int]]) -> list:
    """The parts of `intervals` [(start, end, name)] that lie inside the
    sorted, disjoint segments `segs`."""
    starts = [s for s, _e in segs]
    out = []
    for s, e, n in intervals:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(segs) and segs[i][0] < e:
            lo, hi = max(s, segs[i][0]), min(e, segs[i][1])
            if hi > lo:
                out.append((lo, hi, n))
            i += 1
    return out


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


class DeviceTrace:
    """`with DeviceTrace(on) as tr:` around the window; `tr.call()`
    around each call; `tr.reduce()` after."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile, \
                record_function

            self.prof = self._stack.enter_context(profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            self._stack.enter_context(record_function(WINDOW_MARK))
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)

    def call(self):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(CALL_MARK)

    def reduce(self) -> dict | None:
        """-> {"window_s", "busy_s", "kernel_s", "device_ops",
        "idle_gaps"} over the calls' spans (the marked window where no
        call is marked), or None untraced."""
        if self.prof is None:
            return None
        events = self.prof.profiler.kineto_results.events()
        win = None
        host: list[tuple[int, int, str]] = []
        dev: list[tuple[int, int, str]] = []
        for e in events:
            s = e.start_ns()
            end = s + e.duration_ns()
            kind = str(e.device_type())
            if kind.endswith("CPU"):
                if e.name() == WINDOW_MARK:
                    win = (s, end)
                else:
                    host.append((s, end, e.name()))
            elif kind.endswith("CUDA") and not e.is_user_annotation() \
                    and not e.name().startswith("portbench."):
                # the annotations' copies on the device timeline are
                # not operations
                dev.append((s, end, e.name()))
        if win is None:
            return None
        segs = _union_segments([(s, e) for s, e, n in host
                                if n == CALL_MARK]) or [win]
        dev = _clip(dev, segs)
        busy = _union([(s, e) for s, e, _n in dev])
        kernels = [(s, e, n) for s, e, n in dev if not _is_copy(n)]
        by_name: dict[str, int] = {}
        for s, e, n in dev:
            by_name[n] = by_name.get(n, 0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {
            "window_s": sum(e - s for s, e in segs) / 1e9,
            "busy_s": busy / 1e9,
            "kernel_s": sum(e - s for s, e, _n in kernels) / 1e9,
            "device_ops": [[n, ns / 1e9] for n, ns in top],
            "idle_gaps": _idle_gaps(dev, host, segs),
        }


def _union_segments(intervals: list[tuple[int, int]]) -> list:
    """Sorted, disjoint segments covering `intervals`."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _idle_gaps(dev, host, segs: list[tuple[int, int]]) -> list:
    """The 10 longest stretches of the window's segments with no device
    operation, each named by the host event (not the window's or a
    call's mark) that overlaps it most; by the call mark where no other
    does."""
    edges = sorted((s, e) for s, e, _n in dev)
    gaps = []
    j = 0
    for w0, w1 in segs:
        cursor = w0
        while j < len(edges) and edges[j][0] < w1:
            s, e = edges[j]
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
            j += 1
        if w1 > cursor:
            gaps.append((cursor, w1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    out = []
    for g0, g1 in gaps:
        best, best_ns = "host", 0
        for s, e, n in host:
            ov = min(e, g1) - max(s, g0)
            if ov <= 0:
                continue
            if n == CALL_MARK:
                ov = ov // 1_000_000  # any other event names it first
            if ov > best_ns:
                best, best_ns = n, ov
        out.append([best, (g1 - g0) / 1e9])
    return out
