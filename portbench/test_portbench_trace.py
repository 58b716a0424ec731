"""The trace reduction on a made-up session: the window is the calls'
spans, and device time and idle gaps outside them do not count."""

from __future__ import annotations

from types import SimpleNamespace

from portbench.lib.trace import CALL_MARK, WINDOW_MARK, DeviceTrace


class _Event:
    def __init__(self, name, start, end, kind="CPU", annotation=False):
        self._n, self._s, self._d = name, start, end - start
        self._k, self._a = kind, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return f"DeviceType.{self._k}"

    def is_user_annotation(self):
        return self._a


def _reduce(events):
    tr = DeviceTrace(False)
    tr.prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return tr.reduce()


def test_window_is_the_calls_spans():
    ms = 1_000_000
    out = _reduce([
        _Event(WINDOW_MARK, 0, 100 * ms),
        _Event(CALL_MARK, 10 * ms, 30 * ms),
        _Event(CALL_MARK, 60 * ms, 70 * ms),
        _Event("cudaMemcpyAsync", 12 * ms, 20 * ms),
        _Event("match_kernel", 15 * ms, 25 * ms, "CUDA"),
        _Event("match_kernel", 40 * ms, 50 * ms, "CUDA"),  # between calls
        _Event("Memcpy HtoD", 65 * ms, 75 * ms, "CUDA"),  # runs past a call
        _Event(CALL_MARK, 65 * ms, 66 * ms, "CUDA", annotation=True),
    ])
    assert out["window_s"] == 0.030
    assert out["busy_s"] == 0.015
    assert out["kernel_s"] == 0.010
    gaps = sorted(out["idle_gaps"], key=lambda g: -g[1])
    assert [round(g[1], 6) for g in gaps] == [0.005, 0.005, 0.005]
    assert gaps[0][0] in ("cudaMemcpyAsync", CALL_MARK)


def test_whole_window_where_no_call_is_marked():
    ms = 1_000_000
    out = _reduce([_Event(WINDOW_MARK, 0, 10 * ms),
                   _Event("k", 2 * ms, 4 * ms, "CUDA")])
    assert out["window_s"] == 0.010 and out["busy_s"] == 0.002
