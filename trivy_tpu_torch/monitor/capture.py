"""Scan-time capture of package inventory + engine-level findings.

The monitor's unit of truth is the match layer: per artifact, the
exact `PkgQuery` set its detectors submitted and the engine-level
finding keys those queries produced.  Capturing at the engine handle
(rather than re-deriving from rendered reports) keeps the index's
inventory byte-exact with what a re-match will submit — the zero-diff
guarantee depends on it.

Zero cost when off: `tap()` returns the engine handle unchanged unless
an ambient `capture_scan()` scope is active on this context (the scan's
own thread; fleet lanes and server request threads each carry their
own contextvar).

Copy of trivy_tpu/monitor/capture.py."""

from __future__ import annotations

import contextlib
import contextvars

_collector: contextvars.ContextVar = contextvars.ContextVar(
    "trivy_tpu_torch_monitor_capture", default=None)


class ScanCapture:
    """Accumulates one scan's (space, name, version, scheme) package
    tuples and (…, vuln_id) finding tuples across its detect calls."""

    __slots__ = ("packages", "findings")

    def __init__(self):
        self.packages: set[tuple] = set()
        self.findings: set[tuple] = set()


@contextlib.contextmanager
def capture_scan():
    """Scope under which `tap()`-wrapped engine handles record every
    detect() call's queries and finding keys."""
    cap = ScanCapture()
    token = _collector.set(cap)
    try:
        yield cap
    finally:
        _collector.reset(token)


def current():
    """The ambient ScanCapture (None outside a capture_scan scope) —
    snapshot it in a submitting thread, adopt() it in the worker (a
    contextvar does not follow a scan onto its worker thread)."""
    return _collector.get()


@contextlib.contextmanager
def adopt(cap):
    """Install a current()-snapshotted capture in this thread."""
    if cap is None:
        yield
        return
    token = _collector.set(cap)
    try:
        yield
    finally:
        _collector.reset(token)


class _TapEngine:
    """Engine-handle wrapper recording detect() traffic into the
    ambient ScanCapture; everything else reads through."""

    __slots__ = ("_engine",)

    def __init__(self, engine):
        self._engine = engine

    def detect(self, queries: list) -> list:
        from trivy_tpu_torch.detector.engine import finding_keys

        results = self._engine.detect(queries)
        cap = _collector.get()
        if cap is not None:
            for r in results:
                cap.packages.add(r.query.key)
            cap.findings |= finding_keys(
                self._engine.cdb.advisories, results)
        return results

    def __getattr__(self, name: str):
        return getattr(self._engine, name)


def tap(engine_handle):
    """Wrap `engine_handle` for capture when a capture_scan() scope is
    active; otherwise hand it back untouched (the common path)."""
    if _collector.get() is None:
        return engine_handle
    return _TapEngine(engine_handle)
