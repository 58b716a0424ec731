"""Structured logging with prefixes, colors, trace correlation, and an
optional JSON line format for fleet runs.

Re-expression of the reference slog setup (pkg/log/logger.go:14-35,
handler.go colored tty handler, context.go prefixes) on Python logging,
plus the observability spine's correlation fields: every record carries
the ambient trace_id / span_id / scan_id (obs.tracing contextvars) so a
log line joins the span tree it was emitted under
(docs/observability.md).

Copy of trivy_tpu/log.py; its loggers live under the name
``trivy_tpu_torch``.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

_COLORS = {
    logging.DEBUG: "\x1b[35m",  # magenta
    logging.INFO: "\x1b[34m",  # blue
    logging.WARNING: "\x1b[33m",  # yellow
    logging.ERROR: "\x1b[31m",  # red
}
_RESET = "\x1b[0m"
_PREFIX_COLOR = "\x1b[36m"  # cyan, like the reference's prefix rendering

_tracing = None  # lazy module ref (obs.tracing lazily imports us back)


def _trace_fields() -> dict | None:
    global _tracing
    if _tracing is None:
        from trivy_tpu_torch.obs import tracing

        _tracing = tracing
    return _tracing.log_fields()


class _Formatter(logging.Formatter):
    # timestamps render with a "Z" suffix, so they must BE UTC — the
    # default formatTime uses localtime
    converter = time.gmtime

    def __init__(self, color: bool):
        super().__init__()
        self.color = color

    def format(self, record: logging.LogRecord) -> str:
        ts = self.formatTime(record, "%Y-%m-%dT%H:%M:%SZ")
        level = record.levelname
        prefix = getattr(record, "prefix", "")
        msg = record.getMessage()
        kvs = dict(getattr(record, "kvs", None) or {})
        kvs.update(getattr(record, "trace", None) or {})
        kv_str = "".join(f"\t{k}={v}" for k, v in kvs.items())
        if self.color:
            c = _COLORS.get(record.levelno, "")
            level = f"{c}{level}{_RESET}"
            if prefix:
                prefix = f"{_PREFIX_COLOR}[{prefix}]{_RESET} "
        elif prefix:
            prefix = f"[{prefix}] "
        return f"{ts}\t{level}\t{prefix}{msg}{kv_str}"


class _JSONFormatter(logging.Formatter):
    """One JSON object per line (--log-format json): fleet runs feed
    these into log pipelines, joined to traces via trace_id/span_id/
    scan_id."""

    converter = time.gmtime  # "Z"-suffixed ts must be UTC

    def format(self, record: logging.LogRecord) -> str:
        doc: dict = {
            "ts": self.formatTime(record, "%Y-%m-%dT%H:%M:%SZ"),
            "level": record.levelname,
            "msg": record.getMessage(),
        }
        prefix = getattr(record, "prefix", "")
        if prefix:
            doc["logger"] = prefix
        doc.update(getattr(record, "trace", None) or {})
        for k, v in (getattr(record, "kvs", None) or {}).items():
            doc.setdefault(k, v)
        return json.dumps(doc, default=str)


class Logger:
    """Thin wrapper adding the reference's prefix + key/value style."""

    def __init__(self, name: str = "trivy_tpu_torch", prefix: str = ""):
        self._log = logging.getLogger(name)
        self._prefix = prefix

    def with_prefix(self, prefix: str) -> "Logger":
        return Logger(self._log.name, prefix)

    def _emit(self, level: int, msg: str, kwargs: dict) -> None:
        if not self._log.isEnabledFor(level):
            return
        self._log.log(level, msg, extra={
            "prefix": self._prefix, "kvs": kwargs,
            "trace": _trace_fields(),
        })

    def debug(self, msg: str, **kw) -> None:
        self._emit(logging.DEBUG, msg, kw)

    def info(self, msg: str, **kw) -> None:
        self._emit(logging.INFO, msg, kw)

    def warn(self, msg: str, **kw) -> None:
        self._emit(logging.WARNING, msg, kw)

    warning = warn

    def error(self, msg: str, **kw) -> None:
        self._emit(logging.ERROR, msg, kw)


_initialized = False


def init(debug: bool = False, quiet: bool = False,
         fmt: str = "text") -> None:
    global _initialized
    root = logging.getLogger("trivy_tpu_torch")
    root.handlers.clear()
    handler = logging.StreamHandler(sys.stderr)
    if fmt == "json":
        handler.setFormatter(_JSONFormatter())
    else:
        color = sys.stderr.isatty() and os.environ.get("NO_COLOR") is None
        handler.setFormatter(_Formatter(color))
    root.addHandler(handler)
    if quiet:
        root.setLevel(logging.CRITICAL + 1)
    else:
        root.setLevel(logging.DEBUG if debug else logging.INFO)
    _initialized = True


def logger(prefix: str = "") -> Logger:
    if not _initialized:
        init()
    return Logger(prefix=prefix)
