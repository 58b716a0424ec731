"""Minimal dataclass <-> dict structuring for cache round-trips
(asdict on the way in, from_dict on the way out).

Copy of trivy_tpu/types/serde.py.
"""

from __future__ import annotations

import dataclasses
import enum
import types as _pytypes
import typing


# (class -> resolved type hints) memo: get_type_hints re-compiles every
# stringified annotation on every call, which dominated server-side blob
# decoding (~1s per 1k-package artifact); hints are per-class constants
_HINTS: dict[type, dict] = {}
_FIELDS: dict[type, tuple] = {}


def from_dict(cls, d):
    """Rebuild a dataclass (recursively) from an asdict() dict."""
    if d is None:
        return None
    if not dataclasses.is_dataclass(cls):
        return d
    hints = _HINTS.get(cls)
    if hints is None:
        hints = typing.get_type_hints(cls)
        # _FIELDS publishes first: a concurrent decoder that sees the
        # _HINTS entry must never miss the fields entry (GIL-atomic
        # dict stores; no lock needed for idempotent values)
        _FIELDS[cls] = tuple(f.name for f in dataclasses.fields(cls))
        _HINTS[cls] = hints
    kwargs = {}
    for name in _FIELDS[cls]:
        if name not in d:
            continue
        kwargs[name] = _convert(hints.get(name), d[name])
    return cls(**kwargs)


def _convert(hint, value):
    if value is None or hint is None:
        return value
    origin = typing.get_origin(hint)
    if origin is typing.Union or origin is _pytypes.UnionType:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if len(args) == 1:
            return _convert(args[0], value)
        return value
    if origin in (list, tuple):
        (inner,) = typing.get_args(hint) or (None,)
        return [_convert(inner, v) for v in value]
    if origin is dict:
        return value
    if dataclasses.is_dataclass(hint) and isinstance(value, dict):
        return from_dict(hint, value)
    if isinstance(hint, type) and issubclass(hint, enum.Enum) \
            and not isinstance(value, enum.Enum):
        try:
            return hint(value)
        except ValueError:
            return value
    return value
