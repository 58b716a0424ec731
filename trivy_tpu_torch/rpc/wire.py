"""Wire (de)serialization for RPC payloads (reference pkg/rpc/convert.go).

The wire shape is the internal dataclass shape (dataclasses.asdict with
enums rendered to their values) — full fidelity both ways, rebuilt via
types.serde.from_dict on receipt.

Body compression: request/response bodies above GZIP_MIN_BYTES travel
gzip-encoded when both ends negotiated it. The client always offers
``Accept-Encoding: gzip``; the server gzips large responses for such
clients and advertises its own capability with the ``X-Trivy-Gzip``
response header, after which the client gzips large REQUEST bodies too
(``Content-Encoding: gzip``). Ends that send no headers keep the plain
byte-identical wire: an old client never receives gzip, and an old
server never sees a gzipped request.

Copy of trivy_tpu/rpc/wire.py.
"""

from __future__ import annotations

import dataclasses
import enum
import gzip as _gzip
import json
import os
import zlib
from typing import Any

# responses/requests at or above this many bytes gzip when negotiated
GZIP_MIN_BYTES = int(os.environ.get("TRIVY_TPU_RPC_GZIP_MIN", "8192"))
# server capability advertisement: its presence on any response tells
# the client that gzip REQUEST bodies are understood
GZIP_CAPABLE_HEADER = "X-Trivy-Gzip"


def gzip_bytes(body: bytes) -> bytes:
    """Deterministic gzip frame (mtime pinned so identical payloads
    compress to identical bytes)."""
    return _gzip.compress(body, compresslevel=6, mtime=0)


def gunzip_bytes(body: bytes) -> bytes:
    """Inverse of gzip_bytes; every decode failure surfaces as OSError
    so both endpoints handle torn/corrupt frames through one branch."""
    try:
        return _gzip.decompress(body)
    except (EOFError, zlib.error) as exc:
        raise OSError(f"bad gzip body: {exc}") from exc

from trivy_tpu_torch.types.artifact import OS
from trivy_tpu_torch.types.report import Result
from trivy_tpu_torch.types.scan import ScanOptions
from trivy_tpu_torch.types.serde import from_dict


def _jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        # the ONE canonicalization site: dicts with non-string (int /
        # float) keys serialize sorted by their JSON key rendering, so
        # golden-byte tests never depend on insertion order at a new
        # call site; str-keyed dicts keep insertion order and today's
        # bytes exactly
        if any(not isinstance(k, str) for k in obj):
            return {k: _jsonable(v) for k, v in
                    sorted(obj.items(), key=lambda kv: str(kv[0]))}
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


def encode(obj: Any) -> bytes:
    return json.dumps(_jsonable(obj), ensure_ascii=False).encode()


def scan_request(target: str, artifact_key: str, blob_keys: list[str],
                 options: ScanOptions) -> bytes:
    return encode({
        "target": target,
        "artifact_id": artifact_key,
        "blob_ids": blob_keys,
        "options": options,
    })


def decode_scan_request(body: bytes) -> tuple[str, str, list[str], ScanOptions]:
    doc = json.loads(body)
    return (
        doc.get("target", ""),
        doc.get("artifact_id", ""),
        doc.get("blob_ids", []) or [],
        from_dict(ScanOptions, doc.get("options") or {}),
    )


def scan_response(results: list[Result], os_found: OS) -> bytes:
    return encode({"results": results, "os": os_found})


def decode_scan_response(body: bytes) -> tuple[list[Result], OS]:
    doc = json.loads(body)
    results = [from_dict(Result, r) for r in doc.get("results") or []]
    os_found = from_dict(OS, doc.get("os") or {}) or OS()
    return results, os_found
