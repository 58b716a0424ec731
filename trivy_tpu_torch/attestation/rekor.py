"""Rekor transparency-log client (reference pkg/rekor/client.go):
search the index by artifact digest, retrieve entries, and extract the
attached in-toto attestation.  Plain REST over urllib — network-gated;
used by the unpackaged-file SBOM discovery handler.

Copy of trivy_tpu/attestation/rekor.py.
"""

from __future__ import annotations

import base64
import json
import urllib.request
from dataclasses import dataclass

DEFAULT_URL = "https://rekor.sigstore.dev"
MAX_GET_ENTRIES = 10  # reference client.go:20

_TREE_ID_LEN = 16
_UUID_LEN = 64


class RekorError(Exception):
    pass


class OverGetEntriesLimit(RekorError):
    pass


@dataclass(frozen=True)
class EntryID:
    tree_id: str
    uuid: str

    @classmethod
    def parse(cls, entry_id: str) -> "EntryID":
        if len(entry_id) == _TREE_ID_LEN + _UUID_LEN:
            return cls(entry_id[:_TREE_ID_LEN], entry_id[_TREE_ID_LEN:])
        if len(entry_id) == _UUID_LEN:
            return cls("", entry_id)
        raise RekorError(f"invalid Entry ID length: {len(entry_id)}")

    def __str__(self) -> str:
        return self.tree_id + self.uuid


@dataclass
class Entry:
    statement: bytes  # raw DSSE/in-toto attestation bytes


class Client:
    def __init__(self, url: str = DEFAULT_URL, timeout: float = 30.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def _post(self, path: str, body: dict):
        req = urllib.request.Request(
            self.url + path,
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json",
                     "Accept": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except (OSError, ValueError) as e:
            raise RekorError(f"rekor {path}: {e}") from e

    def search(self, hash_: str) -> list[EntryID]:
        """POST /api/v1/index/retrieve {hash} -> entry IDs
        (reference client.go:75-92)."""
        payload = self._post("/api/v1/index/retrieve", {"hash": hash_})
        return [EntryID.parse(e) for e in payload or []]

    def get_entries(self, entry_ids: list[EntryID]) -> list[Entry]:
        """POST /api/v1/log/entries/retrieve -> attestation bytes
        (reference client.go:94-130)."""
        if len(entry_ids) > MAX_GET_ENTRIES:
            raise OverGetEntriesLimit(
                f"over get entries limit ({MAX_GET_ENTRIES})")
        if not entry_ids:
            return []
        payload = self._post("/api/v1/log/entries/retrieve",
                             {"entryUUIDs": [str(e) for e in entry_ids]})
        out = []
        for resp in payload or []:
            for _uuid, entry in (resp or {}).items():
                att = (entry.get("attestation") or {}).get("data")
                if att:
                    out.append(Entry(statement=base64.b64decode(att)))
        return out
