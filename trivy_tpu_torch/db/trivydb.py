"""Import a real trivy-db BoltDB file into AdvisoryDB (reference reads
it through the trivy-db Go library, pkg/db/db.go:36-38; bucket shapes:
trivy-db pkg/vulnsrc/*).

Bucket dispatch mirrors the trivy-db layout exactly:
- "vulnerability": CVE id -> metadata JSON
- "data-source":   bucket name -> {ID, Name, URL}
- "Red Hat CPE":   repository / nvr / cpe index tables
- "Red Hat":       package -> CVE/RHSA -> {Entries: [CPE-indexed ...]}
- everything else: advisory buckets "<os> <release>" or
  "eco::Source" -> package -> CVE -> advisory JSON

Copy of trivy_tpu/db/trivydb.py.
"""

from __future__ import annotations

import json

from trivy_tpu_torch.db.bolt import BoltDB, BoltError
from trivy_tpu_torch.db.model import Advisory, DataSourceInfo, VulnerabilityMeta
from trivy_tpu_torch.db.store import AdvisoryDB
from trivy_tpu_torch.log import logger

_log = logger("trivydb")


def is_boltdb(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(24)
        return len(head) >= 24 and head[16:20] == b"\xed\xda\x0c\xed"
    except OSError:
        return False


def _json_val(raw: bytes):
    try:
        return json.loads(raw)
    except ValueError:
        return None


def load_trivy_db(path: str) -> AdvisoryDB:
    bolt = BoltDB(path)
    db = AdvisoryDB()
    ds_map: dict[str, DataSourceInfo] = {}
    pending: list[tuple[str, str, Advisory]] = []
    n_skipped = 0
    for bname, bucket in bolt.buckets():
        name = bname.decode("utf-8", "replace")
        if name == "vulnerability":
            for k, v in bucket.pairs():
                doc = _json_val(v)
                if isinstance(doc, dict):
                    db.put_meta(VulnerabilityMeta.from_json(
                        k.decode("utf-8", "replace"), doc))
            continue
        if name == "data-source":
            for k, v in bucket.pairs():
                doc = _json_val(v) or {}
                ds_map[k.decode("utf-8", "replace")] = DataSourceInfo(
                    id=doc.get("ID", ""), name=doc.get("Name", ""),
                    url=doc.get("URL", ""))
            continue
        if name == "Red Hat CPE":
            for kind_b, sub in bucket.sub_buckets():
                kind = kind_b.decode("utf-8", "replace")
                table = {}
                for k, v in sub.pairs():
                    table[k.decode("utf-8", "replace")] = _json_val(v)
                db.redhat_cpe[kind] = table
            continue
        if name == "Red Hat":
            for pkg_b, sub in bucket.sub_buckets():
                pkg = pkg_b.decode("utf-8", "replace")
                for k, v in sub.pairs():
                    doc = _json_val(v)
                    if isinstance(doc, dict):
                        db.put_redhat_entry(
                            pkg, k.decode("utf-8", "replace"),
                            doc.get("Entries") or [])
            continue
        # ordinary advisory bucket
        for pkg_b, sub in bucket.sub_buckets():
            pkg = pkg_b.decode("utf-8", "replace")
            for k, v in sub.pairs():
                doc = _json_val(v)
                if not isinstance(doc, dict):
                    n_skipped += 1
                    continue
                adv = Advisory.from_json(
                    {"VulnerabilityID": k.decode("utf-8", "replace"),
                     **doc})
                pending.append((name, pkg, adv))
    for bucket_name, pkg, adv in pending:
        if adv.data_source is None:
            adv.data_source = ds_map.get(bucket_name)
        db.put_advisory(bucket_name, pkg, adv)
    if db.redhat_entries:
        db.expand_redhat()
    _log.info("imported trivy-db", path=path, skipped=n_skipped,
              **db.stats())
    return db


def try_load(path: str) -> AdvisoryDB | None:
    """Load when `path` is a boltdb file; None otherwise."""
    if not is_boltdb(path):
        return None
    try:
        return load_trivy_db(path)
    except BoltError as exc:
        _log.warn("boltdb parse failed", path=path, err=str(exc))
        return None
