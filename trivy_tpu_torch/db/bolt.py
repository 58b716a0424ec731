"""Read-only BoltDB (etcd-io/bbolt) file parser, plus a minimal writer
for small test fixtures.

trivy-db, trivy-java-db, the reference's cache files, and containerd's
metadata store are all BoltDB files; consuming them directly (reference
links the Go bbolt library, pkg/db/db.go:36-38) means this framework can
import the REAL advisory artifacts instead of requiring a JSON
conversion step.

Format (bbolt on-disk layout):
- fixed 16-byte page header {id u64, flags u16, count u16, overflow u32};
  flags: 0x01 branch, 0x02 leaf, 0x04 meta, 0x10 freelist
- meta page: magic 0xED0CDAED, version 2, pageSize, flags, root bucket
  {root pgid, sequence}, freelist pgid, high-water pgid, txid, checksum —
  the valid meta with the highest txid wins
- leaf elements {flags u32, pos u32, ksize u32, vsize u32} (pos relative
  to the element struct); element flag 0x01 marks a nested bucket whose
  value is {root pgid u64, sequence u64} + (root==0: an inline page)
- branch elements {pos u32, ksize u32, pgid u64}
- a page with overflow N spans N+1 contiguous pageSize units

Copy of trivy_tpu/db/bolt.py.
"""

from __future__ import annotations

import struct

MAGIC = 0xED0CDAED
PAGE_HEADER = struct.Struct("<QHHI")
LEAF_ELEM = struct.Struct("<IIII")
BRANCH_ELEM = struct.Struct("<IIQ")
BUCKET_HEADER = struct.Struct("<QQ")
META = struct.Struct("<IIIIQQQQQQ")

FLAG_BRANCH = 0x01
FLAG_LEAF = 0x02
FLAG_META = 0x04
BUCKET_LEAF_FLAG = 0x01


class BoltError(Exception):
    pass


class Bucket:
    """A bucket positioned at a page (or an inline page buffer)."""

    def __init__(self, db: "BoltDB", root: int, inline: bytes | None = None):
        self.db = db
        self.root = root
        self.inline = inline

    def _page(self, pgid: int) -> tuple[bytes, int]:
        """-> (buffer, offset of page header)."""
        if pgid == 0 and self.inline is not None:
            return self.inline, 0
        return self.db.page(pgid)

    def items(self):
        """Yield (key, value, sub_bucket_or_None) in key order."""
        yield from self._walk(self.root)

    def _walk(self, pgid: int):
        buf, off = self._page(pgid)
        _id, flags, count, _ov = PAGE_HEADER.unpack_from(buf, off)
        body = off + PAGE_HEADER.size
        if flags & FLAG_LEAF:
            for i in range(count):
                eoff = body + i * LEAF_ELEM.size
                eflags, pos, ksize, vsize = LEAF_ELEM.unpack_from(buf, eoff)
                kstart = eoff + pos
                key = bytes(buf[kstart:kstart + ksize])
                val = bytes(buf[kstart + ksize:kstart + ksize + vsize])
                if eflags & BUCKET_LEAF_FLAG:
                    sub_root, _seq = BUCKET_HEADER.unpack_from(val, 0)
                    inline = val[BUCKET_HEADER.size:] if sub_root == 0 \
                        else None
                    yield key, None, Bucket(self.db, sub_root, inline)
                else:
                    yield key, val, None
        elif flags & FLAG_BRANCH:
            for i in range(count):
                eoff = body + i * BRANCH_ELEM.size
                _pos, _ksize, child = BRANCH_ELEM.unpack_from(buf, eoff)
                yield from self._walk(child)
        else:
            raise BoltError(f"unexpected page flags {flags:#x}")

    def get(self, key: bytes) -> bytes | None:
        for k, v, _sub in self.items():
            if k == key:
                return v
        return None

    def bucket(self, key: bytes) -> "Bucket | None":
        for k, _v, sub in self.items():
            if k == key and sub is not None:
                return sub
        return None

    def sub_buckets(self):
        for k, _v, sub in self.items():
            if sub is not None:
                yield k, sub

    def pairs(self):
        for k, v, sub in self.items():
            if sub is None:
                yield k, v


class BoltDB:
    def __init__(self, path: str):
        import mmap

        # mmap, not read(): real trivy-db artifacts are hundreds of MB
        # and access is page-at-offset — no reason to copy the file
        self._f = open(path, "rb")
        try:
            self.data = memoryview(mmap.mmap(
                self._f.fileno(), 0, access=mmap.ACCESS_READ))
        except ValueError:  # empty file
            self._f.close()
            raise BoltError(f"{path} is not a boltdb file")
        def read_meta(off: int):
            if off + PAGE_HEADER.size + META.size > len(self.data):
                return None
            _id, flags, _c, _ov = PAGE_HEADER.unpack_from(self.data, off)
            if not flags & FLAG_META:
                return None
            (magic, version, page_size, _mflags, root, _seq, _freelist,
             _pgid, txid, _checksum) = META.unpack_from(
                self.data, off + PAGE_HEADER.size)
            if magic != MAGIC or version != 2:
                return None
            return (txid, page_size, root)

        # meta0 is at offset 0 and records the page size; meta1 follows
        # at one page (16K on hosts where bbolt used a 16K os page).
        # Fallback offsets cover a corrupt meta0.
        best = None
        m0 = read_meta(0)
        candidates = [m0]
        for off in {m0[1] if m0 else 0, 4096, 16384, 65536} - {0}:
            candidates.append(read_meta(off))
        for m in candidates:
            if m is not None and (best is None or m[0] > best[0]):
                best = m
        if best is None:
            raise BoltError(f"{path} is not a boltdb file")
        self.page_size = best[1]
        self.root = Bucket(self, best[2])

    def page(self, pgid: int) -> tuple[bytes, int]:
        off = pgid * self.page_size
        if off >= len(self.data):
            raise BoltError(f"page {pgid} out of range")
        return self.data, off

    def buckets(self):
        """Top-level (name, Bucket) pairs."""
        yield from self.root.sub_buckets()

    def bucket(self, *names: bytes) -> Bucket | None:
        b = self.root
        for n in names:
            b = b.bucket(n)
            if b is None:
                return None
        return b


# ---------------------------------------------------------------- writer
#
# Minimal fixture writer: the whole tree must fit leaf pages (no branch
# pages) — ample for tests and small generated fixtures.


def _inline_bucket(items: dict) -> bytes:
    """items: {key: bytes | dict} -> bucket value with an inline page."""
    page = _leaf_page_body(items)
    return BUCKET_HEADER.pack(0, 0) + page


def _leaf_page_body(items: dict, pgid: int = 0) -> bytes:
    entries = []
    for k in sorted(items):
        v = items[k]
        key = k if isinstance(k, bytes) else str(k).encode()
        if isinstance(v, dict):
            entries.append((BUCKET_LEAF_FLAG, key, _inline_bucket(v)))
        else:
            entries.append((0, key, v if isinstance(v, bytes)
                            else str(v).encode()))
    n = len(entries)
    header = PAGE_HEADER.pack(pgid, FLAG_LEAF, n, 0)
    elems = bytearray()
    payload = bytearray()
    payload_base = n * LEAF_ELEM.size
    for i, (flags, key, val) in enumerate(entries):
        pos = payload_base + len(payload) - i * LEAF_ELEM.size
        elems += LEAF_ELEM.pack(flags, pos, len(key), len(val))
        payload += key + val
    return header + bytes(elems) + bytes(payload)


def write_bolt(path: str, tree: dict, page_size: int = 4096) -> None:
    """Write {bucket: {key: value | nested dict}} as a boltdb file. Each
    top-level bucket gets its own page; nested buckets are inline (so
    they must stay < ~page budget — fixture-sized data only)."""
    pages: dict[int, bytes] = {}
    root_items: dict = {}
    next_pgid = 4
    for name in sorted(tree):
        body = _leaf_page_body(tree[name], next_pgid)
        n_pages = -(-len(body) // page_size)
        if n_pages > 1:  # rewrite header with overflow count
            _id, flags, count, _ov = PAGE_HEADER.unpack_from(body, 0)
            body = PAGE_HEADER.pack(_id, flags, count, n_pages - 1) \
                + body[PAGE_HEADER.size:]
        pages[next_pgid] = body
        key = name if isinstance(name, bytes) else str(name).encode()
        root_items[key] = ("__page__", next_pgid)
        next_pgid += n_pages

    # root bucket leaf page referencing the top-level bucket pages
    entries = []
    for key in sorted(root_items):
        _tag, pgid = root_items[key]
        entries.append((BUCKET_LEAF_FLAG, key, BUCKET_HEADER.pack(pgid, 0)))
    root_pgid = next_pgid
    n = len(entries)
    elems = bytearray()
    payload = bytearray()
    payload_base = n * LEAF_ELEM.size
    for i, (flags, key, val) in enumerate(entries):
        pos = payload_base + len(payload) - i * LEAF_ELEM.size
        elems += LEAF_ELEM.pack(flags, pos, len(key), len(val))
        payload += key + val
    root_page = PAGE_HEADER.pack(root_pgid, FLAG_LEAF, n, 0) \
        + bytes(elems) + bytes(payload)
    pages[root_pgid] = root_page
    high_water = root_pgid + 1

    def meta(pgid: int, txid: int) -> bytes:
        header = PAGE_HEADER.pack(pgid, FLAG_META, 0, 0)
        body = META.pack(MAGIC, 2, page_size, 0, root_pgid, 0, 2,
                         high_water, txid, 0)
        return header + body

    freelist = PAGE_HEADER.pack(2, 0x10, 0, 0)
    blob = bytearray(high_water * page_size)

    def put(pgid: int, raw: bytes):
        blob[pgid * page_size: pgid * page_size + len(raw)] = raw

    put(0, meta(0, 0))
    put(1, meta(1, 1))
    put(2, freelist)
    put(3, PAGE_HEADER.pack(3, FLAG_LEAF, 0, 0))  # spare empty page
    for pgid, body in pages.items():
        put(pgid, body)
    # lint: allow[atomic-write] single-shot generated bolt fixture, no reader until return
    with open(path, "wb") as f:
        f.write(bytes(blob))
