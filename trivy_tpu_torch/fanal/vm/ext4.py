"""Read-only ext4 filesystem parser (reference pkg/fanal/vm/filesystem +
the go-ext4 library the reference walks VM images with).

Pure-Python, seek-based: superblock → group descriptors → inode table →
extent tree (or classic block map) → directory entries.  Supports the
features a default `mkfs.ext4` enables: 64bit, flex_bg, extents,
filetype, huge_file; classic indirect block maps for ext2/3-style
images; fast symlinks; htree directories (interior nodes read as the
fake linear dirents they are laid out as).

Copy of trivy_tpu/fanal/vm/ext4.py, with one repair: inline data
(`mkfs.ext4 -O inline_data`). The reference returns only i_block's 60
bytes of an inline file and parses an inline directory as a block of
dirents, so it truncates inline files over 60 bytes and walks no file
below an inline directory. Here the rest of an inline file or
directory comes from the in-inode extended attribute `system.data`,
and an inline directory's entries are read after its 4-byte parent
inode number.
"""

from __future__ import annotations

import stat
import struct
from dataclasses import dataclass
from typing import BinaryIO, Iterator

EXT4_MAGIC = 0xEF53
EXTENTS_FL = 0x80000
INLINE_DATA_FL = 0x10000000
XATTR_MAGIC = 0xEA020000
XATTR_INDEX_SYSTEM = 7
ROOT_INO = 2

INCOMPAT_64BIT = 0x80


class Ext4Error(Exception):
    pass


@dataclass
class Superblock:
    block_size: int
    blocks_per_group: int
    inodes_per_group: int
    inode_size: int
    first_data_block: int
    desc_size: int
    inodes_count: int


@dataclass
class Inode:
    ino: int
    mode: int
    size: int
    flags: int
    block: bytes  # raw 60-byte i_block area
    xattrs: bytes = b""  # in-inode extended attribute space

    @property
    def is_dir(self) -> bool:
        return stat.S_ISDIR(self.mode)

    @property
    def is_file(self) -> bool:
        return stat.S_ISREG(self.mode)

    @property
    def is_symlink(self) -> bool:
        return stat.S_ISLNK(self.mode)


@dataclass
class DirEntry:
    name: str
    ino: int
    file_type: int  # 1=file 2=dir 7=symlink (when filetype feature on)


class Ext4:
    """fh must be a seekable binary file positioned anywhere; `offset`
    is the byte offset of the filesystem inside it (partition start)."""

    def __init__(self, fh: BinaryIO, offset: int = 0):
        self.fh = fh
        self.offset = offset
        self.sb = self._read_superblock()
        self._group_desc_cache: dict[int, int] = {}

    # ------------------------------------------------------------ probe

    @staticmethod
    def probe(fh: BinaryIO, offset: int = 0) -> bool:
        try:
            fh.seek(offset + 1024 + 56)
            magic = struct.unpack("<H", fh.read(2))[0]
            return magic == EXT4_MAGIC
        except (OSError, struct.error):
            return False

    # ----------------------------------------------------------- layout

    def _read_at(self, off: int, size: int) -> bytes:
        self.fh.seek(self.offset + off)
        data = self.fh.read(size)
        if len(data) != size:
            raise Ext4Error(f"short read at {off}")
        return data

    def _read_block(self, block: int) -> bytes:
        return self._read_at(block * self.sb.block_size, self.sb.block_size)

    def _read_superblock(self) -> Superblock:
        raw = self._read_at(1024, 1024)
        magic = struct.unpack_from("<H", raw, 56)[0]
        if magic != EXT4_MAGIC:
            raise Ext4Error("not an ext4 filesystem (bad magic)")
        log_block_size = struct.unpack_from("<I", raw, 24)[0]
        feature_incompat = struct.unpack_from("<I", raw, 96)[0]
        desc_size = 32
        if feature_incompat & INCOMPAT_64BIT:
            desc_size = struct.unpack_from("<H", raw, 254)[0] or 64
        return Superblock(
            block_size=1024 << log_block_size,
            blocks_per_group=struct.unpack_from("<I", raw, 32)[0],
            inodes_per_group=struct.unpack_from("<I", raw, 40)[0],
            inode_size=struct.unpack_from("<H", raw, 88)[0] or 128,
            first_data_block=struct.unpack_from("<I", raw, 20)[0],
            desc_size=desc_size,
            inodes_count=struct.unpack_from("<I", raw, 0)[0],
        )

    def _inode_table_block(self, group: int) -> int:
        if group in self._group_desc_cache:
            return self._group_desc_cache[group]
        gd_start = (self.sb.first_data_block + 1) * self.sb.block_size
        raw = self._read_at(gd_start + group * self.sb.desc_size,
                            self.sb.desc_size)
        lo = struct.unpack_from("<I", raw, 8)[0]
        hi = struct.unpack_from("<I", raw, 40)[0] \
            if self.sb.desc_size >= 64 else 0
        block = (hi << 32) | lo
        self._group_desc_cache[group] = block
        return block

    def inode(self, ino: int) -> Inode:
        if not 1 <= ino <= self.sb.inodes_count:
            raise Ext4Error(f"inode {ino} out of range")
        group, index = divmod(ino - 1, self.sb.inodes_per_group)
        table = self._inode_table_block(group)
        off = table * self.sb.block_size + index * self.sb.inode_size
        raw = self._read_at(off, self.sb.inode_size)
        size_lo = struct.unpack_from("<I", raw, 4)[0]
        size_hi = struct.unpack_from("<I", raw, 108)[0] \
            if self.sb.inode_size > 108 else 0
        xattrs = b""
        if self.sb.inode_size > 130:
            extra_isize = struct.unpack_from("<H", raw, 128)[0]
            xattrs = raw[128 + extra_isize:]
        return Inode(
            ino=ino,
            mode=struct.unpack_from("<H", raw, 0)[0],
            size=(size_hi << 32) | size_lo,
            flags=struct.unpack_from("<I", raw, 32)[0],
            block=raw[40:100],
            xattrs=xattrs,
        )

    # ------------------------------------------------------- file data

    def _extent_blocks(self, node_raw: bytes) -> Iterator[tuple[int, int, int]]:
        """Yield (logical_block, physical_block, count) from an extent
        tree node, recursing through index nodes."""
        magic, entries, _max, depth = struct.unpack_from("<HHHH", node_raw, 0)
        if magic != 0xF30A:
            raise Ext4Error("bad extent magic")
        if depth == 0:
            for i in range(entries):
                off = 12 + i * 12
                ee_block, ee_len, hi, lo = struct.unpack_from(
                    "<IHHI", node_raw, off)
                if ee_len > 32768:
                    # unwritten extent: allocated but uninitialized — reads
                    # as zeros, so treat it as a hole rather than exposing
                    # whatever stale bytes sit on disk
                    continue
                yield ee_block, (hi << 32) | lo, ee_len
        else:
            for i in range(entries):
                off = 12 + i * 12
                _ei_block, leaf_lo, leaf_hi, _ = struct.unpack_from(
                    "<IIHH", node_raw, off)
                child = (leaf_hi << 32) | leaf_lo
                yield from self._extent_blocks(self._read_block(child))

    def _classic_blocks(self, inode: Inode,
                        n_blocks: int) -> Iterator[int]:
        """ext2/3-style direct + (double/triple) indirect block map."""
        ids = struct.unpack("<15I", inode.block)
        per = self.sb.block_size // 4
        emitted = 0

        def emit(block_id):
            nonlocal emitted
            emitted += 1
            return block_id

        for b in ids[:12]:
            if emitted >= n_blocks:
                return
            yield emit(b)

        def indirect(block_id, level):
            nonlocal emitted
            if block_id == 0:
                # sparse hole covering the whole subtree
                for _ in range(per ** level):
                    if emitted >= n_blocks:
                        return
                    yield emit(0)
                return
            table = struct.unpack(f"<{per}I", self._read_block(block_id))
            for entry in table:
                if emitted >= n_blocks:
                    return
                if level == 1:
                    yield emit(entry)
                else:
                    yield from indirect(entry, level - 1)

        for level, b in enumerate(ids[12:15], start=1):
            if emitted >= n_blocks:
                return
            yield from indirect(b, level)

    def read_file(self, inode: Inode, limit: int | None = None) -> bytes:
        size = inode.size if limit is None else min(inode.size, limit)
        if inode.flags & INLINE_DATA_FL:
            return self._inline_data(inode)[:size]
        bs = self.sb.block_size
        n_blocks = (inode.size + bs - 1) // bs
        out = bytearray()
        if inode.flags & EXTENTS_FL:
            chunks: dict[int, tuple[int, int]] = {}
            for logical, physical, count in self._extent_blocks(inode.block):
                chunks[logical] = (physical, count)
            pos = 0
            while pos < n_blocks and len(out) < size:
                if pos in chunks:
                    physical, count = chunks[pos]
                    want = min(count, n_blocks - pos)
                    out += self._read_at(physical * bs, want * bs)
                    pos += want
                else:
                    # hole: find next mapped logical block
                    nxt = min((l for l in chunks if l > pos),
                              default=n_blocks)
                    out += b"\x00" * ((nxt - pos) * bs)
                    pos = nxt
        else:
            for b in self._classic_blocks(inode, n_blocks):
                if len(out) >= size:
                    break
                out += b"\x00" * bs if b == 0 else self._read_block(b)
        return bytes(out[:size])

    def read_symlink(self, inode: Inode) -> str:
        if inode.size < 60 and not inode.flags & EXTENTS_FL:
            return inode.block[:inode.size].decode("utf-8", "replace")
        return self.read_file(inode).decode("utf-8", "replace")

    # ------------------------------------------------------ directories

    @staticmethod
    def _inline_data(inode: Inode) -> bytes:
        """An inline inode's data: i_block's 60 bytes, then the value of
        its in-inode extended attribute `system.data`, if any."""
        area = inode.xattrs
        if len(area) < 4 or struct.unpack_from("<I", area)[0] != XATTR_MAGIC:
            return inode.block
        off = 4
        while off + 16 <= len(area) and area[off:off + 4] != b"\0" * 4:
            name_len, index, value_off, _inum, value_size = \
                struct.unpack_from("<BBHII", area, off)
            if index == XATTR_INDEX_SYSTEM and \
                    area[off + 16:off + 16 + name_len] == b"data":
                # value offsets count from the first entry
                return inode.block + area[4 + value_off:
                                          4 + value_off + value_size]
            off += (16 + name_len + 3) & ~3
        return inode.block

    def read_dir(self, inode: Inode) -> list[DirEntry]:
        if inode.flags & INLINE_DATA_FL:
            # the parent's inode number, then dirents to i_block's end,
            # then more in system.data (the parent is not listed)
            data = self._inline_data(inode)
            return self._dirents(data[4:60]) + self._dirents(data[60:])
        return self._dirents(self.read_file(inode))

    @staticmethod
    def _dirents(data: bytes) -> list[DirEntry]:
        out = []
        off = 0
        while off + 8 <= len(data):
            ino, rec_len, name_len, ftype = struct.unpack_from(
                "<IHBB", data, off)
            if rec_len < 8:
                break
            if ino != 0 and name_len:
                name = data[off + 8:off + 8 + name_len].decode(
                    "utf-8", "replace")
                if name not in (".", ".."):
                    out.append(DirEntry(name=name, ino=ino, file_type=ftype))
            off += rec_len
        return out

    def walk(self, max_file_size: int | None = None
             ) -> Iterator[tuple[str, Inode]]:
        """Yield (path, inode) for every regular file, DFS from root."""
        seen: set[int] = set()
        stack: list[tuple[str, int]] = [("", ROOT_INO)]
        while stack:
            prefix, ino = stack.pop()
            if ino in seen:
                continue
            seen.add(ino)
            try:
                node = self.inode(ino)
                entries = self.read_dir(node)
            except Ext4Error:
                continue
            for e in sorted(entries, key=lambda d: d.name, reverse=True):
                path = f"{prefix}/{e.name}" if prefix else e.name
                try:
                    child = self.inode(e.ino)
                except Ext4Error:
                    continue
                if child.is_dir:
                    stack.append((path, e.ino))
                elif child.is_file:
                    yield path, child
