"""Read-only XFS filesystem parser (reference pkg/fanal/vm/filesystem
walks xfs via the masahiro331/go-xfs-filesystem library; this is an
independent implementation of the on-disk format).

Pure-Python, seek-based, big-endian throughout. Supports what `mkfs.xfs`
defaults produce (v5: CRC-enabled metadata, ftype dirents, dinode v3)
plus v4 layouts: shortform/local directories, extent-format files and
directories (block and leaf/node forms — leaf metadata lives past the
32 GiB logical boundary and is simply not walked), B+tree extent maps
for heavily fragmented files, inline and remote symlinks. CRCs are not
verified — this is a scanner, not a repair tool.

Interface mirrors vm/ext4.py: probe(fh, offset), walk() yielding
(path, Inode), read_file(inode), read_symlink(inode).

Copy of trivy_tpu/fanal/vm/xfs.py, whole.
"""

from __future__ import annotations

import stat
import struct
from dataclasses import dataclass
from typing import BinaryIO, Iterator

XFS_MAGIC = b"XFSB"
DINODE_MAGIC = 0x494E  # "IN"

# di_format values
FMT_DEV = 0
FMT_LOCAL = 1
FMT_EXTENTS = 2
FMT_BTREE = 3

INCOMPAT_FTYPE = 0x1

# directory data block magics
DIR_MAGIC_BLOCK = (b"XD2B", b"XDB3")  # single-block form (has tail)
DIR_MAGIC_DATA = (b"XD2D", b"XDD3")  # data blocks of leaf/node dirs
BMAP_MAGIC = (b"BMAP", b"BMA3")  # long-form bmbt nodes
SYMLINK_MAGIC = b"XSLM"

# leaf/free dir blocks live at logical byte offset >= 32 GiB
DIR_LEAF_OFFSET = 32 * 1024 ** 3


class XfsError(Exception):
    pass


@dataclass
class Superblock:
    block_size: int
    agblocks: int
    agcount: int
    inode_size: int
    inopblock: int
    inopblog: int
    agblklog: int
    dirblklog: int
    rootino: int
    version: int
    ftype: bool


@dataclass
class Inode:
    ino: int
    mode: int
    size: int
    format: int
    nextents: int
    fork: bytes  # raw data-fork bytes

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


class Xfs:
    """fh must be a seekable binary file; `offset` is the byte offset of
    the filesystem inside it (partition start)."""

    def __init__(self, fh: BinaryIO, offset: int = 0):
        self.fh = fh
        self.offset = offset
        self.sb = self._read_superblock()

    # ------------------------------------------------------------ probe

    @staticmethod
    def probe(fh: BinaryIO, offset: int = 0) -> bool:
        try:
            fh.seek(offset)
            return fh.read(4) == XFS_MAGIC
        except OSError:
            return False

    # ----------------------------------------------------------- layout

    def _read_at(self, off: int, size: int) -> bytes:
        self.fh.seek(self.offset + off)
        data = self.fh.read(size)
        if len(data) != size:
            raise XfsError(f"short read at {off}")
        return data

    def _read_superblock(self) -> Superblock:
        raw = self._read_at(0, 264)
        if raw[:4] != XFS_MAGIC:
            raise XfsError("not an XFS filesystem (bad magic)")
        versionnum = struct.unpack_from(">H", raw, 100)[0]
        version = versionnum & 0xF
        features_incompat = struct.unpack_from(">I", raw, 216)[0] \
            if version == 5 else 0
        # v4 keeps ftype in features2 (XFS_SB_VERSION2_FTYPE 0x200)
        features2 = struct.unpack_from(">I", raw, 200)[0]
        block_size = struct.unpack_from(">I", raw, 4)[0]
        dirblklog = raw[192]
        # untrusted images: directory block size drives allocations in
        # read_dir; real XFS caps it at 64 KiB (mkfs -n size=)
        if not 512 <= block_size <= 65536:
            raise XfsError(f"implausible block size {block_size}")
        if dirblklog > 7 or (block_size << dirblklog) > (1 << 16):
            raise XfsError(f"implausible dirblklog {dirblklog}")
        return Superblock(
            block_size=block_size,
            rootino=struct.unpack_from(">Q", raw, 56)[0],
            agblocks=struct.unpack_from(">I", raw, 84)[0],
            agcount=struct.unpack_from(">I", raw, 88)[0],
            inode_size=struct.unpack_from(">H", raw, 104)[0],
            inopblock=struct.unpack_from(">H", raw, 106)[0],
            inopblog=raw[123],
            agblklog=raw[124],
            dirblklog=dirblklog,
            version=version,
            ftype=bool(features_incompat & INCOMPAT_FTYPE)
            or bool(version == 4 and features2 & 0x200),
        )

    def _fsblock_byte(self, fsbno: int) -> int:
        """Absolute fsblock number -> byte offset (AG-relative encoding:
        high bits AG number, low sb_agblklog bits block-in-AG)."""
        agno = fsbno >> self.sb.agblklog
        agbno = fsbno & ((1 << self.sb.agblklog) - 1)
        if agno >= self.sb.agcount:
            raise XfsError(f"fsblock {fsbno} beyond AG count")
        return (agno * self.sb.agblocks + agbno) * self.sb.block_size

    def inode(self, ino: int) -> Inode:
        sb = self.sb
        agino_bits = sb.agblklog + sb.inopblog
        agno = ino >> agino_bits
        agino = ino & ((1 << agino_bits) - 1)
        agbno = agino >> sb.inopblog
        idx = agino & (sb.inopblock - 1)
        if agno >= sb.agcount:
            raise XfsError(f"inode {ino} beyond AG count")
        byte = (agno * sb.agblocks + agbno) * sb.block_size \
            + idx * sb.inode_size
        raw = self._read_at(byte, sb.inode_size)
        if struct.unpack_from(">H", raw, 0)[0] != DINODE_MAGIC:
            raise XfsError(f"bad inode magic for ino {ino}")
        version = raw[4]
        fork_off = 176 if version >= 3 else 100
        # di_forkoff (in 8-byte units) bounds the data fork when an
        # attribute fork follows it
        forkoff = raw[82]
        fork_end = fork_off + forkoff * 8 if forkoff else sb.inode_size
        return Inode(
            ino=ino,
            mode=struct.unpack_from(">H", raw, 2)[0],
            format=raw[5],
            size=struct.unpack_from(">Q", raw, 56)[0],
            nextents=struct.unpack_from(">I", raw, 76)[0],
            fork=raw[fork_off:fork_end],
        )

    # ------------------------------------------------------- extent maps

    @staticmethod
    def _unpack_extent(rec: bytes) -> tuple[int, int, int, int]:
        """16-byte packed bmbt record -> (startoff, startblock, count,
        unwritten_flag)."""
        l0, l1 = struct.unpack(">QQ", rec)
        flag = l0 >> 63
        startoff = (l0 >> 9) & ((1 << 54) - 1)
        startblock = ((l0 & 0x1FF) << 43) | (l1 >> 21)
        count = l1 & ((1 << 21) - 1)
        return startoff, startblock, count, flag

    def _extents(self, inode: Inode) -> list[tuple[int, int, int]]:
        """-> [(logical_block, physical_fsblock, count)], holes omitted;
        unwritten extents read as zeros so they are treated as holes."""
        out: list[tuple[int, int, int]] = []
        if inode.format == FMT_EXTENTS:
            for i in range(inode.nextents):
                rec = inode.fork[i * 16:(i + 1) * 16]
                if len(rec) < 16:
                    break
                off, blk, cnt, flag = self._unpack_extent(rec)
                if not flag:
                    out.append((off, blk, cnt))
        elif inode.format == FMT_BTREE:
            out.extend(self._btree_extents(inode.fork))
        return out

    def _btree_extents(self, fork: bytes) -> Iterator[tuple[int, int, int]]:
        """Walk the bmbt rooted in the inode fork (bmdr block: level,
        numrecs, keys, then pointers at the fixed maxrecs offset)."""
        level, numrecs = struct.unpack_from(">HH", fork, 0)
        if level == 0:
            raise XfsError("bmdr root with level 0")
        # real bmbt depth caps at XFS_BTREE_MAXLEVELS (9); a crafted root
        # level near 2^16 with a level-consistent block chain would
        # otherwise recurse past Python's frame limit
        if level > 16:
            raise XfsError("bmdr root level implausible")
        maxrecs = (len(fork) - 4) // 16
        ptr_base = 4 + maxrecs * 8
        # untrusted images: visited-set rejects pointer cycles, and
        # _btree_block enforces the strictly-decreasing level so a crafted
        # on-disk level field cannot drive unbounded recursion
        seen: set[int] = set()
        for i in range(numrecs):
            ptr = struct.unpack_from(">Q", fork, ptr_base + i * 8)[0]
            yield from self._btree_block(ptr, level - 1, seen)

    def _btree_block(self, fsbno: int, expect_level: int,
                     seen: set[int]) -> Iterator[tuple[int, int, int]]:
        if fsbno in seen:
            raise XfsError("bmbt pointer cycle")
        seen.add(fsbno)
        raw = self._read_at(self._fsblock_byte(fsbno), self.sb.block_size)
        if raw[:4] not in BMAP_MAGIC:
            raise XfsError("bad bmbt block magic")
        level, numrecs = struct.unpack_from(">HH", raw, 4)
        if level != expect_level:
            raise XfsError("bmbt level mismatch")
        hdr = 72 if raw[:4] == b"BMA3" else 24
        if level == 0:
            for i in range(numrecs):
                off, blk, cnt, flag = self._unpack_extent(
                    raw[hdr + i * 16: hdr + (i + 1) * 16])
                if not flag:
                    yield off, blk, cnt
        else:
            maxrecs = (self.sb.block_size - hdr) // 16
            ptr_base = hdr + maxrecs * 8
            for i in range(numrecs):
                ptr = struct.unpack_from(">Q", raw, ptr_base + i * 8)[0]
                yield from self._btree_block(ptr, level - 1, seen)

    # ------------------------------------------------------- file data

    def read_file(self, inode: Inode, limit: int | None = None) -> bytes:
        size = inode.size if limit is None else min(inode.size, limit)
        if inode.format == FMT_LOCAL:
            return bytes(inode.fork[:size])
        bs = self.sb.block_size
        out = bytearray(size)
        for logical, physical, count in self._extents(inode):
            start = logical * bs
            if start >= size:
                continue
            want = min(count * bs, size - start)
            data = self._read_at(self._fsblock_byte(physical), want)
            out[start:start + want] = data
        return bytes(out)

    def read_symlink(self, inode: Inode) -> str:
        if inode.format == FMT_LOCAL:
            return inode.fork[:inode.size].decode("utf-8", "replace")
        # remote symlink: v5 blocks carry a 56-byte XSLM header each.
        # Symlink targets cap at PATH_MAX; don't trust a crafted
        # size/extent map to drive larger reads.
        size = min(inode.size, 4096)
        raw = bytearray()
        bs = self.sb.block_size
        for _logical, physical, count in self._extents(inode):
            for c in range(count):
                if len(raw) >= size:
                    break
                blk = self._read_at(self._fsblock_byte(physical + c), bs)
                raw += blk[56:] if blk[:4] == SYMLINK_MAGIC else blk
        return bytes(raw[:size]).decode("utf-8", "replace")

    # ------------------------------------------------------ directories

    # untrusted images: bound per-directory work so a crafted extent map
    # (logical offsets just below the 32 GiB leaf boundary, or 2^21-block
    # extents) cannot force multi-GiB allocations
    MAX_DIR_BLOCKS = 65536  # 256 MiB of directory data at 4 KiB blocks

    def read_dir(self, inode: Inode) -> list[DirEntry]:
        if inode.format == FMT_LOCAL:
            return self._read_sf_dir(inode.fork)
        out: list[DirEntry] = []
        bs = self.sb.block_size
        blk_per_dirblk = 1 << self.sb.dirblklog
        # assemble directory blocks sparsely: dirblock index -> buffer
        # (dirblocks can span extents when dirblklog > 0)
        dirblocks: dict[int, bytearray] = {}
        for logical, physical, count in self._extents(inode):
            if logical * bs >= DIR_LEAF_OFFSET:
                continue  # leaf/freeindex metadata, not entries
            for c in range(count):
                lblock = logical + c
                dindex, within = divmod(lblock, blk_per_dirblk)
                buf = dirblocks.get(dindex)
                if buf is None:
                    if len(dirblocks) >= self.MAX_DIR_BLOCKS:
                        raise XfsError("directory too large")
                    buf = dirblocks[dindex] = \
                        bytearray(bs * blk_per_dirblk)
                data = self._read_at(
                    self._fsblock_byte(physical + c), bs)
                buf[within * bs:(within + 1) * bs] = data
        for dindex in sorted(dirblocks):
            out.extend(self._parse_dir_block(bytes(dirblocks[dindex])))
        return out

    def _read_sf_dir(self, fork: bytes) -> list[DirEntry]:
        """Shortform directory packed directly in the inode fork."""
        if len(fork) < 2:
            return []
        count, i8count = fork[0], fork[1]
        n = count or i8count
        ino_len = 8 if i8count else 4
        pos = 2 + ino_len  # header parent inumber
        out: list[DirEntry] = []
        for _ in range(n):
            if pos + 3 > len(fork):
                break
            namelen = fork[pos]
            pos += 3  # namelen + 2-byte offset tag
            name = fork[pos:pos + namelen].decode("utf-8", "replace")
            pos += namelen
            if self.sb.ftype:
                pos += 1
            if pos + ino_len > len(fork):
                break
            ino = int.from_bytes(fork[pos:pos + ino_len], "big")
            pos += ino_len
            out.append(DirEntry(name=name, ino=ino))
        return out

    def _parse_dir_block(self, blk: bytes) -> list[DirEntry]:
        """One directory data block (block or data form) -> entries."""
        magic = blk[:4]
        if magic in DIR_MAGIC_BLOCK:
            hdr = 64 if magic == b"XDB3" else 16
            # block form: leaf array + tail at the end bound the entries
            count, _stale = struct.unpack_from(">II", blk, len(blk) - 8)
            end = len(blk) - 8 - count * 8
        elif magic in DIR_MAGIC_DATA:
            hdr = 64 if magic == b"XDD3" else 16
            end = len(blk)
        else:
            return []
        out: list[DirEntry] = []
        pos = hdr
        while pos + 8 <= end:
            if blk[pos:pos + 2] == b"\xff\xff":  # unused entry
                length = struct.unpack_from(">H", blk, pos + 2)[0]
                if length < 8:
                    break
                pos += length
                continue
            ino = struct.unpack_from(">Q", blk, pos)[0]
            namelen = blk[pos + 8]
            name = blk[pos + 9:pos + 9 + namelen].decode("utf-8", "replace")
            entry_len = 8 + 1 + namelen + (1 if self.sb.ftype else 0) + 2
            entry_len = (entry_len + 7) & ~7
            if namelen == 0:
                break
            if name not in (".", ".."):
                out.append(DirEntry(name=name, ino=ino))
            pos += entry_len
        return out

    # ------------------------------------------------------------- walk

    def walk(self, max_file_size: int | None = None
             ) -> Iterator[tuple[str, Inode]]:
        """Yield (path, inode) for every regular file, DFS from root."""
        seen: set[int] = set()
        stack: list[tuple[str, int]] = [("", self.sb.rootino)]
        while stack:
            prefix, ino = stack.pop()
            if ino in seen:
                continue
            seen.add(ino)
            try:
                node = self.inode(ino)
                entries = self.read_dir(node)
            except XfsError:
                continue
            for e in sorted(entries, key=lambda d: d.name, reverse=True):
                path = f"{prefix}/{e.name}" if prefix else e.name
                try:
                    child = self.inode(e.ino)
                except XfsError:
                    continue
                if child.is_dir:
                    stack.append((path, e.ino))
                elif child.is_file:
                    yield path, child
