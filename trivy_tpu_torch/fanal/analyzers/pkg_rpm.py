"""rpm package DB analyzer (reference pkg/fanal/analyzer/pkg/rpm/ via
knqyf263/go-rpmdb): reads the rpmdb in its sqlite (rpmdb.sqlite, modern
Fedora/RHEL9+) or BerkeleyDB-hash (Packages, RHEL<=8/CentOS) formats and
parses the stored rpm header blobs.

Header blob layout (rpm tag data as stored in the DB, no lead/signature):
  [index_len:u32][data_len:u32] then index_len 16-byte entries
  (tag:u32, type:u32, offset:u32, count:u32) then the data section.

Copy of trivy_tpu/fanal/analyzers/pkg_rpm.py.
"""

from __future__ import annotations

import os
import re
import sqlite3
import struct
import tempfile

from trivy_tpu_torch.fanal.analyzer import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    register,
)
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.types.artifact import Package, PackageInfo

_log = logger("rpm")

RPMDB_PATHS = {
    "usr/lib/sysimage/rpm/rpmdb.sqlite",
    "var/lib/rpm/rpmdb.sqlite",
    "usr/lib/sysimage/rpm/Packages",
    "var/lib/rpm/Packages",
    "usr/lib/sysimage/rpm/Packages.db",
    "var/lib/rpm/Packages.db",
}

# rpm tags
_T_NAME = 1000
_T_VERSION = 1001
_T_RELEASE = 1002
_T_EPOCH = 1003
_T_ARCH = 1022
_T_VENDOR = 1011
_T_LICENSE = 1014
_T_SOURCERPM = 1044
_T_DIRINDEXES = 1116
_T_BASENAMES = 1117
_T_DIRNAMES = 1118
_T_PROVIDENAME = 1047
_T_REQUIRENAME = 1049
_T_MODULARITYLABEL = 5096

_STRING_TYPES = (6, 8, 9)


def parse_header_blob(blob: bytes) -> dict[int, object] | None:
    if len(blob) < 8:
        return None
    il, dl = struct.unpack(">II", blob[:8])
    if il <= 0 or il > 100000 or dl <= 0 or dl > len(blob):
        return None
    idx_end = 8 + 16 * il
    if idx_end + dl > len(blob) + 8:  # loose sanity
        if idx_end > len(blob):
            return None
    data = blob[idx_end:]
    out: dict[int, object] = {}
    for i in range(il):
        tag, typ, off, count = struct.unpack_from(">IIII", blob, 8 + 16 * i)
        if off >= len(data):
            continue
        try:
            if typ in (6, 9):  # STRING / I18N (first value)
                end = data.index(b"\x00", off)
                out[tag] = data[off:end].decode("utf-8", "replace")
            elif typ == 8:  # STRING_ARRAY
                vals = []
                p = off
                for _ in range(count):
                    end = data.index(b"\x00", p)
                    vals.append(data[p:end].decode("utf-8", "replace"))
                    p = end + 1
                out[tag] = vals
            elif typ == 4:  # INT32
                out[tag] = list(struct.unpack_from(f">{count}i", data, off))
            elif typ == 3:  # INT16
                out[tag] = list(struct.unpack_from(f">{count}h", data, off))
            elif typ == 5:  # INT64
                out[tag] = list(struct.unpack_from(f">{count}q", data, off))
        except (ValueError, struct.error):
            continue
    return out if _T_NAME in out else None


_SRC_RPM = re.compile(r"^(?P<name>.+)-(?P<ver>[^-]+)-(?P<rel>[^-]+)\.src\.rpm$")


def header_to_package(h: dict[int, object]) -> Package | None:
    name = h.get(_T_NAME)
    version = h.get(_T_VERSION)
    if not name or not version:
        return None
    pkg = Package(
        name=str(name),
        version=str(version),
        release=str(h.get(_T_RELEASE, "") or ""),
        arch=str(h.get(_T_ARCH, "") or ""),
        maintainer=str(h.get(_T_VENDOR, "") or ""),
        modularity_label=str(h.get(_T_MODULARITYLABEL, "") or ""),
    )
    epoch = h.get(_T_EPOCH)
    if isinstance(epoch, list) and epoch:
        pkg.epoch = int(epoch[0])
        pkg.src_epoch = pkg.epoch
    lic = h.get(_T_LICENSE)
    if lic:
        pkg.licenses = [str(lic)]
    srpm = h.get(_T_SOURCERPM)
    if srpm and srpm != "(none)":
        m = _SRC_RPM.match(str(srpm))
        if m:
            pkg.src_name = m.group("name")
            pkg.src_version = m.group("ver")
            pkg.src_release = m.group("rel")
    if not pkg.src_name:
        pkg.src_name = pkg.name
        pkg.src_version = pkg.version
        pkg.src_release = pkg.release
    # installed files from dirnames/dirindexes/basenames
    dirs = h.get(_T_DIRNAMES) or []
    idxs = h.get(_T_DIRINDEXES) or []
    bases = h.get(_T_BASENAMES) or []
    if dirs and bases and len(idxs) == len(bases):
        files = []
        for di, base in zip(idxs, bases):
            if 0 <= di < len(dirs):
                files.append(f"{dirs[di]}{base}")
        pkg.installed_files = files
    pkg.id = f"{pkg.name}@{pkg.full_version()}"
    return pkg


# ------------------------------------------------------------- backends


def read_sqlite_rpmdb(content: bytes) -> list[bytes]:
    with tempfile.NamedTemporaryFile(suffix=".sqlite", delete=False) as f:
        f.write(content)
        path = f.name
    try:
        con = sqlite3.connect(path)
        try:
            rows = con.execute("SELECT blob FROM Packages").fetchall()
            return [r[0] for r in rows]
        finally:
            con.close()
    finally:
        os.unlink(path)


def read_bdb_rpmdb(content: bytes) -> list[bytes]:
    """Minimal BerkeleyDB hash reader: walks every page, collects inline
    (H_KEYDATA) and overflow (H_OFFPAGE) data values."""
    if len(content) < 512:
        return []
    magic = struct.unpack_from("<I", content, 12)[0]
    if magic != 0x061561:  # DB_HASHMAGIC little-endian
        be = struct.unpack_from(">I", content, 12)[0]
        if be != 0x061561:
            return []
    pagesize = struct.unpack_from("<I", content, 20)[0]
    if pagesize < 512 or pagesize > 65536:
        return []
    n_pages = len(content) // pagesize
    blobs: list[bytes] = []

    def read_overflow(pgno: int) -> bytes:
        out = bytearray()
        seen = set()
        while pgno and pgno not in seen and pgno < n_pages:
            seen.add(pgno)
            base = pgno * pagesize
            next_pgno = struct.unpack_from("<I", content, base + 16)[0]
            hf_offset = struct.unpack_from("<H", content, base + 22)[0]
            out += content[base + 26: base + 26 + hf_offset]
            pgno = next_pgno
        return bytes(out)

    for pgno in range(1, n_pages):
        base = pgno * pagesize
        ptype = content[base + 25]
        if ptype != 8 and ptype != 13:  # P_HASH(8 old)/P_HASH(13 unsorted)
            continue
        n_entries = struct.unpack_from("<H", content, base + 20)[0]
        if n_entries == 0 or n_entries > pagesize // 2:
            continue
        offsets = struct.unpack_from(f"<{n_entries}H", content, base + 26)
        # entries alternate key/data; data entries are odd indices
        for i in range(1, n_entries, 2):
            off = offsets[i]
            if off >= pagesize:
                continue
            etype = content[base + off]
            if etype == 1:  # H_KEYDATA
                end = offsets[i - 1] if i >= 1 and offsets[i - 1] > off else pagesize
                blobs.append(content[base + off + 1: base + end])
            elif etype == 3:  # H_OFFPAGE
                ov_pgno = struct.unpack_from("<I", content, base + off + 4)[0]
                blobs.append(read_overflow(ov_pgno))
    return blobs


def read_rpmdb(path: str, content: bytes) -> list[Package]:
    if path.endswith("rpmdb.sqlite"):
        raw = read_sqlite_rpmdb(content)
    elif path.endswith("Packages"):
        raw = read_bdb_rpmdb(content)
    else:
        _log.debug("unsupported rpmdb flavor", path=path)
        return []
    pkgs = []
    for blob in raw:
        h = parse_header_blob(blob)
        if h is None:
            continue
        pkg = header_to_package(h)
        if pkg is not None:
            pkgs.append(pkg)
    return pkgs


@register
class RpmAnalyzer(Analyzer):
    type = "rpm"
    version = 1

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return path in RPMDB_PATHS

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        pkgs = read_rpmdb(inp.path, inp.read())
        if not pkgs:
            return None
        installed = [f for p in pkgs for f in p.installed_files]
        res = AnalysisResult()
        res.package_infos = [PackageInfo(file_path=inp.path, packages=pkgs)]
        res.system_installed_files = installed
        return res
