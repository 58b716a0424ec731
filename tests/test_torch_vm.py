"""Port parity, the `vm` scan path: trivy_tpu_torch's disk readers (raw,
MBR and GPT partitions, sparse VMDK, EBS snapshots and AMIs through fake
clients), its ext4 and XFS walkers, `VMArtifact` and the `vm` CLI
(`--device cpu`, so the match kernel's and the secret screens' plain
versions answer, or `--no-tpu`) against the JAX package's on the same
images. The shapes of tests/test_vm.py and tests/test_xfs.py run on the
port's modules; ext4 images come from mkfs.ext4 (-d, or debugfs as the
reference tests populate them), the XFS image is the reference tests'
hand-written image, and the partitioned and VMDK containers from
chip_smoke.py's writers, which its phase 11 uses on the card.

Reports and blob documents are compared exactly (bytes, or equal
dicts). One difference is on purpose: the port reads ext4 inline data
(`mkfs.ext4 -O inline_data`), which the reference truncates or skips.
"""

import json
import os
import struct
import subprocess
import sys
import types

import chip_smoke
import pytest
import test_vm
import torch
from test_torch_fanal import seeded_db, seeded_tree
from test_vm import DEBUGFS, GUEST_FILES, MKFS, _mk_ext4
from test_xfs import (  # noqa: F401  (xfs_image is a fixture)
    ALPINE_RELEASE,
    BS,
    DATA_BLK,
    INO_SIZE,
    INODE_TABLE_BLK,
    LINK_INO,
    OS_RELEASE,
    PACKAGE_LOCK,
    FakeEBSClient,
    FakeEC2Client,
    _dinode,
    _extent,
    _ino,
    xfs_image,
)

from trivy_tpu.artifact.vm import VMArtifact as JaxVMArtifact
from trivy_tpu.cache.cache import MemoryCache as JaxMemoryCache
from trivy_tpu.cli import main as jax_main
from trivy_tpu.cli import run as jax_run
from trivy_tpu.fanal import analyzer as jax_analyzer
from trivy_tpu.fanal.vm.ext4 import Ext4 as JaxExt4
from trivy_tpu.utils import uuid as jax_uuid
from trivy_tpu_torch.artifact.vm import VMArtifact, VMError
from trivy_tpu_torch.cache.cache import MemoryCache
from trivy_tpu_torch.cli import config as run_config
from trivy_tpu_torch.cli import run
from trivy_tpu_torch.fanal import analyzer as port_analyzer
from trivy_tpu_torch.cli.main import main
from trivy_tpu_torch.fanal.analyzers import secret_analyzer
from trivy_tpu_torch.fanal.vm.disk import SparseVMDK, find_filesystems, open_disk
from trivy_tpu_torch.fanal.vm.ebs import EBSDisk, resolve_ami
from trivy_tpu_torch.fanal.vm.ext4 import Ext4
from trivy_tpu_torch.fanal.vm.xfs import Xfs, XfsError
from trivy_tpu_torch.secret import scanner as sc
from trivy_tpu_torch.utils import uuid as port_uuid

FAKE_TIME = "2024-01-01T00:00:00+00:00"
# the CLI's analyzer gating for --scanners vuln,secret: both packages
# disable the config and license-file analyzers
GATED = {"config", "license-file"}

# the reference tests' skip condition (tests/test_vm.py)
needs_mkfs = pytest.mark.skipif(
    not (os.path.exists(MKFS) and os.path.exists(DEBUGFS)),
    reason="mkfs.ext4/debugfs unavailable")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and idle OpenMP workers spin on cores their neighbours' timing
    tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", FAKE_TIME)
    monkeypatch.setenv("TRIVY_TPU_DETERMINISTIC_UUID", "1")
    monkeypatch.setattr(secret_analyzer, "USE_DEVICE", "hybrid")
    monkeypatch.setattr(secret_analyzer, "DEVICE", torch.device("cpu"))
    monkeypatch.setattr(sc, "_CACHE_DIR_OVERRIDE", None)
    # a CLI scan leaves its --secret-config path (default
    # trivy-secret.yaml) on the process-wide secret analyzer, and the
    # analyzer then skips a root-level file of that name: start each
    # test with none in both packages
    for registry in (jax_analyzer._POST_ANALYZERS,
                     port_analyzer._POST_ANALYZERS):
        for a in registry:
            if a.type == "secret":
                a.configure(None)
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()
    yield
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()


# ------------------------------------------------------------ images


@pytest.fixture
def raw_image(tmp_path):
    img = str(tmp_path / "disk.img")
    _mk_ext4(img)
    return img


def mkfs_tree(tree: str, path: str, opts=(), size: str = "32m") -> str:
    subprocess.run([MKFS, "-q", "-F", *opts, "-d", tree, path, size],
                   check=True, capture_output=True)
    return path


def tree_files(root: str) -> dict:
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """The seeded scan tree (a debian 11 root, lockfiles, planted
    secrets), its DB saved, and the tree as one ext4 filesystem in each
    container kind."""
    if not os.path.exists(MKFS):
        pytest.skip("mkfs.ext4 unavailable")
    tmp = tmp_path_factory.mktemp("vm")
    seeded_tree(tmp / "tree")
    seeded_db().save(str(tmp / "db"))
    raw = mkfs_tree(str(tmp / "tree"), str(tmp / "disk.raw"))
    disks = {"raw": raw}
    for kind, writer in (("mbr", chip_smoke.mbr_disk),
                         ("gpt", chip_smoke.gpt_disk),
                         ("vmdk", chip_smoke.sparse_vmdk)):
        disks[kind] = str(tmp / f"disk.{kind}")
        writer(raw, disks[kind])
    with open(raw, "rb") as f:
        image = f.read()
    return {"tree": str(tmp / "tree"), "db": str(tmp / "db"),
            "disks": disks, "image": image}


def fake_aws(image: bytes):
    """`name -> client` over fake EBS direct-API and EC2 clients holding
    `image` as snapshot snap-1 (the root volume of AMI ami-42)."""
    clients = {"ebs": FakeEBSClient(image), "ec2": FakeEC2Client()}
    return clients.__getitem__


TARGETS = {"ebs": "ebs:snap-1", "ami": "ami:ami-42"}
KINDS = ["raw", "mbr", "gpt", "vmdk", "xfs", "ebs", "ami"]


def target_of(request, seeded, kind: str, monkeypatch=None) -> str:
    """The scan target of `kind`; for ebs / ami a fake boto3 module
    (both packages import boto3 when a scan opens such a target)."""
    if kind == "xfs":
        return request.getfixturevalue("xfs_image")
    if kind in TARGETS:
        if monkeypatch is not None:
            boto3 = types.ModuleType("boto3")
            boto3.client = fake_aws(seeded["image"])
            monkeypatch.setitem(sys.modules, "boto3", boto3)
        return TARGETS[kind]
    return seeded["disks"][kind]


# ------------------------------------- tests/test_vm.py shapes, port


@needs_mkfs
class TestExt4:
    def test_walk_and_read(self, raw_image):
        with open(raw_image, "rb") as fh:
            assert Ext4.probe(fh)
            fs = Ext4(fh)
            files = {p: fs.read_file(i) for p, i in fs.walk()
                     if not p.startswith("lost+found")}
        for path, content in GUEST_FILES.items():
            assert files.get(path) == content, path

    def test_large_file_extents(self, tmp_path):
        """A multi-extent file reads back byte-identical."""
        img = str(tmp_path / "disk.img")
        _mk_ext4(img)
        big = os.urandom(1 << 20)
        src = tmp_path / "big.bin"
        src.write_bytes(big)
        script = tmp_path / "s"
        script.write_text(f"mkdir /data\nwrite {src} /data/big.bin\n")
        subprocess.run([DEBUGFS, "-w", "-f", str(script), img],
                       check=True, capture_output=True)
        with open(img, "rb") as fh:
            fs = Ext4(fh)
            files = dict(fs.walk())
            assert fs.read_file(files["data/big.bin"]) == big


@needs_mkfs
def test_mbr_partition(tmp_path):
    img = str(tmp_path / "disk.img")
    _mk_ext4(img, size_mb=8, offset_mb=1)
    with open(img, "r+b") as f:
        mbr = bytearray(512)
        entry = bytearray(16)
        entry[4] = 0x83
        struct.pack_into("<I", entry, 8, 2048)
        struct.pack_into("<I", entry, 12, 8 * 2048)
        mbr[446:462] = entry
        mbr[510:512] = b"\x55\xaa"
        f.seek(0)
        f.write(mbr)
    with open(img, "rb") as fh:
        assert find_filesystems(fh) == [("ext4", 1024 * 1024)]
    with open(img, "rb") as fh:
        files = {p for p, _ in Ext4(fh, offset=1024 * 1024).walk()}
    assert "app/requirements.txt" in files


@needs_mkfs
class TestVMArtifact:
    def test_inspect_raw(self, raw_image):
        cache = MemoryCache()
        ref = VMArtifact(raw_image, cache).inspect()
        assert ref.type == "vm"
        blob = cache.get_blob(ref.blob_ids[0])
        assert blob["os"]["family"] == "alpine"
        apps = {a["file_path"] for a in blob.get("applications") or []}
        assert "app/requirements.txt" in apps

    def test_cli_vm_scan(self, raw_image, tmp_path, capsys):
        rc = main(["vm", raw_image, "--format", "json", "--device", "cpu",
                   "--cache-dir", str(tmp_path / "cache"),
                   "--scanners", "vuln,secret", "--quiet"])
        assert rc == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["ArtifactType"] == "vm"
        assert "secret" in {r["Class"] for r in doc["Results"]}

    def test_no_filesystem(self, tmp_path):
        img = tmp_path / "empty.img"
        img.write_bytes(b"\x00" * 4096)
        with pytest.raises(VMError, match="no supported filesystem"):
            VMArtifact(str(img), MemoryCache()).inspect()


def test_sparse_vmdk_read_through_grains(tmp_path):
    payload = bytes(range(256)) * 64
    path = str(tmp_path / "disk.vmdk")
    test_vm.TestSparseVMDK._mk_vmdk(None, path, payload)
    fh = open_disk(path)
    assert isinstance(fh, SparseVMDK)
    fh.seek(0)
    assert fh.read(len(payload)) == payload
    fh.seek(len(payload))
    assert fh.read(4096) == b"\x00" * 4096  # holes read as zeros
    fh.close()


def test_unwritten_extent_reads_as_zeros():
    """Unwritten (preallocated) extents read back as zeros, like
    holes."""
    hdr = struct.pack("<HHHHI", 0xF30A, 2, 4, 0, 0)
    written = struct.pack("<IHHI", 0, 1, 0, 100)
    unwritten = struct.pack("<IHHI", 1, 32768 + 1, 0, 101)
    node = hdr + written + unwritten
    assert list(Ext4._extent_blocks(object.__new__(Ext4), node)) == \
        [(0, 100, 1)]


# ------------------------------------- tests/test_xfs.py shapes, port


class TestXfsReader:
    def test_probe_and_detect(self, xfs_image):
        with open(xfs_image, "rb") as fh:
            assert Xfs.probe(fh)
            assert find_filesystems(fh) == [("xfs", 0)]

    def test_walk_and_read(self, xfs_image):
        with open(xfs_image, "rb") as fh:
            fs = Xfs(fh)
            files = {p: fs.read_file(i) for p, i in fs.walk()}
        assert files == {"etc/os-release": OS_RELEASE,
                         "etc/alpine-release": ALPINE_RELEASE,
                         "app/package-lock.json": PACKAGE_LOCK}

    def test_symlink(self, xfs_image):
        with open(xfs_image, "rb") as fh:
            fs = Xfs(fh)
            link = fs.inode(LINK_INO)
            assert link.is_symlink
            assert fs.read_symlink(link) == "etc/os-release"

    def test_multi_extent_file(self, xfs_image):
        """Two non-adjacent extents with a hole between them."""
        part1, part2 = b"A" * BS, b"B" * 100
        blk1, blk2 = DATA_BLK + 10, DATA_BLK + 12
        big_ino = _ino(INODE_TABLE_BLK, 7)
        with open(xfs_image, "r+b") as f:
            f.seek(blk1 * BS)
            f.write(part1)
            f.seek(blk2 * BS)
            f.write(part2)
            fork = _extent(0, blk1, 1) + _extent(2, blk2, 1)
            f.seek(INODE_TABLE_BLK * BS + 7 * INO_SIZE)
            f.write(_dinode(0o100644, 2, 2 * BS + len(part2), 2, fork))
        with open(xfs_image, "rb") as fh:
            fs = Xfs(fh)
            data = fs.read_file(fs.inode(big_ino))
        assert data == part1 + b"\x00" * BS + part2

    def test_bad_magic(self, tmp_path):
        img = tmp_path / "junk.img"
        img.write_bytes(b"\x00" * 8192)
        with open(img, "rb") as fh, pytest.raises(XfsError):
            Xfs(fh)

    def test_hostile_dir_extent_bounded(self, xfs_image):
        evil_ino = _ino(INODE_TABLE_BLK, 7)
        far = (32 * 1024 ** 3 // BS) - 2
        with open(xfs_image, "r+b") as f:
            f.seek(INODE_TABLE_BLK * BS + 7 * INO_SIZE)
            f.write(_dinode(0o40755, 2, BS, 1, _extent(far, DATA_BLK, 1)))
        with open(xfs_image, "rb") as fh:
            fs = Xfs(fh)
            assert isinstance(fs.read_dir(fs.inode(evil_ino)), list)
        with open(xfs_image, "r+b") as f:
            f.seek(INODE_TABLE_BLK * BS + 7 * INO_SIZE)
            f.write(_dinode(0o40755, 2, BS, 1,
                            _extent(0, DATA_BLK, (1 << 21) - 1)))
        with open(xfs_image, "rb") as fh:
            fs = Xfs(fh)
            with pytest.raises(XfsError):
                fs.read_dir(fs.inode(evil_ino))
            assert dict(fs.walk())

    def test_hostile_bmbt_cycle_bounded(self, xfs_image):
        evil_ino = _ino(INODE_TABLE_BLK, 7)
        bmbt_blk = DATA_BLK + 8
        blk = bytearray(BS)
        blk[0:4] = b"BMA3"
        struct.pack_into(">HH", blk, 4, 1, 1)
        struct.pack_into(">Q", blk, 72 + (BS - 72) // 16 * 8, bmbt_blk)

        def root_fork(level):
            fork = bytearray(INO_SIZE - 176)
            struct.pack_into(">HH", fork, 0, level, 1)
            struct.pack_into(">Q", fork, 4 + (len(fork) - 4) // 16 * 8,
                             bmbt_blk)
            return bytes(fork)

        with open(xfs_image, "r+b") as f:
            f.seek(bmbt_blk * BS)
            f.write(bytes(blk))
        for level, match in ((2, "cycle"), (3, "level mismatch"),
                             (1001, "implausible")):
            with open(xfs_image, "r+b") as f:
                f.seek(INODE_TABLE_BLK * BS + 7 * INO_SIZE)
                f.write(_dinode(0o100644, 3, BS, 1, root_fork(level)))
            with open(xfs_image, "rb") as fh:
                fs = Xfs(fh)
                with pytest.raises(XfsError, match=match):
                    fs.read_file(fs.inode(evil_ino))
        with open(xfs_image, "rb") as fh:
            assert dict(Xfs(fh).walk())

    def test_hostile_dirblklog_rejected(self, xfs_image):
        with open(xfs_image, "r+b") as f:
            f.seek(192)
            f.write(bytes([64]))
        with open(xfs_image, "rb") as fh:
            with pytest.raises(XfsError, match="dirblklog"):
                Xfs(fh)

    def test_hostile_symlink_size_bounded(self, xfs_image):
        evil_ino = _ino(INODE_TABLE_BLK, 7)
        fork = _extent(0, DATA_BLK, (1 << 21) - 1)
        with open(xfs_image, "r+b") as f:
            f.seek(INODE_TABLE_BLK * BS + 7 * INO_SIZE)
            f.write(_dinode(0o120777, 2, 1 << 40, 1, fork))
        with open(xfs_image, "rb") as fh:
            fs = Xfs(fh)
            assert len(fs.read_symlink(fs.inode(evil_ino))) <= 4096


def test_inspect_xfs(xfs_image):
    cache = MemoryCache()
    ref = VMArtifact(xfs_image, cache).inspect()
    assert ref.type == "vm"
    blob = cache.get_blob(ref.blob_ids[0])
    assert blob["os"]["family"] == "alpine"
    apps = {a["file_path"] for a in blob.get("applications") or []}
    assert "app/package-lock.json" in apps


class TestEBS:
    def test_streamed_reads_match_local(self, xfs_image):
        raw = open(xfs_image, "rb").read()
        disk = EBSDisk(FakeEBSClient(raw), "snap-1")
        disk.seek(0)
        assert disk.read(4096) == raw[:4096]
        disk.seek(60 * 1024)  # across block boundaries and a hole
        assert disk.read(16 * 1024) == \
            (raw + b"\x00" * (1 << 30))[60 * 1024:76 * 1024]

    def test_ami_resolution(self):
        assert resolve_ami(FakeEC2Client(), "ami-42") == "snap-1"

    def test_vm_artifact_over_ebs(self, xfs_image):
        raw = open(xfs_image, "rb").read()
        ebs, ec2 = FakeEBSClient(raw), FakeEC2Client()
        cache = MemoryCache()
        ref = VMArtifact("ami:ami-42", cache,
                         aws_client_factory={"ebs": ebs, "ec2": ec2}.get
                         ).inspect()
        blob = cache.get_blob(ref.blob_ids[0])
        assert blob["os"]["family"] == "alpine"
        assert ebs.get_calls > 0

    def test_missing_boto3_message(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "boto3", None)
        with pytest.raises(VMError, match="boto3"):
            VMArtifact("ebs:snap-none", MemoryCache()).inspect()


# ------------------------------------------------ parity and repairs


# mkfs.ext4 feature sets: the defaults of e2fsprogs 1.47 (metadata_csum,
# 64bit), orphan_file (on by default in upstream 1.47), 32-byte group
# descriptors, classic block maps, 4 KiB blocks, 128-byte inodes
FEATURES = {"default": (), "orphan_file": ("-O", "orphan_file"),
            "no_64bit": ("-O", "^64bit,^metadata_csum"),
            "block_maps": ("-O", "^extent,^64bit"),
            "4k_blocks": ("-b", "4096"),
            "small_inodes": ("-I", "128", "-O", "^metadata_csum,^64bit")}


def read_all(reader, fh, offset: int = 0) -> dict:
    fs = reader(fh, offset)
    return {p: fs.read_file(i) for p, i in fs.walk()}


def read_image(reader, img: str) -> dict:
    with open(img, "rb") as fh:
        return read_all(reader, fh)


@needs_mkfs
@pytest.mark.parametrize("feature", list(FEATURES))
def test_ext4_features_read_every_file(seeded, tmp_path, feature):
    """Each file of the seeded tree reads back byte for byte through the
    port's reader and the reference's, over the feature sets mkfs.ext4
    builds."""
    img = mkfs_tree(seeded["tree"], str(tmp_path / "f.img"),
                    FEATURES[feature])
    want = tree_files(seeded["tree"])
    assert read_image(Ext4, img) == want
    assert read_image(JaxExt4, img) == want


@needs_mkfs
def test_inline_data_fault_in_the_reference_is_repaired(seeded, tmp_path):
    """`mkfs.ext4 -O inline_data` keeps small files and directories in
    the inode. The reference reads no more than i_block's 60 bytes of an
    inline file and parses an inline directory as dirent blocks, so it
    truncates files and walks nothing below such a directory; the port
    reads the rest from the system.data attribute."""
    img = mkfs_tree(seeded["tree"], str(tmp_path / "inline.img"),
                    ("-O", "inline_data"))
    want = tree_files(seeded["tree"])
    assert len(read_image(JaxExt4, img)) < len(want)
    assert read_image(Ext4, img) == want
    # a single small file: the reference cuts it at 60 bytes
    small = tmp_path / "small"
    small.mkdir()
    (small / "os-release").write_bytes(OS_RELEASE)
    img2 = mkfs_tree(str(small), str(tmp_path / "small.img"),
                     ("-O", "inline_data"))
    assert read_image(Ext4, img2)["os-release"] == OS_RELEASE
    assert read_image(JaxExt4, img2)["os-release"] == OS_RELEASE[:60]


@needs_mkfs
@pytest.mark.parametrize("kind", ["raw", "mbr", "gpt", "vmdk"])
def test_containers_find_the_filesystem(seeded, kind):
    """chip_smoke.py's container writers: the filesystem sits at 1 MiB
    in the partitioned disks, and every container reads as the raw
    image."""
    fh = open_disk(seeded["disks"][kind])
    try:
        offset = 0 if kind in ("raw", "vmdk") else 1 << 20
        assert find_filesystems(fh) == [("ext4", offset)]
        assert read_all(Ext4, fh, offset) == tree_files(seeded["tree"])
    finally:
        fh.close()


def test_sparse_vmdk_writer_spans_many_grain_tables(tmp_path):
    """A 5 MiB disk with data in its first and last grains only: three
    grain directory entries, two of them tables, the middle one a hole;
    the VMDK reads back as the flat image."""
    flat = tmp_path / "flat.img"
    body = bytearray(5 << 20)
    body[:4] = b"head"
    body[-4:] = b"tail"
    flat.write_bytes(bytes(body))
    path = str(tmp_path / "d.vmdk")
    assert chip_smoke.sparse_vmdk(str(flat), path) == 2
    assert os.path.getsize(path) < 64 << 10
    fh = open_disk(path)
    assert fh.read(len(body)) == bytes(body)
    fh.close()


def blob_of(artifact_cls, cache_cls, target, **kw) -> tuple:
    cache = cache_cls()
    ref = artifact_cls(target, cache, disabled_analyzers=GATED,
                       **kw).inspect()
    return ref.id, ref.name, ref.type, cache.get_blob(ref.blob_ids[0])


@needs_mkfs
@pytest.mark.parametrize("kind", KINDS)
def test_inspect_blob_equals_reference(request, seeded, kind):
    target = target_of(request, seeded, kind)
    kw = {"aws_client_factory": fake_aws(seeded["image"])} \
        if kind in TARGETS else {}
    want = blob_of(JaxVMArtifact, JaxMemoryCache, target, **kw)
    got = blob_of(VMArtifact, MemoryCache, target, **kw)
    assert got == want
    assert want[3]["os"]["family"] in ("debian", "alpine")


@needs_mkfs
def test_inspect_stats(seeded):
    art = VMArtifact(seeded["disks"]["gpt"], MemoryCache(),
                     disabled_analyzers=GATED)
    art.inspect()
    st = art.stats
    assert st["walked_files"] == len(tree_files(seeded["tree"]))
    assert st["inspect_s"] >= st["walk_s"] + st["post_analyze_s"] > 0
    assert 0 < st["secret_s"] <= st["post_analyze_s"]
    assert st["secret_device_stats"]["files"] == 0  # the CPU: host only


def scan(entry, argv, capsys, uuid_mod) -> tuple[int, str]:
    uuid_mod.reset()
    rc = entry(argv)
    return rc, capsys.readouterr().out


@needs_mkfs
@pytest.mark.parametrize("no_tpu", [False, True], ids=["device", "no-tpu"])
@pytest.mark.parametrize("fmt", ["json", "cyclonedx"])
@pytest.mark.parametrize("kind", KINDS)
def test_port_cli_equals_jax_cli(request, seeded, tmp_path, capsys,
                                 monkeypatch, kind, fmt, no_tpu):
    target = target_of(request, seeded, kind, monkeypatch)
    argv = ["vm", target, "--format", fmt, "--db-path", seeded["db"],
            "--quiet"] + (["--no-tpu"] if no_tpu else [])
    want = scan(jax_main.main, argv + ["--cache-dir", str(tmp_path / "j")],
                capsys, jax_uuid)
    got = scan(main, argv + ["--device", "cpu", "--cache-dir",
                             str(tmp_path / "p")], capsys, port_uuid)
    assert got == want
    assert want[0] == 0
    if fmt == "json":
        doc = json.loads(got[1])
        assert doc["ArtifactType"] == "vm" and doc["ArtifactName"] == target
        classes = {r["Class"] for r in doc["Results"]}
        # the XFS image holds an alpine release, an npm lockfile and no
        # secret
        assert classes == ({"os-pkgs", "lang-pkgs"} if kind == "xfs" else
                           {"os-pkgs", "lang-pkgs", "secret"})


@needs_mkfs
def test_containers_give_equal_results(seeded, tmp_path, capsys):
    """The same filesystem raw, partitioned and in a VMDK: equal results
    but for the OS result's target, which names the disk."""
    docs = {}
    for kind, disk in seeded["disks"].items():
        rc, out = scan(main, ["vm", disk, "--format", "json", "--db-path",
                              seeded["db"], "--quiet", "--device", "cpu",
                              "--cache-dir", str(tmp_path / "c")],
                       capsys, port_uuid)
        assert rc == 0
        docs[kind] = out.replace(disk, "<disk>")
    assert len(set(docs.values())) == 1
    assert "<disk> (debian 11" in docs["raw"]


def error_lines(err: str) -> list:
    """The message of each ERROR log line (no timestamp)."""
    return [ln.split("\t", 2)[2] for ln in err.splitlines()
            if "\tERROR\t" in ln]


@pytest.mark.parametrize("case", ["qcow2", "no_fs", "missing", "boto3"])
def test_vm_errors_equal_reference(tmp_path, capsys, monkeypatch, case):
    target = str(tmp_path / "disk.img")
    if case == "qcow2":
        (tmp_path / "disk.img").write_bytes(b"QFI\xfb" + bytes(4092))
    elif case == "no_fs":
        (tmp_path / "disk.img").write_bytes(bytes(4096))
    elif case == "boto3":
        monkeypatch.setitem(sys.modules, "boto3", None)
        target = "ebs:snap-none"
    argv = ["vm", target, "--format", "json", "--no-tpu"]
    got = [main(argv + ["--cache-dir", str(tmp_path / "p")])]
    got.append(error_lines(capsys.readouterr().err))
    want = [jax_main.main(argv + ["--cache-dir", str(tmp_path / "j")])]
    want.append(error_lines(capsys.readouterr().err))
    assert got == want
    assert got[0] == 1 and len(got[1]) == 1
    assert got[1][0].startswith("VMError: ")


@pytest.mark.parametrize("dest,value", [("config_check", "checks/"),
                                        ("compliance", "docker-cis-1.6.0"),
                                        ("redis_tls", "true")])
def test_unported_option_from_env_is_refused(request, tmp_path, capsys,
                                             monkeypatch, dest, value):
    """An unported option from the environment is refused with one line;
    `config_check`, `compliance` and `redis_tls` are ported, and give
    the reference's report (`checks/` chip_smoke.py phase 21's
    checks)."""
    monkeypatch.setenv("TRIVY_TPU_" + dest.upper(), value)
    if dest not in run_config.UNPORTED:
        assert ported_vm_scan_equals_reference(request, tmp_path, capsys,
                                               monkeypatch) == 0
        return
    rc = main(["vm", str(tmp_path / "disk.img"), "--device", "cpu",
               "--cache-dir", str(tmp_path / "c")])
    captured = capsys.readouterr()
    lines = captured.err.strip().splitlines()
    assert rc == 1 and captured.out == "" and len(lines) == 1
    assert "not ported yet" in lines[0]
    assert dest.replace("_", "-") in lines[0]


def test_unported_option_from_config_file_is_refused(request, tmp_path,
                                                     capsys, monkeypatch):
    """`config-check` and `compliance` from a config file each give the
    reference's report."""
    cfg = tmp_path / "trivy-tpu.yaml"
    cfg.write_text("scan:\n  config-check: [checks/]\n")
    assert ported_vm_scan_equals_reference(
        request, tmp_path, capsys, monkeypatch, "--config", str(cfg)) == 0
    cfg.write_text("compliance: docker-cis-1.6.0\n")
    assert ported_vm_scan_equals_reference(
        request, tmp_path, capsys, monkeypatch, "--config", str(cfg)) == 0


def ported_vm_scan_equals_reference(request, tmp_path, capsys, monkeypatch,
                                    *extra) -> int:
    """A misconfig vm scan of an ext4 image, from `tmp_path` where
    `checks/` holds chip_smoke.py phase 21's checks: the port's report
    equals the reference's. -> its rc."""
    monkeypatch.chdir(tmp_path)
    chip_smoke.write_custom_checks(str(tmp_path))
    img = request.getfixturevalue("raw_image")
    argv = ["vm", img, "--format", "json", "--quiet", "--scanners",
            "vuln,secret,misconfig", "--check-namespaces", "user", *extra]
    want = scan(jax_main.main, argv + ["--cache-dir", str(tmp_path / "j")],
                capsys, jax_uuid)
    got = scan(main, argv + ["--device", "cpu", "--cache-dir",
                             str(tmp_path / "p")], capsys, port_uuid)
    assert got == want
    return got[0]


@needs_mkfs
def test_vm_scan_imports_no_jax_in_a_fresh_process(seeded, tmp_path):
    """A CPU vm scan through the port's CLI, on a GPT disk, loads no jax
    module and nothing of the JAX package."""
    code = f"""
import sys
before = set(sys.modules)
from trivy_tpu_torch.cli.main import main
assert main(["vm", {seeded['disks']['gpt']!r}, "--db-path",
             {seeded['db']!r}, "--cache-dir", {str(tmp_path / 'c')!r},
             "--device", "cpu", "--quiet", "--format", "json",
             "--output", {str(tmp_path / 'r.json')!r}]) == 0
print("\\n".join(sorted(set(sys.modules) - before)))
"""
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=os.path.dirname(os.path.dirname(__file__)),
                         env={**os.environ, "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "trivy_tpu_torch.fanal.vm.ext4" in loaded
    assert "trivy_tpu_torch.artifact.vm" in loaded
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")
                or m == "trivy_tpu" or m.startswith("trivy_tpu.")]

