"""EBS snapshot streaming disk source (reference pkg/fanal/artifact/vm/
{ebs,ami}.go): scan an EBS snapshot (or the snapshot backing an AMI)
without downloading the whole image — the EBS direct APIs serve 512 KiB
blocks on demand, and the filesystem readers only touch the blocks the
walk actually needs.

The AWS client is injectable: production uses boto3 ("ebs" + "ec2"
clients) when it is importable; tests inject fakes. Targets:
  ebs:snap-xxxx   scan the snapshot directly
  ami:ami-xxxx    resolve the AMI's root device snapshot first

Copy of trivy_tpu/fanal/vm/ebs.py, whole, with its imports rewritten.
"""

from __future__ import annotations

import io
from collections import OrderedDict

from trivy_tpu_torch.log import logger

_log = logger("ebs")

DEFAULT_BLOCK_SIZE = 512 * 1024
CACHE_BLOCKS = 64  # ~32 MiB with default block size


class EBSError(Exception):
    pass


class EBSDisk(io.RawIOBase):
    """Seekable read-only view over an EBS snapshot.

    `client` must provide the two EBS direct APIs used here (boto3's
    "ebs" client does):
      list_snapshot_blocks(SnapshotId=..., [NextToken=...]) ->
        {"Blocks": [{"BlockIndex": int, "BlockToken": str}],
         "BlockSize": int, "VolumeSize": int(GiB), "NextToken": str?}
      get_snapshot_block(SnapshotId=..., BlockIndex=..., BlockToken=...)
        -> {"BlockData": readable stream}
    Unlisted blocks are holes (read as zeros). Fetched blocks go through
    a small LRU — filesystem walks revisit metadata blocks constantly.
    """

    def __init__(self, client, snapshot_id: str):
        self.client = client
        self.snapshot_id = snapshot_id
        self.pos = 0
        self.block_size = DEFAULT_BLOCK_SIZE
        self.volume_bytes = 0
        self._tokens: dict[int, str] = {}
        self._cache: OrderedDict[int, bytes] = OrderedDict()
        self._zero = b""
        self._load_block_map()

    def _load_block_map(self) -> None:
        token = None
        while True:
            kwargs = {"SnapshotId": self.snapshot_id}
            if token:
                kwargs["NextToken"] = token
            try:
                resp = self.client.list_snapshot_blocks(**kwargs)
            except Exception as e:  # boto3 raises service-specific types
                raise EBSError(
                    f"cannot list blocks of {self.snapshot_id}: {e}"
                ) from e
            self.block_size = resp.get("BlockSize") or self.block_size
            vol_gib = resp.get("VolumeSize") or 0
            self.volume_bytes = vol_gib * (1 << 30)
            for b in resp.get("Blocks") or []:
                self._tokens[int(b["BlockIndex"])] = b["BlockToken"]
            token = resp.get("NextToken")
            if not token:
                break
        if not self.volume_bytes and self._tokens:
            self.volume_bytes = (max(self._tokens) + 1) * self.block_size
        _log.info("EBS snapshot block map loaded",
                  snapshot=self.snapshot_id, blocks=len(self._tokens),
                  block_size=self.block_size)

    def _block(self, index: int) -> bytes:
        token = self._tokens.get(index)
        if token is None:
            # hole: shared zero buffer, never cached — sparse snapshots
            # would otherwise evict network-fetched blocks from the LRU
            if len(self._zero) != self.block_size:
                self._zero = b"\x00" * self.block_size
            return self._zero
        cached = self._cache.get(index)
        if cached is not None:
            self._cache.move_to_end(index)
            return cached
        try:
            resp = self.client.get_snapshot_block(
                SnapshotId=self.snapshot_id, BlockIndex=index,
                BlockToken=token)
        except Exception as e:
            raise EBSError(
                f"cannot fetch block {index} of {self.snapshot_id}: "
                f"{e}") from e
        body = resp["BlockData"]
        data = body.read() if hasattr(body, "read") else bytes(body)
        if len(data) < self.block_size:
            data += b"\x00" * (self.block_size - len(data))
        self._cache[index] = data
        if len(self._cache) > CACHE_BLOCKS:
            self._cache.popitem(last=False)
        return data

    # ------------------------------------------------------------ file API

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, off: int, whence: int = 0) -> int:
        if whence == 0:
            self.pos = off
        elif whence == 1:
            self.pos += off
        else:
            self.pos = self.volume_bytes + off
        return self.pos

    def tell(self) -> int:
        return self.pos

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = self.volume_bytes - self.pos
        n = max(0, min(n, self.volume_bytes - self.pos))
        out = bytearray()
        while n > 0:
            index, within = divmod(self.pos, self.block_size)
            take = min(n, self.block_size - within)
            out += self._block(index)[within:within + take]
            self.pos += take
            n -= take
        return bytes(out)


def resolve_ami(ec2_client, ami_id: str) -> str:
    """AMI id -> snapshot id of its root EBS device (reference
    vm/ami.go: DescribeImages -> BlockDeviceMappings)."""
    try:
        resp = ec2_client.describe_images(ImageIds=[ami_id])
    except Exception as e:
        raise EBSError(f"cannot describe {ami_id}: {e}") from e
    images = resp.get("Images") or []
    if not images:
        raise EBSError(f"AMI not found: {ami_id}")
    image = images[0]
    root = image.get("RootDeviceName")
    mappings = image.get("BlockDeviceMappings") or []
    for m in mappings:
        ebs = m.get("Ebs") or {}
        if not ebs.get("SnapshotId"):
            continue
        if root is None or m.get("DeviceName") == root:
            return ebs["SnapshotId"]
    for m in mappings:  # no mapping matched the root device name
        ebs = m.get("Ebs") or {}
        if ebs.get("SnapshotId"):
            return ebs["SnapshotId"]
    raise EBSError(f"AMI {ami_id} has no EBS-backed device")


def open_ebs_target(target: str, client_factory=None):
    """'ebs:snap-…' or 'ami:ami-…' -> EBSDisk.

    `client_factory(service_name)` returns an AWS client; defaults to
    boto3 (gated import — the scanner works without it for every
    non-EBS target)."""
    if client_factory is None:
        try:
            import boto3  # type: ignore
        except ImportError as e:
            raise EBSError(
                "boto3 is required for ebs:/ami: targets (pip install "
                "boto3, plus AWS credentials in the environment)") from e

        def client_factory(name):
            return boto3.client(name)

    kind, _, ident = target.partition(":")
    if kind == "ami":
        ident = resolve_ami(client_factory("ec2"), ident)
    return EBSDisk(client_factory("ebs"), ident)
