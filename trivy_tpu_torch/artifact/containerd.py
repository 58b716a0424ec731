"""Containerd image source (reference pkg/fanal/image/daemon/containerd.go,
first in the acquisition chain, image.go:17-58).

The reference talks to containerd over its gRPC socket; this framework
reads the daemon's on-disk state directly — containerd's metadata store
is a BoltDB file and its content store is a flat blob directory, so a
scan needs no gRPC stack and no daemon round-trips:

  <root>/io.containerd.metadata.v1.bolt/meta.db
      v1 -> <namespace> -> image -> <ref> -> target digest/mediatype
  <root>/io.containerd.content.v1.content/blobs/<algo>/<hex>
      manifests, configs, and layer blobs by digest

The daemon root defaults to /var/lib/containerd and is overridable with
CONTAINERD_ROOT (tests point it at a fixture tree). Reads are safe
against a live daemon: bolt files are single-writer/multi-reader and the
scan takes a point-in-time snapshot of the metadata pages.

Copy of trivy_tpu/artifact/containerd.py, with one repair: `diff_ids`
is a method, as on every other image source. The reference's is a
property, so `ImageArtifact`, which calls `img.diff_ids()`, fails on a
containerd image with "'list' object is not callable".
"""

from __future__ import annotations

import gzip
import json
import os

from trivy_tpu_torch.db.bolt import BoltDB, BoltError
from trivy_tpu_torch.log import logger

_log = logger("containerd")

DEFAULT_ROOT = "/var/lib/containerd"
METADATA_DB = "io.containerd.metadata.v1.bolt/meta.db"
CONTENT_DIR = "io.containerd.content.v1.content/blobs"

_MANIFEST_LIST_TYPES = (
    "application/vnd.oci.image.index.v1+json",
    "application/vnd.docker.distribution.manifest.list.v2+json",
)


class ContainerdError(Exception):
    pass


def _host_arch() -> str:
    """Host architecture in OCI platform terms (the image variant that
    actually runs on this node is the one to scan)."""
    import platform as _plat

    machine = _plat.machine().lower()
    return {"x86_64": "amd64", "aarch64": "arm64",
            "arm64": "arm64", "amd64": "amd64"}.get(machine, machine)


def containerd_root() -> str:
    return os.environ.get("CONTAINERD_ROOT", DEFAULT_ROOT)


def _resolve_ref(db: BoltDB, target: str,
                 namespace: str) -> tuple[str, str]:
    """image reference -> (manifest digest, media type)."""
    images = db.bucket(b"v1", namespace.encode(), b"image")
    if images is None:
        raise ContainerdError(
            f"no images in containerd namespace {namespace!r}")
    candidates = {target}
    if ":" not in target.split("/")[-1] and "@" not in target:
        candidates.add(f"{target}:latest")
    if "/" not in target:
        candidates.update(
            f"docker.io/library/{c}" for c in list(candidates))
    for name_b, img in images.sub_buckets():
        if name_b.decode("utf-8", "replace") not in candidates:
            continue
        tgt = img.bucket(b"target")
        if tgt is None:
            continue
        digest = (tgt.get(b"digest") or b"").decode()
        media = (tgt.get(b"mediatype") or b"").decode()
        if digest:
            return digest, media
    raise ContainerdError(f"image {target!r} not found in containerd")


class ContainerdImage:
    """Image backed by containerd's content store (same interface as
    DaemonImage/RegistryImage: name/config/diff_ids/layer_bytes)."""

    def __init__(self, ref: str, root: str | None = None,
                 namespace: str = "default"):
        self.ref = ref
        self.root = root or containerd_root()
        meta_path = os.path.join(self.root, METADATA_DB)
        if not os.path.exists(meta_path):
            raise ContainerdError(f"no containerd metadata at {meta_path}")
        try:
            db = BoltDB(meta_path)
        except BoltError as exc:
            raise ContainerdError(str(exc))
        digest, media = _resolve_ref(db, ref, namespace)
        manifest = json.loads(self._blob(digest))
        if media in _MANIFEST_LIST_TYPES or "manifests" in manifest:
            chosen = None
            host_arch = _host_arch()
            for m in manifest.get("manifests", []):
                plat = m.get("platform") or {}
                if plat.get("architecture") in (host_arch, ""):
                    chosen = m
                    break
            if chosen is None and manifest.get("manifests"):
                chosen = manifest["manifests"][0]
            if chosen is None:
                raise ContainerdError("empty containerd manifest list")
            manifest = json.loads(self._blob(chosen["digest"]))
        self.manifest = manifest
        self.config_digest = manifest.get("config", {}).get("digest", "")
        self._config = json.loads(self._blob(self.config_digest))
        self.layers = manifest.get("layers", [])

    def _blob(self, digest: str) -> bytes:
        algo, _, hexd = digest.partition(":")
        path = os.path.join(self.root, CONTENT_DIR, algo, hexd)
        if not os.path.exists(path):
            raise ContainerdError(f"blob {digest} not in content store")
        with open(path, "rb") as f:
            return f.read()

    @property
    def name(self) -> str:
        return self.ref

    @property
    def config(self) -> dict:
        return self._config

    def diff_ids(self) -> list[str]:
        return list((self._config.get("rootfs") or {}).get("diff_ids")
                    or [])

    def layer_bytes(self, i: int) -> bytes:
        raw = self._blob(self.layers[i]["digest"])
        if self.layers[i].get("mediaType", "").endswith("gzip") or \
                raw[:2] == b"\x1f\x8b":
            return gzip.decompress(raw)
        return raw

    def layer_stream(self, i: int):
        """Content-store blob as an open file: the tar walk's stream
        mode reads (and gunzips) it incrementally — neither the
        compressed nor the decompressed layer is fully materialized."""
        digest = self.layers[i]["digest"]
        algo, _, hexd = digest.partition(":")
        path = os.path.join(self.root, CONTENT_DIR, algo, hexd)
        if not os.path.exists(path):
            raise ContainerdError(f"blob {digest} not in content store")
        return open(path, "rb")

    def close(self) -> None:
        pass
