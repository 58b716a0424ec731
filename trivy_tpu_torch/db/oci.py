"""OCI artifact downloads (reference pkg/oci/artifact.go + pkg/db
OCI pull): the advisory DB / checks bundle are distributed as single-
layer OCI artifacts (tar.gz media types).  Reuses the registry client
from the image-acquisition chain; network-gated — `db import` remains
the offline path.

Every fetched layer blob is verified against its manifest digest (and
declared size) before a single byte is extracted — a torn or tampered
download fails with OCIError instead of landing on disk.
`install_artifact` goes further and gives the advisory DB a crash-safe
lifecycle: extraction into a staged `generations/<digest>` directory
that is fsynced and atomically renamed, then promoted via the
`last-good` symlink.

Copy of trivy_tpu/db/oci.py, with its fault sites `db.download`,
`db.install.extract` and `db.install.promote`.
"""

from __future__ import annotations

import gzip
import hashlib
import io
import os
import tarfile

from trivy_tpu_torch.artifact.image_source import RegistryClient, SourceError, parse_reference
from trivy_tpu_torch.db import generations
from trivy_tpu_torch.durability import atomic
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.resilience import faults

_log = logger("oci")

DB_MEDIA_TYPE = "application/vnd.aquasec.trivy.db.layer.v1.tar+gzip"
JAVADB_MEDIA_TYPE = "application/vnd.aquasec.trivy.javadb.layer.v1.tar+gzip"
CHECKS_MEDIA_TYPE = "application/vnd.oci.image.layer.v1.tar+gzip"


class OCIError(Exception):
    pass


def verify_layer(layer: dict, data: bytes, ref: str = "") -> None:
    """Check a fetched blob against its manifest descriptor: declared
    size (when present) and content digest. Raises OCIError on any
    mismatch — a mismatched blob must never reach extraction."""
    size = layer.get("size")
    if size is not None and size != len(data):
        raise OCIError(
            f"layer size mismatch for {ref or layer.get('digest')}: "
            f"manifest says {size} bytes, got {len(data)}")
    digest = layer.get("digest") or ""
    algo, _, want = digest.partition(":")
    if not want:
        raise OCIError(f"layer of {ref} has no digest in its descriptor")
    try:
        h = hashlib.new(algo)
    except ValueError:
        raise OCIError(f"unsupported digest algorithm {algo!r} in {ref}")
    h.update(data)
    if h.hexdigest() != want:
        raise OCIError(
            f"layer digest mismatch for {ref}: manifest says {digest}, "
            f"fetched blob is {algo}:{h.hexdigest()} (torn or tampered "
            "download)")


def _fetch_layer(ref: str, media_type: str | None, insecure: bool,
                 username: str, password: str) -> tuple[bytes, str]:
    """Pull the (first matching) layer blob of `ref`, verified against
    its manifest descriptor. Returns (blob bytes, digest)."""
    registry, repo, tag, digest = parse_reference(ref)
    client = RegistryClient(registry, insecure=insecure,
                            username=username, password=password)
    try:
        manifest, _ = client.manifest(repo, digest or tag)
    except SourceError as e:
        raise OCIError(f"artifact manifest {ref}: {e}") from e
    layers = manifest.get("layers") or []
    layer = None
    for cand in layers:
        if media_type is None or cand.get("mediaType") == media_type:
            layer = cand
            break
    if layer is None:
        raise OCIError(
            f"no layer with media type {media_type!r} in {ref} "
            f"(found: {[c.get('mediaType') for c in layers]})")
    try:
        data = client.blob(repo, layer["digest"])
    except SourceError as e:
        raise OCIError(f"artifact blob {ref}: {e}") from e
    # fault site "db.download": torn-write / bitflip rules mangle the
    # payload here, which the digest check below must catch
    data = faults.mangle_write("db.download", data)
    verify_layer(layer, data, ref=ref)
    return data, layer["digest"]


def _extract(data: bytes, dest_dir: str) -> list[str]:
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    os.makedirs(dest_dir, exist_ok=True)
    with tarfile.open(fileobj=io.BytesIO(data)) as tf:
        for member in tf.getmembers():
            # path traversal guard
            dest = os.path.realpath(os.path.join(dest_dir, member.name))
            if not dest.startswith(os.path.realpath(dest_dir) + os.sep) \
                    and dest != os.path.realpath(dest_dir):
                raise OCIError(f"unsafe path in artifact: {member.name}")
        tf.extractall(dest_dir, filter="data")
        return tf.getnames()


def download_artifact(ref: str, dest_dir: str,
                      media_type: str | None = None,
                      insecure: bool = False,
                      username: str = "", password: str = "") -> list[str]:
    """Pull an OCI artifact and unpack its (first matching) layer into
    dest_dir, verifying the blob digest first.  Returns the extracted
    member names."""
    data, _ = _fetch_layer(ref, media_type, insecure, username, password)
    names = _extract(data, dest_dir)
    _log.info("downloaded OCI artifact", ref=ref, files=len(names))
    return names


def _validate_staged_db(staging: str) -> str | None:
    """Load + fitness-check a staged advisory DB (db.store.validate_db)
    before it can become a generation. Non-DB artifacts (no recognizable
    DB file) are skipped — install_artifact also serves e.g. bundles."""
    from trivy_tpu_torch.db.store import AdvisoryDB, validate_db

    try:
        db = AdvisoryDB.load(staging)
    except FileNotFoundError:
        return None  # not an advisory DB; nothing to validate
    except Exception as exc:
        return f"unloadable: {exc}"
    return validate_db(db)


def install_artifact(ref: str, db_root: str,
                     media_type: str | None = None,
                     insecure: bool = False,
                     username: str = "", password: str = "") -> str:
    """Crash-safe advisory-DB install: fetch + verify the layer, stage
    it under `generations/<digest>.tmp-<pid>`, validate the staged DB
    (loadable, readable schema, non-empty), fsync the whole tree,
    atomically rename it to `generations/<digest>`, then promote the
    `last-good` symlink. A SIGKILL at any point leaves either the
    previous generation served or a sweepable staging dir — never a
    half-written or unvalidated DB behind `last-good`. A digest that
    was previously quarantined is refused outright. Returns the
    generation path."""
    data, digest = _fetch_layer(ref, media_type, insecure, username,
                                password)
    gen_root = generations.generations_root(db_root)
    os.makedirs(gen_root, exist_ok=True)
    generations.sweep_staging(db_root)

    name = generations.gen_name(digest)
    if generations.is_quarantined(db_root, name):
        raise OCIError(
            f"digest {digest} of {ref} was previously quarantined "
            "(failed validation); refusing to reinstall it — remove the "
            f"*.quarantine dir under {gen_root} to retry")
    gen_dir = os.path.join(gen_root, name)
    if not os.path.isdir(gen_dir):
        import shutil

        staging = f"{gen_dir}.tmp-{os.getpid()}"
        _extract(data, staging)
        # last-good must only ever point at a generation that passed
        # validation — a digest-correct but empty/unreadable DB would
        # otherwise silently zero every CVE match for local scans
        problem = _validate_staged_db(staging)
        if problem is not None:
            shutil.rmtree(staging, ignore_errors=True)
            raise OCIError(
                f"artifact {ref} failed validation: {problem}")
        atomic.fsync_tree(staging)
        # crash point: staging is durable but not yet a generation
        faults.check_kill("db.install.extract")
        try:
            os.rename(staging, gen_dir)
        except OSError:
            if not os.path.isdir(gen_dir):
                raise
            # a concurrent installer of the same digest won the rename;
            # same digest = same verified bytes, so just stand down
            shutil.rmtree(staging, ignore_errors=True)
        atomic.fsync_dir(gen_root)
    # crash point: generation installed but last-good still points at
    # the previous one — next start serves the old DB, re-install is a
    # cheap idempotent promote
    faults.check_kill("db.install.promote")
    generations.promote(db_root, gen_dir)
    _log.info("installed OCI artifact generation", ref=ref, digest=digest,
              path=gen_dir)
    return gen_dir
