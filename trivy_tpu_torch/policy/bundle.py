"""Check-bundle lifecycle (reference pkg/policy/policy.go:20-25):
a directory of check files distributed as an OCI artifact (the
trivy-checks equivalent), cached under ``<cache>/policy/content`` with
a metadata.json recording when it was downloaded; refreshed at most
every 24 h unless --skip-check-update.

The bundle content is plain check files in this framework's formats
(``*.py`` / ``*.yaml`` — see iac/engine.py), so a downloaded bundle and
a --config-check dir load identically.

Copy of trivy_tpu/policy/bundle.py, whole, on the port's db/oci.py and
durability.atomic_write."""

from __future__ import annotations

import json
import os
import time

from trivy_tpu_torch.durability import atomic_write
from trivy_tpu_torch.log import logger

_log = logger("policy")

UPDATE_INTERVAL_S = 24 * 3600  # reference policy.go updateInterval


def _policy_dir(cache_dir: str) -> str:
    return os.path.join(cache_dir, "policy")


def _content_dir(cache_dir: str) -> str:
    return os.path.join(_policy_dir(cache_dir), "content")


def _metadata_path(cache_dir: str) -> str:
    return os.path.join(_policy_dir(cache_dir), "metadata.json")


def _needs_update(cache_dir: str, now: float | None = None) -> bool:
    try:
        with open(_metadata_path(cache_dir)) as f:
            meta = json.load(f)
        downloaded = float(meta["downloaded_at"])
    except (OSError, ValueError, KeyError):
        return True
    return (now if now is not None else time.time()) - downloaded \
        >= UPDATE_INTERVAL_S


def update_bundle(cache_dir: str, repository: str,
                  insecure: bool = False) -> str:
    """Pull the bundle OCI artifact into the policy cache and stamp
    metadata.json. Returns the content dir."""
    from trivy_tpu_torch.db.oci import download_artifact

    content = _content_dir(cache_dir)
    download_artifact(repository, content, media_type=None,
                      insecure=insecure)
    os.makedirs(_policy_dir(cache_dir), exist_ok=True)
    atomic_write(_metadata_path(cache_dir), json.dumps(
        {"downloaded_at": time.time(),
         "repository": repository}).encode())
    return content


def bundle_check_paths(cache_dir: str, repository: str = "",
                       skip_update: bool = False,
                       insecure: bool = False) -> list[str]:
    """Paths to feed the check engine for the downloaded bundle (empty
    if no bundle is configured or cached). Downloads/refreshes first
    when a repository is set and the 24 h interval elapsed."""
    content = _content_dir(cache_dir)
    if repository and not skip_update and _needs_update(cache_dir):
        try:
            update_bundle(cache_dir, repository, insecure=insecure)
        except Exception as e:
            # stale/offline bundle is non-fatal, like the reference's
            # fallback to the embedded checks
            _log.warn("check bundle update failed", err=str(e))
    return [content] if os.path.isdir(content) else []
