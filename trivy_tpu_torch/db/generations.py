"""Advisory-DB generation layout, reader side.

A DB root managed by the verified download path looks like:

    <db_root>/
      generations/
        sha256-<hex>/             one fully-staged, fsynced install
        sha256-<hex>.quarantine   a generation that failed validation
      last-good -> generations/sha256-<hex>     (symlink, atomically swapped)

Readers (`AdvisoryDB.load`, the compiled-DB cache's digest) resolve the
root through `resolve()`: when a `last-good` link exists it wins,
otherwise the root itself is the (legacy, flat) DB directory — so
`db import`-style flat installs keep working unchanged.

Copy of trivy_tpu/db/generations.py, trimmed to the reader side: the
install, promote and quarantine paths come with the port's `db`
commands.
"""

from __future__ import annotations

import os

GENERATIONS_DIR = "generations"
LAST_GOOD = "last-good"


def last_good_path(db_root: str) -> str:
    return os.path.join(db_root, LAST_GOOD)


def resolve(db_root: str) -> str:
    """The directory a reader should load: the last-good generation when
    one is installed, else the root itself (legacy flat layout)."""
    lg = last_good_path(db_root)
    if os.path.isdir(lg):  # follows the symlink
        return lg
    return db_root
