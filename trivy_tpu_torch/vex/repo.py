"""VEX repositories (reference pkg/vex/repo + pkg/vex/repo.go
RepositorySet): named repositories configured in
`<cache>/vex/repository.yaml`, each cached under
`<cache>/vex/repositories/<name>/` with the VEX Repository Specification
layout — `vex-repository.json` manifest, `index.json` mapping
versionless package-URL ids to document locations, and the documents
themselves.

Statements are looked up lazily: a package's purl is stripped of
version/qualifiers/subpath and matched against the index of each enabled
repository in configuration order (first repository wins, reference
repo.go:109-139). Repository downloads go through the HTTP downloader
when a manifest URL is reachable; in offline environments the cached
copy is used as-is and absent repositories are skipped with a warning —
never an error (reference: errNoRepository is non-fatal).

Copy of trivy_tpu/vex/repo.py.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from trivy_tpu_torch.log import logger
from trivy_tpu_torch.utils.purl import parse_purl

_log = logger("vex")

CONFIG_FILE = "repository.yaml"
MANIFEST_FILE = "vex-repository.json"
INDEX_FILE = "index.json"
DEFAULT_REPO_URL = "https://github.com/aquasecurity/vexhub"


def _version_sort_key(name: str):
    try:
        return (1, tuple(int(p) for p in name.split(".")))
    except ValueError:
        return (0, name)


@dataclass
class Repository:
    name: str = ""
    url: str = ""
    enabled: bool = True
    dir: str = ""

    def index(self) -> dict[str, dict] | None:
        """-> {package id: {"location": ..., "format": ...}} or None when
        the repository has never been cached. With several cached spec
        versions, the highest version's index wins (deterministic, never
        a stale directory os.walk happened to visit first)."""
        path = None
        for root, dirs, fns in os.walk(self.dir):
            # visit version dirs newest-first ("0.10" > "0.9" numerically)
            dirs.sort(key=_version_sort_key, reverse=True)
            if INDEX_FILE in fns:
                path = os.path.join(root, INDEX_FILE)
                break
        if path is None:
            return None
        try:
            with open(path, encoding="utf-8") as f:
                raw = json.load(f)
        except (OSError, ValueError) as exc:
            _log.warn("bad VEX repository index", repo=self.name,
                      err=str(exc))
            return None
        out = {}
        for p in raw.get("packages") or []:
            # the spec's JSON uses lowercase keys but Go unmarshals
            # case-insensitively, and published indexes use both
            pid = p.get("id") or p.get("ID")
            if pid:
                out[pid] = {
                    "location": p.get("location") or p.get("Location", ""),
                    "format": p.get("format") or p.get("Format", "openvex"),
                    "dir": os.path.dirname(path),
                }
        return out


def load_config(cache_dir: str) -> list[Repository]:
    """Read `<cache>/vex/repository.yaml`; a missing config yields the
    default repository entry, disabled unless cached (so zero-config
    offline scans don't warn)."""
    import yaml

    path = os.path.join(cache_dir, "vex", CONFIG_FILE)
    repos: list[Repository] = []
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            doc = yaml.safe_load(f) or {}
        for r in doc.get("repositories") or []:
            repos.append(Repository(
                name=r.get("name", ""), url=r.get("url", ""),
                enabled=bool(r.get("enabled", True))))
    else:
        repos.append(Repository(name="default", url=DEFAULT_REPO_URL))
    for r in repos:
        r.dir = os.path.join(cache_dir, "vex", "repositories", r.name)
    return [r for r in repos if r.enabled and r.name]


def _strip_purl(purl: str) -> str:
    """purl without version/qualifiers/subpath — the repository index
    key (reference repo.go:112-118)."""
    try:
        p = parse_purl(purl)
    except Exception:
        return purl
    base = f"pkg:{p.type}/"
    if p.namespace:
        base += f"{p.namespace}/"
    return base + p.name


class RepositorySet:
    """VEX source backed by the cached repositories: resolves statements
    per package purl through the repository indexes."""

    def __init__(self, cache_dir: str):
        self.repos: list[tuple[Repository, dict]] = []
        self._docs: dict[str, object] = {}
        for r in load_config(cache_dir):
            idx = r.index()
            if idx is None:
                _log.warn("VEX repository not found locally, skipping",
                          repo=r.name)
                continue
            self.repos.append((r, idx))
        if not self.repos:
            _log.warn("no available VEX repository found locally")

    def __bool__(self) -> bool:
        return bool(self.repos)

    def _load_doc(self, repo: Repository, entry: dict):
        from trivy_tpu_torch.vex.vex import load_vex

        loc = entry["location"]
        key = f"{repo.name}:{loc}"
        if key not in self._docs:
            path = os.path.normpath(os.path.join(entry["dir"], loc))
            # documents must stay inside the repository cache dir
            # (prefix + separator: "corp-evil" must not pass as "corp")
            base = os.path.normpath(repo.dir)
            if not path.startswith(base + os.sep) and path != base:
                self._docs[key] = None
            else:
                try:
                    doc = load_vex(path)
                    doc.source = f"VEX repository: {repo.name} ({repo.url})"
                    self._docs[key] = doc
                except (OSError, ValueError) as exc:
                    _log.warn("failed to load VEX document",
                              repo=repo.name, location=loc, err=str(exc))
                    self._docs[key] = None
        return self._docs[key]

    def candidate_statements(self, purl: str) -> list[tuple[str, object]]:
        """-> [(source label, VexStatement)] for the component's purl.
        The first repository listing the package wins (precedence order,
        reference repo.go:120-139)."""
        if not purl:
            return []
        pid = _strip_purl(purl)
        for repo, idx in self.repos:
            entry = idx.get(pid)
            if entry is None:
                continue
            doc = self._load_doc(repo, entry)
            if doc is None:
                return []
            return [(doc.source, st) for st in doc.statements]
        return []
