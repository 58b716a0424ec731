""".trivyignore parsing (reference pkg/result/ignore.go): plain-text (one
finding ID per line, '#' comments) and YAML (per-class entries with id,
paths, purls, expired_at, statement).

Copy of trivy_tpu/result/ignore.py.
"""

from __future__ import annotations

import datetime
import fnmatch
import os
from dataclasses import dataclass, field


@dataclass
class IgnoreFinding:
    id: str = ""
    paths: list[str] = field(default_factory=list)
    purls: list[str] = field(default_factory=list)
    expired_at: str = ""  # ISO date
    statement: str = ""

    def expired(self, today: datetime.date) -> bool:
        if not self.expired_at:
            return False
        try:
            return datetime.date.fromisoformat(self.expired_at) < today
        except ValueError:
            return False

    def matches(self, finding_id: str, path: str, purl: str,
                today: datetime.date) -> bool:
        if self.expired(today):
            return False
        if self.id and self.id != finding_id:
            return False
        if self.paths and not any(fnmatch.fnmatch(path, p) for p in self.paths):
            return False
        if self.purls and not any(purl.startswith(p) for p in self.purls):
            return False
        return True


@dataclass
class IgnoreConfig:
    vulnerabilities: list[IgnoreFinding] = field(default_factory=list)
    misconfigurations: list[IgnoreFinding] = field(default_factory=list)
    secrets: list[IgnoreFinding] = field(default_factory=list)
    licenses: list[IgnoreFinding] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not (self.vulnerabilities or self.misconfigurations
                    or self.secrets or self.licenses)

    def section(self, kind: str) -> list[IgnoreFinding]:
        return getattr(self, kind)

    def ignored(self, kind: str, finding_id: str, path: str = "",
                purl: str = "", today: datetime.date | None = None) -> bool:
        today = today or datetime.date.today()
        return any(
            f.matches(finding_id, path, purl, today)
            for f in self.section(kind)
        )


def load_ignore_file(path: str) -> IgnoreConfig:
    """Load .trivyignore (plain) or .trivyignore.yaml."""
    cfg = IgnoreConfig()
    if not path or not os.path.exists(path):
        return cfg
    if path.endswith((".yaml", ".yml")):
        import yaml

        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        for kind, key in [
            ("vulnerabilities", "vulnerabilities"),
            ("misconfigurations", "misconfigurations"),
            ("secrets", "secrets"),
            ("licenses", "licenses"),
        ]:
            for item in doc.get(key) or []:
                getattr(cfg, kind).append(IgnoreFinding(
                    id=item.get("id", ""),
                    paths=item.get("paths", []) or [],
                    purls=item.get("purls", []) or [],
                    expired_at=str(item.get("expired_at", "") or ""),
                    statement=item.get("statement", ""),
                ))
        return cfg
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            entry = IgnoreFinding(id=parts[0])
            # "exp:2024-01-01" suffix support
            for p in parts[1:]:
                if p.startswith("exp:"):
                    entry.expired_at = p[4:]
            # plain-file entries apply to all finding kinds
            cfg.vulnerabilities.append(entry)
            cfg.misconfigurations.append(entry)
            cfg.secrets.append(entry)
            cfg.licenses.append(entry)
    return cfg
