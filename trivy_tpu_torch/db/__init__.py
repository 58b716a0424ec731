"""Advisory database: model and store with JSON(.gz) persistence, and
the BoltDB trivy-db import (copy of trivy_tpu.db)."""

from trivy_tpu_torch.db.model import Advisory, DataSourceInfo, VulnerabilityMeta
from trivy_tpu_torch.db.store import AdvisoryDB

__all__ = ["Advisory", "AdvisoryDB", "DataSourceInfo", "VulnerabilityMeta"]
