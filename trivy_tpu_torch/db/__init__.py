"""Advisory database: model and store with JSON(.gz) persistence (copy
of trivy_tpu.db's model and store; the BoltDB import is not ported)."""

from trivy_tpu_torch.db.model import Advisory, DataSourceInfo, VulnerabilityMeta
from trivy_tpu_torch.db.store import AdvisoryDB

__all__ = ["Advisory", "AdvisoryDB", "DataSourceInfo", "VulnerabilityMeta"]
