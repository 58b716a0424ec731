"""Advisory database: model and in-memory store (copy of trivy_tpu.db's
model and store; persistence comes with the DB slice of the port)."""

from trivy_tpu_torch.db.model import Advisory, DataSourceInfo, VulnerabilityMeta
from trivy_tpu_torch.db.store import AdvisoryDB

__all__ = ["Advisory", "AdvisoryDB", "DataSourceInfo", "VulnerabilityMeta"]
