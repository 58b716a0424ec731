from trivy_tpu_torch.detector.engine import MatchEngine, PkgQuery

__all__ = ["MatchEngine", "PkgQuery"]
