"""Deterministic chaos campaigns over the fault-injection registry.

Seed-derived multi-fault schedules run against live mini-system
scenarios, five invariant oracles per episode, auto-shrinking repros,
and machine-checked (site, action) coverage of ``faults.SITES``.

Copy of trivy_tpu/chaos/: the scenarios take the device path on the
torch device the campaign passes down (``cuda:0`` by default).
"""

from trivy_tpu_torch.chaos.campaign import (CampaignReport, ChaosError,
                                            EpisodeResult, Repro,
                                            full_coverage_check, replay,
                                            run_campaign)
from trivy_tpu_torch.chaos.scenarios import (MANIFEST, SCENARIOS,
                                             declared_pairs,
                                             registry_pairs)
from trivy_tpu_torch.chaos.schedule import EpisodeSpec, shrink

__all__ = [
    "CampaignReport", "ChaosError", "EpisodeResult", "EpisodeSpec",
    "MANIFEST", "Repro", "SCENARIOS", "declared_pairs",
    "full_coverage_check", "registry_pairs", "replay",
    "run_campaign", "shrink",
]
