"""Fleet serving tier (docs/fleet.md): replicated scan servers behind a
smart client.

Three pieces compose the single-server subsystems into a deployment:

- :mod:`trivy_tpu_torch.fleet.endpoints` — ``EndpointSet``, the one place
  where retry, failover, hedging, and client-side load balancing
  compose over N replica URLs (health from ``/readyz``, per-replica
  circuit breakers, budget-capped hedged requests for tail latency);
- :mod:`trivy_tpu_torch.fleet.dedupe` — a distributed layer-analysis claim
  over the redis cache backend, so M replicas sharing one cache tier
  analyze each unique layer once fleet-wide (the cross-server story
  for the in-process ``LayerSingleflight``);
- :mod:`trivy_tpu_torch.fleet.rollout` — the coordinated advisory-DB rollout
  controller: canary replica first, a zero-diff probe set, then roll
  the rest, automatic rollback on a ``/readyz`` regression or a probe
  diff, and the monitor's delta re-score triggered exactly once fleet-wide;
- :mod:`trivy_tpu_torch.fleet.telemetry` — the observability control plane:
  metrics + attribution federation over every replica's ``/metrics``
  and ``/debug/profile`` (counters summed, histogram buckets merged,
  ``replica`` label, exemplars preserved), cross-replica trace
  stitching of hedge/failover fragments into one Chrome trace, the
  token-gated federation endpoint, and the fleet monitor loop;
- :mod:`trivy_tpu_torch.fleet.slo` — the fleet ops event bus (closed EVENTS
  vocabulary, durable fsynced journal with torn-tail-tolerant replay),
  the multi-window burn-rate SLO engine, and the replica-skew
  detector.

``TRIVY_TPU_FLEET=0`` is the kill switch: multi-URL clients pin to the
first endpoint through the exact single-server code path, and servers
keep the in-process layer gate even on a redis cache.
``TRIVY_TPU_FLEET_EVENTS=0`` kills the ops event bus alone.

Copy of trivy_tpu/fleet/__init__.py.
"""

from __future__ import annotations

import os

from trivy_tpu_torch.log import logger

_log = logger("fleet")

DEFAULT_HEDGE_MS = 75.0
DEFAULT_HEDGE_BUDGET = 0.1
DEFAULT_HEALTH_INTERVAL_S = 5.0


def enabled() -> bool:
    """The ``TRIVY_TPU_FLEET`` kill switch (default on)."""
    return os.environ.get("TRIVY_TPU_FLEET", "1") != "0"


def _parse_float(raw: str, name: str, default: float) -> float:
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        _log.warn(f"malformed {name}; using default", value=raw)
        return default


def hedge_s() -> float:
    """Hedge trigger delay in seconds (``TRIVY_TPU_FLEET_HEDGE_MS``):
    how long a scan request may sit unanswered on its primary replica
    before the same request is dispatched to a second one. 0 disables
    hedging."""
    raw = os.environ.get("TRIVY_TPU_FLEET_HEDGE_MS", "")
    return max(_parse_float(raw, "TRIVY_TPU_FLEET_HEDGE_MS",
                            DEFAULT_HEDGE_MS), 0.0) / 1000.0


def hedge_budget() -> float:
    """Max fraction of requests allowed to hedge
    (``TRIVY_TPU_FLEET_HEDGE_BUDGET``): bounds the duplicate-work cost
    so a globally slow fleet cannot double its own load."""
    raw = os.environ.get("TRIVY_TPU_FLEET_HEDGE_BUDGET", "")
    return min(max(_parse_float(raw, "TRIVY_TPU_FLEET_HEDGE_BUDGET",
                                DEFAULT_HEDGE_BUDGET), 0.0), 1.0)


def health_interval_s() -> float:
    """Period of the background ``/readyz`` health prober
    (``TRIVY_TPU_FLEET_HEALTH_INTERVAL_S``)."""
    raw = os.environ.get("TRIVY_TPU_FLEET_HEALTH_INTERVAL_S", "")
    return max(_parse_float(raw, "TRIVY_TPU_FLEET_HEALTH_INTERVAL_S",
                            DEFAULT_HEALTH_INTERVAL_S), 0.1)
