"""Central registry of every ``TRIVY_TPU_*`` environment knob.

One source of truth: the ``env-knob`` lint rule fails when code reads a
``TRIVY_TPU_*`` variable that is not declared here (or declares one
nothing reads), and ``docs/knobs_torch.md`` is GENERATED from this
table — the rule also fails when that file is stale.  Regenerate with::

    python -m trivy_tpu_torch.analysis.lint --write-knobs-doc

Copy of trivy_tpu/analysis/knobs.py holding exactly the knobs the port
reads: the reference's bench harness knobs and the knobs of its JAX
native build are not here, the port's own native build directory
(``TRIVY_TPU_TORCH_NATIVE_DIR``) is. ``docs/knobs.md`` stays the
reference's.

Exception by design: ``cli/config.py`` maps *every* CLI flag onto
``TRIVY_TPU_<FLAG>`` dynamically; that wildcard family is documented
below rather than enumerated.
"""

from __future__ import annotations

from dataclasses import dataclass

DOC_PATH = "docs/knobs_torch.md"


@dataclass(frozen=True)
class Knob:
    name: str
    default: str       # rendered verbatim; "" shows as (unset)
    subsystem: str
    kill_switch: bool  # "set to 0 restores the pre-feature path"
    doc: str


KNOBS: tuple[Knob, ...] = (
    # --- resilience / fault injection
    Knob("TRIVY_TPU_FAULTS", "", "resilience", False,
         "Deterministic fault-injection plan (site:action@selector "
         "grammar, docs/resilience.md); validated at startup."),
    Knob("TRIVY_TPU_FAULT_SEED", "0", "resilience", False,
         "Default RNG seed for `@pF` probability selectors when the "
         "fault spec carries no `seed=` token — makes probabilistic "
         "specs replayable (chaos repros paste both knobs)."),
    # --- chaos campaign engine (docs/resilience.md "Chaos campaigns")
    Knob("TRIVY_TPU_CHAOS_SEED", "0", "chaos", False,
         "Campaign seed for `trivy-tpu chaos run`: derives every "
         "episode's fault schedule, so a campaign replays exactly."),
    Knob("TRIVY_TPU_CHAOS_EPISODES", "50", "chaos", False,
         "Episode count for `trivy-tpu chaos run` when --episodes is "
         "not given."),
    Knob("TRIVY_TPU_CHAOS_BUDGET_S", "30", "chaos", False,
         "Per-episode liveness watchdog budget (seconds): an episode "
         "that does not finish inside it is a liveness violation."),
    # --- scheduler (continuous batching)
    Knob("TRIVY_TPU_SCHED", "1", "sched", True,
         "Cross-request match scheduler; 0 restores the exact "
         "per-request detect path."),
    Knob("TRIVY_TPU_QOS", "1", "sched", True,
         "Per-tenant weighted fair-share on the coalesce queue "
         "(deficit round-robin over chunk interleaving); 0 restores "
         "the tenant-blind oldest-deadline-first compose."),
    Knob("TRIVY_TPU_QOS_TENANT_QUEUE", "", "sched", False,
         "Per-tenant queue-depth cap on the match scheduler; a "
         "tenant over its cap is shed (503 + Retry-After) while "
         "other tenants keep enqueueing. Unset/0 = the global "
         "--sched-max-queue only."),
    Knob("TRIVY_TPU_QOS_WEIGHTS", "", "sched", False,
         "Comma list of tenant=weight fair-share weights for the "
         "QoS compose, e.g. 'abc123=3,*=1' ('*' sets the default "
         "weight). Unset = every tenant weight 1."),
    # --- serving mesh
    Knob("TRIVY_TPU_MESH", "", "ops", False,
         "Serving-mesh topology: 'DPxDB' (e.g. 2x4), 'auto' (sized "
         "from DB rows + device count), unset/off = single-chip "
         "(same as --mesh)."),
    Knob("TRIVY_TPU_MESH_SHARD_RETRIES", "1", "ops", False,
         "Failed mesh shard dispatches retried before that shard's "
         "advisory slice degrades to the host oracle."),
    Knob("TRIVY_TPU_MESH_HBM_GB", "8.0", "ops", False,
         "Per-device HBM budget (GB) the 'auto' mesh topology sizes "
         "advisory shards against (per host on the distributed "
         "MeshDB)."),
    Knob("TRIVY_TPU_DCN", "", "ops", False,
         "Cross-host distributed-MeshDB workers: 'spawn' launches as "
         "many local worker subprocesses as the spec needs ('spawn:N' "
         "pins the count, validated against the spec), "
         "'host:port,...' connects pre-started workers (python -m "
         "trivy_tpu_torch.ops.dcn --worker [--bind ADDR]); unset = "
         "single-host serving only."),
    Knob("TRIVY_TPU_DCN_TIMEOUT_S", "60", "ops", False,
         "Per-request DCN worker timeout (seconds) before the "
         "coordinator retries and then degrades that host's advisory "
         "slice to the bit-identical host mask."),
    # --- detector pipeline
    Knob("TRIVY_TPU_PIPELINE", "1", "detector", True,
         "Double-buffered host/device match executor; 0 runs the "
         "serial stage loop."),
    Knob("TRIVY_TPU_PIPELINE_WORKERS", "(auto)", "detector", False,
         "Crunch-lane thread count override for the pipelined "
         "executor; malformed values warn and fall back."),
    # --- artifact analysis pipeline
    Knob("TRIVY_TPU_ANALYSIS_PIPELINE", "1", "fanal", True,
         "Pipelined layer fetch/analyze with cross-image dedupe; 0 "
         "restores the serial layer loop byte-identically."),
    Knob("TRIVY_TPU_ANALYSIS_PREFETCH", "2", "fanal", False,
         "Layer-prefetch depth: compressed layers allowed in flight "
         "ahead of the analyzing thread."),
    Knob("TRIVY_TPU_ANALYSIS_WORKERS", "5", "fanal", False,
         "Walk-lane count for the multi-lane layer executor; "
         "overrides --parallel, clamped to [1, 32]; malformed values "
         "warn and fall back."),
    Knob("TRIVY_TPU_NATIVE_SPLIT", "1", "fanal", True,
         "Native streaming gunzip+tar splitter on the layer walk; 0 "
         "restores the pure-Python tarfile walk (also the automatic "
         "fallback when no toolchain is present)."),
    Knob("TRIVY_TPU_VECTOR_ANALYZERS", "1", "fanal", True,
         "Vectorized hot analyzers (packed-trigram license "
         "classification, numpy yarn.lock tokenization); 0 restores "
         "the scalar engines, which stay byte-identical either way."),
    # --- compiled-DB cache
    Knob("TRIVY_TPU_COMPILE_CACHE", "1", "tensorize", True,
         "Persistent compiled-DB tensor cache; 0 recompiles from the "
         "advisory DB on every start."),
    # --- continuous monitoring (advisory-delta re-scoring)
    Knob("TRIVY_TPU_MONITOR", "1", "monitor", True,
         "Advisory-delta monitor subsystem; 0 stops scans recording "
         "index state and promotes triggering re-scores."),
    Knob("TRIVY_TPU_DELTA_FULL_THRESHOLD", "0.5", "monitor", False,
         "Touched-key fraction above which a delta re-score degrades "
         "to re-matching every indexed artifact."),
    Knob("TRIVY_TPU_DELTA_VERIFY", "", "monitor", False,
         "1 makes every delta re-score cross-check itself against a "
         "from-scratch full re-match (double work; CI paranoia)."),
    Knob("TRIVY_TPU_DELTA_BUDGET_S", "", "monitor", False,
         "Wall-time budget (seconds) for one delta re-score; on "
         "expiry the sweep sheds and the index state is not advanced."),
    # --- secret engine
    Knob("TRIVY_TPU_SECRET_PROBE", "1", "secret", True,
         "Hybrid-mode device-vs-host timing probe; 0 skips the probe "
         "and uses the host AC path."),
    Knob("TRIVY_TPU_SECRET_DEVICE_SHARE", "(scanner default)", "secret",
         False,
         "Byte fraction the hybrid secret split hands the device "
         "anchor screen."),
    Knob("TRIVY_TPU_SECRET_PACK_MB", "(per-bank default)", "secret",
         False,
         "Packed super-buffer MiB per device anchor-screen dispatch "
         "(the secret engine's dispatch-amortization lever; same as "
         "--secret-pack-mb)."),
    Knob("TRIVY_TPU_SECRET_STREAM_CHUNK_MB", "4", "secret", False,
         "Streaming secret-scan chunk MiB for files over 10 MiB "
         "(floor 64 KiB; same as --secret-stream-chunk-mb)."),
    # --- fleet serving tier
    Knob("TRIVY_TPU_FLEET", "1", "fleet", True,
         "Fleet smart-client + cache-tier features; 0 pins multi-URL "
         "clients to their first endpoint through the exact "
         "single-server path and keeps the in-process layer gate on "
         "redis caches."),
    Knob("TRIVY_TPU_FLEET_HEDGE_MS", "75", "fleet", False,
         "Hedge delay: milliseconds a scan may sit unanswered on its "
         "primary replica before the same request is raced on a "
         "second one (first response wins, zero diff); 0 disables "
         "hedging."),
    Knob("TRIVY_TPU_FLEET_HEDGE_BUDGET", "0.1", "fleet", False,
         "Max fraction of requests allowed to hedge (bounds the "
         "duplicate-work cost of a uniformly slow fleet)."),
    Knob("TRIVY_TPU_FLEET_HEALTH_INTERVAL_S", "5", "fleet", False,
         "Period of the smart client's background /readyz (JSON) "
         "health prober over the endpoint set."),
    Knob("TRIVY_TPU_FLEET_EVENTS", "1", "fleet", True,
         "Fleet ops event bus (docs/fleet.md 'Event catalog'): "
         "failovers, hedge outcomes, breaker/health transitions, "
         "rollout stages, replica skew, SLO burn alerts — ringed, "
         "counted, and journaled when a journal is installed; 0 "
         "restores the pre-feature path (no emission at all)."),
    Knob("TRIVY_TPU_FLEET_EVENTS_JOURNAL", "", "fleet", False,
         "Path of a durable fleet ops event journal THIS process "
         "installs lazily on its first emit — the way a scan client "
         "makes its failover/hedge/breaker events durable (the event "
         "bus is process-local; use one path per process)."),
    Knob("TRIVY_TPU_FLEET_SLO_TARGET", "0.999", "fleet", False,
         "Fleet availability SLO target the burn-rate engine "
         "evaluates multi-window alerts against (burn = error rate / "
         "(1 - target))."),
    Knob("TRIVY_TPU_FLEET_SLO_LATENCY_MS", "", "fleet", False,
         "Latency SLI threshold in milliseconds: a successful request "
         "slower than this counts against the SLO budget (unset = "
         "availability-only SLO)."),
    # --- fleet controller (docs/fleet.md "Self-driving fleet")
    Knob("TRIVY_TPU_CONTROLLER", "1", "fleet", True,
         "Fleet controller kill switch: 0 makes every tick observe "
         "and decide nothing — exactly the pre-controller fleet."),
    Knob("TRIVY_TPU_CONTROLLER_MIN_REPLICAS", "1", "fleet", False,
         "Autoscaler cost floor: the controller never drains the "
         "fleet below this many replicas, however calm the load."),
    Knob("TRIVY_TPU_CONTROLLER_MAX_REPLICAS", "4", "fleet", False,
         "Autoscaler ceiling: the controller never spawns past this "
         "many replicas, however hot the load."),
    Knob("TRIVY_TPU_CONTROLLER_SCALE_UP_LOAD", "4", "fleet", False,
         "Offered load per ready replica above which the controller "
         "spawns one replica (subject to the ceiling and cooldown)."),
    Knob("TRIVY_TPU_CONTROLLER_SCALE_DOWN_LOAD", "1", "fleet", False,
         "Offered load per ready replica below which a tick counts "
         "as calm toward the scale-down hysteresis window."),
    Knob("TRIVY_TPU_CONTROLLER_HOLDS", "3", "fleet", False,
         "Scale-down hysteresis: consecutive calm ticks required "
         "before one replica is drained (any non-calm tick resets "
         "the streak — one quiet minute never shrinks the fleet)."),
    Knob("TRIVY_TPU_CONTROLLER_COOLDOWN_S", "30", "fleet", False,
         "Per-action-kind cooldown seconds between controller "
         "actions (damps oscillation: scale/drain/re-resolve each "
         "rate-limited independently)."),
    Knob("TRIVY_TPU_CONTROLLER_UNHEALTHY_TICKS", "3", "fleet", False,
         "Consecutive failed-probe ticks before a replica is "
         "drained, retired, and replaced (drain_replace)."),
    Knob("TRIVY_TPU_CONTROLLER_DEGRADED_TICKS", "3", "fleet", False,
         "Consecutive ticks a replica must report degraded mesh "
         "hosts before the controller tells it to re-resolve its "
         "topology over the survivors (mesh_reresolve)."),
    Knob("TRIVY_TPU_CONTROLLER_HEDGE_SKEW", "4", "fleet", False,
         "p99/p50 probe-latency skew at which the controller raises "
         "the hedge budget; below half this, the budget returns to "
         "the configured baseline (hedge_tune)."),
    # --- RPC
    Knob("TRIVY_TPU_RPC_GZIP_MIN", "8192", "rpc", False,
         "Minimum body size in bytes before the negotiated gzip wire "
         "framing compresses a request/response."),
    Knob("TRIVY_TPU_WIRE", "1", "rpc", True,
         "Binary columnar RPC wire (application/x-trivy-columnar). 0 "
         "at either end disables the negotiation: the client stops "
         "offering, the server stops advertising and 400s columnar "
         "bodies WITHOUT the capability header so clients unlearn "
         "and resend JSON (docs/performance.md)."),
    # --- observability
    Knob("TRIVY_TPU_TRACE", "", "obs", False,
         "Enable span collection without the --trace flag (1/true)."),
    Knob("TRIVY_TPU_SLOW_SPAN_MS", "", "obs", False,
         "Log any span exceeding this many milliseconds, even with "
         "tracing off."),
    Knob("TRIVY_TPU_JAX_TRACE_DIR", "", "obs", False,
         "Directory for JAX profiler dumps alongside --trace-export."),
    Knob("TRIVY_TPU_ATTRIB", "", "obs", True,
         "Span-to-resource-lane bottleneck attribution "
         "(docs/observability.md): unset = on while a scan server "
         "runs, 1 forces it on for one-shot CLI scans, 0 disables "
         "the aggregator entirely (pre-feature span fast path)."),
    Knob("TRIVY_TPU_FLIGHT_RECORDER_N", "8", "obs", False,
         "Slow-scan flight recorder ring size: the N slowest scan "
         "traces kept live for /debug/flight Chrome-JSON export "
         "(0 disables the recorder)."),
    Knob("TRIVY_TPU_PROFILE_TOKEN", "", "obs", False,
         "Dedicated auth token for the server's /debug/profile and "
         "/debug/flight endpoints (grants profiling access without "
         "the scan/cache token; the scan token always works too)."),
    Knob("TRIVY_TPU_USAGE", "", "obs", True,
         "Per-tenant usage metering (docs/observability.md 'Usage "
         "metering'): unset/1 = on (the server opens a cost-vector "
         "scope per request), 0 disables scope creation entirely — "
         "every accrual call short-circuits on one contextvar read."),
    Knob("TRIVY_TPU_USAGE_TOP_N", "64", "obs", False,
         "Distinct tenants tracked by the usage registry and the "
         "trivy_tpu_tenant_* metrics before new arrivals collapse "
         "into the 'other' bucket (cardinality bound)."),
    Knob("TRIVY_TPU_USAGE_JOURNAL", "", "obs", False,
         "Path of the per-interval usage journal (durability/"
         "appendlog format: torn-tail-tolerant replay, compaction); "
         "empty disables journaling."),
    Knob("TRIVY_TPU_USAGE_INTERVAL_S", "60", "obs", False,
         "Seconds between cumulative usage-journal snapshots (the "
         "journal also syncs once at server shutdown)."),
    # --- analysis (this package)
    Knob("TRIVY_TPU_LOCK_WITNESS", "", "analysis", False,
         "1 wraps the project's named locks in the lock-order witness "
         "(cycle detection at test teardown); off = raw primitives."),
    # --- CLI / environment plumbing
    Knob("TRIVY_TPU_CACHE_DIR", "~/.cache/trivy-tpu", "cli", False,
         "Scan/artifact cache directory (same as --cache-dir)."),
    Knob("TRIVY_TPU_USERNAME", "", "cli", False,
         "Default registry username (same as --username)."),
    Knob("TRIVY_TPU_PASSWORD", "", "cli", False,
         "Default registry password (same as --password)."),
    # --- utils
    Knob("TRIVY_TPU_DETERMINISTIC_UUID", "", "utils", False,
         "1 makes scan/lane UUIDs a deterministic sequence so fleet "
         "goldens byte-match."),
    Knob("TRIVY_TPU_FAKE_TIME", "", "utils", False,
         "Fixed ISO timestamp for the report clock (golden tests)."),
    # --- modules / native
    Knob("TRIVY_TPU_TRUST_STORE", "", "module", False,
         "Override path for the scan-module trust manifest."),
    Knob("TRIVY_TPU_TORCH_NATIVE_DIR", "~/.cache/trivy-tpu-torch/native",
         "native", False,
         "Build/cache directory for the native host helpers (the AC "
         "matcher, the match-result collector)."),
)



def generate_knobs_md(knob_list=None) -> str:
    """The exact content of docs/knobs_torch.md (byte-compared by the
    ``env-knob`` lint rule; regenerate via --write-knobs-doc).
    ``knob_list`` lets the linter render from the LINTED tree's
    extracted table so ``--root worktree`` staleness is judged against
    the worktree's own registry; default is this module's KNOBS."""
    knob_list = KNOBS if knob_list is None else knob_list
    lines = [
        "# `TRIVY_TPU_*` environment knobs",
        "",
        "<!-- GENERATED from trivy_tpu_torch/analysis/knobs.py — do not edit",
        "     by hand.  Regenerate with:",
        "         python -m trivy_tpu_torch.analysis.lint --write-knobs-doc",
        "     The env-knob lint rule fails when this file is stale. -->",
        "",
        "Every environment variable the scanner reads, from one",
        "registry (`trivy_tpu_torch/analysis/knobs.py`).  *Kill-switch — yes*",
        "means setting the knob to `0` restores the exact pre-feature",
        "code path (the zero-diff escape hatch for each perf layer).",
        "",
        "| Name | Default | Subsystem | Kill-switch | What it does |",
        "|---|---|---|---|---|",
    ]
    for k in sorted(knob_list, key=lambda k: (k.subsystem, k.name)):
        default = f"`{k.default}`" if k.default else "(unset)"
        lines.append(
            f"| `{k.name}` | {default} | {k.subsystem} | "
            f"{'yes' if k.kill_switch else 'no'} | {k.doc} |")
    lines += [
        "",
        "Additionally, **every CLI flag** is settable as",
        "`TRIVY_TPU_<FLAG>` (upper-cased, `-` → `_`): explicit",
        "command-line values win, then the environment, then the",
        "config file (`trivy_tpu_torch/cli/config.py`).  That wildcard",
        "family is intentionally not enumerated here.",
        "",
        "See [docs/performance.md](performance.md) for what the",
        "perf-layer kill-switches disable, and",
        "[docs/static-analysis.md](static-analysis.md) for the lint",
        "rule that keeps this table honest.",
        "",
    ]
    return "\n".join(lines)
