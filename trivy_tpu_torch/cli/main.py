"""trivy-tpu-torch CLI: every subcommand of trivy_tpu/cli/main.py
(`image`, `sbom`, `filesystem` (alias `fs`), `rootfs`, `repository`
(alias `repo`), `vm`, `config`, `kubernetes` (alias `k8s`), `convert`,
`db`, `server`, `watch`, `fleet`, `profile`, `usage`, `chaos`, `plugin`,
`module`, `registry`, `clean`, `lint` and `version`) and plugin mode,
with the match kernel and the secret screens on a CUDA card.

    python -m trivy_tpu_torch image --input image.tar --format sarif
    python -m trivy_tpu_torch sbom bom.json --format json --vex vex.json
    python -m trivy_tpu_torch fs ./project --format cyclonedx
    python -m trivy_tpu_torch repo https://host/org/svc.git --tag v1.2
    python -m trivy_tpu_torch vm disk.vmdk --format json
    python -m trivy_tpu_torch convert report.json --format spdx-json
    python -m trivy_tpu_torch db import advisories.json --db-path DB
    python -m trivy_tpu_torch server --listen 0.0.0.0:4954 --db-path DB
    python -m trivy_tpu_torch image --input image.tar --server http://host:4954
    python -m trivy_tpu_torch sbom bom.json --monitor-index mon.jsonl
    python -m trivy_tpu_torch watch --db-path DB --index mon.jsonl --once
    python -m trivy_tpu_torch watch --server http://host:4954
    python -m trivy_tpu_torch sbom bom.json --trace-export t.json --log-format json
    python -m trivy_tpu_torch profile http://host:4954 --flight f.json
    python -m trivy_tpu_torch usage http://host:4954
    python -m trivy_tpu_torch sbom bom.json --server http://a:4954,http://b:4954
    python -m trivy_tpu_torch sbom bom.json --server http://host:4954 --fallback
    python -m trivy_tpu_torch fleet status http://a:4954,http://b:4954
    python -m trivy_tpu_torch fleet rollout http://a:4954,http://b:4954 --db-path DB
    python -m trivy_tpu_torch image --targets t.txt --journal j.jsonl -f json
    python -m trivy_tpu_torch image --targets t.txt --resume j.jsonl -f json
    python -m trivy_tpu_torch chaos run --seed 0 --json chaos.json
    python -m trivy_tpu_torch k8s ./manifests --report all
    python -m trivy_tpu_torch k8s cluster --scanners vuln,misconfig,rbac,infra --image-tar-dir tars
    python -m trivy_tpu_torch fs ./infra --scanners misconfig --config-check checks/ --check-namespaces user
    python -m trivy_tpu_torch fs ./project --ignore-policy ignore.rego
    python -m trivy_tpu_torch image --input image.tar --cache-backend redis://cache:6379
    python -m trivy_tpu_torch fs ./project --scanners vuln,license --license-full
    python -m trivy_tpu_torch image --input image.tar --compliance docker-cis-1.6.0 --report all
    python -m trivy_tpu_torch k8s ./manifests --compliance k8s-nsa-1.0 -f json
    python -m trivy_tpu_torch module install mymodule.py
    python -m trivy_tpu_torch fs ./project --module-dir ./modules
    python -m trivy_tpu_torch plugin install ./my-plugin
    python -m trivy_tpu_torch my-plugin --its-flags
    python -m trivy_tpu_torch registry login --username u --password-stdin ghcr.io
    python -m trivy_tpu_torch clean --scan-cache
    python -m trivy_tpu_torch --generate-default-config
    python -m trivy_tpu_torch lint --json

Copy of trivy_tpu/cli/main.py with the reference's flags. `--device` is
the port's own: the scan runs on ``cuda:0``
unless it names another device (``cpu`` runs the kernels' plain
versions); `--no-tpu` keeps the reference's name for the host-oracle
match path, which needs no card.
"""

from __future__ import annotations

import argparse
import os
import sys

import trivy_tpu_torch
from trivy_tpu_torch import log


def _add_global_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--debug", action="store_true", help="debug logging")
    p.add_argument("--quiet", "-q", action="store_true", help="suppress logs")
    p.add_argument("--log-format", default="text",
                   choices=("text", "json"),
                   help="log line format; json emits one object per "
                        "line with trace_id/span_id/scan_id correlation "
                        "fields (log pipelines)")
    p.add_argument("--config", "-c", default=None,
                   help="config file (default trivy-tpu.yaml if present)")
    p.add_argument("--generate-default-config", action="store_true",
                   help="write trivy-tpu.yaml with defaults and exit")
    p.add_argument(
        "--cache-dir",
        default=os.environ.get(
            "TRIVY_TPU_CACHE_DIR",
            os.path.join(os.path.expanduser("~"), ".cache", "trivy-tpu"),
        ),
        help="cache directory",
    )


def _add_scan_flags(p: argparse.ArgumentParser) -> None:
    from trivy_tpu_torch.report.writer import FORMATS

    p.add_argument("--format", "-f", default="table",
                   help=f"output format ({','.join(FORMATS)})")
    p.add_argument("--output", "-o", default=None, help="output file")
    p.add_argument("--template", "-t", default=None, help="go-style template path/string")
    p.add_argument("--severity", "-s", default=None,
                   help="comma-separated severities (UNKNOWN,LOW,MEDIUM,HIGH,CRITICAL)")
    p.add_argument("--scanners", default="vuln,secret",
                   help="comma-separated scanners (vuln,misconfig,secret,license)")
    p.add_argument("--secret-config", default="trivy-secret.yaml",
                   help="custom secret rule config path (reference "
                        "--secret-config)")
    p.add_argument("--pkg-types", default="os,library",
                   help="comma-separated package types (os,library)")
    p.add_argument("--db-path", default=None,
                   help="advisory DB directory (default <cache>/db)")
    # accepted and without effect, as in the reference (no DB update or
    # online lookup runs at scan time in either package)
    p.add_argument("--skip-db-update", action="store_true")
    p.add_argument("--offline-scan", action="store_true")
    p.add_argument("--list-all-pkgs", action="store_true")
    p.add_argument("--include-dev-deps", action="store_true",
                   help="include development dependencies (supported "
                        "lockfiles only)")
    p.add_argument("--ignorefile", default=".trivyignore")
    p.add_argument("--ignore-policy", default=None,
                   help="finding ignore policy: .yaml condition DSL or "
                        ".py with ignore(finding) (reference's Rego "
                        "--ignore-policy)")
    p.add_argument("--ignore-unfixed", action="store_true",
                   help="hide vulnerabilities with no fixed version")
    p.add_argument("--dependency-tree", action="store_true",
                   help="show a reversed dependency origin tree for "
                        "vulnerable packages (table format)")
    p.add_argument("--file-patterns", action="append", default=[],
                   help="analyzer file pattern (type:regex); repeatable")
    p.add_argument("--ignore-status", default=None,
                   help="comma-separated statuses to ignore")
    p.add_argument("--exit-code", type=int, default=0)
    p.add_argument("--exit-on-eol", type=int, default=0)
    p.add_argument("--no-tpu", action="store_true",
                   help="run matching on the host instead of the match "
                        "kernel (needs no card)")
    p.add_argument("--device", default=None,
                   help="torch device of the match kernel and the "
                        "secret screens (default cuda:0; 'cpu' runs "
                        "their plain versions)")
    _add_mesh_flag(p)
    p.add_argument("--secret-pack-mb", type=float, default=None,
                   metavar="MB",
                   help="packed super-buffer MiB per device secret "
                        "anchor-screen dispatch (default per-bank "
                        "value; env TRIVY_TPU_SECRET_PACK_MB)")
    p.add_argument("--secret-stream-chunk-mb", type=float, default=None,
                   metavar="MB",
                   help="streaming secret-scan chunk MiB for files "
                        "over 10 MiB (byte-identical to whole-file; "
                        "default 4; env "
                        "TRIVY_TPU_SECRET_STREAM_CHUNK_MB)")
    p.add_argument("--trace", action="store_true",
                   help="print a stage-timing trace after the scan "
                        "(set TRIVY_TPU_JAX_TRACE_DIR for a "
                        "torch.profiler capture of the device)")
    p.add_argument("--trace-export", default=None, metavar="FILE",
                   help="write the collected spans as Chrome "
                        "trace-event JSON (open in Perfetto / "
                        "chrome://tracing); implies span collection "
                        "even without --trace")
    p.add_argument("--module-dir", default=None,
                   help="directory of scan-module extensions "
                        "(default <cache>/modules)")
    p.add_argument("--timeout", default="5m",
                   help="per-scan deadline (e.g. 300s, 5m, 1h; "
                        "reference --timeout default 5m)")
    p.add_argument("--scan-timeout", default=None,
                   help="per-scan deadline BUDGET propagated through the "
                        "scan spine and to the server via the "
                        "X-Trivy-Deadline header; the server sheds work "
                        "it cannot finish in time (503 + Retry-After). "
                        "Go-style duration; unset = no budget")
    p.add_argument("--fallback", action="store_true",
                   help="with --server: degrade to a local scan on this "
                        "process's device when the remote is unavailable "
                        "(circuit breaker) or the deadline budget runs "
                        "out; degraded reports carry Metadata.Degraded")
    p.add_argument("--parallel", type=int, default=5,
                   help="number of parallel analysis workers (an "
                        "image's layer walk lanes; the directory walk "
                        "is serial in both packages)")
    p.add_argument("--targets", default=None, metavar="FILE",
                   help="fleet mode: file of extra targets (one per "
                        "line, # comments) scanned alongside the "
                        "positional target; emits one merged JSON "
                        "report")
    p.add_argument("--journal", default=None, metavar="PATH",
                   help="fleet mode: write an append-only scan journal "
                        "(fsynced per-artifact checkpoints) enabling "
                        "--resume after a crash")
    p.add_argument("--resume", default=None, metavar="JOURNAL",
                   help="resume an interrupted fleet scan from its "
                        "journal: completed artifacts are skipped, "
                        "in-flight ones re-run; the merged report is "
                        "byte-identical to an uninterrupted run")
    p.add_argument("--fleet-parallel", type=int, default=1,
                   help="fleet mode: artifacts scanned concurrently")
    p.add_argument("--server", default=None,
                   help="scan server URL (client mode): analysis runs "
                        "here, detection on the server; a comma-"
                        "separated list names a replica set served "
                        "through the fleet smart client (client-side "
                        "load balancing, failover, hedged requests)")
    p.add_argument("--token", default=None, help="server auth token")
    p.add_argument("--monitor-index", default=None, metavar="PATH",
                   help="record each scanned artifact's package "
                        "inventory + finding baseline into the durable "
                        "monitor index at PATH, enabling `watch` "
                        "advisory-delta re-scoring")
    p.add_argument("--cache-backend", default="fs",
                   help="cache backend: fs, memory, or redis://host:port")
    p.add_argument("--redis-ca", default="", help="redis CA cert path")
    p.add_argument("--redis-cert", default="", help="redis client cert path")
    p.add_argument("--redis-key", default="", help="redis client key path")
    p.add_argument("--redis-tls", action="store_true",
                   help="enable TLS for the redis cache backend")
    p.add_argument("--redis-insecure", action="store_true",
                   help="skip certificate verification for the redis "
                        "cache backend (NOT recommended)")
    p.add_argument("--skip-files", action="append", default=[])
    p.add_argument("--skip-dirs", action="append", default=[])
    p.add_argument("--sbom-sources", default="",
                   help="comma-separated SBOM discovery sources for "
                        "unpackaged binaries (rekor)")
    p.add_argument("--rekor-url", default="https://rekor.sigstore.dev",
                   help="rekor server URL for --sbom-sources rekor")
    p.add_argument("--vex", action="append", default=[],
                   help="VEX source: a document path (OpenVEX / CycloneDX "
                        "VEX / CSAF), 'repo' (cached VEX repositories), "
                        "or 'oci' (image-attached attestation); "
                        "repeatable")
    p.add_argument("--show-suppressed", action="store_true",
                   help="include VEX-suppressed findings in the report")
    p.add_argument("--license-full", action="store_true",
                   help="also classify license headers in source files "
                        "(license scanner)")
    p.add_argument("--compliance", default=None,
                   help="compliance report to generate (builtin name like "
                        "docker-cis-1.6.0 or @path/to/spec.yaml)")
    p.add_argument("--report", default="summary",
                   choices=("all", "summary"),
                   help="compliance report detail (all, summary)")
    _add_check_flags(p)


def _add_check_flags(p) -> None:
    """Misconfig check-engine flags (reference pkg/flag/rego_flags.go)."""
    p.add_argument("--config-check", action="append", default=[],
                   dest="config_check",
                   help="path to a custom check file (.py/.yaml) or a "
                        "directory of them; repeatable")
    p.add_argument("--check-namespaces", action="append", default=[],
                   dest="check_namespaces",
                   help="enable custom-check namespaces (e.g. 'user'); "
                        "repeatable")
    p.add_argument("--config-data", action="append", default=[],
                   dest="config_data",
                   help="path to YAML/JSON data made available to custom "
                        "checks; repeatable")
    p.add_argument("--include-deprecated-checks", action="store_true",
                   help="also run checks marked deprecated")
    p.add_argument("--helm-set", action="append", default=[],
                   dest="helm_set",
                   help="helm value override path.to.key=value; "
                        "repeatable")
    p.add_argument("--helm-values", action="append", default=[],
                   dest="helm_values",
                   help="helm values file overriding chart defaults; "
                        "repeatable")
    p.add_argument("--checks-bundle-repository", default="",
                   help="OCI repository for the check bundle "
                        "(overrides the builtin bundle source)")
    p.add_argument("--skip-check-update", action="store_true",
                   help="do not refresh the downloaded check bundle")


# the scan subcommands the port serves: every one of the reference's
SCAN_COMMANDS = (
    ("image", "scan a container image"),
    ("filesystem", "scan a local filesystem directory"),
    ("fs", "alias of filesystem"),
    ("rootfs", "scan a root filesystem"),
    ("repository", "scan a git repository"),
    ("repo", "alias of repository"),
    ("sbom", "scan an SBOM file (CycloneDX/SPDX json)"),
    ("vm", "scan a VM image"),
    ("config", "scan config files for misconfigurations"),
)


def _add_image_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--input", default=None,
                   help="image tar archive path")
    p.add_argument("--image-src", default="containerd,docker,podman,remote",
                   help="comma-separated image sources tried in "
                        "order (containerd,docker,podman,remote)")
    p.add_argument("--insecure", action="store_true",
                   help="allow plain-HTTP / unverified registries")
    p.add_argument("--username", default=os.environ.get(
        "TRIVY_TPU_USERNAME", ""), help="registry username")
    p.add_argument("--password", default=os.environ.get(
        "TRIVY_TPU_PASSWORD", ""), help="registry password")


def _add_db_parser(sub) -> None:
    p = sub.add_parser("db", help="advisory DB operations",
                       allow_abbrev=False)
    _add_global_flags(p)
    dbsub = p.add_subparsers(dest="db_command")
    pi = dbsub.add_parser("import", help="import advisories from a JSON "
                          "dump or a BoltDB trivy.db", allow_abbrev=False)
    _add_global_flags(pi)
    pi.add_argument("source")
    pi.add_argument("--db-path", default=None)
    ps = dbsub.add_parser("stats", help="show DB statistics",
                          allow_abbrev=False)
    _add_global_flags(ps)
    ps.add_argument("--db-path", default=None)
    pd = dbsub.add_parser(
        "download", help="download the advisory DB as an OCI artifact",
        allow_abbrev=False)
    _add_global_flags(pd)
    pd.add_argument("--db-repository",
                    default="ghcr.io/aquasecurity/trivy-db:2")
    pd.add_argument("--insecure", action="store_true")
    pj = dbsub.add_parser(
        "import-java",
        help="import a java sha1->GAV dump (JSONL: "
             '{"groupId","artifactId","version","sha1"} per line)',
        allow_abbrev=False)
    _add_global_flags(pj)
    pj.add_argument("source")


def _add_mesh_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mesh", default=None, metavar="DPxDB",
                   help="serve matching from a sharded device mesh: "
                        "'DPxDB' (e.g. 2x4: 2 data-parallel groups x 4 "
                        "advisory shards over the first 8 CUDA devices; "
                        "every cell on the CPU with --device cpu), "
                        "'HOSTSxDPxDB' (e.g. 2x1x4: cross-host "
                        "distributed MeshDB over TRIVY_TPU_DCN workers, "
                        "dp x db per host), 'auto' (topology from the DB "
                        "size, the device count and the per-host memory "
                        "budget), or 'off' (default; env "
                        "TRIVY_TPU_MESH)")


def _add_server_parser(sub) -> None:
    from trivy_tpu_torch.sched.scheduler import (
        DEFAULT_MAX_ROWS,
        DEFAULT_WINDOW_MS,
    )

    p = sub.add_parser("server", help="run the scan server",
                       allow_abbrev=False)
    _add_global_flags(p)
    p.add_argument("--listen", default="localhost:4954")
    p.add_argument("--token", default=None)
    p.add_argument("--db-path", default=None)
    p.add_argument("--no-tpu", action="store_true",
                   help="match on the host instead of the match kernel "
                        "(needs no card)")
    p.add_argument("--device", default=None,
                   help="torch device of the match kernel (default "
                        "cuda:0; 'cpu' runs its plain version)")
    _add_mesh_flag(p)
    p.add_argument("--drain-timeout", default="30s",
                   help="graceful-drain budget on SIGTERM: /readyz goes "
                        "503 immediately, in-flight scans get this long "
                        "to finish, the rest are shed with Retry-After "
                        "(go-style duration)")
    p.add_argument("--sched-window-ms", type=float,
                   default=DEFAULT_WINDOW_MS,
                   help="match-scheduler coalesce window: max "
                        "milliseconds a scan's detect batch waits to "
                        "share a device micro-batch with concurrent "
                        "requests (TRIVY_TPU_SCHED=0 disables the "
                        "scheduler entirely — exact per-request path)")
    p.add_argument("--sched-max-rows", type=int,
                   default=DEFAULT_MAX_ROWS,
                   help="match-scheduler target micro-batch size in "
                        "package-query rows; larger requests are "
                        "chunk-interleaved across batches so small "
                        "scans are never starved")
    p.add_argument("--monitor-index", default=None, metavar="PATH",
                   help="continuous monitoring: record completed scans "
                        "in the durable monitor index at PATH and "
                        "re-score the fleet incrementally after every "
                        "advisory-DB hot swap, emitting introduced/"
                        "resolved finding events at /monitor/events")


def _add_watch_parser(sub) -> None:
    p = sub.add_parser(
        "watch", help="continuous monitoring: re-score indexed "
        "artifacts when the advisory DB changes, emitting introduced/"
        "resolved findings as JSON lines", allow_abbrev=False)
    _add_global_flags(p)
    p.add_argument("--db-path", default=None,
                   help="advisory DB directory to watch "
                        "(default <cache>/db)")
    p.add_argument("--index", default=None, metavar="PATH",
                   help="monitor index path (default "
                        "<cache>/monitor-index.jsonl; create it by "
                        "scanning with --monitor-index)")
    p.add_argument("--journal", default=None, metavar="PATH",
                   help="fleet scan journal to rebuild the index from "
                        "when it is missing or corrupt")
    p.add_argument("--interval", default="60s",
                   help="poll interval between DB generation checks "
                        "(go-style duration)")
    p.add_argument("--once", action="store_true",
                   help="process at most one pending DB change, then "
                        "exit (scripting/CI)")
    p.add_argument("--server", default=None,
                   help="tail a running server's /monitor/events ring "
                        "instead of watching a local DB root")
    p.add_argument("--token", default=None, help="server auth token")
    p.add_argument("--output", "-o", default=None,
                   help="write events here instead of stdout")
    p.add_argument("--verify", action="store_true",
                   help="cross-check every re-score against a "
                        "from-scratch full re-match (double work)")
    p.add_argument("--no-tpu", action="store_true",
                   help="run re-matching on the host instead of the "
                        "match kernel (needs no card)")
    p.add_argument("--device", default=None,
                   help="torch device of the match kernel (default "
                        "cuda:0; 'cpu' runs its plain version)")
    _add_mesh_flag(p)


def _add_chaos_parser(sub) -> None:
    """`chaos run|replay`: the reference's flags, and the port's
    `--device` for the scenarios that take the device path."""
    p = sub.add_parser(
        "chaos", help="deterministic chaos campaigns over the fault "
        "matrix", allow_abbrev=False)
    _add_global_flags(p)
    chsub = p.add_subparsers(dest="chaos_command")
    pcr = chsub.add_parser(
        "run", help="run a seeded multi-fault campaign with invariant "
        "oracles and 100% (site, action) coverage", allow_abbrev=False)
    _add_global_flags(pcr)
    pcr.add_argument("--seed", type=int, default=None,
                     help="campaign seed (default TRIVY_TPU_CHAOS_SEED)")
    pcr.add_argument("--episodes", type=int, default=None,
                     help="seeded episodes before the coverage sweep "
                     "(default TRIVY_TPU_CHAOS_EPISODES)")
    pcr.add_argument("--scenarios", default=None,
                     help="comma-separated scenario names (default: all)")
    pcr.add_argument("--budget", type=float, default=None,
                     help="per-episode watchdog budget in seconds "
                     "(default TRIVY_TPU_CHAOS_BUDGET_S)")
    pcr.add_argument("--strict", action="store_true",
                     help="degraded stamps do not excuse output "
                     "divergence")
    pcr.add_argument("--json", dest="report_json", default=None,
                     metavar="PATH",
                     help="write the campaign report as JSON")
    pcp = chsub.add_parser(
        "replay", help="replay one TRIVY_TPU_FAULTS spec (a shrunk "
        "repro) against a scenario", allow_abbrev=False)
    _add_global_flags(pcp)
    pcp.add_argument("spec", help="TRIVY_TPU_FAULTS spec string")
    pcp.add_argument("--scenario", required=True,
                     help="scenario name (chaos.SCENARIOS)")
    pcp.add_argument("--budget", type=float, default=None,
                     help="watchdog budget in seconds")
    pcp.add_argument("--strict", action="store_true",
                     help="degraded stamps do not excuse output "
                     "divergence")
    for q in (pcr, pcp):
        q.add_argument("--device", default=None,
                       help="torch device of the scenarios' match "
                            "engines and secret scanner (default "
                            "cuda:0; 'cpu' runs the kernels' plain "
                            "versions)")


def _add_k8s_parser(sub) -> None:
    """`kubernetes` (alias `k8s`): the reference's flags, and the
    port's `--device` for the vuln scanner's image scans."""
    p = sub.add_parser("kubernetes", help="scan a kubernetes cluster or "
                       "manifests directory", allow_abbrev=False,
                       aliases=["k8s"])
    _add_global_flags(p)
    p.add_argument("--report", default="summary",
                   choices=["summary", "all"],
                   help="report detail level")
    p.add_argument("--format", "-f", default="table",
                   choices=["table", "json"],
                   help="output format")
    p.add_argument("--output", "-o", default=None)
    p.add_argument("--scanners", default="misconfig,rbac,infra",
                   help="comma-separated (vuln,misconfig,rbac,infra)")
    p.add_argument("--context", default="", help="kubeconfig context")
    p.add_argument("--namespace", "-n", default="",
                   help="restrict to one namespace")
    p.add_argument("--image-tar-dir", default=None,
                   help="directory of image tars for offline vuln scans")
    p.add_argument("--compliance", default=None,
                   help="compliance report (k8s-nsa-1.0, "
                        "k8s-pss-baseline-0.1, k8s-pss-restricted-0.1, "
                        "or @path)")
    p.add_argument("--db-path", default=None)
    p.add_argument("--no-tpu", action="store_true",
                   help="run the image scans' matching and secret "
                        "screens on the host (needs no card)")
    p.add_argument("--device", default=None,
                   help="torch device of the image scans' match kernel "
                        "and secret screens (default cuda:0; 'cpu' runs "
                        "their plain versions)")
    p.add_argument("--parallel", type=int, default=5)
    p.add_argument("--disable-node-collector", action="store_true",
                   help="skip the per-node collector Job on live "
                        "cluster scans")
    p.add_argument("--node-collector-namespace", default=None,
                   help="namespace for node-collector Jobs "
                        "(default trivy-temp)")
    p.add_argument("--node-collector-imageref", default=None,
                   help="node-collector image to run")
    p.add_argument("target", nargs="?", default="cluster",
                   help="'cluster' (live) or a manifests dir/file")


def _add_host_parsers(sub) -> None:
    """`plugin`, `module`, `registry` and `clean`: the reference's
    parsers, in its order."""
    p = sub.add_parser("plugin", help="manage plugins", allow_abbrev=False)
    _add_global_flags(p)
    plsub = p.add_subparsers(dest="plugin_command")
    pp = plsub.add_parser("install", help="install a plugin from a local "
                          "dir, zip, or URL", allow_abbrev=False)
    _add_global_flags(pp)
    pp.add_argument("source")
    pp = plsub.add_parser("uninstall", help="remove an installed plugin",
                          allow_abbrev=False)
    _add_global_flags(pp)
    pp.add_argument("name")
    pp = plsub.add_parser("list", help="list installed plugins",
                          allow_abbrev=False)
    _add_global_flags(pp)
    pp = plsub.add_parser("info", help="show plugin details",
                          allow_abbrev=False)
    _add_global_flags(pp)
    pp.add_argument("name")
    pp = plsub.add_parser("run", help="run a plugin", allow_abbrev=False)
    _add_global_flags(pp)
    pp.add_argument("name")
    pp.add_argument("plugin_args", nargs=argparse.REMAINDER)

    p = sub.add_parser("module", help="manage scan modules",
                       allow_abbrev=False)
    _add_global_flags(p)
    mosub = p.add_subparsers(dest="module_command")
    mm = mosub.add_parser("install", help="install a module (.py file)",
                          allow_abbrev=False)
    _add_global_flags(mm)
    mm.add_argument("source")
    mm = mosub.add_parser("uninstall", help="remove a module",
                          allow_abbrev=False)
    _add_global_flags(mm)
    mm.add_argument("name")
    mm = mosub.add_parser("list", help="list installed modules",
                          allow_abbrev=False)
    _add_global_flags(mm)

    p = sub.add_parser("registry", help="registry authentication",
                       allow_abbrev=False)
    _add_global_flags(p)
    regsub = p.add_subparsers(dest="registry_command")
    pl = regsub.add_parser("login", help="log in to a registry",
                           allow_abbrev=False)
    _add_global_flags(pl)
    pl.add_argument("--username", "-u", required=True)
    pl.add_argument("--password", default=None,
                    help="password (omit to read from stdin)")
    pl.add_argument("--password-stdin", action="store_true")
    pl.add_argument("server")
    po = regsub.add_parser("logout", help="log out of a registry",
                           allow_abbrev=False)
    _add_global_flags(po)
    po.add_argument("server")

    p = sub.add_parser("clean", help="clean caches", allow_abbrev=False)
    _add_global_flags(p)
    p.add_argument("--all", "-a", action="store_true",
                   help="remove everything under the cache dir")
    p.add_argument("--scan-cache", action="store_true",
                   help="remove cached scan blobs")
    p.add_argument("--vuln-db", action="store_true",
                   help="remove the advisory DB")
    p.add_argument("--java-db", action="store_true",
                   help="remove the java GAV DB")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        allow_abbrev=False,
        prog="trivy-tpu-torch",
        description="security scanner on a CUDA card (image, "
        "filesystem, rootfs, repository, VM image or SBOM -> "
        "vulnerabilities, misconfigurations, secrets, licenses; config "
        "files -> "
        "misconfigurations; a kubernetes cluster -> "
        "misconfigurations, RBAC and infra findings, its images' "
        "vulnerabilities and secrets)",
    )
    _add_global_flags(parser)
    sub = parser.add_subparsers(dest="command")
    # `convert`, then `kubernetes`, then the scan commands: the config
    # layer reads each option's default from the last parser that has
    # it (cli/config.py `_all_defaults`), and this order gives every
    # option the default it has in the reference's parser ("vuln,secret"
    # for --scanners, "summary" for --report)
    p = sub.add_parser("convert", help="convert a saved JSON report", allow_abbrev=False)
    _add_global_flags(p)
    p.add_argument("--format", "-f", default="table")
    p.add_argument("--output", "-o", default=None)
    p.add_argument("--template", "-t", default=None)
    p.add_argument("--severity", "-s", default=None)
    p.add_argument("report")
    _add_k8s_parser(sub)
    for name, help_text in SCAN_COMMANDS:
        p = sub.add_parser(name, help=help_text, allow_abbrev=False)
        _add_global_flags(p)
        _add_scan_flags(p)
        if name in ("repository", "repo"):
            p.add_argument("--branch", default="",
                           help="git branch to check out")
            p.add_argument("--tag", default="", help="git tag to check out")
            p.add_argument("--commit", default="",
                           help="git commit to check out")
        if name == "image":
            _add_image_flags(p)
            p.add_argument("target", nargs="?", default=None)
        else:
            p.add_argument("target")
    _add_db_parser(sub)
    _add_server_parser(sub)
    _add_watch_parser(sub)

    p = sub.add_parser(
        "fleet", help="fleet administration: replica status and the "
        "coordinated advisory-DB rollout (canary, zero-diff probe "
        "set, staged roll, automatic rollback — docs/fleet.md)",
        allow_abbrev=False)
    _add_global_flags(p)
    flsub = p.add_subparsers(dest="fleet_command")
    pfs = flsub.add_parser(
        "status", help="JSON /readyz of every replica (ready state, "
        "serving generation, mesh/secret-probe notes)",
        allow_abbrev=False)
    _add_global_flags(pfs)
    pfs.add_argument("endpoints",
                     help="comma-separated replica URLs")
    pfs.add_argument("--token", default=None, help="server auth token")
    pfr = flsub.add_parser(
        "rollout", help="staged fleet-wide advisory-DB hot swap: "
        "canary first, probe set replayed for zero diff, then roll, "
        "rollback on regression; the delta re-score triggers on "
        "exactly one replica", allow_abbrev=False)
    _add_global_flags(pfr)
    pfr.add_argument("endpoints",
                     help="comma-separated replica URLs")
    pfr.add_argument("--db-path", required=True,
                     help="shared advisory-DB root (the staged+promoted "
                          "generation under it is the rollout target)")
    pfr.add_argument("--token", default=None, help="server auth token")
    pfr.add_argument("--probes", default=None, metavar="FILE",
                     help="probe set: JSON (array or lines) of "
                          "captured scan requests replayed against the "
                          "canary vs the serving fleet; any byte diff "
                          "rolls back")
    pfr.add_argument("--canary", default=None, metavar="URL",
                     help="replica to roll first (default: the first "
                          "endpoint still behind)")
    pfr.add_argument("--no-rescore", action="store_true",
                     help="skip triggering the advisory-delta "
                          "re-score after the roll")
    pfr.add_argument("--output", "-o", default=None,
                     help="write the rollout report JSON here")
    pfr.add_argument("--journal", default=None, metavar="PATH",
                     help="durable fleet ops event journal: rollout "
                          "stages and DB swaps append (fsynced) here "
                          "(docs/fleet.md 'Event catalog')")
    pfm = flsub.add_parser(
        "metrics", help="federated fleet exposition: scrape every "
        "replica's /metrics (OpenMetrics, exemplars preserved) and "
        "merge — counters summed, histogram buckets merged, every "
        "series re-emitted with a replica label (docs/fleet.md)",
        allow_abbrev=False)
    _add_global_flags(pfm)
    pfm.add_argument("endpoints", help="comma-separated replica URLs")
    pfm.add_argument("--token", default=None, help="server auth token")
    pfm.add_argument("--output", "-o", default=None,
                     help="write the federated exposition here "
                          "instead of stdout")
    pfp = flsub.add_parser(
        "profile", help="federated bottleneck attribution: every "
        "replica's /debug/profile merged into one fleet roofline "
        "verdict with per-replica sections (docs/observability.md "
        "'Fleet observability')", allow_abbrev=False)
    _add_global_flags(pfp)
    pfp.add_argument("endpoints", help="comma-separated replica URLs")
    pfp.add_argument("--token", default=None, help="server auth token")
    pfp.add_argument("--json", action="store_true",
                     help="print the raw federated document")
    pfp.add_argument("--flight", default=None, metavar="FILE",
                     help="also stitch every replica's flight "
                          "recorder into ONE Chrome trace at FILE "
                          "(per-replica process rows; hedge losers "
                          "marked cancelled)")
    pfe = flsub.add_parser(
        "events", help="fleet ops event log: read (or follow) the "
        "durable event journal — breaker trips, failovers, hedge "
        "outcomes, rollout stages, DB swaps, replica skew, SLO burn "
        "alerts (docs/fleet.md 'Event catalog')", allow_abbrev=False)
    _add_global_flags(pfe)
    pfe.add_argument("--journal", required=True, metavar="PATH",
                     help="event journal path (torn-tail-tolerant "
                          "replay)")
    pfe.add_argument("--follow", action="store_true",
                     help="keep tailing the journal for new events")
    pfe.add_argument("--since", type=int, default=0, metavar="SEQ",
                     help="only events with a sequence number > SEQ")
    pfe.add_argument("--output", "-o", default=None,
                     help="write events here instead of stdout")
    pfv = flsub.add_parser(
        "serve", help="run the fleet observability control plane: a "
        "token-gated federation endpoint (/metrics /profile /flight "
        "/events) plus the monitor loop — health probes, replica-skew "
        "detection, SLO burn-rate alerts journaled durably "
        "(docs/fleet.md)", allow_abbrev=False)
    _add_global_flags(pfv)
    pfv.add_argument("endpoints", help="comma-separated replica URLs")
    pfv.add_argument("--listen", default="localhost:4955",
                     help="host:port for the federation endpoint")
    pfv.add_argument("--token", default=None,
                     help="token gating the federation endpoint "
                          "(also used upstream unless --upstream-token)")
    pfv.add_argument("--upstream-token", default=None,
                     help="auth token for scraping the replicas")
    pfv.add_argument("--journal", default=None, metavar="PATH",
                     help="durable ops event journal path")
    pfv.add_argument("--interval", default="5s",
                     help="monitor tick period (go-style duration)")
    pfc = flsub.add_parser(
        "control", help="run the self-driving fleet controller: an "
        "SLO-driven remediation/autoscaling loop — scale against "
        "offered load under a cost floor, drain-and-replace unhealthy "
        "replicas, re-resolve degraded mesh topology, tune the hedge "
        "budget; every decision journaled and replayed idempotently "
        "(docs/fleet.md 'Self-driving fleet')", allow_abbrev=False)
    _add_global_flags(pfc)
    pfc.add_argument("endpoints", help="comma-separated replica URLs")
    pfc.add_argument("--token", default=None, help="server auth token")
    pfc.add_argument("--actions", default=None, metavar="PATH",
                     help="controller action journal (intent/applied "
                          "records; replayed idempotently across "
                          "controller crashes). Default: observe-only "
                          "decisions are still emitted but not "
                          "durably journaled")
    pfc.add_argument("--journal", default=None, metavar="PATH",
                     help="durable fleet ops event journal every "
                          "controller_action event appends to")
    pfc.add_argument("--interval", default="5s",
                     help="control-loop tick period (go-style "
                          "duration)")
    pfc.add_argument("--ticks", type=int, default=None, metavar="N",
                     help="stop after N control passes (default: run "
                          "until interrupted)")
    pfc.add_argument("--dry-run", action="store_true",
                     help="journal and emit every decision without "
                          "acting on the fleet (the rehearsal "
                          "contract: nothing changes but the journal)")
    pfc.add_argument("--spawn-cmd", default=None, metavar="CMD",
                     help="shell command that starts one replica and "
                          "prints its URL on the last stdout line "
                          "(how scale_up/drain_replace reach your "
                          "process supervisor); without it the "
                          "controller cannot add replicas")
    pfc.add_argument("--load-cmd", default=None, metavar="CMD",
                     help="shell command printing the fleet's offered "
                          "load (a number) on its last stdout line; "
                          "default: sum of the in-flight scan counts "
                          "replicas report on /readyz. With neither "
                          "signal the controller never scales on "
                          "load")
    pfc.add_argument("--min-replicas", type=int, default=None,
                     help="autoscaler cost floor (default "
                          "TRIVY_TPU_CONTROLLER_MIN_REPLICAS or 1)")
    pfc.add_argument("--max-replicas", type=int, default=None,
                     help="autoscaler ceiling (default "
                          "TRIVY_TPU_CONTROLLER_MAX_REPLICAS or 4)")

    p = sub.add_parser(
        "profile", help="fetch a live server's bottleneck attribution "
        "(/debug/profile): per-resource-lane occupancy, critical-path "
        "shares, the roofline verdict, and the slow-scan flight "
        "recorder; a comma-separated URL federates a replica set "
        "(docs/observability.md)", allow_abbrev=False)
    _add_global_flags(p)
    p.add_argument("server", help="scan server URL (e.g. "
                                  "http://localhost:4954); a comma-"
                                  "separated list federates the whole "
                                  "replica set (per-replica sections + "
                                  "the fleet merge)")
    p.add_argument("--token", default=None,
                   help="server auth token (or the dedicated "
                        "TRIVY_TPU_PROFILE_TOKEN)")
    p.add_argument("--json", action="store_true",
                   help="print the raw /debug/profile document")
    p.add_argument("--flight", default=None, metavar="FILE",
                   help="also fetch /debug/flight (the N slowest scan "
                        "traces) as Chrome trace-event JSON to FILE; "
                        "with a replica set, every recorder is pulled "
                        "and stitched into ONE trace (per-replica "
                        "process rows, hedge losers marked cancelled)")

    p = sub.add_parser(
        "usage", help="fetch a live server's per-tenant usage metering "
        "(/debug/usage): cost vectors per tenant hash, fleet totals, "
        "and the lane-second conservation check; a comma-separated URL "
        "federates a replica set (docs/observability.md 'Usage "
        "metering')", allow_abbrev=False)
    _add_global_flags(p)
    p.add_argument("server", nargs="?", default=None,
                   help="scan server URL (e.g. http://localhost:4954); "
                        "a comma-separated list federates the whole "
                        "replica set; omit with --journal to read a "
                        "usage journal file instead")
    p.add_argument("--token", default=None,
                   help="server auth token (or the dedicated "
                        "TRIVY_TPU_PROFILE_TOKEN)")
    p.add_argument("--json", action="store_true",
                   help="print the raw usage document")
    p.add_argument("--top", type=int, default=None, metavar="K",
                   help="show only the K tenants with the most "
                        "lane-seconds (default: all)")
    p.add_argument("--journal", default=None, metavar="PATH",
                   help="render the last durable snapshot from a usage "
                        "journal (TRIVY_TPU_USAGE_JOURNAL) instead of "
                        "querying a live server")
    _add_host_parsers(sub)
    _add_chaos_parser(sub)
    sub.add_parser("version", help="print version", allow_abbrev=False)

    # `lint` shares the analysis package's flag definitions: one
    # definition, so global flags may precede the subcommand and the
    # CLI accepts exactly what `python -m trivy_tpu_torch.analysis.lint`
    # does
    from trivy_tpu_torch.analysis.lint import add_arguments as _lint_args

    p = sub.add_parser(
        "lint", help="run the project invariant linter over the port "
        "(docs/static-analysis.md)", allow_abbrev=False)
    _lint_args(p)
    return parser


# every subcommand of the port's parser: a first argument outside it
# names a plugin (plugin mode)
KNOWN_COMMANDS = frozenset({
    "image", "filesystem", "fs", "rootfs", "repository", "repo", "sbom",
    "vm", "kubernetes", "k8s", "convert", "server", "db", "clean",
    "config", "version", "registry", "plugin", "module", "lint", "watch",
    "profile", "usage", "fleet", "chaos"})


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    parser = build_parser()

    # `trivy-tpu <plugin-name> args…` runs an installed plugin
    # (reference pkg/plugin/plugin.go:101 + cmd/trivy plugin-mode)
    if argv and not argv[0].startswith("-") and \
            argv[0] not in KNOWN_COMMANDS:
        from trivy_tpu_torch.plugin import PluginManager

        cache_dir = os.environ.get(
            "TRIVY_TPU_CACHE_DIR",
            os.path.join(os.path.expanduser("~"), ".cache", "trivy-tpu"))
        mgr = PluginManager(cache_dir)
        if mgr.get(argv[0]) is not None:
            return mgr.run(argv[0], argv[1:])

    args = parser.parse_args(argv)

    if getattr(args, "command", None) == "lint":
        from trivy_tpu_torch.analysis.lint import run_from_args

        return run_from_args(args)

    if getattr(args, "generate_default_config", False):
        from trivy_tpu_torch.cli.config import generate_default_config

        try:
            path = generate_default_config(getattr(args, "config", None))
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
        print(f"written: {path}")
        return 0

    # layered resolution: CLI > TRIVY_TPU_* env > config file > default
    from trivy_tpu_torch.cli.config import apply_layers

    try:
        apply_layers(args, parser, argv)
    except (ValueError, FileNotFoundError) as e:
        print(str(e), file=sys.stderr)
        return 1
    log.init(debug=getattr(args, "debug", False),
             quiet=getattr(args, "quiet", False),
             fmt=getattr(args, "log_format", "text"))

    if args.command is None:
        parser.print_help()
        return 0
    if args.command == "version":
        print(f"Version: {trivy_tpu_torch.__version__}")
        return 0

    from trivy_tpu_torch.cli import run

    try:
        if args.command == "db":
            return run.run_db(args)
        if args.command == "convert":
            return run.run_convert(args)
        if args.command == "server":
            return run.run_server(args)
        if args.command == "watch":
            return run.run_watch(args)
        if args.command == "profile":
            return run.run_profile(args)
        if args.command == "usage":
            return run.run_usage(args)
        if args.command == "fleet":
            return run.run_fleet_admin(args)
        if args.command == "chaos":
            return run.run_chaos(args)
        if args.command == "clean":
            return run.run_clean(args)
        if args.command == "registry":
            return run.run_registry(args)
        if args.command == "plugin":
            return run.run_plugin(args)
        if args.command == "module":
            return run.run_module(args)
        if args.command in ("kubernetes", "k8s"):
            return run.run_k8s(args)
        return run.run_scan(args)
    except run.FatalError as e:
        log.logger().error(str(e))
        return 1
    except FileNotFoundError as e:
        log.logger().error(f"file not found: {e.filename or e}")
        return 1
    except (ValueError, OSError) as e:
        log.logger().error(str(e))
        return 1
    except Exception as e:  # scan-level failures render as one error line
        if getattr(args, "debug", False):
            raise
        log.logger().error(f"{type(e).__name__}: {e}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
