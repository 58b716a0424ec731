"""Scan runner: DB bootstrap -> scanner selection -> scan -> filter ->
report -> exit code (reference pkg/commands/artifact/run.go Runner).

Copy of trivy_tpu/cli/run.py trimmed to the `image`, `sbom`,
`filesystem` / `fs`, `rootfs`, `repository` / `repo` and `vm` scans
(each with `--monitor-index`), their client mode (`--server`: analysis
here, detection on a scan server or a comma-separated replica set;
`--fallback` degrades to a local scan on this process's device), and
the fleet scan mode (`--targets`, `--journal`, `--resume`,
`--fleet-parallel`: `cli/fleet.py`), each also as a compliance report
(`--compliance`, `--report`), and the `kubernetes` (with its
`--compliance`), `convert`, `db`, `server`, `watch`, `fleet`, `profile`,
`usage`, `chaos`, `plugin`, `module`, `registry` and `clean`
subcommands. Every scan loads the module extensions (`module/`) and
unloads them when it ends. `--trace` /
`--trace-export` collect the run's spans under one `scan` root and
render or export them;
`profile` and `usage` federate a comma-separated replica set. The match
engine and the secret analyzer's screen run on the device `--device`
names (``cuda:0`` by default), the engine's main tier on the serving
mesh `--mesh` names; `--no-tpu` takes the host paths of both.

`STATS` keeps the wall seconds of the last scan's phases, split by this
module's own code: DB load, engine build (compile or compiled-cache
load, plus the upload to the card), for a filesystem or image scan the
walk with the per-file analyzers and the post-analyzers (an image's
summed over its layers and walk lanes; the secret scan's own seconds,
its `device_stats` and the hybrid probe's verdict beside them), apply,
detect, report render. A `vm` scan keeps the image scan's split:
`inspect_s` (disk open, guest walks, post-analyzers) with `walk_s`,
`post_analyze_s` and `secret_s` inside it.
"""

from __future__ import annotations

import os
import sys
import time

from trivy_tpu_torch.log import logger
from trivy_tpu_torch.types.enums import Scanner as ScannerEnum, Severity
from trivy_tpu_torch.types.scan import ScanOptions

_log = logger()

STATS: dict = {}


class FatalError(Exception):
    pass


def _validate_fault_spec() -> None:
    """Fail fast on a malformed or unported TRIVY_TPU_FAULTS before any
    scan work."""
    from trivy_tpu_torch.resilience import faults

    try:
        faults.validate_env()
    except faults.FaultSpecError as e:
        raise FatalError(f"TRIVY_TPU_FAULTS: {e}")


def _severities(arg: str | None) -> list[Severity] | None:
    if not arg:
        return None
    return [Severity.parse(s) for s in arg.split(",") if s.strip()]


def _db_path(args) -> str:
    return getattr(args, "db_path", None) or os.path.join(
        args.cache_dir, "db"
    )


def _device(args):
    """The torch device of the match kernel; None on the host-oracle
    path (--no-tpu). Resolved before any DB work, so a missing card
    fails at once."""
    if getattr(args, "no_tpu", False):
        return None
    from trivy_tpu_torch.device import resolve_device

    try:
        return resolve_device(getattr(args, "device", None))
    except (RuntimeError, ValueError) as exc:
        raise FatalError(f"--device: {exc} (or --no-tpu for the host "
                         "match path)")


def _load_db(args):
    from trivy_tpu_torch.db.store import AdvisoryDB

    path = _db_path(args)
    try:
        db = AdvisoryDB.load(path)
        _log.info("advisory DB loaded", path=path, **db.stats())
        return db
    except FileNotFoundError:
        _log.warn(
            "no advisory DB found; vulnerability results will be empty",
            path=path,
        )
        return AdvisoryDB()


class _EngineCache(dict):
    """Engines by (db path, --no-tpu, device, mesh spec). An engine that
    leaves the cache (cleared, deleted or replaced) is closed, so a
    distributed MeshDB's spawned workers exit with it."""

    @staticmethod
    def _close(engine) -> None:
        close = getattr(engine, "close", None)
        if close is not None:
            close()

    def __setitem__(self, key, engine) -> None:
        old = self.get(key)
        super().__setitem__(key, engine)
        if old is not None and old is not engine:
            self._close(old)

    def __delitem__(self, key) -> None:
        engine = self[key]
        super().__delitem__(key)
        self._close(engine)

    def clear(self) -> None:
        engines = list(self.values())
        super().clear()
        for engine in engines:
            self._close(engine)


_ENGINE_CACHE: dict = _EngineCache()


def _mesh_spec(args) -> str:
    """--mesh, else TRIVY_TPU_MESH; a malformed spec fails here."""
    from trivy_tpu_torch.ops import mesh as mesh_ops

    spec = getattr(args, "mesh", None)
    if spec is None:
        spec = mesh_ops.spec_from_env()
    try:
        mesh_ops.parse_spec(spec)
    except ValueError as exc:
        raise FatalError(f"--mesh/TRIVY_TPU_MESH: {exc}")
    return spec


def new_engine(args):
    """Fresh MatchEngine. The on-disk DB path is threaded through so a
    warm start with an unchanged DB loads the persistent compiled-tensor
    cache instead of recompiling (tensorize.cache). `--mesh` /
    TRIVY_TPU_MESH serves matching from a sharded device mesh
    (ops/mesh.py), or across hosts (ops/dcn.py, with TRIVY_TPU_DCN); a
    spec the devices or the workers cannot serve fails here."""
    from trivy_tpu_torch.detector.engine import MatchEngine
    from trivy_tpu_torch.ops import mesh as mesh_ops

    device = _device(args)
    mesh_spec = _mesh_spec(args)
    t0 = time.perf_counter()
    db = _load_db(args)
    t1 = time.perf_counter()
    kw = dict(use_device=not getattr(args, "no_tpu", False), device=device,
              db_path=_db_path(args) if db.buckets else None)
    if mesh_ops.parse_spec(mesh_spec) is None:
        # no mesh in play: engine errors must not read as mesh problems
        engine = MatchEngine(db, **kw)
    else:
        try:
            engine = MatchEngine(db, mesh_spec=mesh_spec, **kw)
        except ValueError as exc:
            # the spec parsed, so this is a topology the devices cannot
            # place (too few of them), or a cross-host one without its
            # TRIVY_TPU_DCN workers
            raise FatalError(f"--mesh/TRIVY_TPU_MESH: {exc}")
    STATS.update(db_load_s=t1 - t0,
                 engine_build_s=time.perf_counter() - t1,
                 **engine.build_stats)
    return engine


def build_engine(args):
    """MatchEngine, cached per db-path, device and mesh spec within the
    process."""
    key = (_db_path(args), getattr(args, "no_tpu", False),
           str(_device(args)), _mesh_spec(args))
    if key not in _ENGINE_CACHE:
        _ENGINE_CACHE[key] = new_engine(args)
    else:
        STATS.update(db_load_s=0.0, engine_build_s=0.0)
    return _ENGINE_CACHE[key]


def normalize_args(args) -> None:
    """Cross-flag defaults applied once after parsing. SBOM-shaped
    output formats ARE package lists: force full package listing
    (reference flag/report_flags.go forces ListAllPkgs there)."""
    if getattr(args, "format", "") in ("cyclonedx", "spdx-json", "github"):
        args.list_all_pkgs = True


def make_scan_options(args) -> ScanOptions:
    scanners = [ScannerEnum(s) for s in (args.scanners or "").split(",")
                if s]
    return ScanOptions(
        pkg_types=args.pkg_types.split(","),
        scanners=scanners,
        list_all_pkgs=args.list_all_pkgs,
        include_dev_deps=getattr(args, "include_dev_deps", False),
        sbom_sources=[s for s in
                      getattr(args, "sbom_sources", "").split(",") if s],
        rekor_url=getattr(args, "rekor_url", "https://rekor.sigstore.dev"),
    )


def run_scan(args) -> int:
    from trivy_tpu_torch.fanal.analyzers import secret_analyzer

    STATS.clear()
    t0 = time.perf_counter()
    normalize_args(args)
    _validate_fault_spec()

    # --no-tpu forces the host path; the default is "hybrid" (device
    # screen + concurrent host AC; host-only when the screen's device
    # is the CPU). Set per invocation so an earlier --no-tpu run in the
    # same process doesn't stick. The screen runs on the device the
    # match kernel does, resolved here so a missing card fails before
    # any work.
    secret_analyzer.USE_DEVICE = (
        False if getattr(args, "no_tpu", False) else "hybrid")
    secret_analyzer.DEVICE = _device(args)

    # the compiled-NFA cache follows the resolved --cache-dir like
    # every other cache (set per invocation, same pattern as
    # USE_DEVICE above)
    from trivy_tpu_torch.secret import scanner as _secret_scanner

    _secret_scanner.set_cache_dir(getattr(args, "cache_dir", None))

    # --compliance: the spec decides which scanners run and the report
    # becomes a control-check report (reference artifact/run.go:
    # ComplianceSpec.Scanners override + compliance/report.Write)
    compliance_spec = _compliance_spec(args)
    if compliance_spec is not None:
        args.scanners = ",".join(compliance_spec.scanners())

    # secret-engine sizing flags reach the scanner (deep inside the
    # fanal post-analyzer) through their env knobs; explicit flags win
    # over an inherited environment, for this scan only
    knobs = {"TRIVY_TPU_SECRET_PACK_MB": getattr(args, "secret_pack_mb",
                                                 None),
             "TRIVY_TPU_SECRET_STREAM_CHUNK_MB": getattr(
                 args, "secret_stream_chunk_mb", None)}
    inherited = {k: os.environ.get(k) for k, v in knobs.items()
                 if v is not None}
    for k in inherited:
        os.environ[k] = str(knobs[k])

    # jar sha1->GAV lookups use the java DB when it has been imported
    # (reference pkg/javadb updater singleton)
    from trivy_tpu_torch.db import javadb

    jdb_path = javadb.default_path(args.cache_dir)
    javadb.configure(jdb_path if os.path.exists(jdb_path) else None)

    # module extensions: custom analyzers + post-scan hooks
    # (reference pkg/module manager wired into the runner)
    from trivy_tpu_torch.module import ModuleManager
    from trivy_tpu_torch.obs import tracing as trace

    trace_export = getattr(args, "trace_export", None)
    tracing_on = getattr(args, "trace", False) or bool(trace_export)
    if tracing_on:
        trace.enable(True)
        trace.reset()
    explicit_dir = getattr(args, "module_dir", None)
    mod_mgr = ModuleManager(
        explicit_dir or os.path.join(args.cache_dir, "modules"),
        # the shared cache dir is not consent to execute: only
        # manifest-trusted modules load from it
        require_manifest=explicit_dir is None)

    from trivy_tpu_torch.iac import engine as check_engine

    try:
        # inside the try: a load that fails half way still unloads what
        # it registered
        mod_mgr.load()
        # one root span covers the whole command (scan + report), so a
        # traced run exports a single tree under a single trace id
        with trace.span("scan", command=args.command):
            # custom misconfig checks: builtin bundle + --config-check
            # paths, gated by --check-namespaces (reference pkg/iac/rego
            # + pkg/policy); skipped entirely when misconfig isn't
            # scanned
            if "misconfig" in (args.scanners or "").split(",") \
                    or args.command == "config":
                _configure_check_engine(args)
            rc = _run_scan_core(args, compliance_spec)
    finally:
        check_engine.reset()
        mod_mgr.unload()
        if tracing_on:
            try:
                if getattr(args, "trace", False):
                    trace.render(sys.stderr)
                if trace_export:
                    n = trace.export_chrome(trace_export)
                    _log.info("trace exported", path=trace_export, spans=n)
            except OSError as e:
                # a bad export path must not eat the finished scan's
                # exit status (and enable(False) below must still run)
                _log.error("trace export failed", path=trace_export,
                           err=str(e))
            finally:
                trace.enable(False)
        for k, v in inherited.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    STATS["wall_s"] = time.perf_counter() - t0
    return rc


def _compliance_spec(args):
    """The spec `--compliance` names (a built-in id or `@path`), or
    None without the option."""
    if not getattr(args, "compliance", None):
        return None
    from trivy_tpu_torch.compliance.spec import SpecError, get_compliance_spec

    try:
        return get_compliance_spec(args.compliance)
    except (SpecError, OSError) as e:
        raise FatalError(f"compliance spec: {e}")


def _write_compliance(args, results, spec) -> None:
    """Render the compliance report of `results` against `spec` in
    place of the scan report (reference compliance/report.Write)."""
    from trivy_tpu_torch.compliance.report import (
        build_compliance_report,
        write_compliance_report,
    )

    comp = build_compliance_report(results, spec)
    # lint: allow[atomic-write] user-requested report stream (--output), partial file is visible to the user
    out = open(args.output, "w") if args.output else None
    try:
        write_compliance_report(
            comp, fmt="json" if args.format == "json" else "table",
            report=getattr(args, "report", "summary"), output=out)
    finally:
        if out:
            out.close()


def _coerce_helm_value(v: str):
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "~", ""):
        return None
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def _helm_overrides(args) -> dict:
    """--helm-values files then --helm-set pairs -> one nested override
    dict (later sources win, mirroring helm's precedence)."""
    import yaml as _yaml

    from trivy_tpu_torch.iac.helm import _deep_merge

    out: dict = {}
    for path in getattr(args, "helm_values", []) or []:
        try:
            with open(path, encoding="utf-8") as f:
                out = _deep_merge(out, _yaml.safe_load(f) or {})
        except (OSError, _yaml.YAMLError) as e:
            raise FatalError(f"--helm-values {path}: {e}")
    for flag in getattr(args, "helm_set", []) or []:
        # helm accepts comma-joined pairs in one flag (a=1,b=2); commas
        # inside values must be escaped as '\\,' exactly like helm
        segments = [s.replace("\x00", ",") for s in
                    flag.replace("\\,", "\x00").split(",")]
        for pair in segments:
            key, sep, val = pair.partition("=")
            if not sep or not key:
                raise FatalError(
                    f"--helm-set needs key=value, got {pair!r}")
            node = out
            parts = key.split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
                if not isinstance(node, dict):
                    raise FatalError(f"--helm-set {pair!r} conflicts "
                                     "with a scalar override")
            node[parts[-1]] = _coerce_helm_value(val)
    return out


def _configure_check_engine(args) -> None:
    from trivy_tpu_torch.iac import engine as check_engine
    from trivy_tpu_torch.iac.engine import CheckLoadError
    from trivy_tpu_torch.policy.bundle import bundle_check_paths

    # user-supplied paths may contain Python checks (explicit opt-in to
    # code execution); a downloaded bundle is data-only — its .py files
    # are refused at load time (reference Rego bundles are sandboxed by
    # the OPA interpreter; we get the same property by construction)
    user_paths = list(getattr(args, "config_check", []) or [])
    bundle_paths = bundle_check_paths(
        args.cache_dir,
        repository=getattr(args, "checks_bundle_repository", ""),
        skip_update=getattr(args, "skip_check_update", False))
    try:
        check_engine.configure(
            check_paths=user_paths,
            bundle_paths=bundle_paths,
            namespaces=getattr(args, "check_namespaces", []),
            data_paths=getattr(args, "config_data", []),
            include_deprecated=getattr(
                args, "include_deprecated_checks", False))
    except (CheckLoadError, OSError) as e:
        raise FatalError(f"loading checks: {e}")


K8S_SCANNERS = {"vuln", "misconfig", "rbac", "infra"}


def run_k8s(args) -> int:
    """`kubernetes` subcommand (reference pkg/k8s/commands/run.go:26).
    With --compliance the spec's scanners run (those `kubernetes` has;
    `infra` for its KCV controls, `rbac` for its RBAC-range KSV ids) and
    a compliance report takes the cluster report's place. With `vuln`
    among the scanners, the device is resolved first and the image
    scans run the match kernel and the secret screens on it (the host
    paths of both under --no-tpu); misconfig, rbac and infra are host
    work and need no card. A device error ends the run with one line and
    rc 1. The scanner's step seconds are in `k8s/scanner.py` `STATS`."""
    from trivy_tpu_torch.fanal.analyzers import secret_analyzer
    from trivy_tpu_torch.k8s import scanner as k8s_scanner
    from trivy_tpu_torch.k8s.report import write_cluster_report

    scanners = {s.strip() for s in (args.scanners or "").split(",")
                if s.strip()}
    if unknown := scanners - K8S_SCANNERS:
        raise FatalError(
            f"unknown k8s scanners: {', '.join(sorted(unknown))} "
            f"(valid: {', '.join(sorted(K8S_SCANNERS))})")

    compliance_spec = _compliance_spec(args)
    if compliance_spec is not None:
        scanners = set(compliance_spec.scanners()) & K8S_SCANNERS \
            or {"misconfig"}
        # KCV controls are produced by the infra/node assessment and the
        # RBAC-range KSV ids (KSV041-053, the rbac.py rule set) by the
        # RBAC assessment, not by the per-resource misconfig scan
        spec_ids = {c.id for ctrl in compliance_spec.spec.controls
                    for c in ctrl.checks}
        if any(i.startswith("AVD-KCV-") for i in spec_ids):
            scanners.add("infra")
        rbac_ids = {f"AVD-KSV-{n:04d}" for n in range(41, 54)}
        if spec_ids & rbac_ids:
            scanners.add("rbac")

    engine = None
    if "vuln" in scanners:
        # set per invocation, as run_scan does: the image scans' secret
        # screens run where the match kernel does
        secret_analyzer.USE_DEVICE = (
            False if getattr(args, "no_tpu", False) else "hybrid")
        secret_analyzer.DEVICE = _device(args)
        engine = build_engine(args)
    scanner = k8s_scanner.ClusterScanner(
        scanners=scanners, workers=args.parallel,
        image_tar_dir=args.image_tar_dir, engine=engine,
        disable_node_collector=args.disable_node_collector,
        node_collector_namespace=args.node_collector_namespace,
        node_collector_image=args.node_collector_imageref,
    )
    try:
        report = scanner.scan(args.target, context=args.context,
                              namespace=args.namespace)
    except RuntimeError as e:  # a device error among them
        print(" ".join(str(e).splitlines()), file=sys.stderr)
        return 1
    if compliance_spec is not None:
        _write_compliance(args, _cluster_results(report), compliance_spec)
        return 0
    fmt = "json" if args.format == "json" else args.report
    write_cluster_report(report, fmt=fmt, output=args.output)
    return 0


def _cluster_results(report) -> list:
    """A cluster report as the scan results a compliance report reads:
    each resource's misconfigurations, its images' results, and the
    infra (KCV) and RBAC (KSV) findings as `AVD-*` misconfigurations
    (reference k8s compliance includes node-collector output)."""
    from trivy_tpu_torch.types.report import (
        DetectedMisconfiguration,
        Result,
    )

    results: list[Result] = []
    for rr in report.resources:
        if rr.misconfigurations:
            results.append(Result(
                target=rr.resource.fullname, result_class="config",
                type="kubernetes",
                misconfigurations=rr.misconfigurations))
        for _img, rep in rr.image_reports:
            results.extend(rep.results)
    for f in list(report.infra) + list(report.rbac):
        num = "".join(ch for ch in f.id if ch.isdigit())
        prefix = "KCV" if f.id.startswith("KCV") else "KSV"
        results.append(Result(
            target=f.resource, result_class="config",
            type="kubernetes",
            misconfigurations=[DetectedMisconfiguration(
                type="kubernetes", id=f.id,
                avd_id=f"AVD-{prefix}-{int(num or 0):04d}",
                title=f.title, message=f.message,
                severity=f.severity, status="FAIL")]))
    return results


def _parse_duration(spec: str | None) -> float:
    """Go-style duration ("5m", "300s", "1h30m", "500ms") or bare
    seconds -> seconds (reference --timeout, default 5m). Trailing
    garbage is an error, not silently dropped."""
    import math
    import re

    if not spec:
        return 300.0
    try:
        v = float(spec)
        if not math.isfinite(v) or v <= 0:
            raise FatalError(f"invalid --timeout {spec!r}")
        return v
    except ValueError:
        pass
    unit_rx = r"(\d+(?:\.\d+)?)(ms|h|m|s)"
    if not re.fullmatch(f"(?:{unit_rx})+", spec):
        raise FatalError(f"invalid --timeout {spec!r}")
    total = 0.0
    for n, unit in re.findall(unit_rx, spec):
        total += float(n) * {"h": 3600.0, "m": 60.0, "s": 1.0,
                             "ms": 0.001}[unit]
    if total <= 0:
        raise FatalError(f"invalid --timeout {spec!r}")
    return total


def _scan_with_timeout(scanner, options, timeout_s: float,
                       budget_s: float | None = None):
    """Per-scan deadline (reference artifact/run.go:338 ctx timeout).
    The scan runs in a worker thread; on deadline the CLI fails with the
    reference's DeadlineExceeded advice (the worker, being a daemon
    thread, cannot outlive the process). `budget_s` (--scan-timeout)
    additionally arms the cooperative deadline budget that propagates
    through the scan spine and to the server via X-Trivy-Deadline —
    the scope is entered inside the worker because it is thread-local."""
    import threading

    from trivy_tpu_torch.monitor import capture as mon_capture
    from trivy_tpu_torch.obs import tracing, usage

    box: dict = {}
    # the worker thread starts from an empty contextvars context: the
    # trace context (span, scan id), the usage scope and the monitor's
    # scan capture must follow the scan onto it, or its spans orphan
    # and a --monitor-index scan records an empty inventory
    trace_ctx = tracing.capture()
    usage_ctx = usage.capture()
    mon_ctx = mon_capture.current()

    def work():
        try:
            with tracing.adopt(trace_ctx), usage.adopt(usage_ctx), \
                    mon_capture.adopt(mon_ctx):
                if budget_s:
                    from trivy_tpu_torch.resilience.retry import (
                        Deadline,
                        deadline_scope,
                    )

                    with deadline_scope(Deadline.after(budget_s)):
                        box["report"] = scanner.scan_artifact(options)
                else:
                    box["report"] = scanner.scan_artifact(options)
        except BaseException as exc:  # lint: allow[bare-except] re-raised on the main thread after join
            box["error"] = exc

    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise FatalError(
            f"scan deadline exceeded ({timeout_s:.0f}s); increase "
            "--timeout (e.g. --timeout 10m)")
    if "error" in box:
        raise box["error"]
    return box["report"]


def open_monitor_index(args):
    """The durable monitor index for a --monitor-index scan, or None
    (no flag, monitor disabled, or client mode — a remote scan's detect
    phase runs server-side, so the server owns the index there)."""
    path = getattr(args, "monitor_index", None)
    if not path:
        return None
    from trivy_tpu_torch import monitor as monitor_mod

    if not monitor_mod.enabled():
        return None
    if getattr(args, "server", None):
        _log.warn("--monitor-index is ignored in client mode; run the "
                  "server with --monitor-index instead")
        return None
    from trivy_tpu_torch.monitor.index import MonitorIndex

    return MonitorIndex.open_or_reset(path)


def _build_cache(args):
    """Cache backend selection shared by single-target and fleet scans."""
    from trivy_tpu_torch.cache.cache import FSCache, MemoryCache

    backend = getattr(args, "cache_backend", "fs") or "fs"
    if backend.startswith(("redis://", "rediss://")):
        from trivy_tpu_torch.cache.redis import RedisCache, RedisError

        try:
            return RedisCache(
                backend, ca_cert=getattr(args, "redis_ca", ""),
                cert=getattr(args, "redis_cert", ""),
                key=getattr(args, "redis_key", ""),
                tls=getattr(args, "redis_tls", False),
                insecure=getattr(args, "redis_insecure", False))
        except (OSError, RedisError) as e:
            raise FatalError(f"redis cache backend: {e}")
    if backend == "memory":
        return MemoryCache()
    if backend == "fs":
        return FSCache(args.cache_dir)
    raise FatalError(
        f"unknown cache backend {backend!r} (fs, memory, redis://...)")


def _scan_target(args, cache):
    """Build the scanner for args.target and run it under the timeout /
    budget flags -> raw (unfiltered) Report."""
    from trivy_tpu_torch.resilience.retry import DeadlineExceeded
    from trivy_tpu_torch.scanner.scan import Scanner

    options = make_scan_options(args)
    timeout_s = _parse_duration(getattr(args, "timeout", None))
    budget_spec = getattr(args, "scan_timeout", None)
    budget_s = _parse_duration(budget_spec) if budget_spec else None
    artifact, driver = _select_scanner(args, cache)
    try:
        report = _scan_with_timeout(Scanner(driver, artifact), options,
                                    timeout_s, budget_s=budget_s)
    except DeadlineExceeded as e:
        raise FatalError(
            f"scan deadline exceeded: {e} (increase --scan-timeout, or "
            "add --fallback in client mode to degrade to a local scan)")
    # a client-mode scan's apply and detect phases run on the server
    STATS.update(**driver.stats, **getattr(artifact, "stats", {}))
    return report


def _run_scan_core(args, compliance_spec) -> int:
    from trivy_tpu_torch.report.writer import write_report

    if getattr(args, "resume", None) or getattr(args, "targets", None):
        # fleet mode: many artifacts, one journal, one merged report
        from trivy_tpu_torch.cli.fleet import run_fleet

        if compliance_spec is not None:
            raise FatalError("--compliance is not supported with fleet "
                             "scans (--targets/--resume)")
        return run_fleet(args)

    cache = _build_cache(args)
    mon_index = open_monitor_index(args)
    if mon_index is None:
        report = _scan_target(args, cache)
    else:
        from trivy_tpu_torch.monitor.capture import capture_scan
        from trivy_tpu_torch.tensorize import cache as compile_cache

        try:
            with capture_scan() as cap:
                report = _scan_target(args, cache)
            mon_index.update(
                getattr(args, "input", None) or args.target,
                cap.packages, cap.findings,
                db_digest=compile_cache.db_digest(_db_path(args)))
        finally:
            mon_index.close()
    severities = _postprocess_report(args, report)
    from trivy_tpu_torch import obs

    t0 = time.perf_counter()
    if compliance_spec is not None:
        _write_compliance(args, report.results, compliance_spec)
    else:
        with obs.phase("report"):
            write_report(report, fmt=args.format, output=args.output,
                         template=args.template, severities=severities,
                         dependency_tree=getattr(args, "dependency_tree",
                                                 False))
    STATS["render_s"] = time.perf_counter() - t0
    return _exit_code(args, report)


def _exit_code(args, report) -> int:
    # exit-code policy (reference pkg/commands/operation/operation.go:118):
    # FINDINGS drive the exit code; retained package lists do not
    if args.exit_code:
        for res in report.results:
            if (res.vulnerabilities or res.misconfigurations
                    or res.secrets or res.licenses):
                return args.exit_code
    if args.exit_on_eol and report.metadata.os and report.metadata.os.eosl:
        return args.exit_on_eol
    return 0


def _postprocess_report(args, report):
    """Result shaping between scan and render: VEX suppression,
    severity/status/ignore filtering, package stripping. Returns the
    parsed severity list (the table renderer wants it again)."""
    from trivy_tpu_torch.result.filter import filter_report
    from trivy_tpu_torch.result.ignore import load_ignore_file

    # VEX suppression runs before severity/ignore filtering
    # (reference pkg/result/filter.go:37 -> pkg/vex/vex.go:65).
    # Sources: a document path, "repo" (cached VEX repositories), or
    # "oci" (attestation attached to the scanned image).
    vex_specs = getattr(args, "vex", None) or []
    if vex_specs:
        from trivy_tpu_torch.vex import filter_report_vex, load_vex

        sources = []
        for spec in vex_specs:
            if spec == "repo":
                from trivy_tpu_torch.vex.repo import RepositorySet

                rs = RepositorySet(args.cache_dir)
                if rs:
                    sources.append(rs)
            elif spec == "oci":
                from trivy_tpu_torch.vex.oci import load_oci_vex

                doc = load_oci_vex(report)
                if doc is not None:
                    sources.append(doc)
            else:
                sources.append(load_vex(spec))
        n = filter_report_vex(report, sources) if sources else 0
        if n:
            _log.info("vex suppressed findings", count=n)
    if not getattr(args, "show_suppressed", False):
        for res in report.results:
            res.modified_findings = []

    severities = _severities(args.severity)
    ignore_cfg = load_ignore_file(args.ignorefile)
    statuses = (args.ignore_status or "").split(",") \
        if args.ignore_status else None
    ignore_policy = None
    if getattr(args, "ignore_policy", None):
        from trivy_tpu_torch.result.policy import load_ignore_policy

        try:
            ignore_policy = load_ignore_policy(args.ignore_policy)
        except Exception as e:
            # .py policies can raise anything at import time
            # (SyntaxError, ImportError, ...); all of it is user input
            raise FatalError(f"ignore policy: {e}")
    filter_report(report, severities=severities, ignore_statuses=statuses,
                  ignore_config=ignore_cfg,
                  ignore_unfixed=getattr(args, "ignore_unfixed", False),
                  ignore_policy=ignore_policy)

    # packages travel with results internally (VEX reachability, the
    # dependency tree); they render under --list-all-pkgs, the
    # dependency tree, and SBOM-shaped formats (which ARE package lists
    # — the reference forces list-all-pkgs for them)
    keep_pkgs = (getattr(args, "list_all_pkgs", False)
                 or getattr(args, "dependency_tree", False))
    if not keep_pkgs:
        for res in report.results:
            res.packages = []
    return severities


def _select_scanner(args, cache):
    """reference pkg/commands/artifact/scanner.go: artifact kind x
    standalone/client -> (artifact, driver), for every scan kind of the
    reference."""
    cmd = args.command
    if cmd not in ("image", "sbom", "filesystem", "fs", "rootfs",
                   "repository", "repo", "vm", "config"):
        raise FatalError(f"unsupported scan command {cmd!r}")
    if getattr(args, "server", None):
        from trivy_tpu_torch.rpc.client import RemoteCache, RemoteDriver

        driver = RemoteDriver(args.server, token=args.token)
        # analysis runs client-side but blobs land in the SERVER's cache
        # (reference pkg/commands/artifact/scanner.go remote scanners)
        cache = RemoteCache(args.server, token=args.token)
        if getattr(args, "fallback", False):
            # --fallback: blobs mirror into a local cache and the scan
            # degrades to a locally built engine when the breaker opens
            # or the deadline budget runs out. The local engine runs on
            # this process's device (--device, cuda:0 by default): the
            # scan degrades from the server to here, never to the CPU
            from trivy_tpu_torch.cache.cache import MemoryCache
            from trivy_tpu_torch.resilience.breaker import CircuitBreaker
            from trivy_tpu_torch.resilience.fallback import (
                FallbackCache,
                FallbackDriver,
            )

            breaker = CircuitBreaker(failure_threshold=3, recovery_s=30.0,
                                     name="rpc")
            cache = FallbackCache(cache, MemoryCache(), breaker=breaker)
            local_cache = cache

            def _local_driver():
                from trivy_tpu_torch.scanner.local import LocalDriver

                return LocalDriver(build_engine(args), local_cache)

            driver = FallbackDriver(driver, _local_driver, breaker=breaker)
    else:
        from trivy_tpu_torch.scanner.local import LocalDriver

        driver = LocalDriver(build_engine(args), cache)
    # analyzers whose scanner class was not requested are disabled
    # (reference pkg/commands/artifact/run.go disabledAnalyzers)
    scanners = set((args.scanners or "").split(","))
    disabled: set[str] = set()
    if "misconfig" not in scanners and cmd != "config":
        disabled.add("config")
    if "secret" not in scanners:
        disabled.add("secret")
    if "license" not in scanners:
        disabled.add("license-file")
    else:
        from trivy_tpu_torch.fanal.analyzers.license_file import (
            LicenseFileAnalyzer,
        )

        LicenseFileAnalyzer.full = bool(getattr(args, "license_full", False))
    if cmd == "sbom":
        from trivy_tpu_torch.artifact.sbom import SBOMArtifact

        return SBOMArtifact(args.target, cache), driver
    helm_overrides = _helm_overrides(args)

    if cmd == "image":
        from trivy_tpu_torch.artifact.image import ImageArtifact

        target = getattr(args, "input", None) or args.target
        if target is None:
            raise FatalError("image target or --input required")
        sources = tuple(
            s.strip() for s in
            getattr(args, "image_src", "containerd,docker,podman,remote"
                    ).split(",") if s.strip())
        return ImageArtifact(
            target, cache, from_tar=bool(getattr(args, "input", None)),
            parallel=args.parallel,
            disabled_analyzers=disabled,
            secret_config=getattr(args, "secret_config", None),
            file_patterns=getattr(args, "file_patterns", []),
            image_sources=sources,
            insecure=getattr(args, "insecure", False),
            username=getattr(args, "username", ""),
            password=getattr(args, "password", ""),
            helm_overrides=helm_overrides,
        ), driver

    # per-target analyzer gating (reference artifact/run.go:178-215):
    # fs scans read lockfiles, not installed-package stores; rootfs the
    # inverse; repository additionally skips OS analyzers; vm gates
    # nothing
    from trivy_tpu_torch.fanal.analyzer import (
        TYPE_INDIVIDUAL_PKGS,
        TYPE_LOCKFILES,
        TYPE_OSES,
    )

    if cmd in ("filesystem", "fs"):
        disabled |= TYPE_INDIVIDUAL_PKGS | {"sbom"}
    elif cmd == "rootfs":
        disabled |= TYPE_LOCKFILES
    elif cmd in ("repository", "repo"):
        disabled |= TYPE_INDIVIDUAL_PKGS | TYPE_OSES | {"sbom"}
    if cmd in ("repository", "repo"):
        from trivy_tpu_torch.artifact.repo import RepoArtifact

        return RepoArtifact(
            args.target, cache,
            skip_files=args.skip_files, skip_dirs=args.skip_dirs,
            parallel=args.parallel,
            disabled_analyzers=disabled,
            secret_config=getattr(args, "secret_config", None),
            branch=getattr(args, "branch", ""),
            tag=getattr(args, "tag", ""),
            commit=getattr(args, "commit", ""),
            helm_overrides=helm_overrides,
        ), driver
    if cmd == "vm":
        from trivy_tpu_torch.artifact.vm import VMArtifact

        return VMArtifact(
            args.target, cache,
            parallel=args.parallel,
            disabled_analyzers=disabled,
            secret_config=getattr(args, "secret_config", None),
            file_patterns=getattr(args, "file_patterns", []),
            helm_overrides=helm_overrides,
        ), driver
    from trivy_tpu_torch.artifact.local_fs import FSArtifact

    return FSArtifact(
        args.target, cache,
        skip_files=args.skip_files, skip_dirs=args.skip_dirs,
        misconfig_only=(cmd == "config"),
        disabled_analyzers=disabled,
        secret_config=getattr(args, "secret_config", None),
        file_patterns=getattr(args, "file_patterns", []),
        helm_overrides=helm_overrides,
    ), driver


def run_server(args) -> int:
    """`server`: load the DB, build the engine on the card (`--device`;
    `--no-tpu` matches on the host) and serve until SIGTERM, which
    drains in-flight scans within `--drain-timeout`."""
    from trivy_tpu_torch.cache.cache import FSCache
    from trivy_tpu_torch.rpc.server import serve

    _validate_fault_spec()
    engine = new_engine(args)
    host, _, port = args.listen.partition(":")
    serve(engine, host=host or "localhost", port=int(port or 4954),
          token=args.token, cache=FSCache(args.cache_dir),
          db_path=_db_path(args),
          drain_timeout=_parse_duration(
              getattr(args, "drain_timeout", None) or "30s"),
          sched_window_ms=getattr(args, "sched_window_ms", None),
          sched_max_rows=getattr(args, "sched_max_rows", None),
          monitor_index=getattr(args, "monitor_index", None))
    return 0


def run_fleet_admin(args) -> int:
    """`trivy-tpu fleet status|rollout|metrics|profile|events|serve`
    (docs/fleet.md): replica-set health, the coordinated advisory-DB
    rollout controller, and the fleet observability control plane
    (metrics/attribution federation, stitched traces, the durable ops
    event log)."""
    import json as _json
    import sys

    from trivy_tpu_torch.fleet import rollout as rollout_mod
    from trivy_tpu_torch.fleet.endpoints import split_urls

    _validate_fault_spec()
    cmd = getattr(args, "fleet_command", None)
    if cmd is None:
        raise FatalError("fleet: choose a subcommand (status, rollout, "
                         "metrics, profile, events, serve, control)")
    token = getattr(args, "token", None)
    if cmd == "events":
        return _run_fleet_events(args)
    endpoints = split_urls(getattr(args, "endpoints", "") or "")
    if not endpoints:
        raise FatalError("fleet: no endpoints given")
    if cmd == "status":
        status = rollout_mod.fleet_status(endpoints, token=token)
        print(_json.dumps(status, indent=2, sort_keys=True))
        return 0 if all(s.get("ready") for s in status) else 1
    if cmd == "metrics":
        from trivy_tpu_torch.fleet import telemetry

        fed = telemetry.federate_endpoints(endpoints, token=token)
        body = fed.render().decode()
        if getattr(args, "output", None):
            # lint: allow[atomic-write] user-requested exposition dump (--output), not program state
            with open(args.output, "w", encoding="utf-8") as f:
                f.write(body)
        else:
            print(body, end="")
        errors = getattr(fed, "errors", {})
        for idx, err in sorted(errors.items()):
            print(f"# scrape failed: replica {idx}: {err}",
                  file=sys.stderr)
        return 0 if not errors else 1
    if cmd == "profile":
        return _render_fleet_profile(endpoints, token,
                                     as_json=getattr(args, "json", False),
                                     flight=getattr(args, "flight", None))
    if cmd == "serve":
        return _run_fleet_serve(args, endpoints, token)
    if cmd == "control":
        return _run_fleet_control(args, endpoints, token)
    if cmd != "rollout":
        raise FatalError(f"fleet: unknown subcommand {cmd!r}")
    if getattr(args, "journal", None):
        from trivy_tpu_torch.fleet import slo as slo_mod

        slo_mod.install_journal(args.journal)
    probes = None
    if getattr(args, "probes", None):
        probes = rollout_mod.load_probes(args.probes)
    try:
        report = rollout_mod.run_rollout(
            _db_path(args), endpoints, token=token, probes=probes,
            rescore=not getattr(args, "no_rescore", False),
            canary=getattr(args, "canary", None),
            on_event=lambda ev: print(
                _json.dumps(ev, sort_keys=True), file=sys.stderr))
    except rollout_mod.RolloutError as e:
        raise FatalError(f"fleet rollout: {e}")
    doc = report.doc()
    out = _json.dumps(doc, indent=2, sort_keys=True)
    if getattr(args, "output", None):
        # lint: allow[atomic-write] user-requested report stream (--output), partial file is visible to the user
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(out + "\n")
    print(out)
    return 0 if report.outcome in ("completed", "noop") else 1


def _run_fleet_events(args) -> int:
    """`trivy-tpu fleet events --journal PATH [--follow]`: replay the
    durable ops event journal (torn tail tolerated) as JSON lines;
    --follow tails the file incrementally and survives compaction /
    rotation (the tail reopens on inode change or truncation and
    resumes from the sealed replay point — the seq cursor)."""
    import json as _json
    import time as _time

    from trivy_tpu_torch.durability.appendlog import AppendLogError
    from trivy_tpu_torch.fleet.slo import JournalTail, OpsEventLog

    follow = getattr(args, "follow", False)
    since = getattr(args, "since", 0) or 0
    if not follow:
        # One-shot replay: the line-bounded journal reader already
        # tolerates torn tails and corrupt records.
        try:
            events = OpsEventLog.read(args.journal)
        except (AppendLogError, OSError) as e:
            raise FatalError(f"fleet events: {e}")
        out = sys.stdout
        if getattr(args, "output", None):
            # lint: allow[atomic-write] user-requested event stream (--output): append-only JSONL the user tails
            out = open(args.output, "a", encoding="utf-8")
        try:
            for ev in events:
                if int(ev.get("seq", 0)) > since:
                    out.write(_json.dumps(ev, sort_keys=True) + "\n")
            out.flush()
            return 0
        finally:
            if out is not sys.stdout:
                out.close()
    out = sys.stdout
    if getattr(args, "output", None):
        # lint: allow[atomic-write] user-requested event stream (--output): append-only JSONL the user tails
        out = open(args.output, "a", encoding="utf-8")
    tail = JournalTail(args.journal, since=since)
    try:
        while True:
            for ev in tail.poll():
                out.write(_json.dumps(ev, sort_keys=True) + "\n")
            out.flush()
            _time.sleep(1.0)
    except KeyboardInterrupt:
        return 0
    finally:
        tail.close()
        if out is not sys.stdout:
            out.close()


def _run_fleet_control(args, endpoints: list, token: str | None) -> int:
    """`trivy-tpu fleet control`: the blocking self-driving loop —
    observe the fleet, decide against policy, journal, act
    (docs/fleet.md "Self-driving fleet")."""
    from trivy_tpu_torch.fleet import controller as ctrl_mod
    from trivy_tpu_torch.fleet import slo as slo_mod

    if getattr(args, "journal", None):
        past = slo_mod.install_journal(args.journal)
        _log.info("ops event journal installed", path=args.journal,
                  replayed=len(past))
    interval = _parse_duration(getattr(args, "interval", None) or "5s")
    policy = ctrl_mod.ControllerPolicy(
        min_replicas=getattr(args, "min_replicas", None),
        max_replicas=getattr(args, "max_replicas", None))
    actuator = ctrl_mod.HttpFleetActuator(
        endpoints, token=token,
        spawn_cmd=getattr(args, "spawn_cmd", None),
        load_cmd=getattr(args, "load_cmd", None))
    ctl = ctrl_mod.FleetController(
        actuator, policy=policy,
        journal_path=getattr(args, "actions", None),
        dry_run=getattr(args, "dry_run", False))
    try:
        ctl.run(interval_s=interval,
                max_ticks=getattr(args, "ticks", None),
                on_tick=lambda report: print(
                    ctrl_mod.render_report(report), flush=True))
        return 0
    except KeyboardInterrupt:
        return 0
    finally:
        ctl.close()
        if getattr(args, "journal", None):
            slo_mod.uninstall_journal()


def _run_fleet_serve(args, endpoints: list, token: str | None) -> int:
    """`trivy-tpu fleet serve`: the blocking control-plane process —
    federation endpoint + monitor loop (docs/fleet.md)."""
    import time

    from trivy_tpu_torch.fleet import slo as slo_mod
    from trivy_tpu_torch.fleet import telemetry

    if getattr(args, "journal", None):
        past = slo_mod.install_journal(args.journal)
        _log.info("ops event journal installed", path=args.journal,
                  replayed=len(past))
    host, _sep, port = (getattr(args, "listen", None)
                        or "localhost:4955").rpartition(":")
    try:
        port_n = int(port)
    except ValueError:
        raise FatalError(f"fleet serve: bad --listen {args.listen!r}")
    interval = _parse_duration(getattr(args, "interval", None) or "5s")
    monitor = telemetry.FleetMonitor(endpoints, token=token)
    srv = telemetry.FederationServer(
        endpoints, host=host or "localhost", port=port_n,
        token=getattr(args, "token", None),
        upstream_token=getattr(args, "upstream_token", None) or token,
        monitor=monitor, monitor_interval_s=interval)
    srv.start()
    print(f"federation endpoint: {srv.address} "
          f"({len(endpoints)} replica(s))")
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        return 0
    finally:
        srv.shutdown()
        if getattr(args, "journal", None):
            slo_mod.uninstall_journal()


def _render_fleet_profile(endpoints: list, token: str | None,
                          as_json: bool, flight: str | None) -> int:
    """Shared by `trivy-tpu fleet profile` and the multi-endpoint form
    of `trivy-tpu profile`: per-replica attribution sections plus the
    federated fleet verdict; --flight stitches every replica's flight
    recorder into ONE Chrome trace."""
    import json as _json

    from trivy_tpu_torch.fleet import telemetry

    profiles = []
    errors = []
    for ep in endpoints:
        try:
            profiles.append((ep.rstrip("/"),
                             telemetry.fetch_profile(ep, token=token)))
        except telemetry.FederationError as e:
            errors.append(str(e))
    if not profiles:
        raise FatalError("profile fetch failed: "
                         + "; ".join(errors or ["no endpoints"]))
    doc = telemetry.federate_profiles(profiles)
    if flight:
        fdoc = telemetry.stitch_endpoints(endpoints, token=token)
        # lint: allow[atomic-write] user-requested trace-export artifact, not program state
        with open(flight, "w", encoding="utf-8") as f:
            _json.dump(fdoc, f, indent=1)
            f.write("\n")
        st = fdoc.get("stitch", {})
        print(f"stitched flight trace written: {flight} "
              f"({st.get('replicas', 0)} replica(s), "
              f"{st.get('traces', 0)} trace(s), "
              f"{st.get('fragments', 0)} fragment(s), "
              f"{st.get('cancelled_spans', 0)} cancelled span(s), "
              f"{st.get('orphan_roots', 0)} orphan root(s))")
    if as_json:
        print(_json.dumps(doc, indent=2, sort_keys=True))
        return 0 if not errors else 1
    for label, rep in doc["replicas"].items():
        print(f"-- replica {label} "
              f"(scans {rep.get('scans', 0)}, "
              f"verdict: {rep.get('verdict', '?')})")
    fleet = doc["fleet"]
    print(f"-- fleet ({len(doc['replicas'])} replica(s), "
          f"scans {fleet['scans']}, wall {fleet['wall_s']:.3f}s)")
    print(f"{'lane':<16} {'busy s':>10} {'critical s':>11} {'share':>7}")
    for lane, row in fleet["lanes"].items():
        print(f"{lane:<16} {row['busy_s']:>10.3f} "
              f"{row['crit_s']:>11.3f} {row['crit_share']:>7.1%}")
    print(f"{'other':<16} {'':>10} {fleet['other_s']:>11.3f}")
    print(f"fleet verdict: {fleet['verdict']}")
    for err in errors:
        print(f"scrape failed: {err}", file=sys.stderr)
    return 0 if not errors else 1


def run_profile(args) -> int:
    """`trivy-tpu profile URL`: render a live server's bottleneck
    attribution (docs/observability.md "Attribution & profiling") —
    per-lane busy/critical seconds, the roofline "bound by X" verdict,
    recent per-scan records, and the slow-scan flight recorder.

    A comma-separated URL names a replica set: every replica's profile
    renders as its own section plus the federated fleet merge, and
    --flight stitches every replica's flight recorder into ONE Chrome
    trace (docs/observability.md "Fleet observability")."""
    import json as _json
    import urllib.error
    import urllib.request

    from trivy_tpu_torch.fleet.endpoints import split_urls

    endpoints = [u if u.startswith("http") else "http://" + u
                 for u in split_urls(args.server)]
    if len(endpoints) > 1:
        return _render_fleet_profile(
            endpoints, getattr(args, "token", None),
            as_json=getattr(args, "json", False),
            flight=getattr(args, "flight", None))

    base = args.server.rstrip("/")
    if not base.startswith("http"):
        base = "http://" + base

    def get(path: str) -> dict:
        req = urllib.request.Request(base + path)
        if getattr(args, "token", None):
            req.add_header("Trivy-Token", args.token)
        with urllib.request.urlopen(req, timeout=10) as r:
            return _json.loads(r.read().decode())

    try:
        doc = get("/debug/profile")
        if getattr(args, "flight", None):
            fdoc = get("/debug/flight")
            # lint: allow[atomic-write] user-requested trace-export artifact, not program state
            with open(args.flight, "w", encoding="utf-8") as f:
                _json.dump(fdoc, f, indent=1)
                f.write("\n")
            print(f"flight ring written: {args.flight} "
                  f"({len(fdoc.get('traceEvents', []))} events, "
                  f"{fdoc.get('flightRecorder', {}).get('traces', 0)} "
                  "traces)")
    except urllib.error.URLError as e:
        raise FatalError(f"profile fetch failed: {e}")
    if getattr(args, "json", False):
        print(_json.dumps(doc, indent=2, sort_keys=True))
        return 0
    if not doc.get("enabled", False) and not doc.get("roots"):
        print("attribution disabled on this server "
              "(TRIVY_TPU_ATTRIB=0) or no scans observed yet")
        return 0
    print(f"scans observed: {doc.get('scans', 0)}  "
          f"(roots: {doc.get('roots', 0)}, "
          f"wall {doc.get('wall_s', 0.0):.3f}s)")
    print(f"{'lane':<16} {'busy s':>10} {'critical s':>11} {'share':>7}")
    for lane, row in (doc.get("lanes") or {}).items():
        print(f"{lane:<16} {row.get('busy_s', 0.0):>10.3f} "
              f"{row.get('crit_s', 0.0):>11.3f} "
              f"{row.get('crit_share', 0.0):>7.1%}")
    print(f"{'other':<16} {'':>10} "
          f"{doc.get('other_s', 0.0):>11.3f}")
    print(f"verdict: {doc.get('verdict', '?')}")
    flight = doc.get("flight") or {}
    slowest = flight.get("slowest") or []
    if slowest:
        print(f"flight recorder (slowest {len(slowest)} of "
              f"ring {flight.get('n')}):")
        for r in slowest:
            print(f"  {r.get('wall_s', 0.0):>9.3f}s  "
                  f"{r.get('name', ''):<14} "
                  f"dominant={r.get('dominant', '')} "
                  f"trace={r.get('trace_id', '')}")
    return 0


def _render_usage_table(tenants: dict, top: int | None) -> None:
    """Per-tenant cost-vector table, ordered by lane-seconds (the
    field closest to 'who is spending the fleet')."""
    rows = []
    for tenant, rec in tenants.items():
        f = rec.get("fields") or {}
        lane_s = sum((rec.get("lanes") or {}).values())
        rows.append((tenant, f, lane_s))
    rows.sort(key=lambda r: (-r[2], r[0]))
    if top is not None:
        rows = rows[:max(top, 0)]
    print(f"{'tenant':<20} {'scans':>7} {'sheds':>6} {'queries':>9} "
          f"{'rows':>10} {'MB in':>8} {'MB out':>8} {'lane s':>9}")
    for tenant, f, lane_s in rows:
        print(f"{tenant:<20} {f.get('scans', 0.0):>7.0f} "
              f"{f.get('sheds', 0.0):>6.0f} "
              f"{f.get('queries', 0.0):>9.0f} "
              f"{f.get('rows_matched', 0.0):>10.0f} "
              f"{f.get('wire_bytes_in', 0.0) / 1e6:>8.3f} "
              f"{f.get('wire_bytes_out', 0.0) / 1e6:>8.3f} "
              f"{lane_s:>9.3f}")


def run_usage(args) -> int:
    """`trivy-tpu usage URL[,URL2]`: render per-tenant usage metering
    (docs/observability.md "Usage metering") — one cost-vector row per
    tenant hash, fleet totals, and the lane-second conservation check.
    A comma-separated URL federates the replica set (tenant vectors
    summed — hashes are replica-independent); `--journal PATH` renders
    the last durable snapshot from a usage journal instead."""
    import json as _json
    import urllib.error
    import urllib.request

    top = getattr(args, "top", None)
    journal = getattr(args, "journal", None)
    if journal:
        from trivy_tpu_torch.obs import usage as usage_mod

        doc = usage_mod.replay_journal(journal)
        if getattr(args, "json", False):
            print(_json.dumps(doc, indent=2, sort_keys=True))
            return 0
        print(f"usage journal: {journal}")
        _render_usage_table(doc.get("tenants") or {}, top)
        return 0
    if not getattr(args, "server", None):
        raise FatalError("usage: provide a server URL or --journal PATH")

    from trivy_tpu_torch.fleet.endpoints import split_urls

    endpoints = [u if u.startswith("http") else "http://" + u
                 for u in split_urls(args.server)]
    token = getattr(args, "token", None) \
        or os.environ.get("TRIVY_TPU_PROFILE_TOKEN")
    if len(endpoints) > 1:
        from trivy_tpu_torch.fleet import telemetry as _telemetry

        doc = _telemetry.federate_usage_endpoints(endpoints, token=token)
        if getattr(args, "json", False):
            print(_json.dumps(doc, indent=2, sort_keys=True))
            return 0 if not doc.get("errors") else 1
        fleet = doc.get("fleet") or {}
        print(f"fleet usage ({len(endpoints)} replicas, "
              f"{len(fleet.get('tenants') or {})} tenants)")
        _render_usage_table(fleet.get("tenants") or {}, top)
        cons = fleet.get("conservation") or {}
        print(f"conservation: tenant lane-seconds "
              f"{cons.get('tenant_lane_s', 0.0):.3f} vs attribution "
              f"{cons.get('attrib_lane_s', 0.0):.3f} — "
              f"{'OK' if cons.get('ok') else 'VIOLATION'}")
        for ep, err in (doc.get("errors") or {}).items():
            print(f"usage fetch failed: {ep}: {err}", file=sys.stderr)
        return 0 if not doc.get("errors") and cons.get("ok", True) else 1

    base = endpoints[0].rstrip("/")
    req = urllib.request.Request(base + "/debug/usage")
    if token:
        req.add_header("Trivy-Token", token)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            doc = _json.loads(r.read().decode())
    except urllib.error.URLError as e:
        raise FatalError(f"usage fetch failed: {e}")
    if getattr(args, "json", False):
        print(_json.dumps(doc, indent=2, sort_keys=True))
        return 0
    if not doc.get("enabled", True) and not doc.get("tenants"):
        print("usage metering disabled on this server "
              "(TRIVY_TPU_USAGE=0) or no scans observed yet")
        return 0
    print(f"usage ({len(doc.get('tenants') or {})} tenants, "
          f"top-N {doc.get('top_n', 0)})")
    _render_usage_table(doc.get("tenants") or {}, top)
    cons = doc.get("conservation") or {}
    print(f"conservation: tenant lane-seconds "
          f"{cons.get('tenant_lane_s', 0.0):.3f} vs attribution "
          f"{cons.get('attrib_lane_s', 0.0):.3f} — "
          f"{'OK' if cons.get('ok') else 'VIOLATION'}")
    return 0 if cons.get("ok", True) else 1


def run_watch(args) -> int:
    """`watch`: poll for advisory-DB generation changes and re-score the
    indexed fleet incrementally on the card (`--device`; `--no-tpu`
    matches on the host), emitting introduced/resolved finding events
    as JSON lines — or tail a running server's /monitor/events ring
    with --server (no device needed)."""
    import sys

    from trivy_tpu_torch.monitor import watch as watch_mod

    _validate_fault_spec()
    interval = _parse_duration(getattr(args, "interval", None) or "60s")
    if not getattr(args, "server", None):
        # a missing card fails before any index or DB work
        _device(args)
        _mesh_spec(args)
    out = sys.stdout
    if getattr(args, "output", None):
        # the user's event stream: append-only JSONL they tail
        # lint: allow[atomic-write] user-requested event stream (--output): append-only JSONL the user tails
        out = open(args.output, "a", encoding="utf-8")
    try:
        if getattr(args, "server", None):
            return watch_mod.watch_remote(
                args.server, out, token=getattr(args, "token", None),
                interval_s=min(interval, 10.0),
                once=getattr(args, "once", False))
        from trivy_tpu_torch import monitor as monitor_mod

        if not monitor_mod.enabled():
            raise FatalError(
                "TRIVY_TPU_MONITOR=0 disables the monitor subsystem")
        db_path = _db_path(args)
        index_path = getattr(args, "index", None) or os.path.join(
            args.cache_dir, "monitor-index.jsonl")
        index = watch_mod.open_index(
            index_path, journal_path=getattr(args, "journal", None))
        try:
            return watch_mod.watch_local(
                db_path, index, lambda: new_engine(args), out,
                interval_s=interval, once=getattr(args, "once", False),
                verify=True if getattr(args, "verify", False) else None)
        finally:
            index.close()
    except KeyboardInterrupt:
        return 0
    finally:
        if out is not sys.stdout:
            out.close()


def run_convert(args) -> int:
    import json

    from trivy_tpu_torch.report.writer import write_report
    from trivy_tpu_torch.result.filter import filter_report

    with open(args.report) as f:
        doc = json.load(f)
    report = _report_from_json(doc)
    severities = _severities(args.severity)
    if severities:
        filter_report(report, severities=severities)
    write_report(report, fmt=args.format, output=args.output,
                 template=args.template, severities=severities)
    return 0


def _report_from_json(doc: dict):
    """Rebuild a Report (subset) from its JSON rendering for `convert`."""
    from trivy_tpu_torch.types import report as R
    from trivy_tpu_torch.types.artifact import OS, Layer, Package, PkgIdentifier
    from trivy_tpu_torch.types.enums import Status

    rep = R.Report(
        schema_version=doc.get("SchemaVersion", 2),
        created_at=doc.get("CreatedAt", ""),
        artifact_name=doc.get("ArtifactName", ""),
        artifact_type=doc.get("ArtifactType", ""),
    )
    md = doc.get("Metadata") or {}
    rep.metadata = R.Metadata(
        size=md.get("Size", 0),
        os=OS(family=md.get("OS", {}).get("Family", ""),
              name=md.get("OS", {}).get("Name", ""),
              eosl=md.get("OS", {}).get("EOSL", False),
              extended=md.get("OS", {}).get("Extended", False))
        if md.get("OS") else None,
        image_id=md.get("ImageID", ""),
        diff_ids=md.get("DiffIDs", []) or [],
        repo_tags=md.get("RepoTags", []) or [],
        repo_digests=md.get("RepoDigests", []) or [],
        degraded=md.get("Degraded", ""),
    )
    for rdoc in doc.get("Results") or []:
        res = R.Result(
            target=rdoc.get("Target", ""),
            result_class=rdoc.get("Class", ""),
            type=rdoc.get("Type", ""),
        )
        for v in rdoc.get("Vulnerabilities") or []:
            ident = v.get("PkgIdentifier") or {}
            res.vulnerabilities.append(R.DetectedVulnerability(
                vulnerability_id=v.get("VulnerabilityID", ""),
                vendor_ids=v.get("VendorIDs", []) or [],
                pkg_id=v.get("PkgID", ""),
                pkg_name=v.get("PkgName", ""),
                pkg_path=v.get("PkgPath", ""),
                pkg_identifier=PkgIdentifier(
                    purl=ident.get("PURL", ""), uid=ident.get("UID", "")
                ),
                installed_version=v.get("InstalledVersion", ""),
                fixed_version=v.get("FixedVersion", ""),
                status=Status.parse(v.get("Status", "unknown")),
                severity_source=v.get("SeveritySource", ""),
                primary_url=v.get("PrimaryURL", ""),
                layer=Layer(
                    digest=(v.get("Layer") or {}).get("Digest", ""),
                    diff_id=(v.get("Layer") or {}).get("DiffID", ""),
                ),
                data_source=R.DataSource(
                    id=(v.get("DataSource") or {}).get("ID", ""),
                    base_id=(v.get("DataSource") or {}).get("BaseID", ""),
                    name=(v.get("DataSource") or {}).get("Name", ""),
                    url=(v.get("DataSource") or {}).get("URL", ""),
                ) if v.get("DataSource") else None,
                info=R.VulnerabilityInfo(
                    title=v.get("Title", ""),
                    description=v.get("Description", ""),
                    severity=v.get("Severity", "UNKNOWN"),
                    cwe_ids=v.get("CweIDs", []) or [],
                    cvss=v.get("CVSS", {}) or {},
                    references=v.get("References", []) or [],
                    published_date=v.get("PublishedDate", ""),
                    last_modified_date=v.get("LastModifiedDate", ""),
                    vendor_severity=v.get("VendorSeverity", {}) or {},
                ),
            ))
        for p in rdoc.get("Packages") or []:
            ident = p.get("Identifier") or {}
            res.packages.append(Package(
                id=p.get("ID", ""), name=p.get("Name", ""),
                version=p.get("Version", ""),
                release=p.get("Release", ""),
                epoch=p.get("Epoch", 0) or 0,
                arch=p.get("Arch", ""),
                src_name=p.get("SrcName", ""),
                src_version=p.get("SrcVersion", ""),
                src_release=p.get("SrcRelease", ""),
                licenses=p.get("Licenses", []) or [],
                relationship=p.get("Relationship", ""),
                depends_on=p.get("DependsOn", []) or [],
                file_path=p.get("FilePath", ""),
                identifier=PkgIdentifier(
                    purl=ident.get("PURL", ""), uid=ident.get("UID", "")),
                layer=Layer(
                    digest=(p.get("Layer") or {}).get("Digest", ""),
                    diff_id=(p.get("Layer") or {}).get("DiffID", ""),
                ),
            ))
        for s in rdoc.get("Secrets") or []:
            res.secrets.append(R.DetectedSecret(
                rule_id=s.get("RuleID", ""), category=s.get("Category", ""),
                severity=s.get("Severity", "UNKNOWN"),
                title=s.get("Title", ""), start_line=s.get("StartLine", 0),
                end_line=s.get("EndLine", 0), match=s.get("Match", ""),
            ))
        for m in rdoc.get("Misconfigurations") or []:
            res.misconfigurations.append(R.DetectedMisconfiguration(
                type=m.get("Type", ""), id=m.get("ID", ""),
                avd_id=m.get("AVDID", ""), title=m.get("Title", ""),
                description=m.get("Description", ""),
                message=m.get("Message", ""), namespace=m.get("Namespace", ""),
                resolution=m.get("Resolution", ""),
                severity=m.get("Severity", "UNKNOWN"),
                primary_url=m.get("PrimaryURL", ""),
                references=m.get("References", []) or [],
                status=m.get("Status", ""),
            ))
        if rdoc.get("MisconfSummary"):
            res.misconf_summary = R.MisconfSummary(
                successes=rdoc["MisconfSummary"].get("Successes", 0),
                failures=rdoc["MisconfSummary"].get("Failures", 0),
            )
        rep.results.append(res)
    return rep


def run_db(args) -> int:
    from trivy_tpu_torch.db.store import AdvisoryDB

    if args.db_command == "import":
        if os.path.isdir(args.source):
            db = AdvisoryDB.load(args.source)
        else:
            from trivy_tpu_torch.db.trivydb import try_load

            # a real trivy-db boltdb artifact imports directly
            db = try_load(args.source) or _import_json(args.source)
        path = _db_path(args)
        db.save(path)
        # an explicit import is the new truth: drop the last-good link
        # a previous `db download` left, or every reader would resolve
        # through it and silently keep serving the old generation
        from trivy_tpu_torch.db import generations as _gens

        lg = _gens.last_good_path(path)
        if os.path.islink(lg):
            os.unlink(lg)
            _log.info("imported DB supersedes downloaded generation; "
                      "last-good link removed", path=path)
        _log.info("imported advisory DB", path=path, **db.stats())
        return 0
    if args.db_command == "stats":
        path = _db_path(args)
        db = AdvisoryDB.load(path)
        import json as _json

        print(_json.dumps(db.stats(), indent=2))
        return 0
    if args.db_command == "download":
        from trivy_tpu_torch.db.oci import (
            DB_MEDIA_TYPE,
            OCIError,
            install_artifact,
        )

        dest = _db_path(args)
        try:
            # crash-safe generation install: verified blob, staged
            # extraction, atomic last-good promotion
            gen = install_artifact(
                args.db_repository, dest, media_type=DB_MEDIA_TYPE,
                insecure=getattr(args, "insecure", False))
        except OCIError as e:
            raise FatalError(str(e))
        _log.info("advisory DB downloaded", path=dest, generation=gen)
        return 0
    if args.db_command == "import-java":
        import gzip
        import json as _json

        from trivy_tpu_torch.db import javadb

        jdb = javadb.JavaDB.create(javadb.default_path(args.cache_dir))
        opener = gzip.open if args.source.endswith(".gz") else open
        with opener(args.source, "rb") as f:
            entries = (_json.loads(line) for line in f if line.strip())
            n = jdb.import_entries(entries)
        jdb.write_metadata()
        jdb.close()
        _log.info("imported java DB", entries=n)
        return 0
    raise FatalError(
        "usage: trivy-tpu-torch db {import,import-java,stats,download}")


def _import_json(path: str):
    """Import a flat JSON advisory dump: {"buckets": {...}, "vulnerability":
    {...}} (same shape the store persists)."""
    import gzip
    import json

    from trivy_tpu_torch.db.model import Advisory, VulnerabilityMeta
    from trivy_tpu_torch.db.store import AdvisoryDB

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        blob = json.loads(f.read())
    db = AdvisoryDB()
    for bucket, pkgs in blob.get("buckets", {}).items():
        for name, advs in pkgs.items():
            for a in advs:
                db.put_advisory(bucket, name, Advisory.from_json(a))
    for vid, m in blob.get("vulnerability", {}).items():
        db.put_meta(VulnerabilityMeta.from_json(vid, m))
    return db


def run_clean(args) -> int:
    """`clean` (reference pkg/commands/clean): selective cache removal."""
    import shutil

    if args.all:
        shutil.rmtree(args.cache_dir, ignore_errors=True)
        _log.info("removed cache", path=args.cache_dir)
        return 0
    selected = False
    if getattr(args, "vuln_db", False):
        shutil.rmtree(os.path.join(args.cache_dir, "db"), ignore_errors=True)
        _log.info("removed advisory DB")
        selected = True
    if getattr(args, "java_db", False):
        shutil.rmtree(os.path.join(args.cache_dir, "javadb"),
                      ignore_errors=True)
        _log.info("removed java DB")
        selected = True
    if getattr(args, "scan_cache", False) or not selected:
        shutil.rmtree(os.path.join(args.cache_dir, "fanal"),
                      ignore_errors=True)
        _log.info("removed scan cache")
    return 0


def run_registry(args) -> int:
    """`registry login|logout` (reference pkg/commands/auth): credentials
    are stored docker-config style so the registry client
    (artifact.image_source._docker_config_auth) picks them up."""
    import base64
    import json as _json

    sub = getattr(args, "registry_command", None)
    cfg_dir = os.environ.get("DOCKER_CONFIG",
                             os.path.expanduser("~/.docker"))
    cfg_path = os.path.join(cfg_dir, "config.json")
    try:
        with open(cfg_path, "rb") as f:
            cfg = _json.load(f)
    except (OSError, ValueError):
        cfg = {}
    auths = cfg.setdefault("auths", {})

    if sub == "login":
        password = args.password
        if password is None or getattr(args, "password_stdin", False):
            password = sys.stdin.readline().rstrip("\n")
        if not password:
            raise FatalError("no password provided (use --password or pipe "
                             "it to stdin with --password-stdin)")
        raw = f"{args.username}:{password}".encode()
        auths[args.server] = {"auth": base64.b64encode(raw).decode()}
        os.makedirs(cfg_dir, exist_ok=True)
        fd = os.open(cfg_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            _json.dump(cfg, f, indent=2)
        _log.info("logged in", registry=args.server)
        return 0
    if sub == "logout":
        if auths.pop(args.server, None) is None:
            _log.warn("not logged in", registry=args.server)
            return 0
        # same 0600 idiom as login: credentials must never be group-readable
        fd = os.open(cfg_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            _json.dump(cfg, f, indent=2)
        _log.info("logged out", registry=args.server)
        return 0
    raise FatalError("usage: registry {login|logout} <server>")


def run_plugin(args) -> int:
    """`plugin install|uninstall|list|info|run` (reference pkg/plugin)."""
    from trivy_tpu_torch.plugin import PluginError, PluginManager

    mgr = PluginManager(args.cache_dir)
    sub = getattr(args, "plugin_command", None)
    try:
        if sub == "install":
            p = mgr.install(args.source)
            print(f"installed {p.name} {p.version}".rstrip())
            return 0
        if sub == "uninstall":
            if not mgr.uninstall(args.name):
                raise FatalError(f"plugin {args.name!r} is not installed")
            return 0
        if sub == "list":
            for p in mgr.list():
                print(f"{p.name}\t{p.version}\t{p.summary}")
            return 0
        if sub == "info":
            p = mgr.get(args.name)
            if p is None:
                raise FatalError(f"plugin {args.name!r} is not installed")
            print(f"name: {p.name}\nversion: {p.version}\n"
                  f"summary: {p.summary}\ndescription: {p.description}")
            return 0
        if sub == "run":
            return mgr.run(args.name, list(args.plugin_args))
    except PluginError as e:
        raise FatalError(str(e))
    raise FatalError("usage: plugin {install|uninstall|list|info|run}")


def run_module(args) -> int:
    """`module install|uninstall|list` (reference pkg/module manager):
    modules are .py files under <cache>/modules loaded at scan time."""
    import shutil

    mod_dir = os.path.join(args.cache_dir, "modules")
    sub = getattr(args, "module_command", None)
    if sub == "install":
        if not args.source.endswith(".py") or not os.path.exists(args.source):
            raise FatalError(f"module source must be an existing .py file: "
                             f"{args.source}")
        os.makedirs(mod_dir, exist_ok=True)
        dest = os.path.join(mod_dir, os.path.basename(args.source))
        shutil.copyfile(args.source, dest)
        from trivy_tpu_torch.module.manager import ModuleManager

        ModuleManager.record_trust(mod_dir, os.path.basename(dest))
        _log.info("installed module", path=dest)
        return 0
    if sub == "uninstall":
        name = args.name if args.name.endswith(".py") else args.name + ".py"
        path = os.path.join(mod_dir, name)
        if not os.path.exists(path):
            raise FatalError(f"module {args.name!r} is not installed")
        os.unlink(path)
        from trivy_tpu_torch.module.manager import ModuleManager

        ModuleManager.revoke_trust(mod_dir, name)
        return 0
    if sub == "list":
        if os.path.isdir(mod_dir):
            for f in sorted(os.listdir(mod_dir)):
                if f.endswith(".py"):
                    print(f)
        return 0
    raise FatalError("usage: module {install|uninstall|list}")


def run_chaos(args) -> int:
    """`chaos run|replay`: seeded multi-fault schedules against live
    mini-system scenarios, five invariant oracles per episode,
    machine-checked (site, action) coverage, auto-shrinking repros. The
    scenarios' device paths run on `--device` (``cuda:0`` by default;
    without a card and without `--device cpu` the command fails here)."""
    import json as _json

    from trivy_tpu_torch.chaos import campaign
    from trivy_tpu_torch.device import resolve_device

    try:
        device = resolve_device(getattr(args, "device", None))
    except (RuntimeError, ValueError) as exc:
        raise FatalError(f"--device: {exc}")

    cmd = getattr(args, "chaos_command", None)
    budget = getattr(args, "budget", None)
    budget_s = budget if budget is not None else \
        campaign.default_budget_s()
    strict = bool(getattr(args, "strict", False))

    if cmd == "replay":
        try:
            res = campaign.replay(args.spec, args.scenario,
                                  budget_s=budget_s, strict=strict,
                                  device=device)
        except campaign.ChaosError as e:
            raise FatalError(f"chaos replay: {e}")
        print(_json.dumps(res.to_dict(), indent=2, sort_keys=True))
        if res.ok:
            _log.info("replay held all invariants", spec=args.spec,
                      scenario=args.scenario)
            return 0
        _log.error("replay reproduced the failure", spec=args.spec,
                   failures=res.failures)
        return 1

    if cmd == "run":
        seed = getattr(args, "seed", None)
        seed = seed if seed is not None else campaign.default_seed()
        episodes = getattr(args, "episodes", None)
        episodes = episodes if episodes is not None else \
            campaign.default_episodes()
        names = None
        if getattr(args, "scenarios", None):
            names = [s.strip() for s in args.scenarios.split(",")
                     if s.strip()]
            unknown = [n for n in names
                       if n not in campaign.SCENARIOS]
            if unknown:
                raise FatalError(
                    f"chaos: unknown scenario(s) {unknown!r}; "
                    f"known: {sorted(campaign.SCENARIOS)}")
        try:
            rep = campaign.run_campaign(
                seed=seed, n_episodes=episodes, scenario_names=names,
                budget_s=budget_s, strict=strict,
                log=lambda m: _log.info(m), device=device)
        except campaign.ChaosError as e:
            raise FatalError(f"chaos run: {e}")
        out = getattr(args, "report_json", None)
        if out:
            from trivy_tpu_torch.durability.atomic import atomic_write

            body = _json.dumps(rep.to_dict(), indent=2,
                               sort_keys=True).encode()
            atomic_write(out, body, fault_site="report.write")
        for repro in rep.repros:
            print(f"repro [{repro.scenario}] {repro.env_line()}",
                  file=sys.stderr)
        print(f"chaos: {len(rep.results)} episodes, "
              f"{len(rep.failures)} failing, "
              f"coverage {rep.coverage:.3f}"
              + (f", excluded {sorted(rep.excluded)}"
                 if rep.excluded else ""))
        return 0 if rep.ok else 1

    raise FatalError("usage: chaos {run|replay}")
