"""Standalone (local) scan driver (reference pkg/scanner/local/scan.go):
applier squash -> per-class scans -> metadata fill -> post-scan hooks.
The vulnerability matching inside runs on the card via MatchEngine.

Copy of trivy_tpu/scanner/local.py. In server mode the detect phase
goes through the cross-request match scheduler; under a monitor capture
scope the engine handle records the scan's queries and finding keys for
the monitor index; the ambient deadline budget is checked between
phases. `stats` keeps the seconds of the last scan's phases (the rekor
SBOM discovery of `--sbom-sources rekor` counts with the apply phase).
"""

from __future__ import annotations

import time

from trivy_tpu_torch import vulnerability
from trivy_tpu_torch.detector import langpkg, ospkg
from trivy_tpu_torch.detector.engine import MatchEngine
from trivy_tpu_torch.detector.langpkg import PKG_TARGETS
from trivy_tpu_torch.fanal.applier import apply_layers
from trivy_tpu_torch.types.artifact import ArtifactDetail, BlobInfo
from trivy_tpu_torch.types.enums import ResultClass, Scanner as ScannerEnum
from trivy_tpu_torch.types.report import DetectedSecret, Result
from trivy_tpu_torch.types.scan import ScanOptions
from trivy_tpu_torch.types.serde import from_dict


class LocalDriver:
    def __init__(self, engine: MatchEngine, cache, scheduler=None):
        self.engine = engine
        self.cache = cache
        # server mode attaches the cross-request match scheduler so the
        # detect phase joins shared device micro-batches instead of
        # dispatching privately (trivy_tpu_torch/sched); None = direct
        self.scheduler = scheduler
        # seconds of the last scan: blob reads + squash, detection
        self.stats: dict = {}

    def _match_engine(self):
        """Engine handle for the detect phase: with a scheduler
        attached, detect() routes through its coalesced micro-batches —
        byte-identical results, one saturated dispatch lane. Everything
        else (db, cdb, advisories) reads through to the real engine.
        Under an active monitor capture scope the handle additionally
        records query inventory + finding keys for the package→artifact
        index (trivy_tpu_torch/monitor; no-op wrapper otherwise)."""
        from trivy_tpu_torch.monitor.capture import tap

        if self.scheduler is None:
            return tap(self.engine)
        from trivy_tpu_torch.sched.scheduler import SchedEngine

        return tap(SchedEngine(self.engine, self.scheduler))

    def scan(self, target, artifact_key, blob_keys, options: ScanOptions):
        from trivy_tpu_torch.resilience.retry import checkpoint
        from trivy_tpu_torch.scanner import post

        # phase-boundary deadline checkpoints: under an ambient deadline
        # budget (server header / --scan-timeout) a scan that cannot
        # finish sheds promptly between phases instead of burning device
        # time nobody will wait for
        from trivy_tpu_torch import obs
        from trivy_tpu_torch.obs import tracing as trace

        checkpoint("apply_layers")
        t0 = time.perf_counter()
        # blob reads + squash are the "cache" phase of the latency
        # histogram; the span keeps its historical name
        with obs.phase("apply_layers", phase="cache"):
            detail = self._apply_layers(blob_keys)
            self._merge_artifact_info(detail, artifact_key)
            trace.add_meta(pkgs=len(detail.packages),
                           apps=len(detail.applications))
        if not options.include_dev_deps:
            # development dependencies are excluded unless requested
            # (reference pkg/scanner/local/scan.go:438 excludeDevDeps)
            for app in detail.applications:
                if any(getattr(p, "dev", False) for p in app.packages):
                    app.packages = [p for p in app.packages
                                    if not getattr(p, "dev", False)]
        if "rekor" in (options.sbom_sources or []):
            from trivy_tpu_torch.fanal.unpackaged import discover_sboms

            checkpoint("rekor_sbom_discovery")
            with trace.span("rekor_sbom_discovery"):
                discover_sboms(detail, options.rekor_url)
        checkpoint("detect")
        t1 = time.perf_counter()
        with obs.phase("detect"):
            results = self._scan_detail(target, detail, options)
        t2 = time.perf_counter()
        self.stats = {"apply_s": t1 - t0, "detect_s": t2 - t1}
        checkpoint("post_hooks")
        with trace.span("post_hooks"):
            # globally registered hooks (reference
            # pkg/scanner/local/scan.go:152 -> post/post_scan.go:35)
            results = post.scan(results, options)
        return results, detail.os

    def _merge_artifact_info(self, detail: ArtifactDetail,
                             artifact_key: str) -> None:
        """Merge image-config analysis (env secrets, apk-history
        packages) into the squashed detail (reference applier
        ApplyLayers consumes ArtifactInfo alongside the blobs)."""
        if not artifact_key:
            return
        raw = self.cache.get_artifact(artifact_key)
        if not raw:
            return
        from trivy_tpu_torch.types.artifact import ArtifactInfo

        info = from_dict(ArtifactInfo, raw)
        detail.image_config = info
        if info.secret is not None and info.secret.findings:
            detail.secrets.append(info.secret)

    # ------------------------------------------------------------ layers

    def _apply_layers(self, blob_keys: list[str]) -> ArtifactDetail:
        blobs = []
        for key in blob_keys:
            raw = self.cache.get_blob(key)
            if not raw:
                raise RuntimeError(f"missing blob in cache: {key}")
            blob = from_dict(BlobInfo, raw)
            blob.diff_id = blob.diff_id or key
            blobs.append(blob)
        return apply_layers(blobs)

    # ------------------------------------------------------------ scans

    def _scan_detail(
        self, target: str, detail: ArtifactDetail, options: ScanOptions
    ) -> list[Result]:
        results: list[Result] = []
        if ScannerEnum.VULN in options.scanners:
            results.extend(self._scan_vulns(target, detail, options))
        if ScannerEnum.SECRET in options.scanners:
            from trivy_tpu_torch import obs

            with obs.phase("secret_results", phase="secret"):
                results.extend(self._secret_results(detail))
        if ScannerEnum.LICENSE in options.scanners:
            results.extend(self._license_results(detail, options))
        results.extend(self._misconfig_results(detail))
        return results

    def _scan_vulns(
        self, target: str, detail: ArtifactDetail, options: ScanOptions
    ) -> list[Result]:
        results: list[Result] = []
        include_os = "os" in options.pkg_types
        include_lib = "library" in options.pkg_types
        engine = self._match_engine()

        if include_os and (detail.os.detected or detail.packages):
            vulns, eosl = ([], False)
            if detail.os.detected and detail.packages:
                vulns, eosl = ospkg.detect(
                    engine, detail.os, detail.repository, detail.packages
                )
                detail.os.eosl = eosl
            vulnerability.fill_info(self.engine.db, vulns)
            res = Result(
                target=f"{target} ({detail.os.family} {detail.os.name})"
                if detail.os.detected else target,
                result_class=ResultClass.OS_PKGS,
                type=detail.os.family,
                vulnerabilities=sorted(vulns, key=lambda v: v.sort_key()),
            )
            # packages always travel with the result; the runner strips
            # them at render time unless --list-all-pkgs (reference
            # behavior). Result ROWS still appear only for findings /
            # detected OS / explicit package listing.
            res.packages = detail.packages
            if res.vulnerabilities or detail.os.detected \
                    or options.list_all_pkgs:
                results.append(res)

        if include_lib:
            for app in detail.applications:
                if not app.packages:
                    continue
                vulns = langpkg.detect_app(engine, app)
                vulnerability.fill_info(self.engine.db, vulns)
                res = Result(
                    target=app.file_path
                    or PKG_TARGETS.get(app.type, app.type),
                    result_class=ResultClass.LANG_PKGS,
                    type=app.type,
                    vulnerabilities=sorted(vulns, key=lambda v: v.sort_key()),
                )
                res.packages = app.packages
                if res.vulnerabilities or options.list_all_pkgs:
                    results.append(res)
        return results

    def _secret_results(self, detail: ArtifactDetail) -> list[Result]:
        results = []
        for secret in sorted(detail.secrets, key=lambda s: s.file_path):
            results.append(Result(
                target=secret.file_path,
                result_class=ResultClass.SECRET,
                secrets=[
                    DetectedSecret(
                        rule_id=f.rule_id, category=f.category,
                        severity=f.severity, title=f.title,
                        start_line=f.start_line, end_line=f.end_line,
                        match=f.match, layer=f.layer,
                    )
                    for f in secret.findings
                ],
            ))
        return results

    def _license_results(
        self, detail: ArtifactDetail, options: ScanOptions
    ) -> list[Result]:
        from trivy_tpu_torch.licensing.scanner import scan_licenses

        return scan_licenses(detail, options)

    def _misconfig_results(self, detail: ArtifactDetail) -> list[Result]:
        from trivy_tpu_torch.misconf.result import to_result

        results = []
        for misconf in sorted(
            detail.misconfigurations, key=lambda m: m.file_path
        ):
            res = to_result(misconf)
            if res is not None:
                results.append(res)
        return results
