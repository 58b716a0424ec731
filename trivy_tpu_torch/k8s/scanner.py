"""Cluster scan orchestration (reference pkg/k8s/scanner/scanner.go:
parallel pipeline over cluster artifacts; vuln scan per workload image,
misconfig scan per resource, RBAC + infra assessments merged into one
cluster report).

Copy of trivy_tpu/k8s/scanner.py. An image scan runs the match kernel
(the engine's device) and the secret screens (the secret analyzer's
device). Where the reference logs any failed image scan and leaves the
image out of the report, the port does so only for a failure that is
not the device's: a device error (`device.is_device_error`: a CUDA
error, a kernel that cannot build or launch, a failed upload) ends the
scan, so a broken kernel never yields a report without its images.
`STATS` keeps the seconds of the last scan's steps."""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import yaml

from trivy_tpu_torch.device import is_device_error
from trivy_tpu_torch.k8s.artifacts import (
    RBAC_KINDS,
    WORKLOAD_KINDS,
    KubeResource,
    load_cluster,
    load_manifests,
)
from trivy_tpu_torch.k8s.infra import InfraFinding, assess_infra
from trivy_tpu_torch.k8s.rbac import RbacFinding, assess_rbac
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.utils.pipeline import PipelineError, run_pipeline

_log = logger("k8s")

# seconds of the last scan's steps: enumerate (parse or list), misconfig,
# rbac_infra (the node collector included), images
STATS: dict = {}


@dataclass
class ResourceResult:
    resource: KubeResource = None
    misconfigurations: list = field(default_factory=list)  # Detected...
    images: list[str] = field(default_factory=list)
    # vulnerability results per image (populated when the image is
    # resolvable locally, e.g. an image-tar directory is given)
    image_reports: list = field(default_factory=list)


@dataclass
class ClusterReport:
    cluster_name: str = ""
    resources: list[ResourceResult] = field(default_factory=list)
    rbac: list[RbacFinding] = field(default_factory=list)
    infra: list[InfraFinding] = field(default_factory=list)


class ClusterScanner:
    """scan(target): target is a manifests dir/file or 'cluster' for a
    live kubeconfig-backed cluster."""

    def __init__(self, scanners: set[str] | None = None, workers: int = 5,
                 image_tar_dir: str | None = None, engine=None,
                 disable_node_collector: bool = False,
                 node_collector_namespace: str | None = None,
                 node_collector_image: str | None = None,
                 kube_client_factory=None):
        self.scanners = scanners or {"misconfig", "rbac", "infra"}
        self.workers = workers
        self.image_tar_dir = image_tar_dir
        self.engine = engine  # MatchEngine for image vuln scans
        self.disable_node_collector = disable_node_collector
        self.node_collector_namespace = node_collector_namespace
        self.node_collector_image = node_collector_image
        # injectable for tests; defaults to KubeClient(context=...)
        self.kube_client_factory = kube_client_factory

    def scan(self, target: str, context: str = "",
             namespace: str = "") -> ClusterReport:
        STATS.clear()
        t0 = time.perf_counter()
        if target == "cluster":
            resources = load_cluster(context=context, namespace=namespace)
            name = context or "cluster"
        else:
            resources = load_manifests(target)
            name = os.path.basename(os.path.abspath(target))
        t1 = time.perf_counter()
        STATS["enumerate_s"] = t1 - t0
        report = ClusterReport(cluster_name=name)
        workloads = [r for r in resources if r.kind in WORKLOAD_KINDS]
        others = [r for r in resources if r.kind not in WORKLOAD_KINDS]

        scannable = workloads + [
            r for r in others if r.kind not in RBAC_KINDS]
        if "misconfig" in self.scanners:
            report.resources = run_pipeline(
                scannable, self._scan_resource, workers=self.workers)
            report.resources = [r for r in report.resources
                                if r is not None]
        elif "vuln" in self.scanners:
            # vuln-only scans still need the workload rows to find images
            report.resources = [
                ResourceResult(resource=r, images=r.images)
                for r in scannable if r.images]
        t2 = time.perf_counter()
        STATS["misconfig_s"] = t2 - t1
        if "rbac" in self.scanners:
            report.rbac = assess_rbac(resources)
        if "infra" in self.scanners:
            report.infra = assess_infra(resources)
            report.infra.extend(self._node_findings(resources, target,
                                                    context))
        t3 = time.perf_counter()
        STATS["rbac_infra_s"] = t3 - t2
        if "vuln" in self.scanners and self.image_tar_dir:
            self._scan_images(report)
        STATS["images_s"] = time.perf_counter() - t3
        return report

    def _node_findings(self, resources: list[KubeResource], target: str,
                       context: str) -> list[InfraFinding]:
        """Node-level KCV findings: NodeInfo documents found among the
        scanned manifests (out-of-band collector runs) are assessed
        directly; live cluster scans additionally dispatch the
        node-collector Job per node unless disabled."""
        from trivy_tpu_torch.k8s.node_collector import (
            assess_node_info,
            collect_node_info,
        )

        out: list[InfraFinding] = []
        for res in resources:
            if res.kind == "NodeInfo":
                out.extend(assess_node_info(res.raw))
        if target != "cluster" or self.disable_node_collector:
            return out
        try:
            if self.kube_client_factory is not None:
                client = self.kube_client_factory()
            else:
                from trivy_tpu_torch.k8s.client import KubeClient

                client = KubeClient(context=context)
            nodes = [n["metadata"]["name"] for n in client.list("Node")]
        except Exception as e:
            _log.warn("node-collector skipped", err=str(e))
            return out
        kwargs = {}
        if self.node_collector_namespace:
            kwargs["namespace"] = self.node_collector_namespace
        if self.node_collector_image:
            kwargs["image"] = self.node_collector_image

        def collect_one(node: str):
            doc = collect_node_info(client, node, **kwargs)
            return assess_node_info(doc) if doc else []

        for findings in run_pipeline(nodes, collect_one,
                                     workers=self.workers):
            out.extend(findings)
        return out

    # ------------------------------------------------------------ steps

    def _scan_resource(self, res: KubeResource) -> ResourceResult | None:
        from trivy_tpu_torch.misconf.scanner import scan_config

        content = yaml.safe_dump(res.raw, sort_keys=False).encode()
        misconf = scan_config(res.fullname + ".yaml", content,
                              file_type="kubernetes")
        rr = ResourceResult(resource=res, images=res.images)
        if misconf is not None:
            rr.misconfigurations = misconf.failures
        elif not rr.images and res.kind not in WORKLOAD_KINDS:
            return None  # nothing checkable and nothing to report
        return rr

    def _scan_images(self, report: ClusterReport) -> None:
        """Scan workload images resolvable as local tars: an image
        `repo/name:tag` matches <image_tar_dir>/<name>_<tag>.tar or
        <name>.tar (registry pulls are the online path)."""
        distinct = sorted({img for rr in report.resources
                           for img in rr.images})

        def scan_one(img: str):
            tar = self._find_tar(img)
            if tar is None:
                return img, None
            try:
                return img, self._scan_image_tar(tar)
            except Exception as e:
                if is_device_error(e):
                    raise
                _log.warn("image scan failed", image=img, err=str(e))
                return img, None

        try:
            seen = dict(run_pipeline(distinct, scan_one,
                                     workers=self.workers))
        except PipelineError as e:
            # scan_one passes up a device error (or a kill) alone: the
            # first ends the scan
            raise e.failures[0][1] from None
        for rr in report.resources:
            for img in rr.images:
                rep = seen.get(img)
                if rep is not None:
                    rr.image_reports.append((img, rep))

    def _scan_image_tar(self, tar_path: str):
        from trivy_tpu_torch.artifact.image import ImageArtifact
        from trivy_tpu_torch.cache.cache import MemoryCache
        from trivy_tpu_torch.scanner.local import LocalDriver
        from trivy_tpu_torch.scanner.scan import Scanner
        from trivy_tpu_torch.types.scan import ScanOptions

        cache = MemoryCache()
        artifact = ImageArtifact(tar_path, cache, from_tar=True,
                                 parallel=self.workers)
        driver = LocalDriver(self.engine, cache)
        return Scanner(driver, artifact).scan_artifact(ScanOptions())

    def _find_tar(self, image: str) -> str | None:
        if not self.image_tar_dir:
            return None
        name = image.rsplit("/", 1)[-1]
        exact = os.path.join(self.image_tar_dir,
                             name.replace(":", "_") + ".tar")
        if os.path.exists(exact):
            return exact
        # tag-less fallback only when the workload itself pins no tag
        # (or the default "latest") — a versioned ref must match exactly,
        # otherwise we would attribute the wrong image's findings to it
        tag = name.split(":", 1)[1] if ":" in name else ""
        if tag in ("", "latest"):
            p = os.path.join(self.image_tar_dir,
                             name.split(":")[0] + ".tar")
            if os.path.exists(p):
                return p
        return None
