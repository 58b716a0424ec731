"""Container-image artifact (reference pkg/fanal/artifact/image/image.go):
diffID-keyed cache lookups, per-layer walk+analyze, image-config analysis.

Image sources (reference pkg/fanal/image/image.go:17-58 tries containerd ->
docker -> podman -> remote registry): here the tar-archive path
(docker save / OCI layout) is first-class; daemon/registry clients plug in
behind the same interface when available.

Copy of trivy_tpu/artifact/image.py, with the fleet journal hook of
`fanal/pipeline.py`. Two changes: the image config's secret
scan builds its scanner for the device the CLI resolved
(`secret_analyzer.DEVICE`), and `stats` keeps the seconds of the last
inspect, summed over the walk lanes under a lock: the layer split with
the per-file analyzers (`walk_s`), the post-analyzers
(`post_analyze_s`), within those the secret analyzer's scans
(`secret_s`) and what they added to its scanner's `device_stats`, the
hybrid probe's verdict, and the pipeline's layer counts.
"""

from __future__ import annotations

import dataclasses
import gzip
import hashlib
import io
import json
import os
import re
import tarfile
import threading
import time

from trivy_tpu_torch.artifact.base import ArtifactReference
from trivy_tpu_torch.cache.cache import cache_key
from trivy_tpu_torch.fanal import analyzers  # noqa: F401
from trivy_tpu_torch.fanal import pipeline
from trivy_tpu_torch.fanal.analyzer import AnalysisResult, AnalyzerGroup
from trivy_tpu_torch.fanal.handlers import system_file_filter
from trivy_tpu_torch.fanal.walker import walk_layer_tar
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import tracing
from trivy_tpu_torch.secret.scanner import hybrid_probe_state
from trivy_tpu_torch.types.artifact import ArtifactInfo, Package, Secret

_log = logger("image")


class ImageError(Exception):
    pass


def _sha256(data: bytes) -> str:
    return "sha256:" + hashlib.sha256(data).hexdigest()


def _maybe_gunzip(data: bytes) -> bytes:
    if data[:2] == b"\x1f\x8b":
        return gzip.decompress(data)
    return data


class TarImage:
    """docker-save or OCI-layout tar archive."""

    def __init__(self, path: str):
        self.path = path
        try:
            self._tf = tarfile.open(path)
        except tarfile.TarError as e:
            raise ImageError(f"cannot read image archive {path}: {e}") from e
        self._names = set(self._tf.getnames())
        self.config: dict = {}
        self.config_digest = ""
        self.layer_names: list[str] = []  # in-archive layer file names
        self.name = os.path.basename(path)
        self._load()

    def _read(self, name: str) -> bytes:
        f = self._tf.extractfile(name)
        if f is None:
            raise ImageError(f"missing member {name}")
        return f.read()

    def _load(self) -> None:
        if "manifest.json" in self._names:  # docker save format
            manifest = json.loads(self._read("manifest.json"))[0]
            cfg_name = manifest["Config"]
            cfg_raw = self._read(cfg_name)
            self.config = json.loads(cfg_raw)
            self.config_digest = _sha256(cfg_raw)
            self.layer_names = manifest["Layers"]
            tags = manifest.get("RepoTags") or []
            if tags:
                self.name = tags[0]
            return
        if "index.json" in self._names:  # OCI layout
            index = json.loads(self._read("index.json"))
            mdesc = index["manifests"][0]
            manifest = json.loads(self._read(self._blob_path(mdesc["digest"])))
            cfg_digest = manifest["config"]["digest"]
            cfg_raw = self._read(self._blob_path(cfg_digest))
            self.config = json.loads(cfg_raw)
            self.config_digest = cfg_digest
            self.layer_names = [
                self._blob_path(l["digest"]) for l in manifest["layers"]
            ]
            ref = (mdesc.get("annotations") or {}).get(
                "org.opencontainers.image.ref.name"
            )
            if ref:
                self.name = ref
            return
        raise ImageError(f"not a docker-save/OCI tar: {self.path}")

    @staticmethod
    def _blob_path(digest: str) -> str:
        algo, _, hexd = digest.partition(":")
        return f"blobs/{algo}/{hexd}"

    def diff_ids(self) -> list[str]:
        return list((self.config.get("rootfs") or {}).get("diff_ids") or [])

    def layer_bytes(self, i: int) -> bytes:
        return _maybe_gunzip(self._read(self.layer_names[i]))

    def layer_stream(self, i: int) -> io.BytesIO:
        """Layer i as a readable stream of the (possibly still gzipped)
        member bytes — walk_layer_tar's stream mode gunzips on the fly,
        so the full decompressed copy `layer_bytes` materializes never
        exists; peak RSS is the compressed member plus one tar entry."""
        return io.BytesIO(self._read(self.layer_names[i]))

    def close(self) -> None:
        self._tf.close()


class ImageArtifact:
    def __init__(
        self,
        target: str,
        cache,
        from_tar: bool = False,
        parallel: int = 5,
        disabled_analyzers: set[str] | None = None,
        secret_config: str | None = None,
        file_patterns: list[str] | None = None,
        image_sources: tuple[str, ...] = ("docker", "podman", "remote"),
        insecure: bool = False,
        username: str = "",
        password: str = "",
        helm_overrides: dict | None = None,
    ):
        self.target = target
        self.cache = cache
        self.from_tar = from_tar or os.path.exists(target)
        self.parallel = parallel
        self.disabled = set(disabled_analyzers or set())
        self.secret_config = secret_config
        self.file_patterns = file_patterns or []
        self.helm_overrides = helm_overrides
        self.image_sources = image_sources
        self.insecure = insecure
        self.username = username
        self.password = password
        # populated by the pipelined path: layers/analyzed/deduped/
        # inflight_waits/journal_replayed/workers/occupancy for this scan
        self.last_analysis_stats: dict = {}
        self.stats: dict = {}
        self._stats_lock = threading.Lock()

    def _group(self) -> AnalyzerGroup:
        group = AnalyzerGroup.build(disabled_types=self.disabled,
                                    file_patterns=self.file_patterns,
                                    helm_overrides=self.helm_overrides)
        for a in group.analyzers + group.post_analyzers:
            if a.type == "secret" and self.secret_config:
                a.configure(self.secret_config)
        return group

    def _add_stats(self, **seconds) -> None:
        """Sum one lane's seconds (and the secret scan's device stats)
        into this scan's `stats`; lanes call it concurrently."""
        added = seconds.pop("secret_device_stats", None)
        with self._stats_lock:
            for k, v in seconds.items():
                self.stats[k] = self.stats.get(k, 0.0) + v
            if added:
                total = self.stats.setdefault("secret_device_stats", {})
                for k, v in added.items():
                    total[k] = total.get(k, 0) + v

    def inspect(self) -> ArtifactReference:
        t0 = time.perf_counter()
        self.stats = {"walk_s": 0.0, "post_analyze_s": 0.0}
        if self.from_tar:
            img = TarImage(self.target)
        else:
            # daemon/registry fallback chain
            # (reference pkg/fanal/image/image.go:26-58)
            from trivy_tpu_torch.artifact.image_source import (
                SourceError,
                resolve_image,
            )

            try:
                img = resolve_image(
                    self.target, sources=self.image_sources,
                    insecure=self.insecure,
                    username=self.username, password=self.password)
            except SourceError as e:
                raise ImageError(str(e)) from e
        try:
            return self._inspect_image(img)
        finally:
            img.close()
            self.stats.update(inspect_s=time.perf_counter() - t0,
                              analysis=dict(self.last_analysis_stats))

    def _inspect_image(self, img) -> ArtifactReference:
        group = self._group()
        versions = group.versions()
        diff_ids = img.diff_ids()
        # cache keys: diffID x analyzer versions (reference image.go:169)
        blob_ids = [
            cache_key(d, analyzer_versions=versions,
                      patterns=self.file_patterns) for d in diff_ids
        ]
        artifact_id = cache_key(img.config_digest, analyzer_versions=versions,
                                patterns=self.file_patterns)

        missing_artifact, missing_blobs = self.cache.missing_blobs(
            artifact_id, blob_ids
        )
        missing_set = set(missing_blobs)
        # base layers (guessed from history) skip secret scanning: their
        # secrets are the base image author's, not this image's
        # (reference image.go:527 guessBaseLayers)
        base_diff_ids = set(_guess_base_diff_ids(
            diff_ids, img.config.get("history") or []))
        # built up front: lanes ask for it concurrently
        no_secret_group = AnalyzerGroup.build(
            disabled_types=self.disabled | {"secret"},
            file_patterns=self.file_patterns,
            helm_overrides=self.helm_overrides) if base_diff_ids else None
        if any(a.type == "secret" for a in group.post_analyzers):
            self.stats.update(secret_s=0.0, secret_device_stats={})

        def group_for(diff_id: str) -> AnalyzerGroup:
            return no_secret_group if diff_id in base_diff_ids else group

        if pipeline.enabled():
            self._inspect_layers_pipelined(
                img, group_for, diff_ids, blob_ids, missing_set)
        else:
            # serial legacy path, byte-identical to the pre-pipeline
            # builds (TRIVY_TPU_ANALYSIS_PIPELINE=0)
            for i, (diff_id, blob_id) in enumerate(zip(diff_ids, blob_ids)):
                if blob_id not in missing_set:
                    continue
                self._inspect_layer(group_for(diff_id), img, i, diff_id,
                                    blob_id)

        if "secret_s" in self.stats:
            self.stats["secret_probe"] = hybrid_probe_state()
        if missing_artifact:
            info = self._inspect_config(img)
            self.cache.put_artifact(artifact_id, dataclasses.asdict(info))

        size = 0
        if self.from_tar:
            try:
                size = os.path.getsize(self.target)
            except OSError:
                pass
        return ArtifactReference(
            name=img.name,
            type="container_image",
            id=artifact_id,
            blob_ids=blob_ids,
            image_metadata={
                "ImageID": img.config_digest,
                "DiffIDs": diff_ids,
                "RepoTags": [img.name] if ":" in img.name else [],
                "RepoDigests": [img.repo_digest]
                if getattr(img, "repo_digest", "") else [],
                "ImageConfig": img.config,
                "Size": size,
            },
        )

    def _inspect_layers_pipelined(self, img, group_for,
                                  diff_ids: list[str],
                                  blob_ids: list[str],
                                  missing_set: set[str]) -> None:
        """Default layer path: one fetch lane feeds N walk lanes
        (``--parallel`` / ``TRIVY_TPU_ANALYSIS_WORKERS``) that split and
        analyze distinct layers concurrently, while the coordinator
        applies every BlobInfo document strictly in layer order — so
        results are byte-identical to the serial path at any lane
        count. The process-wide singleflight registry still ensures a
        blob shared by concurrent scans is analyzed exactly once."""
        hook = pipeline.journal_hook()
        stats = {"layers": len(blob_ids), "analyzed": 0, "deduped": 0,
                 "inflight_waits": 0, "journal_replayed": 0,
                 "occupancy": 0.0}
        # serial analyzes every occurrence of a duplicated diffID and
        # the LAST write wins (created_by = history[last index]); the
        # deduped path analyzes once, so it must use that same last
        # index to stay byte-identical
        last_occurrence = {b: i for i, b in enumerate(blob_ids)
                           if b in missing_set}
        todo: list[tuple[int, str, str]] = []
        seen: set[str] = set()
        for i, (diff_id, blob_id) in enumerate(zip(diff_ids, blob_ids)):
            if blob_id not in missing_set or blob_id in seen:
                # cached at probe time (earlier scan, resumed crawl) or
                # a duplicate diffID inside this image: no analysis
                stats["deduped"] += 1
                obs_metrics.LAYER_DEDUPE_HITS.inc()
                if hook is not None and blob_id in hook.precompleted:
                    stats["journal_replayed"] += 1
                continue
            seen.add(blob_id)
            todo.append((last_occurrence[blob_id], diff_id, blob_id))

        lead: list[tuple[int, str, str]] = []
        slots: dict[str, object] = {}
        waits: list[tuple[int, str, str, object]] = []
        for i, diff_id, blob_id in todo:
            slot, leader = pipeline.SINGLEFLIGHT.claim(blob_id, self.cache)
            if leader:
                lead.append((i, diff_id, blob_id))
                slots[blob_id] = slot
            else:
                waits.append((i, diff_id, blob_id, slot))

        def fetch(item):
            i, _diff_id, _blob_id = item
            return self._layer_source(img, i)

        def walk(item, layer):
            i, diff_id, blob_id = item
            walked = self._split_layer(img, i, layer)
            return pipeline.lane_with_retry(
                lambda: self._analyze_members(group_for(diff_id), img, i,
                                              diff_id, blob_id, walked))

        def apply(item, doc):
            _i, _diff_id, blob_id = item
            self._apply_blob(blob_id, doc)
            pipeline.SINGLEFLIGHT.finish(blob_id, slots[blob_id],
                                         doc=doc, ok=True)
            if hook is not None:
                hook.layer_done(blob_id)
            stats["analyzed"] += 1

        workers = pipeline.analysis_workers(self.parallel)
        stats["workers"] = workers
        try:
            run = pipeline.run_layer_lanes(lead, fetch, walk, apply,
                                           workers=workers)
            stats["occupancy"] = run["occupancy"]
        finally:
            # a failed scan must release every claim it still holds or
            # concurrent scans of the shared layers would wait forever
            for blob_id, slot in slots.items():
                pipeline.SINGLEFLIGHT.finish(blob_id, slot, ok=False)

        for i, diff_id, blob_id, slot in waits:
            self._await_layer(img, group_for(diff_id), i, diff_id,
                              blob_id, slot, hook, stats)
        self.last_analysis_stats = stats

    def _lead_analyze(self, group, img, i: int, diff_id: str,
                      blob_id: str, slot, hook, stats,
                      layer=None) -> None:
        """The one leader sequence (pipeline path and follower-promoted
        takeover alike): analyze, publish to waiters, journal, count."""
        try:
            doc = self._inspect_layer(group, img, i, diff_id, blob_id,
                                      layer=layer)
        except BaseException:
            pipeline.SINGLEFLIGHT.finish(blob_id, slot, ok=False)
            raise
        pipeline.SINGLEFLIGHT.finish(blob_id, slot, doc=doc, ok=True)
        if hook is not None:
            hook.layer_done(blob_id)
        stats["analyzed"] += 1

    def _await_layer(self, img, group, i: int, diff_id: str, blob_id: str,
                     slot, hook, stats) -> None:
        """Follower path: wait for the concurrent leader's BlobInfo; on
        leader failure, contend to become the new leader and analyze."""
        for _ in range(8):  # each round either resolves or re-claims
            stats["inflight_waits"] += 1
            obs_metrics.LAYER_DEDUPE_INFLIGHT_WAITS.inc()
            # queue_wait attribution lane: parked on another scan's
            # in-flight analysis of this same layer
            with tracing.span("analysis.dedupe.wait"):
                slot.event.wait(pipeline._INPROC_WAIT_S)
            if slot.ok:
                if slot.doc is not None and slot.src_cache is not self.cache:
                    # the leader analyzed into a different cache handle
                    # (separate scans); replay the doc into ours
                    self.cache.put_blob(blob_id, slot.doc)
                stats["deduped"] += 1
                obs_metrics.LAYER_DEDUPE_HITS.inc()
                return
            slot, leader = pipeline.SINGLEFLIGHT.claim(blob_id, self.cache)
            if leader:
                # same one-refetch-on-error fetch as the pipeline path
                # (fault-matrix parity)
                self._lead_analyze(
                    group, img, i, diff_id, blob_id, slot, hook, stats,
                    layer=pipeline.fetch_with_retry(
                        lambda: self._layer_source(img, i)))
                return
        # pathological churn: analyze unconditionally (idempotent write)
        self._inspect_layer(group, img, i, diff_id, blob_id)
        stats["analyzed"] += 1

    @staticmethod
    def _layer_source(img, i: int):
        """Prefer the streaming accessor (gunzip happens inside the tar
        walk, bounded by one member); sources without one hand over the
        decompressed bytes as before."""
        stream = getattr(img, "layer_stream", None)
        if stream is not None:
            return stream(i)
        return img.layer_bytes(i)

    def _split_layer(self, img, i: int, layer=None):
        """Walk half, part 1: split the layer tar into members (native
        splitter when available, tarfile otherwise). Consumes and
        closes the stream; safe to run on any walk lane."""
        t0 = time.perf_counter()
        if layer is None:
            layer = img.layer_bytes(i)
        try:
            return walk_layer_tar(layer)
        finally:
            # streaming sources hand over open file objects
            if hasattr(layer, "close"):
                layer.close()
            self._add_stats(walk_s=time.perf_counter() - t0)

    def _analyze_members(self, group, img, i: int, diff_id: str,
                         blob_id: str, walked) -> dict:
        """Walk half, part 2: run the analyzers over split members and
        build the BlobInfo document. Pure recomputation over in-memory
        members — no stream, no cache writes — so lanes can run it
        concurrently and the ``analysis.lane`` fault ladder can replay
        it. (blob_id rides along as the per-layer identity for tests
        instrumenting the walk seam.)"""
        _log.info("analyzing layer...", diff_id=diff_id[:19])
        t0 = time.perf_counter()
        files, opaque_dirs, whiteouts = walked
        result = AnalysisResult()
        post_files: dict = {}
        for inp in files:
            group.analyze_file(result, inp, post_files)
        t1 = time.perf_counter()
        secret = [a for a in group.post_analyzers if a.type == "secret"]
        for a in secret:
            a.reset_last_scan()  # this layer's alone
        group.post_analyze(result, post_files)
        lane = {"walk_s": t1 - t0,
                "post_analyze_s": time.perf_counter() - t1}
        for a in secret:
            lane["secret_s"], lane["secret_device_stats"] = a.last_scan()
        self._add_stats(**lane)
        system_file_filter(result)
        blob = result.to_blob()
        blob.diff_id = diff_id
        blob.digest = ""
        blob.opaque_dirs = opaque_dirs
        blob.whiteout_files = whiteouts
        history = [
            h for h in (img.config.get("history") or [])
            if not h.get("empty_layer")
        ]
        if i < len(history):
            blob.created_by = history[i].get("created_by", "")
        return dataclasses.asdict(blob)

    def _apply_blob(self, blob_id: str, doc: dict) -> None:
        """Apply half: the cache write and counter — coordinator-only
        in the lanes path, so writes land strictly in layer order."""
        self.cache.put_blob(blob_id, doc)
        obs_metrics.LAYERS_ANALYZED.inc()

    def _inspect_layer(self, group, img, i: int, diff_id: str,
                       blob_id: str, layer=None) -> dict:
        """Serial composition of the split/analyze/apply halves — the
        kill-switch path and follower-promoted takeovers use this, and
        the lanes path is golden-tested against it."""
        walked = self._split_layer(img, i, layer)
        doc = self._analyze_members(group, img, i, diff_id, blob_id,
                                    walked)
        self._apply_blob(blob_id, doc)
        return doc

    def _inspect_config(self, img: TarImage) -> ArtifactInfo:
        """Image-config analysis (reference image.go:505 inspectConfig):
        history packages + secrets in ENV."""
        cfg = img.config
        info = ArtifactInfo(
            architecture=cfg.get("architecture", ""),
            created=cfg.get("created", ""),
            os=cfg.get("os", ""),
        )
        # history packages: `apk add` commands in image history
        # (reference analyzer/imgconf/apk — offline subset: pinned
        # `pkg=ver` entries carry versions, unpinned are name-only)
        info.history_packages = _history_apk_packages(
            cfg.get("history") or [])

        # secrets in config env (reference analyzer/imgconf/secret); the
        # scanner is built for the device the CLI resolved, as the
        # secret analyzer's is (scan_file itself runs on the host)
        env = (cfg.get("config") or {}).get("Env") or []
        if env:
            from trivy_tpu_torch.fanal.analyzers import secret_analyzer
            from trivy_tpu_torch.secret.scanner import SecretScanner

            content = "\n".join(env).encode()
            secret = SecretScanner(device=secret_analyzer.DEVICE).scan_file(
                "config.json", content)
            if secret is not None:
                info.secret = Secret(
                    file_path=img.config_digest, findings=secret.findings
                )
        return info

    def clean(self, ref: ArtifactReference) -> None:
        pass  # layer blobs stay cached (that IS the resume mechanism)


_APK_ADD_RE = re.compile(r"\bapk\b[^|;&]*?\badd\b([^|;&]*)")


def _history_apk_packages(history: list[dict]) -> list[Package]:
    """Parse `apk add` invocations out of image-config history
    (reference pkg/fanal/analyzer/imgconf/apk/apk.go:147-180; the
    reference additionally resolves versions/deps via a fetched
    APKINDEX — network-gated here, so only pinned versions are kept)."""
    out: list[Package] = []
    seen: set[str] = set()
    for h in history:
        cmd = h.get("created_by", "")
        for m in _APK_ADD_RE.finditer(cmd):
            tokens = m.group(1).split()
            skip_next = False
            for tok in tokens:
                if skip_next:  # argument of --virtual/-t: a group name
                    skip_next = False
                    continue
                if tok in ("--virtual", "-t"):
                    skip_next = True
                    continue
                if tok.startswith("-") or tok.startswith("$"):
                    continue
                if tok in (".", "&&", "\\") or tok.startswith("."):
                    continue
                name, _, ver = tok.partition("=")
                if not name or name in seen:
                    continue
                seen.add(name)
                out.append(Package(
                    id=f"{name}@{ver}" if ver else name,
                    name=name, version=ver))
    return out


def guess_base_image_index(history: list[dict]) -> int:
    """Index of the last base-image history entry: the trailing CMD of
    the base image, scanning backward past this image's own metadata
    entries (reference pkg/fanal/image/image.go:111-137)."""
    found_non_empty = False
    for i in range(len(history) - 1, -1, -1):
        h = history[i]
        empty = bool(h.get("empty_layer"))
        if not found_non_empty:
            if empty:
                continue
            found_non_empty = True
        if not empty:
            continue
        created_by = h.get("created_by", "")
        if created_by.startswith("/bin/sh -c #(nop)  CMD") or \
                created_by.startswith("CMD"):
            return i
    return -1


def _guess_base_diff_ids(diff_ids: list[str],
                         history: list[dict]) -> list[str]:
    """history index -> diff IDs (empty layers excluded)
    (reference image.go:527-554)."""
    base_index = guess_base_image_index(history)
    out = []
    diff_idx = 0
    for i, h in enumerate(history):
        if i > base_index:
            break
        if h.get("empty_layer"):
            continue
        if diff_idx >= len(diff_ids):
            return []
        out.append(diff_ids[diff_idx])
        diff_idx += 1
    return out
