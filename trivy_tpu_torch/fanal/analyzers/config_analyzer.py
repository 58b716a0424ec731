"""Config (IaC) analyzer: detects config files during the walk and runs
the misconfiguration engine over them (reference
pkg/fanal/analyzer/config/* post-analyzers -> pkg/misconf.Scanner).

Copy of trivy_tpu/fanal/analyzers/config_analyzer.py, with one
addition: what each thread's last `post_analyze` took is kept
(`last_seconds`), so a scan can report the config analyzer's share of
its post-analyzers.
"""

from __future__ import annotations

import os
import threading
import time

from trivy_tpu_torch.fanal.analyzer import (
    AnalysisInput,
    AnalysisResult,
    PostAnalyzer,
    register_post,
)
from trivy_tpu_torch.iac import detection

_MAX_CONFIG_SIZE = 5 * 1024 * 1024

_CANDIDATE_EXT = (".yaml", ".yml", ".json", ".tf", ".tf.json", ".tpl")
_CHART_ARCHIVE_EXT = (".tgz", ".tar.gz")


def _looks_like_config(path: str) -> bool:
    name = os.path.basename(path).lower()
    if detection._DOCKERFILE_NAME.search(name):
        return True
    return name.endswith(_CANDIDATE_EXT + _CHART_ARCHIVE_EXT) \
        or name == "chart.yaml"


def _strip_helm_hooks(rendered: bytes) -> bytes | None:
    """Blank out rendered docs carrying a helm.sh/hook annotation (test/
    install hooks are not cluster resources; the reference's helm scan
    output omits them). Kept docs stay byte-identical at their original
    line offsets — dropped docs become blank lines — so finding line
    numbers still point into the rendered template. None when nothing
    scannable remains."""
    if b"helm.sh/hook" not in rendered:
        return rendered
    import yaml

    text = rendered.decode("utf-8", "replace")
    lines = text.splitlines(keepends=True)
    # document chunks split on '---' separator lines
    chunks: list[tuple[int, int]] = []
    start = 0
    for i, line in enumerate(lines):
        # document separators sit at column 0; an indented literal
        # '---' inside a block scalar is NOT a separator
        if line.rstrip() == "---" and line[:1] == "-":
            chunks.append((start, i))
            start = i + 1
    chunks.append((start, len(lines)))

    def is_hook(chunk_text: str) -> bool:
        if "helm.sh/hook" not in chunk_text:
            return False
        try:
            doc = yaml.safe_load(chunk_text)
        except yaml.YAMLError:
            return False
        if not isinstance(doc, dict):
            return False
        ann = (doc.get("metadata") or {}).get("annotations") or {}
        return any(str(k).startswith("helm.sh/hook") for k in ann)

    kept_any = False
    out_lines = list(lines)
    for lo, hi in chunks:
        chunk = "".join(lines[lo:hi])
        if is_hook(chunk):
            for i in range(lo, hi):
                out_lines[i] = "\n"
        elif chunk.strip():
            kept_any = True
    if not kept_any:
        return None
    return "".join(out_lines).encode()


def _render_chart_archive(data: bytes,
                          overrides: dict | None) -> list[tuple[str, bytes]]:
    """Packaged helm chart (.tgz) -> rendered (chart-relative path,
    yaml) pairs; empty when the archive holds no chart."""
    import gzip
    import io
    import tarfile

    from trivy_tpu_torch.iac.helm import render_chart

    members: dict[str, bytes] = {}
    total = 0
    try:
        with tarfile.open(fileobj=io.BytesIO(data), mode="r:*") as tar:
            for m in tar.getmembers():
                if not m.isfile() or m.size > _MAX_CONFIG_SIZE:
                    continue
                # untrusted archives: bound member count and total
                # decompressed bytes (a tiny gzip can expand hugely)
                if len(members) >= 4096 or total > 64 * 1024 * 1024:
                    break
                f = tar.extractfile(m)
                if f is not None:
                    name = m.name
                    while name.startswith("./"):
                        name = name[2:]
                    data_m = f.read(_MAX_CONFIG_SIZE + 1)
                    if len(data_m) > _MAX_CONFIG_SIZE:
                        continue  # lied about size
                    members[name] = data_m
                    total += len(data_m)
    except (tarfile.TarError, gzip.BadGzipFile, OSError, EOFError):
        return []
    # the chart lives under a top-level directory inside the archive
    roots = {p.split("/", 1)[0] for p in members
             if p.endswith("/Chart.yaml") and p.count("/") == 1}
    out: list[tuple[str, bytes]] = []
    for root in sorted(roots):
        chart_files = {
            p[len(root) + 1:]: c for p, c in members.items()
            if p.startswith(root + "/")
        }
        out.extend(render_chart(chart_files, overrides))
    return out


@register_post
class ConfigAnalyzer(PostAnalyzer):
    type = "config"
    version = 1
    # --helm-set / --helm-values for this scan; set on a per-group copy
    # by AnalyzerGroup.build (never mutated on the registry singleton, so
    # concurrent scans in one process cannot leak overrides)
    helm_overrides: dict | None = None
    # per thread: the seconds of the last post_analyze (shared by the
    # per-group copies, as the registry's instance is)
    _last = threading.local()

    def last_seconds(self) -> float:
        """Seconds of this thread's last post_analyze; 0.0 before any."""
        return getattr(self._last, "s", 0.0)

    def reset_last_seconds(self) -> None:
        self._last.s = 0.0

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        if size > _MAX_CONFIG_SIZE:
            return False
        return _looks_like_config(path)

    def post_analyze(self, files: dict[str, AnalysisInput]):
        t0 = time.perf_counter()
        try:
            return self._post_analyze(files)
        finally:
            self._last.s = time.perf_counter() - t0

    def _post_analyze(self, files: dict[str, AnalysisInput]):
        from trivy_tpu_torch.iac.helm import find_chart_roots, render_chart
        from trivy_tpu_torch.misconf.scanner import scan_config

        res = AnalysisResult()
        # helm charts render as a unit (reference scans the helm-engine
        # output, not raw templates); rendered docs scan as kubernetes
        roots = find_chart_roots(files)
        in_chart: set[str] = set()
        for root in roots:
            prefix = root + "/" if root else ""
            chart_files = {
                p[len(prefix):]: files[p].read()
                for p in files if p.startswith(prefix)
            }
            if not chart_files:
                continue
            # only files the helm engine consumes are chart-owned; other
            # configs living under the chart dir (Dockerfile, *.tf, ...)
            # still scan individually
            in_chart.update(
                prefix + rel for rel in chart_files
                if rel in ("Chart.yaml", "values.yaml", "values.yml")
                or rel.startswith("templates/")
            )
            for rel_path, rendered in render_chart(chart_files,
                                                   self.helm_overrides):
                rendered = _strip_helm_hooks(rendered)
                if rendered is None:
                    continue
                full = prefix + rel_path
                misconf = scan_config(full, rendered,
                                      file_type=detection.KUBERNETES)
                if misconf is not None and (misconf.failures
                                            or misconf.successes):
                    misconf.file_type = detection.HELM
                    for d in misconf.failures + misconf.successes:
                        d.type = detection.HELM
                    res.misconfigurations.append(misconf)

        # packaged charts (*.tgz) render in place; targets keep the
        # archive path prefix (reference: "chart.tar.gz:templates/x")
        for path, inp in sorted(files.items()):
            if not path.lower().endswith(_CHART_ARCHIVE_EXT):
                continue
            in_chart.add(path)
            for rel_path, rendered in _render_chart_archive(
                    inp.read(), self.helm_overrides):
                rendered = _strip_helm_hooks(rendered)
                if rendered is None:
                    continue
                misconf = scan_config(f"{path}:{rel_path}", rendered,
                                      file_type=detection.KUBERNETES)
                if misconf is not None and (misconf.failures
                                            or misconf.successes):
                    misconf.file_type = detection.HELM
                    for d in misconf.failures + misconf.successes:
                        d.type = detection.HELM
                    res.misconfigurations.append(misconf)
        # terraform evaluates per MODULE directory (variables, locals,
        # child modules span files), not per file
        from trivy_tpu_torch.misconf.scanner import scan_terraform_modules

        tf_paths = {p for p in files
                    if p.endswith((".tf", ".tf.json")) and p not in in_chart}
        if tf_paths:
            res.misconfigurations.extend(scan_terraform_modules(
                {p: files[p].read() for p in tf_paths}))

        type_pats = getattr(self, "iac_type_patterns", [])
        for path, inp in sorted(files.items()):
            if path in in_chart or path in tf_paths:
                continue
            forced = None
            for rx, ftype in type_pats:
                if rx.search(path):
                    forced = ftype
                    break
            misconf = scan_config(path, inp.read(), file_type=forced)
            if misconf is not None and (
                misconf.failures or misconf.successes
            ):
                res.misconfigurations.append(misconf)
        return res
