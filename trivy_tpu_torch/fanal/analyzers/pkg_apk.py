"""apk installed-package DB analyzer
(reference pkg/fanal/analyzer/pkg/apk/apk.go): parses
lib/apk/db/installed — blocks of single-letter fields:
P name, V version, A arch, L license, o origin (source pkg), m maintainer,
F directory, R file-in-directory, D/p dependencies/provides.

Copy of trivy_tpu/fanal/analyzers/pkg_apk.py.
"""

from __future__ import annotations

from trivy_tpu_torch.fanal.analyzer import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    register,
)
from trivy_tpu_torch.types.artifact import Package, PackageInfo

DB_PATH = "lib/apk/db/installed"


def parse_apk_installed(text: str):
    pkgs: list[Package] = []
    installed_files: list[str] = []
    provides: dict[str, str] = {}  # provided name -> pkg id
    cur: Package | None = None
    cur_dir = ""
    cur_files: list[str] = []
    depends: dict[str, list[str]] = {}

    def flush():
        nonlocal cur, cur_files
        if cur is not None and not cur.empty:
            cur.id = f"{cur.name}@{cur.version}"
            cur.installed_files = cur_files
            pkgs.append(cur)
        cur, cur_files = None, []

    for line in text.splitlines():
        if not line.strip():
            flush()
            cur_dir = ""
            continue
        if len(line) < 2 or line[1] != ":":
            continue
        tag, value = line[0], line[2:]
        if tag == "P":
            flush()
            cur = Package(name=value)
        elif cur is None:
            continue
        elif tag == "V":
            cur.version = value
        elif tag == "A":
            cur.arch = value
        elif tag == "L" and value:
            cur.licenses = [value]
        elif tag == "o":
            cur.src_name = value
        elif tag == "m":
            cur.maintainer = value
        elif tag == "F":
            cur_dir = value
        elif tag == "R":
            path = f"{cur_dir}/{value}" if cur_dir else value
            cur_files.append(path)
            installed_files.append(path)
        elif tag == "p":
            for prov in value.split():
                provides[prov.split("=")[0]] = cur.name
        elif tag == "D":
            depends[cur.name] = value.split()
    flush()

    for p in pkgs:
        if not p.src_name:
            p.src_name = p.name
        p.src_version = p.version
        # split version-release for reporting; matching uses the full string
        if "-r" in p.version:
            v, _, r = p.version.rpartition("-")
            if r.startswith("r") and r[1:].isdigit():
                p.version, p.release = v, r
                p.src_version, p.src_release = v, r
    # resolve dependencies to package ids
    name_to_id = {p.name: p.id for p in pkgs}
    for p in pkgs:
        deps = []
        for d in depends.get(p.name, []):
            d = d.split("=")[0].split("<")[0].split(">")[0].split("~")[0]
            if d.startswith("!"):
                continue
            target = name_to_id.get(d) or name_to_id.get(provides.get(d, ""))
            if target and target != p.id:
                deps.append(target)
        p.depends_on = sorted(set(deps))
    return pkgs, installed_files


@register
class ApkAnalyzer(Analyzer):
    type = "apk"
    version = 1

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return path == DB_PATH

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        pkgs, installed = parse_apk_installed(
            inp.read().decode("utf-8", "replace")
        )
        if not pkgs:
            return None
        res = AnalysisResult()
        res.package_infos = [PackageInfo(file_path=inp.path, packages=pkgs)]
        res.system_installed_files = installed
        return res
