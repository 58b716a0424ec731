"""Language analyzers: declarative wiring of the dependency parsers into
the analyzer registry (reference pkg/fanal/analyzer/language/*: mostly thin
wrappers over pkg/dependency/parser via language.Analyze).

Copy of trivy_tpu/fanal/analyzers/lang.py.
"""

from __future__ import annotations

import os
import re
import stat

from trivy_tpu_torch.fanal.analyzer import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    PostAnalyzer,
    register,
    register_post,
)
from trivy_tpu_torch.parsers import golang, java_pom, misc_lang, nodejs
from trivy_tpu_torch.parsers import python as pyparse
from trivy_tpu_torch.types.artifact import Application


def _app(app_type: str, path: str, pkgs) -> AnalysisResult | None:
    # version-less packages are unmatchable noise EXCEPT the graph root
    # (go.mod main module): VEX product reachability needs it
    pkgs = [p for p in pkgs
            if p and (not p.empty
                      or getattr(p, "relationship", "") == "root")]
    if not pkgs:
        return None
    res = AnalysisResult()
    res.applications = [Application(type=app_type, file_path=path, packages=pkgs)]
    return res


class _LockfileAnalyzer(PostAnalyzer):
    """One lockfile filename -> one application."""

    app_type = ""
    filenames: tuple = ()
    parser = None

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return os.path.basename(path) in self.filenames

    def _accepts(self, path: str) -> bool:
        # post_files buckets are keyed by analyzer type; two analyzers
        # sharing a type must not run on each other's files.  Files routed
        # in via --file-patterns are accepted too.
        if os.path.basename(path) in self.filenames:
            return True
        return any(p.search(path)
                   for p in getattr(self, "extra_patterns", ()))

    def post_analyze(self, files: dict[str, AnalysisInput]):
        res = AnalysisResult()
        for path, inp in sorted(files.items()):
            if not self._accepts(path):
                continue
            got = _app(self.app_type, path, type(self).parser(inp.read()))
            res.merge(got)
        return res


def _lockfile(app_type: str, filenames: tuple, parser,
              atype: str = "") -> None:
    atype = atype or app_type
    cls = type(
        f"{atype.title()}Analyzer",
        (_LockfileAnalyzer,),
        {"type": atype, "app_type": app_type, "filenames": filenames,
         "parser": staticmethod(parser)},
    )
    register_post(cls())


_lockfile("npm", ("package-lock.json",), nodejs.parse_package_lock)
_lockfile("yarn", ("yarn.lock",), nodejs.parse_yarn_lock)
_lockfile("pnpm", ("pnpm-lock.yaml",), nodejs.parse_pnpm_lock)
_lockfile("pip", ("requirements.txt",), pyparse.parse_requirements)
_lockfile("pipenv", ("Pipfile.lock",), pyparse.parse_pipfile_lock)
# poetry gets its own analyzer below (pyproject.toml supplements the lock)
_lockfile("uv", ("uv.lock",), pyparse.parse_uv_lock)
_lockfile("julia", ("Manifest.toml",), misc_lang.parse_julia_manifest)
_lockfile("nuget", ("packages.config",),
          misc_lang.parse_nuget_packages_config, atype="nuget-config")
_lockfile("nuget", ("Directory.Packages.props",),
          misc_lang.parse_nuget_packages_props, atype="packages-props")
_lockfile("pom", ("pom.xml",), java_pom.parse_pom)
_lockfile("cargo", ("Cargo.lock",), misc_lang.parse_cargo_lock)
_lockfile("composer", ("composer.lock",), misc_lang.parse_composer_lock)
_lockfile("bundler", ("Gemfile.lock",), misc_lang.parse_gemfile_lock)
_lockfile("gradle", ("gradle.lockfile",),
          misc_lang.parse_gradle_lockfile)
_lockfile("sbt", ("build.sbt.lock",), misc_lang.parse_sbt_lockfile)
_lockfile("nuget", ("packages.lock.json",), misc_lang.parse_nuget_lock)
_lockfile("pub", ("pubspec.lock",), misc_lang.parse_pubspec_lock)
_lockfile("hex", ("mix.lock",), misc_lang.parse_mix_lock)
_lockfile("cocoapods", ("Podfile.lock",), misc_lang.parse_podfile_lock)
_lockfile("swift", ("Package.resolved",), misc_lang.parse_swift_resolved)
_lockfile("conan", ("conan.lock",), misc_lang.parse_conan_lock)
_lockfile("conda-environment", ("environment.yml", "environment.yaml"),
          misc_lang.parse_conda_environment)


@register_post
class PoetryAnalyzer(PostAnalyzer):
    """poetry.lock + sibling pyproject.toml: the lockfile lists every
    package; pyproject marks which are direct deps and which belong to
    dev groups (reference pkg/fanal/analyzer/language/python/poetry)."""

    type = "poetry"
    version = 2
    app_type = "poetry"

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return os.path.basename(path) in ("poetry.lock", "pyproject.toml")

    def post_analyze(self, files):
        res = AnalysisResult()
        by_dir: dict[str, dict[str, AnalysisInput]] = {}
        for path, inp in files.items():
            by_dir.setdefault(os.path.dirname(path), {})[
                os.path.basename(path)] = inp
        for d, group in sorted(by_dir.items()):
            if "poetry.lock" not in group:
                continue
            pkgs = pyparse.parse_poetry_lock(group["poetry.lock"].read())
            if "pyproject.toml" in group:
                try:
                    proj = pyparse.parse_pyproject(group["pyproject.toml"].read())
                except Exception:
                    proj = None
                if proj:
                    direct = proj["dependencies"]
                    dev = set().union(*proj["groups"].values()) \
                        if proj["groups"] else set()
                    for p in pkgs:
                        norm = pyparse._norm_name(p.name)
                        if norm in direct:
                            p.relationship = "direct"
                        elif norm in dev:
                            p.relationship = "direct"
                            p.dev = True
                        else:
                            p.relationship = "indirect"
                            p.indirect = True
            res.merge(_app("poetry", group["poetry.lock"].path, pkgs))
        return res


@register_post
class DotnetDepsAnalyzer(PostAnalyzer):
    type = "dotnet-core"
    version = 1
    app_type = "dotnet-core"

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return path.endswith(".deps.json")

    def post_analyze(self, files):
        res = AnalysisResult()
        for path, inp in sorted(files.items()):
            res.merge(_app(self.app_type, path,
                           misc_lang.parse_deps_json(inp.read())))
        return res


@register_post
class GoModAnalyzer(PostAnalyzer):
    """go.mod (+ go.sum supplement when go.mod predates go 1.17, whose
    lockfiles list no indirect deps — reference
    pkg/fanal/analyzer/language/golang/mod)."""

    type = "gomod"
    version = 2
    app_type = "gomod"

    _GO_DIRECTIVE = re.compile(rb"^go\s+(\d+)\.(\d+)", re.M)

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return os.path.basename(path) in ("go.mod", "go.sum")

    def post_analyze(self, files):
        res = AnalysisResult()
        by_dir: dict[str, dict[str, AnalysisInput]] = {}
        for path, inp in files.items():
            by_dir.setdefault(os.path.dirname(path), {})[
                os.path.basename(path)] = inp
        for d, group in sorted(by_dir.items()):
            if "go.mod" not in group:
                continue
            mod_content = group["go.mod"].read()
            pkgs = golang.parse_go_mod(mod_content)
            m = self._GO_DIRECTIVE.search(mod_content)
            pre117 = m is None or (int(m.group(1)), int(m.group(2))) < (1, 17)
            if pre117 and "go.sum" in group:
                have = {p.name for p in pkgs}
                for p in golang.parse_go_sum(group["go.sum"].read()):
                    if p.name not in have:
                        p.indirect = True
                        p.relationship = "indirect"
                        pkgs.append(p)
            res.merge(_app("gomod", group["go.mod"].path, pkgs))
        return res


# ------------------------------------------------- individual packages


@register
class NodePkgAnalyzer(Analyzer):
    """node_modules/**/package.json -> installed node packages."""

    type = "node-pkg"
    version = 1

    _RX = re.compile(r"(^|/)node_modules/(@[^/]+/)?[^/]+/package\.json$")

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return bool(self._RX.search(path))

    def analyze(self, inp: AnalysisInput):
        pkg = nodejs.parse_package_json(inp.read())
        if pkg is None:
            return None
        pkg.file_path = inp.path
        return _app("node-pkg", inp.path, [pkg])


@register
class PythonPkgAnalyzer(Analyzer):
    """site-packages dist-info/egg-info -> installed python packages."""

    type = "python-pkg"
    version = 1

    _RX = re.compile(r"\.(dist-info/METADATA|egg-info/PKG-INFO|egg-info)$")

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return bool(self._RX.search(path))

    def analyze(self, inp: AnalysisInput):
        pkg = pyparse.parse_dist_metadata(inp.read())
        if pkg is None:
            return None
        pkg.file_path = inp.path
        return _app("python-pkg", inp.path, [pkg])


@register
class GemspecAnalyzer(Analyzer):
    type = "gemspec"
    version = 1

    _RX = re.compile(r"specifications/.+\.gemspec$")

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return bool(self._RX.search(path))

    def analyze(self, inp: AnalysisInput):
        pkg = misc_lang.parse_gemspec(inp.read())
        if pkg is None:
            return None
        pkg.file_path = inp.path
        return _app("gemspec", inp.path, [pkg])


@register
class JarAnalyzer(Analyzer):
    type = "jar"
    version = 1

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return path.endswith((".jar", ".war", ".ear", ".par"))

    def analyze(self, inp: AnalysisInput):
        return _app("jar", inp.path, misc_lang.parse_jar(inp.read(), inp.path))


@register
class ComposerVendorAnalyzer(Analyzer):
    """vendor/composer/installed.json (reference
    analyzer/language/php/composer vendor analyzer; same entry shape as
    composer.lock, parsed by the shared parser)."""

    type = "composer-vendor"
    version = 1

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return os.path.basename(path) == "installed.json"

    def analyze(self, inp: AnalysisInput):
        try:
            pkgs = misc_lang.parse_composer_lock(inp.read())
        except ValueError:
            return None
        return _app("composer-vendor", inp.path, pkgs)


@register
class CondaPkgAnalyzer(Analyzer):
    type = "conda-pkg"
    version = 1

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return "conda-meta/" in path and path.endswith(".json")

    def analyze(self, inp: AnalysisInput):
        pkg = misc_lang.parse_conda_meta(inp.read())
        if pkg is None:
            return None
        pkg.file_path = inp.path
        return _app("conda-pkg", inp.path, [pkg])


def _looks_like_executable(path: str, size: int, mode: int,
                           extra_exts: tuple = ()) -> bool:
    """Candidate filter shared by the binary analyzers: plausible size,
    executable bit (when mode is known), extension-less or a known
    binary extension."""
    if size < 1024 or size > 200 * 1024 * 1024:
        return False
    if not (mode & (stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH)) and mode:
        return False
    base = os.path.basename(path)
    return "." not in base or base.endswith((".bin", ".exe") + extra_exts)


_BINARY_MAGICS = (b"\x7fELF", b"MZ\x90\x00", b"\xcf\xfa\xed\xfe",
                  b"\xfe\xed\xfa\xcf")


@register
class WordPressAnalyzer(Analyzer):
    """wp-includes/version.php -> wordpress core version (reference
    analyzer/language/php/wordpress)."""

    type = "wordpress"
    version = 1

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return path.endswith("wp-includes/version.php")

    def analyze(self, inp: AnalysisInput):
        pkg = misc_lang.parse_wordpress_version(inp.read())
        if pkg is None:
            return None
        pkg.file_path = inp.path
        return _app("wordpress", inp.path, [pkg])


@register
class RustBinaryAnalyzer(Analyzer):
    """Executables with a cargo-auditable dependency list embedded
    (reference analyzer/language/rust/binary)."""

    type = "rustbinary"
    version = 1

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return _looks_like_executable(path, size, mode)

    def analyze(self, inp: AnalysisInput):
        content = inp.read()
        if content[:4] not in _BINARY_MAGICS:
            return None
        if b"cargo" not in content and b"rustc" not in content:
            return None
        pkgs = misc_lang.parse_rust_binary(content)
        return _app("rustbinary", inp.path, pkgs)


@register
class GoBinaryAnalyzer(Analyzer):
    """Executable ELF/PE/Mach-O files with embedded Go build info
    (reference analyzer/language/golang/binary)."""

    type = "gobinary"
    version = 1

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        return _looks_like_executable(path, size, mode, (".test",))

    def analyze(self, inp: AnalysisInput):
        content = inp.read()
        if content[:4] not in _BINARY_MAGICS:
            return None
        pkgs = golang.parse_go_binary(content)
        return _app("gobinary", inp.path, pkgs)
