"""Pluggable AST rule framework + the project's invariant rules.

A rule is a class with an ``id``, a one-line ``summary``, a
``rationale`` (why the invariant exists — shown by ``--list-rules``
and docs/static-analysis.md), and a ``check(project)`` generator of
:class:`Finding`.  Register with ``@register``; the linter runs
every registered rule unless ``--rule`` narrows the set.

Suppressions (see docs/static-analysis.md):

- inline — ``# lint: allow[rule-id] reason`` on the flagged line or
  the line directly above.  A suppression with no reason is itself a
  finding: the comment is the review trail.
- baseline — a JSON file of ``{"rule", "path", "reason"}`` entries so
  a PR can land enforcement before every legacy finding is fixed.

Rules read the tree through :class:`Project`, which seeded-violation
tests instantiate over a synthetic mini-tree (and override the
declared fault-site / knob tables) to prove each rule actually fires.

Copy of trivy_tpu/analysis/rules.py over the port's tree: every path,
scope and registry names ``trivy_tpu_torch/``, the knob doc is
``docs/knobs_torch.md``, and the lock-order rule checks cycles with the
port's ``analysis/witness.py``.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass

from trivy_tpu_torch.analysis import lockstatic

SUPPRESS_RX = re.compile(
    r"#\s*lint:\s*allow\[(?P<rules>[a-z0-9_,\- ]+)\]\s*(?P<reason>.*)")


@dataclass
class Finding:
    rule: str
    path: str   # project-root-relative, forward slashes
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}


class PyFile:
    def __init__(self, relpath: str, source: str):
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)


class Project:
    """The linted file set: ``trivy_tpu_torch/**/*.py`` (the port has no
    bench script, and ``chip_smoke.py`` is a smoke script), tests
    excluded (they seed violations on purpose).  Declared tables
    (fault sites, knobs) default to the real registries; tests override
    the attributes to exercise coherence rules in isolation."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._files: dict[str, PyFile] = {}
        self._load_order: list[str] = []
        self._collect()
        self.declared_fault_sites = self._extract_fault_sites()
        self.declared_fault_actions = self._extract_fault_actions()
        self.declared_knobs = self._extract_knobs()
        self.declared_span_taxonomy = self._extract_span_taxonomy()
        self.declared_event_kinds = self._extract_event_kinds()
        self.declared_action_kinds = self._extract_action_kinds()
        self.declared_chaos_manifest = self._extract_chaos_manifest()
        self.declared_usage_fields = self._extract_usage_fields()

    def _collect(self) -> None:
        pkg = os.path.join(self.root, "trivy_tpu_torch")
        for dirpath, dirnames, filenames in os.walk(pkg):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    self._add(os.path.join(dirpath, fn))

    def _add(self, path: str) -> None:
        rel = os.path.relpath(path, self.root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            source = f.read()
        self._files[rel] = PyFile(rel, source)
        self._load_order.append(rel)

    def files(self) -> list[PyFile]:
        return [self._files[r] for r in self._load_order]

    def file(self, relpath: str) -> PyFile | None:
        return self._files.get(relpath)

    def doc_text(self, relname: str) -> str | None:
        path = os.path.join(self.root, relname)
        if not os.path.exists(path):
            return None
        with open(path, encoding="utf-8") as f:
            return f.read()

    # The declared registries come from the LINTED tree's own source
    # (AST-extracted — both tables are literal enough), not from the
    # interpreter's imported trivy_tpu_torch package: `lint --root WORKTREE`
    # must validate the worktree against the worktree's registries.
    # Trees without the registry file (seeded mini-projects) fall back
    # to the real import, and tests override the attributes directly.

    def _registry_assign(self, relpath: str, name: str):
        pf = self.file(relpath)
        if pf is None:
            return None
        for node in pf.tree.body:
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target]
                       if isinstance(node, ast.AnnAssign) else [])
            if any(isinstance(t, ast.Name) and t.id == name
                   for t in targets):
                return node.value
        return None

    def _extract_fault_sites(self):
        value = self._registry_assign(
            "trivy_tpu_torch/resilience/faults.py", "SITES")
        if value is not None:
            try:
                return [(s, tuple(a)) for s, a in ast.literal_eval(value)]
            except (ValueError, TypeError):
                pass
        return self._real_fault_sites()

    def _extract_fault_actions(self):
        value = self._registry_assign(
            "trivy_tpu_torch/resilience/faults.py", "ACTIONS")
        if value is not None:
            try:
                return set(ast.literal_eval(value))
            except (ValueError, TypeError):
                pass
        try:
            from trivy_tpu_torch.resilience import faults
            return set(faults.ACTIONS)
        except ImportError:
            return None  # no action vocabulary known -> skip the check

    def _extract_knobs(self):
        value = self._registry_assign(
            "trivy_tpu_torch/analysis/knobs.py", "KNOBS")
        if isinstance(value, ast.Tuple):
            try:
                from trivy_tpu_torch.analysis.knobs import Knob
                return [Knob(*[ast.literal_eval(a) for a in c.args],
                             **{k.arg: ast.literal_eval(k.value)
                                for k in c.keywords})
                        for c in value.elts]
            except Exception:  # malformed table -> import fallback
                pass
        return self._real_knobs()

    def _extract_span_taxonomy(self):
        """Attribution taxonomy from the LINTED tree's obs/attrib.py
        (lane map, structural set, prefix families, lane vocabulary) —
        AST-extracted like the knob/fault tables; import fallback for
        trees without the module; tests override the attribute."""
        attrib_py = "trivy_tpu_torch/obs/attrib.py"
        vals = {}
        for name in ("SPAN_LANES", "SPAN_STRUCTURAL",
                     "SPAN_PREFIX_LANES", "LANES"):
            node = self._registry_assign(attrib_py, name)
            if node is None:
                vals = None
                break
            try:
                vals[name] = ast.literal_eval(node)
            except (ValueError, TypeError):
                vals = None
                break
        if vals is not None:
            return {
                "span_lanes": dict(vals["SPAN_LANES"]),
                "structural": set(vals["SPAN_STRUCTURAL"]),
                "prefixes": tuple(tuple(p)
                                  for p in vals["SPAN_PREFIX_LANES"]),
                "lanes": tuple(vals["LANES"]),
            }
        try:
            from trivy_tpu_torch.obs import attrib
        except ImportError:
            return None
        return {
            "span_lanes": dict(attrib.SPAN_LANES),
            "structural": set(attrib.SPAN_STRUCTURAL),
            "prefixes": tuple(attrib.SPAN_PREFIX_LANES),
            "lanes": tuple(attrib.LANES),
        }

    def _extract_event_kinds(self):
        """Fleet event-kind registry from the LINTED tree's
        fleet/slo.py EVENTS table (AST-extracted like the fault/knob
        tables; import fallback; tests override the attribute).
        ``None`` means no registry is known and the event-kind rule
        skips (seeded mini-trees override explicitly)."""
        value = self._registry_assign("trivy_tpu_torch/fleet/slo.py", "EVENTS")
        if value is not None:
            try:
                return [(k, d) for k, d in ast.literal_eval(value)]
            except (ValueError, TypeError):
                pass
        if self.file("trivy_tpu_torch/fleet/slo.py") is not None:
            return []  # present but unparsable: the rule flags it
        try:
            from trivy_tpu_torch.fleet import slo
            return list(slo.EVENTS)
        except ImportError:
            return None

    def _extract_action_kinds(self):
        """Fleet-controller action registry from the LINTED tree's
        fleet/controller.py ACTIONS table.  ``None`` means the tree
        has no controller — the event-kind rule then skips its action
        checks entirely (NO import fallback: a seeded mini-tree
        without a controller must keep the pre-controller rule
        behavior, and tests override the attribute to opt in)."""
        value = self._registry_assign(
            "trivy_tpu_torch/fleet/controller.py", "ACTIONS")
        if value is not None:
            try:
                return [(k, d) for k, d in ast.literal_eval(value)]
            except (ValueError, TypeError):
                pass
        if self.file("trivy_tpu_torch/fleet/controller.py") is not None:
            return []  # present but unparsable: the rule flags it
        return None

    def _extract_chaos_manifest(self):
        """Chaos scenario coverage map from the LINTED tree's
        chaos/scenarios.py MANIFEST table.  ``None`` means the tree
        has no chaos package — the chaos-coverage rule then skips
        entirely (NO import fallback: a seeded mini-tree without the
        package must keep pre-chaos rule behavior, and tests override
        the attribute to opt in)."""
        value = self._registry_assign(
            "trivy_tpu_torch/chaos/scenarios.py", "MANIFEST")
        if value is not None:
            try:
                raw = ast.literal_eval(value)
                return {name: [(site, tuple(actions))
                               for site, actions in entries]
                        for name, entries in raw.items()}
            except (ValueError, TypeError):
                pass
        if self.file("trivy_tpu_torch/chaos/scenarios.py") is not None:
            return {}  # present but unparsable: the rule flags it
        return None

    def _extract_usage_fields(self):
        """Cost-vector field catalog from the LINTED tree's
        obs/usage.py FIELDS table.  ``None`` means the tree has no
        usage module — the usage-field rule then skips entirely (NO
        import fallback: seeded mini-trees without the module keep
        pre-metering rule behavior; tests override the attribute)."""
        value = self._registry_assign("trivy_tpu_torch/obs/usage.py", "FIELDS")
        if value is not None:
            try:
                return [(n, d) for n, d in ast.literal_eval(value)]
            except (ValueError, TypeError):
                pass
        if self.file("trivy_tpu_torch/obs/usage.py") is not None:
            return []  # present but unparsable: the rule flags it
        return None

    @staticmethod
    def _real_fault_sites():
        try:
            from trivy_tpu_torch.resilience import faults
            return list(getattr(faults, "SITES", ()))
        except ImportError:  # seeded mini-projects override anyway
            return []

    @staticmethod
    def _real_knobs():
        from trivy_tpu_torch.analysis import knobs
        return list(knobs.KNOBS)


# -------------------------------------------------------------- registry

RULES: dict[str, type] = {}


def register(cls):
    RULES[cls.id] = cls
    return cls


class Rule:
    id = ""
    summary = ""
    rationale = ""

    def check(self, project: Project):
        raise NotImplementedError


# ------------------------------------------------------------- helpers

def _const_str(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _func_tail(func) -> str | None:
    """Rightmost identifier of a call target: ``a.b.c(...)`` -> ``c``."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _module_consts(tree: ast.Module) -> dict[str, str]:
    """Module-level ``NAME = "literal"`` string constants."""
    out: dict[str, str] = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            val = _const_str(node.value)
            if val is not None:
                out[node.targets[0].id] = val
    return out


def _walk_with_parents(tree):
    """Yield (node, func_stack) — the enclosing FunctionDef chain."""
    stack: list[ast.AST] = []

    def rec(node):
        is_fn = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        if is_fn:
            stack.append(node)
        for child in ast.iter_child_nodes(node):
            yield child, tuple(stack)
            yield from rec(child)
        if is_fn:
            stack.pop()

    yield from rec(tree)


# ======================================================= 1. atomic-write

@register
class AtomicWriteRule(Rule):
    id = "atomic-write"
    summary = ("raw open-for-write / os.replace outside durability/ — "
               "durable state must use durability.atomic")
    rationale = (
        "The durability layer made every persistent write crash-safe "
        "(tmp + fsync + "
        "rename + checksum framing). A raw open(path, 'w') reintroduces "
        "torn-write windows the whole durability matrix exists to "
        "close. User-facing output streams are legitimate — suppress "
        "those with a reason.")

    SCOPE = "trivy_tpu_torch/"
    EXEMPT = ("trivy_tpu_torch/durability/",)

    def check(self, project: Project):
        for pf in project.files():
            if not pf.relpath.startswith(self.SCOPE):
                continue
            if pf.relpath.startswith(self.EXEMPT):
                continue
            for node in ast.walk(pf.tree):
                if not isinstance(node, ast.Call):
                    continue
                tail = _func_tail(node.func)
                if tail == "open" and isinstance(node.func, ast.Name):
                    mode = None
                    if len(node.args) >= 2:
                        mode = _const_str(node.args[1])
                    for kw in node.keywords:
                        if kw.arg == "mode":
                            mode = _const_str(kw.value)
                    if mode and any(c in mode for c in "wax"):
                        yield Finding(
                            self.id, pf.relpath, node.lineno,
                            f"raw open(..., {mode!r}) — persistent state "
                            "must go through durability.atomic."
                            "atomic_write (suppress for user-facing "
                            "output streams)")
                elif (tail == "replace"
                      and isinstance(node.func, ast.Attribute)
                      and isinstance(node.func.value, ast.Name)
                      and node.func.value.id == "os"):
                    yield Finding(
                        self.id, pf.relpath, node.lineno,
                        "os.replace outside durability/ — promote via "
                        "durability.atomic (or suppress if this IS an "
                        "atomic-publish idiom)")


# ========================================================= 2. fault-site

@register
class FaultSiteRule(Rule):
    id = "fault-site"
    summary = ("every fault site used in code ⇔ declared in "
               "faults.SITES ⇔ listed in docs/resilience.md")
    rationale = (
        "The fault matrix is only as good as its site list: an "
        "instrumented call site missing from the grammar cannot be "
        "exercised by TRIVY_TPU_FAULTS specs, and a documented site "
        "that no code fires is a matrix hole reviewers trust but "
        "nothing tests. faults.SITES is the single source of truth.")

    FAULT_FNS = {"fire", "check_kill", "check_device", "mangle_write"}
    # site families synthesized at runtime (faults.rpc_site();
    # fleet.endpoint.<index> per replica), never appearing as code
    # literals
    DYNAMIC_FAMILIES = {"rpc", "rpc.scan", "rpc.cache",
                        "fleet.endpoint"}
    DOC = "docs/resilience.md"

    def _used_sites(self, project: Project):
        # a site counts as USED only when it flows into a fault call
        # (directly or via a module constant) — a surviving *_SITE
        # constant whose fire() was deleted must not mask the
        # declared-but-never-fired check
        used: dict[str, tuple[str, int]] = {}
        for pf in project.files():
            consts = _module_consts(pf.tree)
            for node in ast.walk(pf.tree):
                if not isinstance(node, ast.Call):
                    continue
                tail = _func_tail(node.func)
                if tail in self.FAULT_FNS and node.args:
                    site = _const_str(node.args[0])
                    if site is None and isinstance(node.args[0], ast.Name):
                        site = consts.get(node.args[0].id)
                    if site:
                        used.setdefault(site, (pf.relpath, node.lineno))
                for kw in node.keywords:
                    if kw.arg == "fault_site":
                        site = _const_str(kw.value)
                        if site is None and isinstance(kw.value, ast.Name):
                            site = consts.get(kw.value.id)
                        if site:
                            used.setdefault(site,
                                            (pf.relpath, node.lineno))
        return used

    @staticmethod
    def _covered(site: str, declared: set[str]) -> bool:
        return site in declared or any(
            site.startswith(d + ".") for d in declared)

    def check(self, project: Project):
        declared_pairs = project.declared_fault_sites
        declared = {s for s, _ in declared_pairs}
        faults_py = "trivy_tpu_torch/resilience/faults.py"
        if not declared_pairs:
            yield Finding(self.id, faults_py, 1,
                          "faults.SITES is missing or empty — the site "
                          "grammar must be exported as structured data")
            return
        valid_actions = project.declared_fault_actions
        if valid_actions is not None:
            for site, actions in declared_pairs:
                for a in actions:
                    if a not in valid_actions:
                        yield Finding(
                            self.id, faults_py, 1,
                            f"SITES declares unknown action {a!r} for "
                            f"site {site!r}")
        used = self._used_sites(project)
        for site, (path, line) in sorted(used.items()):
            if not self._covered(site, declared):
                yield Finding(
                    self.id, path, line,
                    f"fault site {site!r} used in code but not declared "
                    "in faults.SITES")
        for site in sorted(declared):
            if site in self.DYNAMIC_FAMILIES:
                continue
            if site not in used and not any(
                    u == site or u.startswith(site + ".") for u in used):
                yield Finding(
                    self.id, faults_py, 1,
                    f"fault site {site!r} declared in faults.SITES but "
                    "no code fires it")
        doc = project.doc_text(self.DOC)
        if doc is None:
            yield Finding(self.id, self.DOC, 1,
                          "docs/resilience.md missing — the fault-site "
                          "grammar must be documented")
        else:
            doc_sites = self._doc_sites(doc)
            for site in sorted(declared):
                listed = (site in doc_sites if doc_sites is not None
                          else site in doc)
                if not listed:
                    yield Finding(
                        self.id, self.DOC, 1,
                        f"declared fault site {site!r} not listed in "
                        "docs/resilience.md")
            for site in sorted(doc_sites or ()):
                if not self._covered(site, declared):
                    yield Finding(
                        self.id, self.DOC, 1,
                        f"doc grammar lists fault site {site!r} but "
                        "faults.SITES does not declare it")

    @staticmethod
    def _doc_sites(doc: str):
        """Tokens of the doc's ``site :=`` grammar production (exact
        set — substring matching against prose is unsound: deleting
        ``db.save`` would still 'match' inside ``db.save.metadata``).
        None when the doc has no parseable production; the declared→doc
        check then degrades to the substring test and the reverse
        direction is skipped (seeded mini-project docs)."""
        m = re.search(r"^site\s*:=(.*(?:\n\s*\|.*)*)", doc, re.M)
        if not m:
            return None
        return {t for t in re.split(r"[|\s]+", m.group(1)) if t}


# ======================================================== 3. metric-name

@register
class MetricNameRule(Rule):
    id = "metric-name"
    summary = ("every trivy_tpu_* metric: registered snake_case, "
               "bounded literal label set, cataloged in "
               "docs/observability.md (both directions)")
    rationale = (
        "Dashboards and alerts key on metric names; the golden test "
        "keeps old names byte-stable but nothing stopped NEW metrics "
        "from skipping the docs catalog or declaring open-ended label "
        "sets. The registry bounds series cardinality at runtime — "
        "this rule bounds it at review time.")

    NAME_RX = re.compile(r"^trivy_tpu_[a-z0-9]+(_[a-z0-9]+)*$")
    REG_FNS = {"counter", "gauge", "histogram"}
    DOC = "docs/observability.md"
    DOC_ROW_RX = re.compile(r"\|\s*`(trivy_tpu_[a-zA-Z0-9_]+)`")

    def check(self, project: Project):
        registered: dict[str, tuple[str, int]] = {}
        for pf in project.files():
            for node in ast.walk(pf.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in self.REG_FNS
                        and node.args):
                    continue
                name = _const_str(node.args[0])
                if name is None or not name.startswith("trivy_tpu_"):
                    continue
                registered.setdefault(name, (pf.relpath, node.lineno))
                if not self.NAME_RX.match(name):
                    yield Finding(
                        self.id, pf.relpath, node.lineno,
                        f"metric {name!r} is not snake_case "
                        "(trivy_tpu_[a-z0-9_]+)")
                labels = None
                for kw in node.keywords:
                    if kw.arg == "labels":
                        labels = kw.value
                if labels is not None and not (
                        isinstance(labels, (ast.Tuple, ast.List))
                        and all(_const_str(e) is not None
                                for e in labels.elts)):
                    yield Finding(
                        self.id, pf.relpath, node.lineno,
                        f"metric {name!r}: labels must be a literal "
                        "tuple of names (a computed label set defeats "
                        "the cardinality bound)")
        doc = project.doc_text(self.DOC)
        if doc is None:
            yield Finding(self.id, self.DOC, 1,
                          "docs/observability.md missing — the metric "
                          "catalog lives there")
            return
        # both directions match against parsed catalog ROWS — a prose
        # mention of the name elsewhere in the doc is not a catalog entry
        doc_names = set(self.DOC_ROW_RX.findall(doc))
        for name, (path, line) in sorted(registered.items()):
            if name not in doc_names:
                yield Finding(
                    self.id, path, line,
                    f"metric {name!r} registered but absent from the "
                    "docs/observability.md catalog")
        for name in sorted(doc_names):
            if name not in registered:
                yield Finding(
                    self.id, self.DOC, 1,
                    f"docs/observability.md catalogs {name!r} but no "
                    "code registers it")


# ========================================================== 4. env-knob

@register
class EnvKnobRule(Rule):
    id = "env-knob"
    summary = ("every TRIVY_TPU_* env read declared in analysis.knobs "
               "(and vice versa); docs/knobs_torch.md regenerated")
    rationale = (
        "Undocumented knobs are how operators discover behavior by "
        "reading source at 3am. The knobs table is the contract: every "
        "read is declared with a default and doc line, every declared "
        "knob is actually read, and docs/knobs_torch.md is generated "
        "from "
        "the table so it cannot drift.")

    ENV_FNS = {"get", "pop", "getenv"}
    DOC = "docs/knobs_torch.md"

    @staticmethod
    def _is_environ(node) -> bool:
        return (isinstance(node, ast.Attribute)
                and node.attr == "environ"
                and isinstance(node.value, ast.Name)
                and node.value.id == "os")

    def _key_name(self, node, consts) -> tuple[str | None, bool]:
        """-> (resolved TRIVY_TPU_* name or None, is_dynamic)."""
        val = _const_str(node)
        if val is None and isinstance(node, ast.Name):
            val = consts.get(node.id)
        if val is not None:
            return (val, False) if val.startswith("TRIVY_TPU_") else \
                (None, False)
        # computed key: dynamic iff any resolvable fragment carries the
        # prefix (cli/config.py's ENV_PREFIX + flag wildcard)
        for sub in ast.walk(node):
            frag = _const_str(sub)
            if frag is None and isinstance(sub, ast.Name):
                frag = consts.get(sub.id)
            if frag and frag.startswith("TRIVY_TPU_"):
                return None, True
        return None, False

    def _reads(self, pf: PyFile):
        consts = _module_consts(pf.tree)
        for node in ast.walk(pf.tree):
            key = None
            if isinstance(node, ast.Call):
                func = node.func
                if (isinstance(func, ast.Attribute)
                        and func.attr in self.ENV_FNS
                        and (self._is_environ(func.value)
                             or (isinstance(func.value, ast.Name)
                                 and func.value.id == "os"
                                 and func.attr == "getenv"))
                        and node.args):
                    key = node.args[0]
            elif isinstance(node, ast.Subscript):
                if self._is_environ(node.value):
                    key = node.slice
            elif isinstance(node, ast.Compare):
                if (len(node.ops) == 1
                        and isinstance(node.ops[0], (ast.In, ast.NotIn))
                        and self._is_environ(node.comparators[0])):
                    key = node.left
            if key is None:
                continue
            name, dynamic = self._key_name(key, consts)
            if name is not None:
                yield name, node.lineno, False
            elif dynamic:
                yield "", node.lineno, True

    def check(self, project: Project):
        declared = {k.name for k in project.declared_knobs}
        knobs_py = "trivy_tpu_torch/analysis/knobs.py"
        read: set[str] = set()
        for pf in project.files():
            for name, line, dynamic in self._reads(pf):
                if dynamic:
                    yield Finding(
                        self.id, pf.relpath, line,
                        "dynamic TRIVY_TPU_* env read — computed knob "
                        "names bypass the registry (suppress with the "
                        "wildcard's contract if intentional)")
                    continue
                read.add(name)
                if name not in declared:
                    yield Finding(
                        self.id, pf.relpath, line,
                        f"env knob {name!r} read here but not declared "
                        "in analysis.knobs.KNOBS")
        for name in sorted(declared - read):
            yield Finding(
                self.id, knobs_py, 1,
                f"knob {name!r} declared but nothing reads it")
        doc = project.doc_text(self.DOC)
        if doc is not None or project.doc_text("README.md") is not None:
            # staleness is judged against the LINTED tree's extracted
            # table (a --root worktree that adds a knob but forgets to
            # regenerate must fail); seeded mini-projects have no docs/
            # at all -> doc is None AND no README -> skip
            from trivy_tpu_torch.analysis import knobs as knobs_mod
            want = knobs_mod.generate_knobs_md(project.declared_knobs)
            if doc is None:
                yield Finding(
                    self.id, self.DOC, 1,
                    "docs/knobs_torch.md missing — generate it with "
                    "`python -m trivy_tpu_torch.analysis.lint "
                    "--write-knobs-doc`")
            elif doc != want:
                yield Finding(
                    self.id, self.DOC, 1,
                    "docs/knobs_torch.md is stale vs analysis.knobs — "
                    "regenerate with `python -m "
                    "trivy_tpu_torch.analysis.lint --write-knobs-doc`")


# ==================================================== 5. monotonic-clock

@register
class MonotonicClockRule(Rule):
    id = "monotonic-clock"
    summary = ("time.time() banned in retry/deadline/scheduler "
               "arithmetic — use time.monotonic()")
    rationale = (
        "Wall clocks jump (NTP step, VM resume); a deadline computed "
        "from time.time() can expire a request instantly or never. "
        "Elapsed-time math in the timing-sensitive modules must use "
        "the monotonic clock. Wall-clock timestamps persisted for "
        "humans (journals, report clocks, mtime comparisons) live "
        "outside this scope or carry a suppression.")

    SCOPE = (
        "trivy_tpu_torch/resilience/", "trivy_tpu_torch/sched/", "trivy_tpu_torch/rpc/",
        "trivy_tpu_torch/fanal/", "trivy_tpu_torch/detector/", "trivy_tpu_torch/cache/",
        "trivy_tpu_torch/utils/pipeline.py", "trivy_tpu_torch/k8s/node_collector.py",
    )

    def check(self, project: Project):
        for pf in project.files():
            if not pf.relpath.startswith(self.SCOPE):
                continue
            for node in ast.walk(pf.tree):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "time"
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "time"):
                    yield Finding(
                        self.id, pf.relpath, node.lineno,
                        "time.time() in a timing-sensitive module — "
                        "use time.monotonic() for elapsed/deadline "
                        "math (suppress only for persisted wall-clock "
                        "timestamps)")


# =================================================== 6. tracing-capture

@register
class TracingCaptureRule(Rule):
    id = "tracing-capture"
    summary = ("callables handed to threads/executors in "
               "obs-instrumented modules must capture/adopt the "
               "tracing context")
    rationale = (
        "The single-trace-tree guarantee depends on every "
        "cross-thread handoff using tracing.capture() in the submitter "
        "and tracing.adopt() in the worker; one missed handoff turns a "
        "scan's spans into orphaned roots and breaks trace-correlated "
        "log grepping. Server accept loops with no ambient scan "
        "context suppress with that reason.")

    SCOPE = "trivy_tpu_torch/"
    EXECUTOR_RX = re.compile(r"(^|_)(ex|executor|pool)$|executor",
                             re.IGNORECASE)

    @staticmethod
    def _module_instrumented(pf: PyFile) -> bool:
        return "trivy_tpu_torch.obs" in pf.source

    @staticmethod
    def _has_capture(node) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                tail = _func_tail(sub.func)
                if tail in ("capture", "adopt"):
                    return True
        return False

    def check(self, project: Project):
        for pf in project.files():
            if not pf.relpath.startswith(self.SCOPE):
                continue
            if not self._module_instrumented(pf):
                continue
            # class name -> ClassDef, for resolving self.<method> targets
            classes = {n.name: n for n in ast.walk(pf.tree)
                       if isinstance(n, ast.ClassDef)}
            class_of_fn: dict[ast.AST, ast.ClassDef] = {}
            for cls in classes.values():
                for item in cls.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        class_of_fn[item] = cls
            module_fns = {n.name: n for n in pf.tree.body
                          if isinstance(n, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))}
            for node, fn_stack in _walk_with_parents(pf.tree):
                if not isinstance(node, ast.Call):
                    continue
                target = None
                kind = None
                tail = _func_tail(node.func)
                if tail == "Thread":
                    for kw in node.keywords:
                        if kw.arg == "target":
                            target = kw.value
                            kind = "threading.Thread"
                elif (tail == "submit"
                      and isinstance(node.func, ast.Attribute)):
                    recv = node.func.value
                    recv_name = (recv.id if isinstance(recv, ast.Name)
                                 else recv.attr
                                 if isinstance(recv, ast.Attribute)
                                 else "")
                    if recv_name and self.EXECUTOR_RX.search(recv_name) \
                            and node.args:
                        target = node.args[0]
                        kind = f"{recv_name}.submit"
                if target is None:
                    continue
                # pass if the enclosing function captures/adopts ...
                if fn_stack and self._has_capture(fn_stack[-1]):
                    continue
                # ... or the resolved target function / its class does
                resolved = None
                if isinstance(target, ast.Name):
                    resolved = module_fns.get(target.id)
                elif (isinstance(target, ast.Attribute)
                      and isinstance(target.value, ast.Name)
                      and target.value.id == "self" and fn_stack):
                    cls = class_of_fn.get(fn_stack[-1])
                    if cls is not None:
                        resolved = cls  # whole class: worker methods
                        # often delegate adopt() to a helper method
                if resolved is not None and self._has_capture(resolved):
                    continue
                yield Finding(
                    self.id, pf.relpath, node.lineno,
                    f"{kind} handoff in an obs-instrumented module "
                    "without tracing.capture()/adopt() — worker spans "
                    "will orphan from the submitting scan's trace")


# ====================================================== 7. bare-except

@register
class BareExceptRule(Rule):
    id = "bare-except"
    summary = ("no bare `except:`; `except BaseException` must "
               "re-raise (or carry a suppression explaining delivery)")
    rationale = (
        "InjectedKill is a BaseException precisely so crash simulations "
        "unwind without cleanup handlers running; a handler that "
        "swallows BaseException also swallows the injected kill, "
        "KeyboardInterrupt and interpreter shutdown. Handlers that "
        "transport the exception to another thread re-raise there — "
        "they suppress with that reason.")

    def check(self, project: Project):
        for pf in project.files():
            for node in ast.walk(pf.tree):
                if not isinstance(node, ast.ExceptHandler):
                    continue
                if node.type is None:
                    yield Finding(
                        self.id, pf.relpath, node.lineno,
                        "bare `except:` — name the exception type "
                        "(this also catches KeyboardInterrupt and "
                        "InjectedKill)")
                    continue
                names = []
                types = (node.type.elts
                         if isinstance(node.type, ast.Tuple)
                         else [node.type])
                for t in types:
                    if isinstance(t, ast.Name):
                        names.append(t.id)
                if "BaseException" not in names:
                    continue
                if any(isinstance(sub, ast.Raise)
                       for sub in ast.walk(node)):
                    continue
                yield Finding(
                    self.id, pf.relpath, node.lineno,
                    "`except BaseException` without a re-raise — this "
                    "swallows InjectedKill / KeyboardInterrupt; "
                    "re-raise or suppress with the delivery path")


# ======================================================= 8. lock-order

@register
class LockOrderRule(Rule):
    id = "lock-order"
    summary = ("the static `with <lock>` nesting graph must be acyclic "
               "(companion to the runtime witness)")
    rationale = (
        "A lock-order cycle is a deadlock waiting for the right "
        "interleaving. The runtime witness sees real acquisitions in "
        "the concurrency tests; this static pass sees every nesting "
        "the code spells out, so an inversion is caught even when no "
        "test drives both arms. The two graphs share one naming "
        "convention and are unioned in tests/test_analysis.py.")

    SCOPE = "trivy_tpu_torch/"

    def check(self, project: Project):
        files = [(pf.relpath, pf.tree) for pf in project.files()
                 if pf.relpath.startswith(self.SCOPE)]
        edges, where = lockstatic.static_graph(files)
        cyc = lockstatic_find_cycle(edges)
        if cyc:
            spots = []
            for a, b in zip(cyc, cyc[1:]):
                path, line = where.get((a, b), ("?", 0))
                spots.append(f"{a} -> {b} ({path}:{line})")
            first = where.get((cyc[0], cyc[1]), ("trivy_tpu_torch", 1))
            yield Finding(
                self.id, first[0], first[1],
                "static lock-order cycle: " + "; ".join(spots))


def lockstatic_find_cycle(edges):
    from trivy_tpu_torch.analysis.witness import find_cycle
    return find_cycle(edges)


# ==================================================== 9. span-taxonomy

@register
class SpanTaxonomyRule(Rule):
    id = "span-taxonomy"
    summary = ("every span name emitted under trivy_tpu_torch/ ⇔ classified "
               "in obs/attrib.py's attribution taxonomy (both "
               "directions; dynamic families via declared prefixes)")
    rationale = (
        "The bottleneck attribution layer (/debug/profile, bench "
        "capstone) is only as honest as its span taxonomy: an emitted "
        "span the classifier doesn't know silently lands in 'other' "
        "and the roofline verdict drifts, while a classified span no "
        "code emits is vocabulary reviewers trust but nothing feeds. "
        "obs/attrib.py is the single source of truth; bench.py's "
        "harness-only spans are out of scope by design.")

    SPAN_FNS = {"span", "phase", "server_span"}
    SCOPE = "trivy_tpu_torch/"
    ATTRIB_PY = "trivy_tpu_torch/obs/attrib.py"

    def _emitted(self, project: Project):
        """-> ({name: (path, line)}, [(prefix_frag, path, line)]).
        A span name counts when the first argument of a span/phase/
        server_span call resolves to a literal (directly or via a
        module constant); f-string names contribute their leading
        literal fragment as a dynamic-family probe. Unresolvable
        names (helper parameters like obs.phase's forwarding call)
        are ignored — they re-emit a name classified at the real
        call site."""
        used: dict[str, tuple[str, int]] = {}
        dynamic: list[tuple[str, str, int]] = []
        for pf in project.files():
            if not pf.relpath.startswith(self.SCOPE):
                continue
            consts = _module_consts(pf.tree)
            for node in ast.walk(pf.tree):
                if not (isinstance(node, ast.Call)
                        and _func_tail(node.func) in self.SPAN_FNS
                        and node.args):
                    continue
                arg = node.args[0]
                name = _const_str(arg)
                if name is None and isinstance(arg, ast.Name):
                    name = consts.get(arg.id)
                if name is not None:
                    used.setdefault(name, (pf.relpath, node.lineno))
                elif isinstance(arg, ast.JoinedStr) and arg.values:
                    frag = _const_str(arg.values[0])
                    if frag:
                        dynamic.append((frag, pf.relpath, node.lineno))
        return used, dynamic

    def check(self, project: Project):
        tax = project.declared_span_taxonomy
        if tax is None:
            return  # no taxonomy known (mini-tree without attrib)
        lanes = set(tax["lanes"])
        span_lanes = tax["span_lanes"]
        structural = set(tax["structural"])
        prefixes = tuple(tax["prefixes"])
        for name, lane in sorted(span_lanes.items()):
            if lane not in lanes:
                yield Finding(
                    self.id, self.ATTRIB_PY, 1,
                    f"SPAN_LANES maps {name!r} to unknown lane "
                    f"{lane!r} (not in LANES)")
        for prefix, lane in prefixes:
            if lane not in lanes:
                yield Finding(
                    self.id, self.ATTRIB_PY, 1,
                    f"SPAN_PREFIX_LANES maps {prefix!r} to unknown "
                    f"lane {lane!r} (not in LANES)")
        used, dynamic = self._emitted(project)
        declared = set(span_lanes) | structural
        for name, (path, line) in sorted(used.items()):
            if name in declared:
                continue
            if any(name.startswith(p) for p, _l in prefixes):
                continue
            yield Finding(
                self.id, path, line,
                f"span {name!r} emitted here but not classified in "
                "obs/attrib.py (SPAN_LANES / SPAN_STRUCTURAL / a "
                "declared prefix family) — unclassified spans land "
                "in the attribution report's 'other' bucket")
        for frag, path, line in dynamic:
            if not any(frag.startswith(p) or p.startswith(frag)
                       for p, _l in prefixes):
                yield Finding(
                    self.id, path, line,
                    f"dynamic span family {frag!r}… not covered by "
                    "any SPAN_PREFIX_LANES entry in obs/attrib.py")
        for name in sorted(declared):
            if name not in used:
                yield Finding(
                    self.id, self.ATTRIB_PY, 1,
                    f"taxonomy classifies span {name!r} but no "
                    "instrumented call site emits it")
        for prefix, _lane in prefixes:
            if not any(f.startswith(prefix) or prefix.startswith(f)
                       for f, _p, _ln in dynamic) \
                    and not any(u.startswith(prefix) for u in used):
                yield Finding(
                    self.id, self.ATTRIB_PY, 1,
                    f"SPAN_PREFIX_LANES declares family {prefix!r} "
                    "but no call site emits a span under it")


# ====================================================== 10. event-kind

@register
class EventKindRule(Rule):
    id = "event-kind"
    summary = ("every fleet event kind emitted via emit_event() ⇔ "
               "declared in fleet/slo.py EVENTS ⇔ cataloged in "
               "docs/fleet.md, all directions")
    rationale = (
        "The fleet ops event log is the durable record operators "
        "replay after an incident; its value rests on a closed "
        "vocabulary. A kind emitted but undeclared bypasses the "
        "registry's validation and the docs catalog; a declared kind "
        "nothing emits is operational vocabulary reviewers trust but "
        "no code produces; an undocumented kind is a journal record "
        "nobody can interpret at 3am. fleet/slo.py's EVENTS table is "
        "the single source of truth.")

    EMIT_FNS = {"emit_event"}
    # controller action kinds surface at two literal-first-arg sites:
    # the emit funnel (emit_action) and the decision constructor
    # (_Decision) — either one anchors "some code produces this kind"
    ACTION_EMIT_FNS = {"emit_action"}
    ACTION_SITE_FNS = {"emit_action", "_Decision"}
    SLO_PY = "trivy_tpu_torch/fleet/slo.py"
    CONTROLLER_PY = "trivy_tpu_torch/fleet/controller.py"
    DOC = "docs/fleet.md"
    # catalog rows: | `kind` | description |  (the event + controller-
    # action catalogs are the only docs/fleet.md tables whose first
    # cell is a backticked lowercase identifier)
    DOC_ROW_RX = re.compile(r"^\|\s*`([a-z][a-z0-9_]*)`\s*\|", re.M)

    def _calls(self, project: Project, fns: set):
        """(literal-kind-or-None, (path, line)) per call of ``fns`` —
        literal first arguments deduped to their first site, computed
        ones yielded per site."""
        used: dict[str, tuple[str, int]] = {}
        for pf in project.files():
            consts = _module_consts(pf.tree)
            for node in ast.walk(pf.tree):
                if not (isinstance(node, ast.Call)
                        and _func_tail(node.func) in fns
                        and node.args):
                    continue
                kind = _const_str(node.args[0])
                if kind is None and isinstance(node.args[0], ast.Name):
                    kind = consts.get(node.args[0].id)
                if kind is not None:
                    used.setdefault(kind, (pf.relpath, node.lineno))
                else:
                    yield None, (pf.relpath, node.lineno)
        for kind, where in used.items():
            yield kind, where

    def _emitted(self, project: Project):
        yield from self._calls(project, self.EMIT_FNS)

    def check(self, project: Project):
        declared_pairs = project.declared_event_kinds
        if declared_pairs is None:
            return  # no registry known (mini-tree without fleet/slo.py)
        if not declared_pairs:
            yield Finding(self.id, self.SLO_PY, 1,
                          "fleet.slo.EVENTS is missing or empty — the "
                          "event vocabulary must be exported as "
                          "structured data")
            return
        declared = {k for k, _ in declared_pairs}
        used: dict[str, tuple[str, int]] = {}
        for kind, (path, line) in self._emitted(project):
            if kind is None:
                yield Finding(
                    self.id, path, line,
                    "emit_event() with a computed kind — event kinds "
                    "must be literal so the registry/docs coherence "
                    "is checkable (suppress with the contract if "
                    "intentional)")
                continue
            used.setdefault(kind, (path, line))
            if kind not in declared:
                yield Finding(
                    self.id, path, line,
                    f"fleet event kind {kind!r} emitted here but not "
                    "declared in fleet.slo.EVENTS")
        for kind in sorted(declared - set(used)):
            yield Finding(
                self.id, self.SLO_PY, 1,
                f"fleet event kind {kind!r} declared in EVENTS but "
                "no code emits it")
        # ---- controller actions (docs/fleet.md "Self-driving fleet")
        action_pairs = getattr(project, "declared_action_kinds", None)
        actions: set = set()
        if action_pairs is not None:
            if not action_pairs:
                yield Finding(
                    self.id, self.CONTROLLER_PY, 1,
                    "fleet.controller.ACTIONS is missing or empty — "
                    "the controller action vocabulary must be "
                    "exported as structured data")
            actions = {k for k, _ in action_pairs}
            for kind in sorted(actions & declared):
                yield Finding(
                    self.id, self.CONTROLLER_PY, 1,
                    f"kind {kind!r} declared in BOTH fleet.slo.EVENTS "
                    "and fleet.controller.ACTIONS — the vocabularies "
                    "must stay disjoint (actions ride inside "
                    "controller_action events)")
            action_sites: dict[str, tuple[str, int]] = {}
            for kind, (path, line) in self._calls(
                    project, self.ACTION_EMIT_FNS):
                if kind is None:
                    yield Finding(
                        self.id, path, line,
                        "emit_action() with a computed kind — action "
                        "kinds must be literal so the registry/docs "
                        "coherence is checkable (suppress with the "
                        "contract if intentional)")
                    continue
                action_sites.setdefault(kind, (path, line))
                if kind not in actions:
                    yield Finding(
                        self.id, path, line,
                        f"controller action kind {kind!r} emitted "
                        "here but not declared in "
                        "fleet.controller.ACTIONS")
            for kind, (path, line) in self._calls(
                    project, self.ACTION_SITE_FNS - self.ACTION_EMIT_FNS):
                if kind is None:
                    continue  # reconstruction sites may be computed
                action_sites.setdefault(kind, (path, line))
                if kind not in actions:
                    yield Finding(
                        self.id, path, line,
                        f"controller action kind {kind!r} emitted "
                        "here but not declared in "
                        "fleet.controller.ACTIONS")
            for kind in sorted(actions - set(action_sites)):
                yield Finding(
                    self.id, self.CONTROLLER_PY, 1,
                    f"controller action kind {kind!r} declared in "
                    "ACTIONS but no code emits it")
        # ---- the docs/fleet.md catalogs (events + actions)
        doc = project.doc_text(self.DOC)
        if doc is None:
            yield Finding(self.id, self.DOC, 1,
                          "docs/fleet.md missing — the fleet event "
                          "catalog lives there")
            return
        doc_kinds = set(self.DOC_ROW_RX.findall(doc))
        for kind in sorted(declared):
            if kind not in doc_kinds:
                yield Finding(
                    self.id, self.DOC, 1,
                    f"declared fleet event kind {kind!r} absent from "
                    "the docs/fleet.md event catalog")
        for kind in sorted(actions):
            if kind not in doc_kinds:
                yield Finding(
                    self.id, self.DOC, 1,
                    f"declared controller action kind {kind!r} absent "
                    "from the docs/fleet.md action catalog")
        for kind in sorted(doc_kinds - declared - actions):
            if action_pairs is None:
                yield Finding(
                    self.id, self.DOC, 1,
                    f"docs/fleet.md catalogs event kind {kind!r} but "
                    "fleet.slo.EVENTS does not declare it")
            else:
                yield Finding(
                    self.id, self.DOC, 1,
                    f"docs/fleet.md catalogs kind {kind!r} but "
                    "neither fleet.slo.EVENTS nor "
                    "fleet.controller.ACTIONS declares it")


# =================================================== 11. chaos-coverage

@register
class ChaosCoverageRule(Rule):
    id = "chaos-coverage"
    summary = ("chaos scenario MANIFEST ⇔ faults.SITES ⇔ "
               "docs/resilience.md: every (site, action) pair claimed "
               "by exactly one scenario that exists and is documented")
    rationale = (
        "The chaos campaign's coverage gate is only sound if the "
        "manifest it checks against is itself sound. A fault pair no "
        "scenario claims is a hole campaigns can never exercise — the "
        "injection point exists but nothing drives traffic through "
        "it; a pair claimed twice makes per-scenario sweep ownership "
        "ambiguous; a manifest entry without a scenario class is "
        "coverage the campaign silently skips. chaos/scenarios.py's "
        "MANIFEST is the single source of truth and must stay an "
        "exact partition of faults.SITES.")

    SCENARIOS_PY = "trivy_tpu_torch/chaos/scenarios.py"
    DOC = "docs/resilience.md"
    SECTION_RX = re.compile(r"^#+\s*Chaos campaigns\s*$", re.M)

    def _manifest_line(self, project: Project) -> int:
        node = project._registry_assign(self.SCENARIOS_PY, "MANIFEST")
        return getattr(node, "lineno", 1)

    @staticmethod
    def _scenario_class_names(project: Project) -> set[str]:
        """`name = "<literal>"` class attributes of scenarios.py
        ClassDefs — the campaign's scenario registry keys."""
        pf = project.file(ChaosCoverageRule.SCENARIOS_PY)
        names: set[str] = set()
        if pf is None:
            return names
        for node in pf.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            for sub in node.body:
                if (isinstance(sub, ast.Assign)
                        and any(isinstance(t, ast.Name)
                                and t.id == "name"
                                for t in sub.targets)):
                    val = _const_str(sub.value)
                    if val:
                        names.add(val)
        return names

    def check(self, project: Project):
        manifest = getattr(project, "declared_chaos_manifest", None)
        if manifest is None:
            return  # tree has no chaos package
        line = self._manifest_line(project)
        if not manifest:
            yield Finding(
                self.id, self.SCENARIOS_PY, line,
                "chaos.scenarios.MANIFEST is missing or not a pure "
                "literal — the scenario coverage map must be exported "
                "as structured data")
            return
        claimed: dict[tuple[str, str], str] = {}
        for name in sorted(manifest):
            for site, actions in manifest[name]:
                for action in actions:
                    pair = (site, action)
                    if pair in claimed and claimed[pair] != name:
                        yield Finding(
                            self.id, self.SCENARIOS_PY, line,
                            f"fault pair {site}:{action} claimed by "
                            f"both {claimed[pair]!r} and {name!r} — "
                            "the manifest must partition faults.SITES")
                    claimed.setdefault(pair, name)
        declared_pairs = project.declared_fault_sites
        # an empty/missing SITES registry is the fault-site rule's
        # finding, not a reason to call every claimed pair unknown
        if declared_pairs:
            registry = {(site, a) for site, actions in declared_pairs
                        for a in actions}
            for site, action in sorted(registry - set(claimed)):
                yield Finding(
                    self.id, self.SCENARIOS_PY, line,
                    f"fault pair {site}:{action} is declared in "
                    "faults.SITES but no chaos scenario claims it — "
                    "campaigns can never cover it")
            for site, action in sorted(set(claimed) - registry):
                yield Finding(
                    self.id, self.SCENARIOS_PY, line,
                    f"chaos manifest claims fault pair {site}:{action} "
                    "that faults.SITES does not declare")
        class_names = self._scenario_class_names(project)
        if project.file(self.SCENARIOS_PY) is not None:
            for name in sorted(set(manifest) - class_names):
                yield Finding(
                    self.id, self.SCENARIOS_PY, line,
                    f"manifest scenario {name!r} has no scenario "
                    "class (no ClassDef with a literal name = "
                    f"{name!r}) — its pairs are coverage the "
                    "campaign silently skips")
            for name in sorted(class_names - set(manifest)):
                yield Finding(
                    self.id, self.SCENARIOS_PY, line,
                    f"scenario class {name!r} is not in MANIFEST — "
                    "it claims no fault pairs and campaigns never "
                    "run it")
        doc = project.doc_text(self.DOC)
        if doc is None:
            return  # the fault-site rule owns the doc's existence
        m = self.SECTION_RX.search(doc)
        if m is None:
            yield Finding(
                self.id, self.DOC, 1,
                'docs/resilience.md has no "Chaos campaigns" section '
                "— the campaign engine must be documented")
            return
        section = doc[m.end():]
        nxt = re.search(r"^#+ ", section, re.M)
        if nxt is not None:
            section = section[:nxt.start()]
        for name in sorted(manifest):
            if f"`{name}`" not in section:
                yield Finding(
                    self.id, self.DOC, 1,
                    f"chaos scenario {name!r} missing from the "
                    'docs/resilience.md "Chaos campaigns" section '
                    "(expected backticked in the scenario table)")


# ==================================================== 12. usage-field

@register
class UsageFieldRule(Rule):
    id = "usage-field"
    summary = ("usage cost-vector fields: emitted ⇔ usage.FIELDS ⇔ "
               "docs/observability.md 'Cost-vector fields' catalog")
    rationale = (
        "Billing-adjacent data must not drift: a usage.add() of a "
        "field the FIELDS registry does not declare is spend nobody "
        "can interpret, a declared field nothing emits is a catalog "
        "entry operators will query forever and always read zero, and "
        "an undocumented field is a number tenants see on their bill "
        "with no definition behind it. The registry is the single "
        "source of truth and must stay a pure literal so this rule "
        "(and the docs) can read it without importing the tree.")

    USAGE_PY = "trivy_tpu_torch/obs/usage.py"
    DOC = "docs/observability.md"
    SECTION_RX = re.compile(r"^#+\s*Cost-vector fields\s*$", re.M)
    DOC_ROW_RX = re.compile(r"^\|\s*`([a-z0-9_]+)`", re.M)

    def _fields_line(self, project: Project) -> int:
        node = project._registry_assign(self.USAGE_PY, "FIELDS")
        return getattr(node, "lineno", 1)

    @staticmethod
    def _emitted(project: Project):
        """(field, path, line) for every literal usage.add()/add_to()
        call site; add_lanes() call sites anchor the ``lane_s``
        conservation field (attrib hands a whole lane dict over, so
        no literal field name appears there)."""
        for pf in project.files():
            if pf.relpath == UsageFieldRule.USAGE_PY:
                continue  # the registry's own module
            for node in ast.walk(pf.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "usage"):
                    continue
                if node.func.attr == "add" and node.args:
                    yield (_const_str(node.args[0]), pf.relpath,
                           node.lineno)
                elif node.func.attr == "add_to" and len(node.args) >= 2:
                    yield (_const_str(node.args[1]), pf.relpath,
                           node.lineno)
                elif node.func.attr == "add_lanes":
                    yield ("lane_s", pf.relpath, node.lineno)

    def check(self, project: Project):
        declared_pairs = getattr(project, "declared_usage_fields", None)
        if declared_pairs is None:
            return  # tree has no usage module
        line = self._fields_line(project)
        if not declared_pairs:
            yield Finding(
                self.id, self.USAGE_PY, line,
                "obs.usage.FIELDS is missing or not a pure literal — "
                "the cost-vector catalog must be exported as "
                "structured data")
            return
        declared = {n for n, _d in declared_pairs}
        emitted: dict[str, tuple[str, int]] = {}
        for field, path, lineno in self._emitted(project):
            if field is None:
                yield Finding(
                    self.id, path, lineno,
                    "usage field name must be a string literal — a "
                    "computed field defeats the catalog check")
                continue
            emitted.setdefault(field, (path, lineno))
            if field not in declared:
                yield Finding(
                    self.id, path, lineno,
                    f"usage field {field!r} emitted but not declared "
                    "in obs.usage.FIELDS")
        for field in sorted(declared - set(emitted)):
            yield Finding(
                self.id, self.USAGE_PY, line,
                f"usage field {field!r} declared in FIELDS but no "
                "code emits it — operators will query it forever and "
                "always read zero")
        doc = project.doc_text(self.DOC)
        if doc is None:
            return  # the metric-name rule owns the doc's existence
        m = self.SECTION_RX.search(doc)
        if m is None:
            yield Finding(
                self.id, self.DOC, 1,
                'docs/observability.md has no "Cost-vector fields" '
                "section — the usage catalog must be documented")
            return
        section = doc[m.end():]
        nxt = re.search(r"^#+ ", section, re.M)
        if nxt is not None:
            section = section[:nxt.start()]
        doc_fields = set(self.DOC_ROW_RX.findall(section))
        for field in sorted(declared - doc_fields):
            yield Finding(
                self.id, self.DOC, 1,
                f"usage field {field!r} missing from the "
                '"Cost-vector fields" table')
        for field in sorted(doc_fields - declared):
            yield Finding(
                self.id, self.DOC, 1,
                f'"Cost-vector fields" table documents {field!r} but '
                "obs.usage.FIELDS does not declare it")


# ----------------------------------------------------------- the runner

def _suppression_for(pf: PyFile | None, finding: Finding):
    """-> ("ok" | "missing-reason" | None)."""
    if pf is None:
        return None
    for ln in (finding.line, finding.line - 1):
        if 1 <= ln <= len(pf.lines):
            m = SUPPRESS_RX.search(pf.lines[ln - 1])
            if m:
                rules = {r.strip() for r in m.group("rules").split(",")}
                if finding.rule in rules:
                    return "ok" if m.group("reason").strip() else \
                        "missing-reason"
    return None


def load_baseline(path: str) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    entries = doc.get("findings", [])
    for e in entries:
        if not (e.get("rule") and e.get("path")):
            raise ValueError(
                "baseline entries need at least {rule, path}")
    return entries


def run(project: Project, rule_ids=None, baseline=None):
    """Run rules -> (findings, suppressed).

    ``baseline`` is a list of ``{"rule", "path", "reason"}`` dicts;
    entries without a non-empty reason are reported as findings
    (rule id ``baseline``) rather than honored — a baseline is
    staged debt, not a mute button."""
    baseline = baseline or []
    base_ok = set()
    findings: list[Finding] = []
    suppressed: list[tuple[Finding, str]] = []
    for e in baseline:
        if str(e.get("reason", "")).strip():
            base_ok.add((e["rule"], e["path"]))
        else:
            findings.append(Finding(
                "baseline", e["path"], 0,
                f"baseline entry for [{e['rule']}] has no reason — "
                "baselines record justified debt, not mutes"))
    for rid, cls in sorted(RULES.items()):
        if rule_ids is not None and rid not in rule_ids:
            continue
        for f in cls().check(project):
            sup = _suppression_for(project.file(f.path), f)
            if sup == "ok":
                suppressed.append((f, "inline"))
            elif sup == "missing-reason":
                findings.append(Finding(
                    "suppression", f.path, f.line,
                    f"suppression of [{f.rule}] has no reason — the "
                    "comment is the review trail"))
            elif (f.rule, f.path) in base_ok:
                suppressed.append((f, "baseline"))
            else:
                findings.append(f)
    return findings, suppressed
