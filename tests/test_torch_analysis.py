"""The port's static-analysis suite (trivy_tpu_torch/analysis): the
ENFORCEMENT test that keeps the port's tree lint-clean with the port's
linter, a seeded violation per rule run through both linters (the
findings equal once `trivy_tpu/` is mapped to `trivy_tpu_torch/`), the
rule catalog, suppressions and the shared baseline, the knob table and
its generated doc (`docs/knobs_torch.md`, never `docs/knobs.md`), and
the static-vs-runtime lock graph check on the port's witness."""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import random
import subprocess
import sys
import threading

import pytest

from trivy_tpu.analysis import knobs as jax_knobs
from trivy_tpu.analysis import rules as jax_rules
from trivy_tpu.cli import main as jax_main
from trivy_tpu_torch.analysis import knobs, lint, lockstatic, rules, witness
from trivy_tpu_torch.cli.main import main

pytestmark = pytest.mark.analysis

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def to_port(text: str) -> str:
    """A reference path, import or message as the port spells it."""
    return (text.replace("trivy_tpu/", "trivy_tpu_torch/")
            .replace("trivy_tpu.", "trivy_tpu_torch.")
            .replace("docs/knobs.md", "docs/knobs_torch.md"))


def make_project(tmp_path, files: dict[str, str],
                 docs: dict[str, str] | None = None,
                 package: str = "trivy_tpu_torch",
                 mod=rules) -> "rules.Project":
    """Synthetic mini-tree: `files` land under `package`/, `docs` under
    docs/ (README.md marks it a checkout)."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    (tmp_path / "README.md").write_text("mini-tree fixture\n")
    for rel, src in files.items():
        p = tmp_path / package / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    for rel, text in (docs or {}).items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return mod.Project(str(tmp_path))


@pytest.fixture(scope="module")
def port_project():
    """The port's tree, parsed once for the tests that only read it."""
    return rules.Project(REPO_ROOT)


def run_rule(project, rule_id, mod=rules) -> list:
    findings, _ = mod.run(project, rule_ids={rule_id})
    return [f for f in findings if f.rule == rule_id]


# ===================================================== enforcement


def test_port_tree_is_lint_clean():
    """THE gate: the port's linter exits clean on the port's tree with
    the shared, empty baseline."""
    findings, suppressed = lint.run_lint(root=REPO_ROOT)
    assert not findings, "\n" + "\n".join(f.render() for f in findings)
    assert suppressed, "expected the documented justified suppressions"
    assert {via for _f, via in suppressed} == {"inline"}


def test_every_port_suppression_carries_a_reason(port_project):
    markers = 0
    for pf in port_project.files():
        for line in pf.lines:
            m = rules.SUPPRESS_RX.search(line)
            if m:
                markers += 1
                assert m.group("reason").strip(), (pf.relpath, line)
    assert markers >= 40


def test_shared_baseline_is_empty():
    with open(os.path.join(REPO_ROOT, ".lint-baseline.json")) as f:
        assert json.load(f) == {"version": 1, "findings": []}


def test_file_sets_do_not_overlap(port_project):
    """The port's linter reads `trivy_tpu_torch/` alone (no bench
    script, no smoke script); the reference's never reads the port."""
    port = [pf.relpath for pf in port_project.files()]
    ref = [pf.relpath for pf in jax_rules.Project(REPO_ROOT).files()]
    assert port and all(p.startswith("trivy_tpu_torch/") for p in port)
    assert "trivy_tpu_torch/analysis/rules.py" in port
    assert not any(p.startswith("trivy_tpu_torch/") for p in ref)
    assert "chip_smoke.py" not in port + ref


def test_module_entrypoint_json():
    proc = subprocess.run(
        [sys.executable, "-m", "trivy_tpu_torch.analysis.lint", "--json"],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["clean"] is True
    assert sorted(doc["rules"]) == sorted(rules.RULES)
    assert all(f["path"].startswith("trivy_tpu_torch/")
               for f in doc["suppressed"])


def test_list_rules_is_the_reference_catalog(capsys):
    assert main(["lint", "--list-rules"]) == 0
    port = capsys.readouterr().out
    assert jax_main.main(["lint", "--list-rules"]) == 0
    ref = capsys.readouterr().out
    assert port == to_port(ref)
    assert sorted(rules.RULES) == sorted(jax_rules.RULES)


def test_lint_subcommand_runs_the_port_linter(capsys):
    assert main(["--quiet", "lint", "--rule", "bare-except"]) == 0
    assert capsys.readouterr().out.endswith("— clean\n")


def test_unknown_rule_flag():
    assert lint.main(["--rule", "no-such-rule"]) == 2


def test_installed_tree_refused(tmp_path, capsys):
    assert lint.main(["--root", str(tmp_path)]) == 2
    assert "does not look like a trivy-tpu source checkout" in \
        capsys.readouterr().err


# ====================== one seeded violation per rule, both linters

FAULT_SITES = [("used.site", ("drop",)), ("ghost.site", ("drop",))]
SPAN_TAXONOMY = {
    "lanes": ("fetch_io",),
    "span_lanes": {"const.span": "fetch_io", "ghost.span": "fetch_io",
                   "bad.span": "no_such_lane"},
    "structural": set(),
    "prefixes": (("rpc.", "fetch_io"),),
}

# id -> (rule, files under the package, docs, Project overrides,
# whether it fires). Sources and doc names are the reference's
# spelling; the port's tree gets them through `to_port`.
CASES = {
    "atomic_write_fires": ("atomic-write", {
        "x/writer.py": (
            "import os\n"
            "def save(p, data):\n"
            "    with open(p, 'w') as f:\n"
            "        f.write(data)\n"
            "    os.replace(p, p + '.bak')\n"),
        "durability/atomic2.py": (
            "def ok(p, data):\n"
            "    with open(p, 'w') as f:\n"
            "        f.write(data)\n")}, {}, {}, True),
    "atomic_write_read_mode_ok": ("atomic-write", {
        "x/reader.py": "def load(p):\n    return open(p).read()\n"},
        {}, {}, False),
    "fault_site_fires": ("fault-site", {
        "x/mod.py": (
            "from trivy_tpu.resilience import faults\n"
            "def f():\n"
            "    faults.fire('rogue.site')\n")},
        {"docs/resilience.md": "sites: used.site\n"},
        {"declared_fault_sites": FAULT_SITES}, True),
    "fault_site_doc_grammar_fires": ("fault-site", {
        "x/mod.py": (
            "from trivy_tpu.resilience import faults\n"
            "def f():\n"
            "    faults.fire('db.save')\n"
            "    faults.fire('db.save.metadata')\n")},
        {"docs/resilience.md": (
            "```\nsite     := db.save.metadata | phantom.site\n```\n")},
        {"declared_fault_sites": [("db.save", ("kill",)),
                                  ("db.save.metadata", ("kill",))]},
        True),
    "metric_name_fires": ("metric-name", {
        "obs2/m.py": (
            "def setup(reg, names):\n"
            "    reg.counter('trivy_tpu_CamelCase_total', 'x')\n"
            "    reg.gauge('trivy_tpu_undocumented', 'x')\n"
            "    reg.histogram('trivy_tpu_computed', 'x',\n"
            "                  labels=tuple(names))\n")},
        {"docs/observability.md": (
            "| `trivy_tpu_CamelCase_total` | counter |\n"
            "| `trivy_tpu_computed` | histogram |\n"
            "| `trivy_tpu_ghost_total` | counter |\n")}, {}, True),
    "env_knob_fires": ("env-knob", {
        "x/cfg.py": (
            "import os\n"
            "A = os.environ.get('TRIVY_TPU_MYSTERY')\n"
            "B = os.environ.get('TRIVY_TPU_' + 'DYN')\n")}, {},
        {"declared_knobs": [("TRIVY_TPU_DECLARED_ONLY", "", "x", False,
                             "d")]}, True),
    "env_knob_stale_doc_fires": ("env-knob", {
        "x/none.py": "import os\nA = os.environ.get('TRIVY_TPU_K')\n"},
        {"docs/knobs.md": "# stale\n"},
        {"declared_knobs": [("TRIVY_TPU_K", "", "x", False, "d")]}, True),
    "monotonic_clock_fires": ("monotonic-clock", {
        "sched/loop.py": (
            "import time\n"
            "def wait(budget):\n"
            "    deadline = time.time() + budget\n"),
        "k8s/node_collector.py": (
            "import time\n"
            "T = time.time()\n"),
        "report/stamp.py": (
            "import time\n"
            "def stamp():\n"
            "    return time.time()\n")}, {}, {}, True),
    "tracing_capture_fires": ("tracing-capture", {
        "x/workers.py": (
            "import threading\n"
            "from trivy_tpu.obs import tracing\n"
            "def orphan(fn):\n"
            "    threading.Thread(target=fn).start()\n"
            "def good(fn):\n"
            "    ctx = tracing.capture()\n"
            "    threading.Thread(target=fn).start()\n"
            "def pooled(ex, fn):\n"
            "    ex.submit(fn)\n"),
        "x/plain.py": (
            "import threading\n"
            "def f(fn):\n"
            "    threading.Thread(target=fn).start()\n")}, {}, {}, True),
    "span_taxonomy_fires": ("span-taxonomy", {
        "x/spans.py": (
            "from trivy_tpu.obs import tracing\n"
            "SITE = 'const.span'\n"
            "def f(method):\n"
            "    with tracing.span('rogue.span'):\n"
            "        pass\n"
            "    with tracing.span(SITE):\n"
            "        pass\n"
            "    with tracing.span(f'dyn.{method}'):\n"
            "        pass\n")}, {},
        {"declared_span_taxonomy": SPAN_TAXONOMY}, True),
    "event_kind_fires": ("event-kind", {
        "fleet2/ops.py": (
            "from trivy_tpu.fleet.slo import emit_event\n"
            "KIND = 'const_kind'\n"
            "def f(kind):\n"
            "    emit_event('rogue_kind', endpoint='x')\n"
            "    emit_event(KIND)\n"
            "    emit_event(kind)\n")},
        {"docs/fleet.md": (
            "| Kind | One record means |\n|---|---|\n"
            "| `const_kind` | declared and emitted |\n"
            "| `phantom_kind` | documented but undeclared |\n")},
        {"declared_event_kinds": [("const_kind", "d"),
                                  ("ghost_kind", "d")]}, True),
    "action_kind_fires": ("event-kind", {
        "fleet2/ctl.py": (
            "from trivy_tpu.fleet.controller import (\n"
            "    _Decision, emit_action)\n"
            "from trivy_tpu.fleet.slo import emit_event\n"
            "def f(kind):\n"
            "    emit_event('good_event')\n"
            "    emit_action('rogue_action')\n"
            "    emit_action(kind)\n"
            "    _Decision('site_action', {}, None)\n")},
        {"docs/fleet.md": (
            "| Kind | One action means |\n|---|---|\n"
            "| `good_event` | a healthy event row |\n"
            "| `declared_action` | declared, emitted nowhere |\n"
            "| `phantom_action` | documented, in neither registry |\n"
            "| `rogue_action` | emitted + documented, undeclared |\n"
            "| `site_action` | emitted via a _Decision site |\n")},
        {"declared_event_kinds": [("good_event", "d")],
         "declared_action_kinds": [("declared_action", "d"),
                                   ("site_action", "d")]}, True),
    "chaos_coverage_fires": ("chaos-coverage", {
        "chaos/scenarios.py": (
            "MANIFEST = {\n"
            "    'alpha': (('rpc', ('drop', 'ghost')),),\n"
            "    'beta': (('rpc', ('drop',)),),\n"
            "    'phantom': (('db.save', ('kill',)),),\n"
            "}\n"
            "class AlphaScenario:\n"
            "    name = 'alpha'\n"
            "class BetaScenario:\n"
            "    name = 'beta'\n"
            "class RogueScenario:\n"
            "    name = 'rogue'\n")},
        {"docs/resilience.md": (
            "# Resilience\n\n## Chaos campaigns\n\n"
            "`alpha` and `phantom` are tabled; beta is not "
            "backticked.\n")},
        {"declared_fault_sites": [("rpc", ("drop", "timeout")),
                                  ("db.save", ("kill",))]}, True),
    "chaos_coverage_clean_ok": ("chaos-coverage", {
        "chaos/scenarios.py": (
            "MANIFEST = {'alpha': (('rpc', ('drop',)),)}\n"
            "class AlphaScenario:\n"
            "    name = 'alpha'\n")},
        {"docs/resilience.md": "## Chaos campaigns\n\n| `alpha` | rpc |\n"},
        {"declared_fault_sites": [("rpc", ("drop",))]}, False),
    "usage_field_fires": ("usage-field", {
        "rpc/srv.py": (
            "from trivy_tpu.obs import usage\n"
            "def f(name):\n"
            "    usage.add('scans')\n"
            "    usage.add('mystery')\n"
            "    usage.add(name)\n")},
        {"docs/observability.md": (
            "# Observability\n\n## Cost-vector fields\n\n"
            "| field | meaning |\n|---|---|\n"
            "| `scans` | scans |\n\n## Next\n")},
        {"declared_usage_fields": [("scans", "d"), ("sheds", "d")]}, True),
    "bare_except_fires": ("bare-except", {
        "x/handlers.py": (
            "def a():\n"
            "    try:\n"
            "        pass\n"
            "    except:\n"
            "        pass\n"
            "def b():\n"
            "    try:\n"
            "        pass\n"
            "    except BaseException:\n"
            "        pass\n"
            "def c():\n"
            "    try:\n"
            "        pass\n"
            "    except BaseException:\n"
            "        raise\n")}, {}, {}, True),
    "lock_order_fires": ("lock-order", {
        "x/abba.py": (
            "import threading\n"
            "_a_lock = threading.Lock()\n"
            "_b_lock = threading.Lock()\n"
            "def one():\n"
            "    with _a_lock:\n"
            "        with _b_lock:\n"
            "            pass\n"
            "def two():\n"
            "    with _b_lock:\n"
            "        with _a_lock:\n"
            "            pass\n")}, {}, {}, True),
    "lock_order_consistent_ok": ("lock-order", {
        "x/ok.py": (
            "import threading\n"
            "_a_lock = threading.Lock()\n"
            "_b_lock = threading.Lock()\n"
            "def one():\n"
            "    with _a_lock:\n"
            "        with _b_lock:\n"
            "            pass\n"
            "def two():\n"
            "    with _a_lock, _b_lock:\n"
            "        pass\n")}, {}, {}, False),
}


def _seeded(tmp_path, case, pkg):
    """The case's mini-tree for one package, run through that
    package's linter -> its findings, in the port's spelling."""
    rule, files, docs, overrides, _fires = CASES[case]
    mod, kmod, package = (
        (rules, knobs, "trivy_tpu_torch") if pkg == "port"
        else (jax_rules, jax_knobs, "trivy_tpu"))
    spell = to_port if pkg == "port" else (lambda s: s)
    project = make_project(
        tmp_path / pkg, {k: spell(v) for k, v in files.items()},
        {spell(k): v for k, v in docs.items()}, package, mod)
    for attr, value in overrides.items():
        if attr == "declared_knobs":
            value = [kmod.Knob(*k) for k in value]
        setattr(project, attr, value)
    found = run_rule(project, rule, mod)
    return sorted((f.rule, to_port(f.path), f.line, to_port(f.message))
                  for f in found)


@pytest.mark.parametrize("case", sorted(CASES))
def test_seeded_violation_equals_the_reference(tmp_path, case):
    port = _seeded(tmp_path, case, "port")
    ref = _seeded(tmp_path, case, "ref")
    assert port == ref
    assert bool(port) == CASES[case][4], port


def test_every_rule_has_a_seeded_case():
    fired = {rule for rule, *_rest, fires in CASES.values() if fires}
    assert set(rules.RULES) <= fired, set(rules.RULES) - fired


def test_every_scope_names_the_port():
    """`trivy_tpu/` is not a prefix of `trivy_tpu_torch/`: every scope of
    the port's rules names the port's package."""
    for cls in rules.RULES.values():
        for attr in ("SCOPE", "EXEMPT"):
            scope = getattr(cls, attr, None)
            if scope is None:
                continue
            scopes = (scope,) if isinstance(scope, str) else scope
            assert all(s.startswith("trivy_tpu_torch/") for s in scopes), \
                (cls.id, scopes)


# ===================================== suppressions, baseline, report


def _violating(tmp_path, comment=""):
    return make_project(tmp_path, {
        "x/w.py": (
            "def save(p, d):\n"
            f"    {comment}\n"
            "    with open(p, 'w') as f:\n"
            "        f.write(d)\n")})


def test_inline_suppression_with_reason(tmp_path):
    project = _violating(tmp_path,
                         "# lint: allow[atomic-write] user output stream")
    findings, suppressed = rules.run(project, rule_ids={"atomic-write"})
    assert findings == []
    assert [via for _, via in suppressed] == ["inline"]


def test_inline_suppression_requires_reason(tmp_path):
    project = _violating(tmp_path, "# lint: allow[atomic-write]")
    findings, _ = rules.run(project, rule_ids={"atomic-write"})
    assert [f.rule for f in findings] == ["suppression"]
    assert "no reason" in findings[0].message


def test_baseline_suppresses_with_reason(tmp_path):
    project = _violating(tmp_path)
    baseline = [{"rule": "atomic-write",
                 "path": "trivy_tpu_torch/x/w.py",
                 "reason": "staged fix"}]
    findings, suppressed = rules.run(project, rule_ids={"atomic-write"},
                                     baseline=baseline)
    assert findings == []
    assert [via for _, via in suppressed] == ["baseline"]


def test_baseline_without_reason_is_reported(tmp_path):
    project = _violating(tmp_path)
    baseline = [{"rule": "atomic-write", "path": "trivy_tpu_torch/x/w.py"}]
    findings, _ = rules.run(project, rule_ids={"atomic-write"},
                            baseline=baseline)
    assert {f.rule for f in findings} == {"baseline", "atomic-write"}


def test_json_report_shape(tmp_path, capsys):
    _violating(tmp_path)
    rc = lint.main(["--root", str(tmp_path), "--json",
                    "--rule", "atomic-write", "--baseline", ""])
    assert rc == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["clean"] is False
    f = doc["findings"][0]
    assert (f["rule"], f["path"], f["line"]) == \
        ("atomic-write", "trivy_tpu_torch/x/w.py", 3)


# ============================================= knobs registry / doc


def test_generated_doc_is_current():
    with open(os.path.join(REPO_ROOT, knobs.DOC_PATH),
              encoding="utf-8") as f:
        assert f.read() == knobs.generate_knobs_md()
    assert knobs.DOC_PATH == "docs/knobs_torch.md"


def test_knob_table_is_what_the_port_reads(port_project):
    """The port declares exactly the knobs its code reads: the
    reference's bench knobs and its JAX native build directory are
    dropped, the port's native build directory is added."""
    rule = rules.RULES["env-knob"]()
    read = {name for pf in port_project.files()
            for name, _line, dynamic in rule._reads(pf) if not dynamic}
    declared = {k.name for k in knobs.KNOBS}
    assert read == declared
    ref = {k.name: k for k in jax_knobs.KNOBS}
    dropped = set(ref) - declared
    assert dropped == {n for n, k in ref.items() if k.subsystem == "bench"} \
        | {"TRIVY_TPU_NATIVE_DIR"}
    assert len(dropped) == 31
    assert declared - set(ref) == {"TRIVY_TPU_TORCH_NATIVE_DIR"}
    assert "TRIVY_TPU_TRUST_STORE" in declared
    # the knobs both packages read keep the reference's rows, in the
    # port's spelling of module paths
    assert [str(dataclasses.astuple(k)) for k in knobs.KNOBS
            if k.name in ref] == \
        [to_port(str(dataclasses.astuple(ref[k.name])))
         for k in knobs.KNOBS if k.name in ref]


def test_kill_switches_marked():
    assert {k.name for k in knobs.KNOBS if k.kill_switch} == \
        {k.name for k in jax_knobs.KNOBS if k.kill_switch}


def test_write_knobs_doc_never_writes_the_reference_doc(tmp_path, capsys):
    (tmp_path / "trivy_tpu_torch").mkdir()
    (tmp_path / "README.md").write_text("mini-tree fixture\n")
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "knobs.md").write_text("the reference's\n")
    assert lint.main(["--root", str(tmp_path), "--write-knobs-doc"]) == 0
    assert "docs/knobs_torch.md" in capsys.readouterr().out
    with open(tmp_path / "docs" / "knobs_torch.md", encoding="utf-8") as f:
        assert f.read() == knobs.generate_knobs_md()
    assert (tmp_path / "docs" / "knobs.md").read_text() == \
        "the reference's\n"


def test_reference_knob_doc_untouched_by_the_port():
    with open(os.path.join(REPO_ROOT, "docs", "knobs.md"),
              encoding="utf-8") as f:
        assert f.read() == jax_knobs.generate_knobs_md()


# ======================================== static vs runtime lock graph


def test_static_extraction_names_and_edges():
    src = (
        "import threading\n"
        "class S:\n"
        "    def f(self):\n"
        "        with self._cond:\n"
        "            with self._memo_lock:\n"
        "                pass\n")
    edges, where = lockstatic.static_graph(
        [("trivy_tpu_torch/sched/scheduler.py", ast.parse(src))])
    assert edges == {
        "sched.scheduler._cond": {"sched.scheduler._memo_lock"}}
    assert where[("sched.scheduler._cond",
                  "sched.scheduler._memo_lock")][1] == 5
    assert lockstatic.module_name("trivy_tpu_torch/analysis/__init__.py") \
        == "analysis"


def test_lock_order_rule_uses_the_port_witness(monkeypatch):
    seen = []

    def find_cycle(edges):
        seen.append(edges)
        return None

    monkeypatch.setattr(witness, "find_cycle", find_cycle)
    assert rules.lockstatic_find_cycle({"a": {"b"}}) is None
    assert seen == [{"a": {"b"}}]


def _static_graph(project):
    edges, _ = lockstatic.static_graph(
        [(pf.relpath, pf.tree) for pf in project.files()
         if pf.relpath.startswith("trivy_tpu_torch/")])
    return edges


def test_port_static_graph_acyclic(port_project):
    assert witness.find_cycle(_static_graph(port_project)) is None


def test_runtime_union_static_acyclic(monkeypatch, port_project):
    """Drive the port's scheduler (4 submitting threads over a
    host-oracle engine) under the port's witness, then union the
    runtime graph with the port's static graph: one order check."""
    from trivy_tpu_torch.db import Advisory, AdvisoryDB
    from trivy_tpu_torch.detector.engine import MatchEngine, PkgQuery
    from trivy_tpu_torch.sched.scheduler import MatchScheduler

    monkeypatch.setenv(witness.ENV, "1")
    witness.WITNESS.reset()
    try:
        db = AdvisoryDB()
        for i in range(16):
            db.put_advisory("npm::ghsa", f"pkg{i}", Advisory(
                vulnerability_id=f"CVE-2025-{i}",
                vulnerable_versions=[f"<{(i % 4) + 1}.0.0"]))
        engine = MatchEngine(db, use_device=False)
        sched = MatchScheduler(lambda: engine, window_ms=3.0)
        try:
            rng = random.Random(7)

            def submit():
                qs = [PkgQuery("npm::", f"pkg{rng.randrange(16)}",
                               f"{rng.randrange(5)}.0.0", "npm")
                      for _ in range(32)]
                sched.submit(qs)

            threads = [threading.Thread(target=submit) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            sched.close()
        assert witness.WITNESS.acquired_total() > 0, \
            "witness saw no acquisitions: make_lock wiring broken?"
        combined = lockstatic.union(witness.WITNESS.edges(),
                                    _static_graph(port_project))
        assert witness.find_cycle(combined) is None, \
            witness.WITNESS.report()
    finally:
        witness.WITNESS.reset()
