"""Project invariant linter entry point.

Run as a module or via the CLI subcommand::

    python -m trivy_tpu_torch.analysis.lint [--json] [--baseline FILE]
        [--root DIR] [--rule ID ...] [--list-rules] [--write-knobs-doc]
    python -m trivy_tpu_torch lint [same flags]

Exit codes: 0 clean, 1 findings, 2 usage/internal error.  The tier-1
enforcement test (tests/test_torch_analysis.py) calls :func:`run_lint`,
so a lint regression fails verification, not just this command.

Copy of trivy_tpu/analysis/lint.py over the port's tree
(``trivy_tpu_torch/``); the shared baseline ``.lint-baseline.json``
and the shared docs are read as the reference reads them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# rules/knobs (the AST machinery) import lazily inside the functions
# that need them: cli/main.py imports this module on EVERY invocation
# just to register the `lint` subcommand's flags

DEFAULT_BASELINE = ".lint-baseline.json"


def repo_root() -> str:
    """The tree this package was loaded from (…/trivy_tpu_torch/analysis/..)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def is_project_tree(root: str) -> bool:
    """True when `root` is a source checkout, not an installed package.

    Several rules check repo-level artifacts (docs/, the baseline) that wheels do not ship; linting site-packages would
    report phantom doc-missing / knob-unread findings on a healthy
    install, so the CLI refuses with a clear message instead."""
    return any(os.path.exists(os.path.join(root, marker))
               for marker in ("pyproject.toml", "README.md"))


def run_lint(root: str | None = None, rule_ids=None,
             baseline_path: str | None = None):
    """-> (findings, suppressed).  `baseline_path=None` uses the
    default baseline file when present; "" disables baselines."""
    from trivy_tpu_torch.analysis import rules

    root = root or repo_root()
    if baseline_path is None:
        cand = os.path.join(root, DEFAULT_BASELINE)
        baseline_path = cand if os.path.exists(cand) else ""
    baseline = rules.load_baseline(baseline_path) if baseline_path else []
    project = rules.Project(root)
    return rules.run(project, rule_ids=rule_ids, baseline=baseline)


def add_arguments(ap) -> None:
    """Register the lint flags on ``ap`` — shared between this module's
    own parser and the ``trivy-tpu lint`` subcommand (one definition,
    so the CLI accepts exactly what ``python -m`` accepts)."""
    ap.add_argument("--root", default=None,
                    help="tree to lint (default: the installed repo)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help=f"baseline file (default: {DEFAULT_BASELINE} "
                         "at the root if present; '' disables)")
    ap.add_argument("--rule", action="append", default=None, metavar="ID",
                    help="run only this rule (repeatable)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--write-knobs-doc", action="store_true",
                    help="regenerate docs/knobs_torch.md from "
                         "analysis.knobs "
                         "and exit")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="trivy-tpu-torch lint",
        description="project invariant linter (docs/static-analysis.md)")
    add_arguments(ap)
    return run_from_args(ap.parse_args(argv))


def run_from_args(args) -> int:
    """The post-parse half of :func:`main` — the ``trivy-tpu lint``
    subcommand dispatches here with the namespace the main CLI parsed."""
    from trivy_tpu_torch.analysis import knobs, rules

    if args.list_rules:
        for rid, cls in sorted(rules.RULES.items()):
            print(f"{rid}: {cls.summary}")
        return 0

    root = args.root or repo_root()
    if not is_project_tree(root):
        print(f"lint: {root} does not look like a trivy-tpu source "
              "checkout (no pyproject.toml or README.md) — the linter "
              "validates repo-level invariants (docs/) that "
              "installed packages do not ship; pass --root "
              "PATH-TO-CHECKOUT", file=sys.stderr)
        return 2
    if args.write_knobs_doc:
        # render from the TARGET tree's extracted table, matching what
        # the env-knob staleness check will compare against
        declared = rules.Project(root).declared_knobs
        path = os.path.join(root, knobs.DOC_PATH)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # plain write: docs are derived artifacts, regenerated at will
        with open(path, "w", encoding="utf-8") as f:  # lint: allow[atomic-write] generated doc, rewritten idempotently from the registry
            f.write(knobs.generate_knobs_md(declared))
        print(f"wrote {path}")
        return 0

    if args.rule:
        unknown = set(args.rule) - set(rules.RULES)
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
    try:
        findings, suppressed = run_lint(
            root=root, rule_ids=set(args.rule) if args.rule else None,
            baseline_path=args.baseline)
    except (OSError, ValueError, SyntaxError) as exc:
        print(f"lint failed: {exc}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps({
            "findings": [f.as_dict() for f in findings],
            "suppressed": [
                {**f.as_dict(), "via": via} for f, via in suppressed],
            "rules": sorted(rules.RULES),
            "clean": not findings,
        }, indent=2, sort_keys=True))
    else:
        for f in findings:
            print(f.render())
        print(f"{len(findings)} finding(s), {len(suppressed)} "
              "suppressed" + ("" if findings else " — clean"))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
