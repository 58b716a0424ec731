"""Static companion to the lock witness: ``with <lock>`` nesting → graph.

The runtime witness (``analysis.witness``) only sees interleavings the
tests actually drive.  This pass reads every ``with`` statement in the
tree and records the lock-nesting pairs the *code* can produce, using
the same naming convention the witness uses
(``<module-under-trivy_tpu_torch>.<attr>``), so the two graphs union into one
order check: an edge witnessed at runtime in one direction and written
statically in the other is a lock inversion even if no test ever
interleaved it.

Heuristics (documented limitations, not bugs):

- a ``with`` item counts as a lock when it is a bare attribute or name
  whose identifier contains ``lock``, ``cond`` or ``mutex`` (the
  project convention) — ``with self._cond:``, ``with _CONN_POOL_LOCK:``;
- nesting is tracked lexically within one function body; cross-function
  nesting (helper called under a held lock that takes another lock) is
  the runtime witness's job;
- ``with registry.locked():`` — a *call* — is invisible here; the
  runtime witness covers the metrics registry;
- the name is keyed on the *use-site* module (no type inference), so a
  lock reached through another object's attribute (``with
  self.cdb._intern_lock:`` in detector/engine.py) gets a
  ``detector.engine.*`` alias while the runtime witness names it by its
  creation site (``tensorize.compile._intern_lock``) — an inversion
  split across the two aliases is only caught when the runtime witness
  observes both arms itself.

Copy of trivy_tpu/analysis/lockstatic.py: names are rooted at
``trivy_tpu_torch/``, as the port's witness names its locks.
"""

from __future__ import annotations

import ast
import os
import re

LOCK_ID_RX = re.compile(r"lock|cond|mutex", re.IGNORECASE)


def lock_name(item: ast.expr, module: str) -> str | None:
    """The witness-convention name for a with-item, or None if the
    expression does not look like a named lock."""
    if isinstance(item, ast.Attribute) and LOCK_ID_RX.search(item.attr):
        return f"{module}.{item.attr}"
    if isinstance(item, ast.Name) and LOCK_ID_RX.search(item.id):
        return f"{module}.{item.id}"
    return None


def module_name(relpath: str) -> str:
    """``trivy_tpu_torch/sched/scheduler.py`` -> ``sched.scheduler`` (the
    witness naming root).  Files outside trivy_tpu_torch/ keep their stem."""
    p = relpath.replace(os.sep, "/")
    if p.startswith("trivy_tpu_torch/"):
        p = p[len("trivy_tpu_torch/"):]
    if p.endswith(".py"):
        p = p[:-3]
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


class _Extractor(ast.NodeVisitor):
    """Collects (outer, inner, line) nesting triples per function."""

    def __init__(self, module: str):
        self.module = module
        self.stack: list[str] = []
        self.edges: list[tuple[str, str, int]] = []
        self.names: set[str] = set()

    # a fresh lexical scope gets a fresh nesting stack
    def _scoped(self, node) -> None:
        saved, self.stack = self.stack, []
        self.generic_visit(node)
        self.stack = saved

    visit_FunctionDef = visit_AsyncFunctionDef = visit_Lambda = _scoped

    def visit_With(self, node: ast.With) -> None:
        taken: list[str] = []
        for item in node.items:
            name = lock_name(item.context_expr, self.module)
            if name is None:
                continue
            self.names.add(name)
            for held in self.stack + taken:
                if held != name:
                    self.edges.append((held, name, node.lineno))
            taken.append(name)
        self.stack.extend(taken)
        for stmt in node.body:
            self.visit(stmt)
        del self.stack[len(self.stack) - len(taken):]


def extract(relpath: str, tree: ast.AST) -> _Extractor:
    ex = _Extractor(module_name(relpath))
    ex.visit(tree)
    return ex


def static_graph(files) -> tuple[dict[str, set[str]],
                                 dict[tuple[str, str], tuple[str, int]]]:
    """Build the whole-tree static nesting graph.

    ``files`` yields ``(relpath, ast_tree)``.  Returns ``(edges,
    where)`` with ``where[(a, b)] = (relpath, line)`` of the first
    occurrence, for diagnostics."""
    edges: dict[str, set[str]] = {}
    where: dict[tuple[str, str], tuple[str, int]] = {}
    for relpath, tree in files:
        ex = extract(relpath, tree)
        for a, b, line in ex.edges:
            edges.setdefault(a, set()).add(b)
            where.setdefault((a, b), (relpath, line))
    return edges, where


def union(*graphs: dict[str, set[str]]) -> dict[str, set[str]]:
    """Union adjacency-set graphs (runtime witness + static pass)."""
    out: dict[str, set[str]] = {}
    for g in graphs:
        for a, bs in g.items():
            out.setdefault(a, set()).update(bs)
    return out
