"""Nothing a run imports is JAX, Flax or the JAX package, compared by the
whole top-level name (the port's own name begins with the JAX
package's)."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from portbench.lib import cell

FORBIDDEN = {"jax", "jaxlib", "flax", "trivy_tpu"}


def test_no_harness_file_imports_them():
    for dirpath, dirnames, filenames in os.walk(cell.HERE):
        dirnames[:] = [d for d in dirnames if d != "_cache"]
        for f in filenames:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                for n in names:
                    assert n.split(".", 1)[0] not in FORBIDDEN, (f, n)


CHILD = """
import sys, time
sys.path.insert(0, {root!r})
from portbench.conftest import tiny
from portbench.lib import cell
import portbench.run as run_mod
spec = cell.load_spec()
for w in ("crawl.fresh", "secret.source"):
    cfg, traffic = tiny(w)
    run, metrics = cell.run_cell(spec, w, 3, 0.2, True, "cpu",
                                 time.perf_counter(), cfg=cfg,
                                 traffic=traffic, cache={cache!r})
    assert run.correct, run.checks
for m in spec["end_to_end"] + spec["per_layer"]:
    cell.reader(m["name"])
print("FORBIDDEN", run_mod.forbidden_modules())
"""


def test_a_run_loads_none_of_them(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", CHILD.format(root=cell.ROOT,
                                            cache=str(tmp_path))],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
