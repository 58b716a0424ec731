"""Run one cell of the benchmark of `trivy_tpu_torch` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. It makes the cell's inputs from the
seed, sets the program up on `cuda:0`, warms up on inputs the window
never uses, measures for `--seconds`, checks what the window produced
against the plain reference, and prints one JSON line last on standard
output: the end-to-end metrics untraced, the per-layer ones with
`--trace 1`. The numbers compared for `correct` go last on standard
error and last in that line.

Without a card, or with fewer cards than the cell asks for, it exits 2
and prints no result. Every build and kernel cache stays inside the
checkout: the kernels' nvcc build in `trivy_tpu_torch/ops/_build/`,
the DB and its compiled entries and the compiled-NFA cache under
`portbench/_cache/`.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")
FORBIDDEN = {"jax", "jaxlib", "flax", "trivy_tpu"}


def _environment() -> None:
    """Clear the program's tuning switches the caller's environment may
    carry, and point every cache into the checkout."""
    for key in list(os.environ):
        if key.startswith("TRIVY_TPU_"):
            del os.environ[key]
    os.environ["TRIVY_TPU_CACHE_DIR"] = os.path.join(CACHE, "trivy")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose whole top-level name is
    JAX's, Flax's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, ROOT)
    from portbench.lib import cell, peaks

    spec = cell.load_spec(ROOT)
    work, _cfg, _traffic = cell.cell(spec, args.workload, ROOT)

    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < work["chips"]:
        print(f"{args.workload} needs {work['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run, metrics = cell.run_cell(spec, args.workload, args.seed,
                                 args.seconds, bool(args.trace), "cuda:0",
                                 T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measured process: {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": run.device_kind,
              "count": work["chips"],
              "memory_peak_bytes": run.memory_peak_bytes,
              "power_limit": peaks.power_limit()}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if args.trace:
        t = run.trace or {}
        device["busy_s"] = t.get("busy_s", 0.0)
        device["window_s"] = t.get("window_s", run.window_s)
        out["breakdown"] = {"device_ops": t.get("device_ops", []),
                            "idle_gaps": t.get("idle_gaps", [])}
    info = dict(run.counters, window_s=run.window_s, setup_s=run.setup_s,
                **run.notes)
    print(f"{args.workload} seed={args.seed} {json.dumps(info)}",
          file=sys.stderr)
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in run.checks}
    for c in run.checks:
        print(f"check {c.name}={c.value} limit={c.limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
