"""Read a cell's control at its own size, on several seeds.

    python3 portbench/control.py --workload <name> --calls <n> \
        --seeds <s1> <s2> ...

The control is the plain reference with the shortcut a faster program
would tempt (`lossy=True`: versions compared on their first three
numeric fields; secrets scanned in independent 16 KiB pieces), put in
the program's place: it answers what a run of `--calls` calls would
check, and is judged as the program is. Each seed prints one line of
its checks; a control that the judge passes would leave `correct`
unable to see that shortcut. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.lib import cell

    spec = cell.load_spec(ROOT)
    _work, cfg, traffic = cell.cell(spec, args.workload, ROOT)
    system = importlib.import_module(f"portbench.systems.{cfg['system']}")
    failed = 0
    for seed in args.seeds:
        run = system.control(cfg, traffic, seed, spec["run_seconds"],
                             args.calls, cell.CACHE)
        failed += not run.correct
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": run.correct, "notes": run.notes,
                          "checks": {c.name: c.value for c in run.checks}}),
              flush=True)
    return 0 if failed == len(args.seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
