"""Two-process DCN dry run through the production distributed-MeshDB
path (ops/dcn.py): a coordinator process serving shards 0..3 of an
8-way global partition on its own 1x4 grid, and one spawned worker
process serving shards 4..7 behind the worker protocol, merged by the
engine's shard decoder.

Copy of trivy_tpu/ops/dcn_dryrun.py. It asserts the engine path a
`--mesh 2x1x4` server takes (`MatchEngine._mdb` is a `dcn.HostMeshDB`,
its health shows the host topology, no degradation), so the dry run and
serving cannot drift. The findings must equal the host oracle's for
every query, and the coordinator must have collected the remote host's
words (its slice was not silently host-masked).

`--device` places both processes' cells: "cpu", "cuda:N" (every cell on
card N; the default is cuda:0) or "cuda" (the first four cards of each
process). The launcher spawns the coordinator, which spawns its worker,
and writes the result document:

    python -m trivy_tpu_torch.ops.dcn_dryrun [--out MULTICHIP_DCN.json]
        [--device D]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

N_HOSTS = 2
N_LOCAL_DEVICES = 4            # cells per host
N_QUERIES = 514                # deliberately not a lane multiple
DB_ADVISORIES = 3000
DEFAULT_DEVICE = "cuda:0"


# ------------------------------------------------------------- coordinator


def _coordinator(device: str) -> None:
    import torch

    from trivy_tpu_torch.detector.engine import MatchEngine
    from trivy_tpu_torch.device import build_mesh
    from trivy_tpu_torch.ops import dcn
    from trivy_tpu_torch.tensorize.synth import synth_queries, synth_trivy_db

    dev = torch.device(device)
    db = synth_trivy_db(n_advisories=DB_ADVISORIES)
    os.environ[dcn.ENV_DCN] = "spawn"
    # a named device holds all four cells (and so the worker's); "cuda"
    # takes the first four cards
    grid = None if dev.type == "cuda" and dev.index is None else \
        build_mesh(1, N_LOCAL_DEVICES, devices=[dev] * N_LOCAL_DEVICES)
    engine = MatchEngine(db, device=dev, mesh=grid,
                         mesh_spec=f"{N_HOSTS}x1x{N_LOCAL_DEVICES}")
    try:
        # the dry run exercises the PRODUCTION cross-host path: the
        # engine must serve from a HostMeshDB, not a local mesh
        if not isinstance(engine._mdb, dcn.HostMeshDB):
            raise AssertionError(
                "engine did not take the distributed-MeshDB path")
        health = engine.shard_health()
        want = f"{N_HOSTS}x1x{N_LOCAL_DEVICES}"
        if health["shape"] != want or health["hosts"] != N_HOSTS \
                or health["degraded"] or health["degraded_hosts"]:
            raise AssertionError(f"unexpected mesh health {health}")

        queries = synth_queries(db, N_QUERIES)
        got = engine.detect(queries)
        oracle = engine.oracle_detect(queries)
        diff = sum(1 for g, o in zip(got, oracle)
                   if g.adv_indices != o.adv_indices)
        matches = sum(len(g.adv_indices) for g in got)
        health = engine.shard_health()
        print(json.dumps({
            "hosts": N_HOSTS,
            "mesh": health["shape"],
            "device": str(dev),
            "worker_device": engine._mdb.worker_device,
            "db_rows": int(engine.cdb.n_rows),
            "global_shards": engine._mdb.n_db,
            "queries": len(queries),
            "diff_vs_oracle": diff,
            "matches": matches,
            # the remote host must have served its slice
            "remote_dispatches": engine._mdb.dispatches.get(1, 0),
            "degraded_hosts": health["degraded_hosts"],
            "slice_sources": engine._mdb.host_sources(),
        }), flush=True)
        if diff:
            raise AssertionError(f"{diff} queries mismatched the oracle")
    finally:
        engine.close()


# ---------------------------------------------------------------- launcher


def run(out_path: str | None = None, timeout: int = 600,
        device: str = DEFAULT_DEVICE) -> dict:
    """Spawn the coordinator (which spawns its worker), check, and
    (optionally) write the result document. -> the document."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "trivy_tpu_torch.ops.dcn_dryrun",
         "--coordinator", "--device", device],
        env=dict(os.environ), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
    )
    errs: list[str] = []
    result = None
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        errs.append("timeout")
    for line in out.splitlines():
        if line.startswith("{"):
            try:
                result = json.loads(line)
            except json.JSONDecodeError:
                errs.append(f"unparseable coordinator line: {line[:200]}")
    if proc.returncode != 0:
        errs.append(err[-2000:])
    doc = {
        "n_hosts": N_HOSTS,
        "n_local_devices": N_LOCAL_DEVICES,
        "device": device,
        "result": result,
        "ok": not errs and result is not None,
        "errors": errs,
    }
    if doc["ok"]:
        doc["ok"] = (
            result["diff_vs_oracle"] == 0
            and result["matches"] > 0
            and result["remote_dispatches"] > 0
            and not result["degraded_hosts"]
        )
        if not doc["ok"]:
            doc["errors"].append(f"production-path check failed: {result}")
    if out_path:
        # lint: allow[atomic-write] dryrun report artifact (--out), not program state
        with open(out_path, "w") as f:
            json.dump(doc, f, indent=2)
    return doc


def main(argv: list[str]) -> int:
    device = DEFAULT_DEVICE
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
    if "--coordinator" in argv:
        _coordinator(device)
        return 0
    out = "MULTICHIP_DCN.json"
    if "--out" in argv:
        out = argv[argv.index("--out") + 1]
    doc = run(out_path=out, device=device)
    print(json.dumps(doc, indent=2))
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
