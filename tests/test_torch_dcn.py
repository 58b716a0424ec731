"""Port parity, cross-host serving: trivy_tpu_torch.ops.dcn (the
distributed MeshDB, its worker protocol and the engine.host ladder) and
the engine, server, CLI and watch paths over it, against the JAX
package's trivy_tpu.ops.dcn on one seeded DB and the same queries.

The shapes are tests/test_dcn.py's: spec, worker-list and topology
parsing; 2x1x2, 2x2x2 and 2x2x4 through detect, detect_many and submit;
the scheduler's probes; the engine.host rungs and a real worker's death;
the local engine.shard ladder; the host-slice cache (warm start, keyed
by topology, a corrupt entry quarantined); /readyz and its JSON; the hot
reload that keeps the host topology and ends the old engine's worker; a
standalone worker refusing shutdown; a predecessor session kept
resident; the retired collective halves. Beyond them: the wire both
ways (a port coordinator with a reference worker, a reference
coordinator with a port worker), a worker's device error raising on the
coordinator, the spawned worker's device, a CUDA spawn without a card,
the re-resolve over the surviving hosts, `sbom` and `watch --once` with
`--mesh 2x1x1`, and the port's dry run. The skew detector's shape
(test_skew_detector_emits_on_host_degradation) is in
tests/test_torch_fleetobs.py with the rest of the fleet.

Workers: two port workers (`--device cpu`) and two reference workers
(8 virtual CPU devices) shared by the module in endpoint mode; tests
that kill or respawn a worker use spawn mode. Every port cell is the
CPU, so the match kernel's plain version answers; the `cuda`-marked
test runs the kernel in both processes on a card. Hit lists compare by
exact equality.
"""

from __future__ import annotations

import json
import os
import random
import socket
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch
from test_fanal import PACKAGE_LOCK, _fixture_db
from test_match import _random_db, _random_queries
from test_torch_match import port_db

from trivy_tpu.cache.cache import MemoryCache as JaxMemoryCache
from trivy_tpu.cli import main as jax_main
from trivy_tpu.db.model import Advisory as JaxAdvisory
from trivy_tpu.detector.engine import MatchEngine as JaxEngine
from trivy_tpu.obs import metrics as jax_metrics
from trivy_tpu.ops import dcn as jax_dcn
from trivy_tpu.ops import mesh as jax_mesh
from trivy_tpu.resilience import faults as jax_faults
from trivy_tpu.rpc.server import ScanService as JaxScanService
from trivy_tpu.utils import uuid as jax_uuid
from trivy_tpu_torch.cache.cache import MemoryCache
from trivy_tpu_torch.cli import run
from trivy_tpu_torch.cli.main import main
from trivy_tpu_torch.db import AdvisoryDB
from trivy_tpu_torch.detector.engine import MatchEngine, PkgQuery
from trivy_tpu_torch.ops import dcn
from trivy_tpu_torch.ops import match as tm
from trivy_tpu_torch.ops import mesh as mesh_ops
from trivy_tpu_torch.resilience import faults
from trivy_tpu_torch.rpc.server import ScanService
from trivy_tpu_torch.tensorize import cache as compile_cache
from trivy_tpu_torch.utils import uuid as port_uuid

pytestmark = pytest.mark.dcn

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread here and in every worker this module starts:
    the suite runs several test processes at once, and idle OpenMP
    workers spin on cores their neighbours' timing tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


def _start(cmd: list[str], env: dict) -> subprocess.Popen:
    return subprocess.Popen(cmd, env=env, cwd=str(ROOT),
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)


def _endpoint(proc: subprocess.Popen) -> str:
    line = proc.stdout.readline()
    assert line.startswith(dcn.READY_LINE), line
    return "127.0.0.1:" + line.split("port=")[1].strip()


@pytest.fixture(scope="module")
def workers(_one_thread):
    """Two standalone port workers on the CPU and two reference workers
    on 8 virtual CPU devices, all started at once; each engine's hello
    loads its own session's slice."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("TRIVY_TPU_MESH", None)
    env.pop(dcn.ENV_DCN, None)
    jenv = {**env, "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    procs = {
        "port": [_start([sys.executable, "-m", "trivy_tpu_torch.ops.dcn",
                         "--worker", "--port", "0", "--device", "cpu"], env)
                 for _ in range(2)],
        "ref": [_start([sys.executable, "-m", "trivy_tpu.ops.dcn",
                        "--worker", "--port", "0"], jenv)
                for _ in range(2)]}
    try:
        yield {k: [_endpoint(p) for p in ps] for k, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
                p.wait(timeout=30)


@pytest.fixture(scope="module")
def jdb():
    return _random_db(random.Random(42))


@pytest.fixture(scope="module")
def db(jdb):
    return port_db(jdb)


@pytest.fixture(scope="module")
def jqueries():
    return _random_queries(random.Random(13), n=500)


@pytest.fixture(scope="module")
def queries(jqueries):
    return [PkgQuery(*q.key) for q in jqueries]


@pytest.fixture(scope="module")
def oracle(jdb, jqueries):
    e = JaxEngine(jdb, window=32, use_device=False)
    return [r.adv_indices for r in e.oracle_detect(jqueries)]


def _hits(engine, queries):
    return [r.adv_indices for r in engine.detect(queries)]


def _both(spec: str) -> None:
    """The same fault plan in both packages."""
    faults.install_spec(spec)
    jax_faults.install_spec(spec)


def _engine(db, spec, monkeypatch, workers, **kw):
    monkeypatch.setenv(dcn.ENV_DCN, workers)
    return MatchEngine(db, window=32, device="cpu", mesh_spec=spec, **kw)


def _jengine(jdb, spec, monkeypatch, workers, **kw):
    monkeypatch.setenv(dcn.ENV_DCN, workers)
    return JaxEngine(jdb, window=32, mesh_spec=spec, **kw)


def _ref_counts() -> dict:
    """The reference's DCN metrics for host 1, to diff around a run."""
    return {"degradations": jax_metrics.DCN_HOST_DEGRADATIONS.value(
                host="1"),
            "dispatches": jax_metrics.DCN_HOST_DISPATCH_SECONDS.snapshot(
                host="1")[2],
            "merges": jax_metrics.DCN_MERGE_SECONDS.snapshot()[2]}


def _port_counts(e) -> dict:
    return {"degradations": e._mdb.degradations.get(1, 0),
            "dispatches": e._mdb.dispatches.get(1, 0),
            "merges": e._mdb.merges}


# ------------------------------------------------------------- spec/topology


def test_parse_spec_hosts():
    for spec in ("2x1x2", " 2 X 2 x 4 ", "1x2x4", "3x1x1", "2x4"):
        assert mesh_ops.parse_spec(spec) == jax_mesh.parse_spec(spec), spec
    assert mesh_ops.parse_spec("2x1x2") == (2, 1, 2)
    for bad, msg in (("0x1x2", ">= 1"), ("2x1x2x2", "bad mesh spec")):
        for mod in (mesh_ops, jax_mesh):
            with pytest.raises(ValueError, match=msg):
                mod.parse_spec(bad)


def test_spec_spanning_hosts_requires_dcn(db, jdb, monkeypatch):
    monkeypatch.delenv(dcn.ENV_DCN, raising=False)
    with pytest.raises(ValueError) as got:
        MatchEngine(db, window=32, device="cpu", mesh_spec="2x1x2")
    with pytest.raises(ValueError) as want:
        JaxEngine(jdb, window=32, mesh_spec="2x1x2")
    assert str(got.value) == str(want.value)
    assert "TRIVY_TPU_DCN" in str(got.value)
    # and the local-mesh builders refuse a cross-host spec
    with pytest.raises(ValueError, match="spans hosts") as got:
        mesh_ops.build_from_spec("2x1x2", n_rows=100, device=CPU)
    with pytest.raises(ValueError) as want:
        jax_mesh.build_from_spec("2x1x2", n_rows=100)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("value,spec", [
    ("127.0.0.1:1,127.0.0.1:2", "2x1x2"), ("spawn:4", "2x1x2")])
def test_worker_count_must_match_spec(db, jdb, monkeypatch, value, spec):
    monkeypatch.setenv(dcn.ENV_DCN, value)
    with pytest.raises(ValueError) as got:
        MatchEngine(db, window=32, device="cpu", mesh_spec=spec)
    with pytest.raises(ValueError) as want:
        JaxEngine(jdb, window=32, mesh_spec=spec)
    assert str(got.value) == str(want.value)
    # bare "spawn" sizes itself from the spec
    monkeypatch.setenv(dcn.ENV_DCN, "spawn")
    assert dcn.plan_from_spec(spec, n_rows=100, device=CPU) \
        == jax_dcn.plan_from_spec(spec, n_rows=100) == (2, 1, 2)


@pytest.mark.parametrize("value", [None, "", "off", "spawn", "spawn:3",
                                   "a:1, b:2", "nocolon", "spawn:0",
                                   "spawn:x"])
def test_configured_workers_parse(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(dcn.ENV_DCN, raising=False)
    else:
        monkeypatch.setenv(dcn.ENV_DCN, value)
    try:
        want = jax_dcn.configured_workers()
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            dcn.configured_workers()
        assert str(got.value) == str(exc)
    else:
        assert dcn.configured_workers() == want


def test_choose_host_topology(monkeypatch):
    cases = [(2, 4, 10_000), (2, 4, 1_000_000), (1, 8, 500_000),
             (2, 8, 500_000), (3, 1, 7)]
    for hbm in (None, "0.001", "0.01"):
        if hbm is None:
            monkeypatch.delenv(mesh_ops.ENV_HBM, raising=False)
        else:
            monkeypatch.setenv(mesh_ops.ENV_HBM, hbm)
        for case in cases:
            assert dcn.choose_host_topology(*case) == \
                jax_dcn.choose_host_topology(*case), (hbm, case)
    monkeypatch.setenv(mesh_ops.ENV_HBM, "0.01")
    assert dcn.choose_host_topology(2, 8, 500_000) == (8, 1)
    # "auto" with workers goes cross-host, sized on the CPU's one device
    monkeypatch.setenv(dcn.ENV_DCN, "spawn")
    assert dcn.plan_from_spec("auto", n_rows=100, device=CPU) == (2, 1, 1)
    monkeypatch.delenv(dcn.ENV_DCN)
    assert dcn.plan_from_spec("auto", n_rows=100, device=CPU) is None


# ------------------------------------------------------------------- parity


@pytest.mark.parametrize("spec,dp,db_local",
                         [("2x1x2", 1, 2), ("2x2x2", 2, 2),
                          ("2x2x4", 2, 4)])
def test_zero_diff_all_host_shapes(db, jdb, queries, jqueries, oracle,
                                   workers, monkeypatch, spec, dp,
                                   db_local):
    e = _engine(db, spec, monkeypatch, workers["port"][0])
    je = _jengine(jdb, spec, monkeypatch, workers["ref"][0])
    try:
        h = e.shard_health()
        assert h == je.shard_health() == {
            "shape": spec, "data": dp, "db": 2 * db_local,
            "degraded": [], "hosts": 2, "degraded_hosts": []}
        # the remote host's slices come from the same global partition
        assert (e._mdb.shard_len, e._mdb.shard_base) == \
            (je._mdb.shard_len, je._mdb.shard_base)
        assert e._mdb.shard_len > e._mdb.shard_base
        assert _hits(e, queries) == oracle == _hits(je, jqueries)
        crawl = e.detect_many(queries, batch_size=128, depth=2)
        assert [r.adv_indices for r in crawl] == oracle
        lists = [queries[:200], queries[200:201], queries[201:]]
        assert [r.adv_indices for rs in e.submit(lists)
                for r in rs] == oracle
        assert e._mdb.host_sources() == je._mdb.host_sources() == ["push"]
    finally:
        e.close()
        je.close()


def test_sched_probes_compose_with_host_grid(db, jdb, queries, jqueries,
                                             oracle, workers, monkeypatch):
    e = _engine(db, "2x2x2", monkeypatch, workers["port"][0])
    je = _jengine(jdb, "2x2x2", monkeypatch, workers["ref"][0])
    try:
        assert e.mesh_data_axis == je.mesh_data_axis == 2  # the LOCAL axis
        assert _hits(e, queries) == oracle == _hits(je, jqueries)
        assert e.mesh_row_floor >= 128
        assert e.mesh_row_floor == je.mesh_row_floor
    finally:
        e.close()
        je.close()


# ----------------------------------------------------------- fault ladder


@pytest.mark.fault
@pytest.mark.parametrize("spec,shape,warm,degraded", [
    ("engine.host:error@1", "2x1x1", False, []),
    ("engine.host:error@1-2", "2x1x1", False, [1]),
    ("engine.host:device-lost@1", "2x1x2", True, [1]),
    ("engine.host:drop@1;engine.host:delay=0.001@2", "2x1x1", False, []),
    ("engine.host:delay=0.001@1-3", "2x1x1", False, [])])
def test_host_rungs_equal_reference(db, jdb, queries, jqueries, oracle,
                                    workers, monkeypatch, spec, shape, warm,
                                    degraded):
    """Each engine.host rung: the oracle's hits, the reference's
    degraded hosts, degradations, collects and merges; a degraded host
    stays degraded and exact after the faults end."""
    e = _engine(db, shape, monkeypatch, workers["port"][0])
    je = _jengine(jdb, shape, monkeypatch, workers["ref"][0])
    try:
        if warm:  # healthy first
            assert _hits(e, queries[:100]) == oracle[:100] \
                == _hits(je, jqueries[:100])
        ref0, port0 = _ref_counts(), _port_counts(e)
        _both(spec)
        assert _hits(e, queries) == oracle
        assert _hits(je, jqueries) == oracle
        faults.reset()
        jax_faults.reset()
        h, jh = e.shard_health(), je.shard_health()
        assert h == jh and h["degraded_hosts"] == degraded
        assert h["degraded"] == []  # the local slice stays on its device
        ref1, port1 = _ref_counts(), _port_counts(e)
        assert {k: port1[k] - port0[k] for k in port1} == \
            {k: ref1[k] - ref0[k] for k in ref1}
        if degraded:
            assert _hits(e, queries) == oracle
            assert e.shard_health()["degraded_hosts"] == degraded
        retried = e._mdb.host_retry_count.get(1, 0)
        assert retried == (1 if "error" in spec else 0), retried
    finally:
        e.close()
        je.close()


@pytest.mark.fault
def test_local_shard_ladder_still_works(db, jdb, queries, jqueries, oracle,
                                        workers, monkeypatch):
    """engine.shard fires for the coordinator's OWN cells, apart from
    the host ladder."""
    e = _engine(db, "2x1x2", monkeypatch, workers["port"][0])
    je = _jengine(jdb, "2x1x2", monkeypatch, workers["ref"][0])
    try:
        _both("engine.shard:device-lost@1")
        assert _hits(e, queries) == oracle == _hits(je, jqueries)
        h = e.shard_health()
        assert h == je.shard_health()
        assert h["degraded"] == [0] and h["degraded_hosts"] == []
        faults.reset()
        # the local slice comes back onto its device
        assert e.reresolve_mesh() is True
        assert e.shard_health()["degraded"] == []
        assert _hits(e, queries) == oracle
    finally:
        e.close()
        je.close()


def test_real_worker_death_degrades_host(db, queries, oracle, monkeypatch):
    monkeypatch.setenv(dcn.ENV_DCN, "spawn")
    e = MatchEngine(db, window=32, device="cpu", mesh_spec="2x1x1")
    try:
        assert _hits(e, queries[:100]) == oracle[:100]
        # kill the worker mid-service: the next collect's transport
        # failure rides the engine.host ladder into the host mask
        proc = e._mdb.hosts[0].proc
        proc.kill()
        proc.wait(timeout=30)
        assert _hits(e, queries) == oracle
        assert e.shard_health()["degraded_hosts"] == [1]
        assert e._mdb.degradations == {1: 1}
    finally:
        e.close()


def test_reresolve_over_survivors_equals_reference(db, jdb, queries,
                                                   jqueries, oracle,
                                                   workers, monkeypatch):
    """Three hosts, host 1 lost: the re-resolve re-partitions over the
    coordinator and the surviving worker (renumbered host 1), as the
    reference's does; both serve the oracle's hits on their devices."""
    e = _engine(db, "3x1x1", monkeypatch, ",".join(workers["port"]))
    je = _jengine(jdb, "3x1x1", monkeypatch, ",".join(workers["ref"]))
    try:
        _both("engine.host:device-lost@1")
        assert _hits(e, queries) == oracle == _hits(je, jqueries)
        faults.reset()
        jax_faults.reset()
        assert e.shard_health() == je.shard_health()
        assert e.shard_health()["degraded_hosts"] == [1]
        assert e.reresolve_mesh() is True
        assert je.reresolve_mesh() is True
        h = e.shard_health()
        assert h == je.shard_health() == {
            "shape": "2x1x1", "data": 1, "db": 2, "degraded": [],
            "hosts": 2, "degraded_hosts": []}
        assert (e._mdb.shard_len, e._mdb.shard_base) == \
            (je._mdb.shard_len, je._mdb.shard_base)
        n0 = e._mdb.dispatches.get(1, 0)
        assert _hits(e, queries) == oracle == _hits(je, jqueries)
        assert e._mdb.dispatches[1] == n0 + 1
        assert e._mdb.reresolves == 1
        assert e.shard_health()["degraded_hosts"] == []
        # a healthy topology: the re-resolve is the local mesh's no-op
        assert e.reresolve_mesh() is False
    finally:
        e.close()
        je.close()


def _device_error_worker(monkeypatch):
    """An in-process worker whose device work fails: its serving
    thread's match_dispatch raises. -> (endpoint, stop)."""
    real = tm.match_dispatch

    def failing(ddb, batch):
        if threading.current_thread().name == "dcn-test-worker":
            raise RuntimeError("CUDA error: an illegal memory access")
        return real(ddb, batch)

    monkeypatch.setattr(tm, "match_dispatch", failing)
    srv = socket.create_server(("127.0.0.1", 0))
    state = dcn._WorkerState(CPU)

    def accept():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            threading.Thread(target=dcn._serve_conn,
                             args=(conn, state, False),
                             name="dcn-test-worker", daemon=True).start()

    threading.Thread(target=accept, daemon=True).start()
    return f"127.0.0.1:{srv.getsockname()[1]}", srv.close


@pytest.mark.fault
def test_worker_device_error_raises_and_degrades_nothing(db, queries,
                                                         oracle,
                                                         monkeypatch):
    endpoint, stop = _device_error_worker(monkeypatch)
    e = _engine(db, "2x1x1", monkeypatch, endpoint)
    try:
        with pytest.raises(dcn.WorkerDeviceError, match="illegal memory"):
            e.detect(queries)
        h = e.shard_health()
        assert h["degraded_hosts"] == [] and h["degraded"] == []
        assert e._mdb.degradations == {} and e._mdb.host_retry_count == {}
        assert e.use_device and not e.device_lost
        # the stream stayed in step: once the device works, so does the
        # host, on the same connection
        monkeypatch.undo()
        assert _hits(e, queries) == oracle
        assert e.shard_health()["degraded_hosts"] == []
    finally:
        e.close()
        stop()


# ------------------------------------------------------------ the wire


@pytest.mark.parametrize("side", ["port_coordinator", "ref_coordinator"])
def test_interop_with_the_reference(db, jdb, queries, jqueries, oracle,
                                    workers, monkeypatch, side):
    """The wire is the reference's: a port coordinator drives a
    reference worker, and a reference coordinator a port worker."""
    if side == "port_coordinator":
        e = _engine(db, "2x1x2", monkeypatch, workers["ref"][1])
        qs = queries
    else:
        e = _jengine(jdb, "2x1x2", monkeypatch, workers["port"][1])
        qs = jqueries
    try:
        assert _hits(e, qs) == oracle
        assert e.shard_health()["degraded_hosts"] == []
        assert e.detect_many(qs, batch_size=128, depth=2)
    finally:
        e.close()


def test_spawned_worker_runs_on_the_coordinators_device(db, queries,
                                                       oracle,
                                                       monkeypatch):
    monkeypatch.setenv(dcn.ENV_DCN, "spawn")
    e = MatchEngine(db, window=32, device="cpu", mesh_spec="2x2x1")
    try:
        assert e._mdb.worker_device == "cpu"
        assert _hits(e, queries) == oracle
        host = e._mdb.hosts[0]
        assert "--device" in host.proc.args
        assert host.proc.args[host.proc.args.index("--device") + 1] == "cpu"
        st = dcn.worker_stats(host.endpoint)
        assert st["device"] == "cpu"
        assert st["sessions"][e._mdb._session]["cells"] == [["cpu"],
                                                           ["cpu"]]
        assert st["jax"] is False and st["trivy_tpu"] is False
        assert st["pid"] == host.proc.pid
    finally:
        e.close()
    assert host.proc.poll() is not None


def test_cuda_spawn_without_a_card_raises(monkeypatch):
    """A CUDA worker on a host without a card does not come up, raises
    with its own error line, and no worker is left running."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    started = []
    real = subprocess.Popen

    def popen(*a, **kw):
        started.append(real(*a, **kw))
        return started[-1]

    monkeypatch.setattr(subprocess, "Popen", popen)
    with pytest.raises(ValueError, match="CUDA is not available"):
        dcn._spawn_worker("cuda", 60.0)
    assert len(started) == 1 and started[0].poll() is not None
    assert started[0].returncode != 0
    # the coordinator's own placement refuses a card it does not have
    with pytest.raises(ValueError,
                       match="coordinator needs 2 local devices, has 0"):
        dcn.grid_devices(1, 2, "cuda", "coordinator")


def test_standalone_worker_refuses_remote_shutdown(workers):
    """A worker started without --parent-watch is not killable by one
    frame from anything that reaches its port."""
    host, _, port = workers["port"][0].rpartition(":")
    sock = socket.create_connection((host, int(port)), timeout=10)
    try:
        sock.settimeout(10)
        dcn._send_msg(sock, {"op": "shutdown", "rid": 1})
        reply, _ = dcn._recv_msg(sock)
        assert not reply.get("ok") and "not allowed" in reply["error"]
        assert reply["rid"] == 1
        dcn._send_msg(sock, {"op": "ping", "rid": 2})
        reply, _ = dcn._recv_msg(sock)
        assert reply.get("ok") and reply.get("rid") == 2
    finally:
        sock.close()


def test_worker_keeps_predecessor_session_resident(db, queries, oracle,
                                                   workers, monkeypatch):
    """An endpoint hot swap: the successor engine hellos the SAME worker
    before the old engine goes; both keep serving on the worker."""
    e1 = _engine(db, "2x1x1", monkeypatch, workers["port"][0])
    e2 = None
    try:
        assert _hits(e1, queries[:100]) == oracle[:100]
        e2 = _engine(db, "2x1x1", monkeypatch, workers["port"][0])
        assert _hits(e2, queries) == oracle
        assert _hits(e1, queries) == oracle
        assert e1.shard_health()["degraded_hosts"] == []
        assert e2.shard_health()["degraded_hosts"] == []
    finally:
        if e2 is not None:
            e2.close()
        e1.close()


# ------------------------------------------------------- host-slice cache


def _saved(db, tmp_path, name="db"):
    root = str(tmp_path / name)
    db.save(root, compress=False)
    return root


def test_host_slice_cache_warm_start(db, jdb, queries, oracle, workers,
                                     monkeypatch, tmp_path):
    root = _saved(db, tmp_path)
    jroot = str(tmp_path / "jdb")
    jdb.save(jroot, compress=False)
    e1 = _engine(db, "2x1x2", monkeypatch, workers["port"][0],
                 db_path=root)
    je1 = _jengine(jdb, "2x1x2", monkeypatch, workers["ref"][0],
                   db_path=jroot)
    try:
        assert _hits(e1, queries) == oracle
        assert e1.build_stats["mesh_host_cache"] == "miss"
        # the worker loads the entry its coordinator saved just before,
        # as the reference's does
        assert e1._mdb.host_sources() == je1._mdb.host_sources()
    finally:
        e1.close()
        je1.close()
    digest = compile_cache.db_digest(root)
    for h in (0, 1):
        p = compile_cache.host_slice_entry_path(root, digest, 32, 2, h, 4)
        assert os.path.exists(p), p
        assert p.endswith(f".dcn2h{h}.mesh4.npz")
        assert os.path.dirname(p).endswith("compiled-torch")
        # the reference's entry of the same key is its own
        jp = jax_dcn_path(jroot, h)
        assert os.path.exists(jp) and "compiled-torch" not in jp
    hits0 = compile_cache.COUNTS["hits"]
    e2 = _engine(db, "2x1x2", monkeypatch, workers["port"][0],
                 db_path=root)
    try:
        assert compile_cache.COUNTS["hits"] > hits0
        assert e2.build_stats["mesh_host_cache"] == "hit"
        assert e2._mdb.host_sources() == ["cache"]
        assert _hits(e2, queries) == oracle
    finally:
        e2.close()


def jax_dcn_path(root: str, h: int) -> str:
    from trivy_tpu.tensorize import cache as jcache

    return jcache.host_slice_entry_path(root, jcache.db_digest(root), 32,
                                        2, h, 4)


def test_host_slice_cache_keyed_by_topology(db, workers, monkeypatch,
                                            tmp_path):
    root = _saved(db, tmp_path)
    _engine(db, "2x1x2", monkeypatch, workers["port"][0],
            db_path=root).close()
    digest = compile_cache.db_digest(root)
    assert os.path.exists(compile_cache.host_slice_entry_path(
        root, digest, 32, 2, 1, 4))
    # another host count or db axis is another entry set
    assert not os.path.exists(compile_cache.host_slice_entry_path(
        root, digest, 32, 2, 0, 2))
    assert not os.path.exists(compile_cache.host_slice_entry_path(
        root, digest, 32, 3, 0, 4))


def test_host_slice_corrupt_entry_quarantined(db, queries, oracle,
                                              workers, monkeypatch,
                                              tmp_path):
    root = _saved(db, tmp_path)
    _engine(db, "2x1x1", monkeypatch, workers["port"][0],
            db_path=root).close()
    digest = compile_cache.db_digest(root)
    path = compile_cache.host_slice_entry_path(root, digest, 32, 2, 1, 2)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x01  # silent bit rot in the WORKER's entry
    with open(path, "wb") as f:
        f.write(bytes(raw))
    e2 = _engine(db, "2x1x1", monkeypatch, workers["port"][0],
                 db_path=root)
    try:
        # the worker quarantined its entry and took a push instead
        assert e2._mdb.host_sources() == ["push"]
        assert e2.build_stats["mesh_push_mb"][0] > 0
        assert _hits(e2, queries) == oracle
        assert os.path.exists(path + compile_cache.QUARANTINE_SUFFIX)
        # ... and saved the pushed slice again
        assert os.path.exists(path)
    finally:
        e2.close()


# ------------------------------------------------- server and CLI surfaces


def test_readyz_and_doc_report_host_topology(db, jdb, queries, jqueries,
                                             oracle, workers, monkeypatch):
    e = _engine(db, "2x1x2", monkeypatch, workers["port"][0])
    je = _jengine(jdb, "2x1x2", monkeypatch, workers["ref"][0])
    svc = ScanService(e, MemoryCache())
    jsvc = JaxScanService(je, JaxMemoryCache())
    try:
        ok, why = svc.ready()
        assert (ok, why) == jsvc.ready()
        assert ok and "mesh 2x1x2" in why and "degraded" not in why
        doc = svc.ready_doc()
        assert doc["mesh"] == jsvc.ready_doc()["mesh"] == {
            "shape": "2x1x2", "degraded": [], "hosts": 2,
            "degraded_hosts": []}
        _both("engine.host:device-lost@1")
        assert _hits(e, queries) == oracle == _hits(je, jqueries)
        faults.reset()
        jax_faults.reset()
        ok, why = svc.ready()
        assert (ok, why) == jsvc.ready()
        assert ok and "host(s) 1 degraded to host-mask" in why
        assert svc.ready_doc()["mesh"] == jsvc.ready_doc()["mesh"]
        assert svc.ready_doc()["mesh"]["degraded_hosts"] == [1]
    finally:
        svc.close()
        if jsvc.scheduler is not None:
            jsvc.scheduler.close()
        e.close()
        je.close()


def test_hot_reload_keeps_host_topology(db, queries, monkeypatch, tmp_path):
    from trivy_tpu_torch.db import generations

    monkeypatch.setenv(dcn.ENV_DCN, "spawn")
    root = str(tmp_path / "db")

    def promote(name: str, updated: str) -> None:
        gen = os.path.join(generations.generations_root(root), name)
        os.makedirs(gen)
        db.meta.updated_at = updated
        db.save(gen)
        generations.promote(root, gen)

    promote("sha256-aaa", "2024-01-01T00:00:00Z")
    e = MatchEngine(AdvisoryDB.load(root), window=32, device="cpu",
                    mesh_spec="2x1x1", db_path=root)
    svc = ScanService(e, MemoryCache(), db_path=root)
    try:
        promote("sha256-bbb", "2024-02-02T00:00:00Z")
        assert svc.maybe_reload_db() is True
        assert svc.engine is not e
        # the swap kept the host topology AND ended the old engine's
        # worker: no worker leaks per reload
        h = svc.engine.shard_health()
        assert h["shape"] == "2x1x1" and h["hosts"] == 2
        assert e._mdb._closed
        assert e._mdb.hosts[0].proc.poll() is not None
        assert svc.engine._mdb.hosts[0].proc.poll() is None
        want = [r.adv_indices for r in svc.engine.oracle_detect(queries)]
        assert _hits(svc.engine, queries) == want
    finally:
        svc.close()
        svc.engine.close()
        e.close()


@pytest.fixture()
def cli_env(db, tmp_path, monkeypatch):
    import test_sbom_e2e

    root = str(tmp_path / "db")
    db.save(root)
    bom = tmp_path / "bom.json"
    bom.write_text(json.dumps(test_sbom_e2e.CDX_DOC))
    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", "2024-01-01T00:00:00+00:00")
    run._ENGINE_CACHE.clear()
    yield {"db": root, "bom": str(bom), "cache": str(tmp_path / "c")}
    run._ENGINE_CACHE.clear()


def test_cli_sbom_mesh_across_hosts_equals_single_device(cli_env, capsys,
                                                         monkeypatch):
    """`sbom --mesh 2x1x1 --device cpu` with TRIVY_TPU_DCN=spawn writes
    the report of the run without a mesh, and the reference's; once the
    CLI's engine cache drops the engine, its worker is gone."""
    base = ["sbom", cli_env["bom"], "--format", "json", "--db-path",
            cli_env["db"], "--cache-dir", cli_env["cache"], "--quiet"]
    assert main(base + ["--device", "cpu"]) == 0
    plain = capsys.readouterr().out
    monkeypatch.setenv(dcn.ENV_DCN, "spawn")
    assert main(base + ["--device", "cpu", "--mesh", "2x1x1"]) == 0
    meshed = capsys.readouterr().out
    monkeypatch.delenv(dcn.ENV_DCN)
    assert jax_main.main(base) == 0
    assert meshed == plain == capsys.readouterr().out
    (engine,) = [e for e in run._ENGINE_CACHE.values()
                 if e.dcn_plan is not None]
    proc = engine._mdb.hosts[0].proc
    assert proc.poll() is None
    run._ENGINE_CACHE.clear()
    assert proc.poll() is not None


def test_watch_once_across_hosts_equals_reference(tmp_path, capsys,
                                                  monkeypatch):
    """`watch --once --mesh 2x1x1 --device cpu` (a spawned worker)
    prints the reference's events after a DB update."""
    from test_torch_monitor import lines_without_duration

    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", "2024-01-01T00:00:00+00:00")
    monkeypatch.setenv("TRIVY_TPU_DETERMINISTIC_UUID", "1")
    root = str(tmp_path / "db")
    _fixture_db().save(root)
    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "package-lock.json").write_text(PACKAGE_LOCK)
    runs = (("port", main, ["--device", "cpu", "--mesh", "2x1x1"]),
            ("ref", jax_main.main, ["--no-tpu"]))
    for name, entry, dev in runs:
        port_uuid.reset()
        jax_uuid.reset()
        assert entry(["fs", str(proj), "--db-path", root, "--cache-dir",
                      str(tmp_path / f"{name}-c"), "--quiet",
                      "--scanners", "vuln", "--monitor-index",
                      str(tmp_path / f"{name}.jsonl"),
                      *dev[:2]]) == 0
    capsys.readouterr()
    db2 = _fixture_db()
    db2.put_advisory("npm::g", "lodash", JaxAdvisory(
        vulnerability_id="CVE-2099-0001", vulnerable_versions=["<5.0.0"]))
    db2.save(root)
    monkeypatch.setenv(dcn.ENV_DCN, "spawn")
    outs = {}
    for name, entry, dev in runs:
        port_uuid.reset()
        jax_uuid.reset()
        rc = entry(["watch", "--db-path", root, "--index",
                    str(tmp_path / f"{name}.jsonl"), "--once", "--quiet",
                    "--cache-dir", str(tmp_path / f"{name}-w"), *dev])
        cap = capsys.readouterr()
        assert rc == 0, cap.err
        outs[name] = lines_without_duration(cap.out)
    assert outs["port"] == outs["ref"]
    events = [ln for ln in outs["port"] if ln["event"] != "rescore"]
    assert [(e["event"], e["name"], e["vuln_id"]) for e in events] == \
        [("introduced", "lodash", "CVE-2099-0001")]


def test_dcn_dryrun_through_the_production_path(tmp_path):
    """The port's two-process dry run (tests/test_dcn_dryrun.py's
    shape) on the CPU: the coordinator's engine serves from a
    HostMeshDB, its worker served its slice, the oracle's hits."""
    from trivy_tpu_torch.ops.dcn_dryrun import N_HOSTS
    from trivy_tpu_torch.ops.dcn_dryrun import run as dryrun

    out = tmp_path / "dcn.json"
    doc = dryrun(out_path=str(out), timeout=300, device="cpu")
    assert doc["ok"], doc["errors"]
    res = doc["result"]
    assert res["hosts"] == N_HOSTS and res["mesh"] == "2x1x4"
    assert res["device"] == res["worker_device"] == "cpu"
    assert res["diff_vs_oracle"] == 0 and res["matches"] > 0
    assert res["remote_dispatches"] > 0
    assert res["degraded_hosts"] == []
    assert json.loads(out.read_text())["ok"] is True


# --------------------------------------------------------- retired halves


def test_collective_halves_retired():
    """The port has no collective kernel: host_shards is the one slice
    partition of both serving paths, and device.build_mesh is what the
    reference's multihost.crawl_mesh does (no multihost module)."""
    import importlib.util

    from trivy_tpu_torch import device

    assert not hasattr(tm, "ShardedDB")
    assert not hasattr(tm, "_sharded_match")
    assert not hasattr(tm, "shard_map_available")
    assert callable(tm.host_shards)
    assert callable(device.build_mesh) and callable(mesh_ops.build_mesh)
    assert importlib.util.find_spec("trivy_tpu_torch.ops.multihost") is None


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_cuda_spawn_two_hosts_launches_in_both(db, queries, oracle,
                                              monkeypatch):
    """On a card: `2x1x1` with a spawned worker, both processes on
    cuda:0, equal to the single-device engine and the oracle, each
    process's cell launching the match kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    single = MatchEngine(db, window=32, device=dev)
    assert _hits(single, queries) == oracle
    monkeypatch.setenv(dcn.ENV_DCN, "spawn")
    e = MatchEngine(db, window=32, device=dev, mesh_spec="2x1x1")
    try:
        endpoint = e._mdb.hosts[0].endpoint
        dcn.worker_stats(endpoint, reset=True)
        e._mdb.grid[0][0].launches = 0
        assert _hits(e, queries) == oracle
        st = dcn.worker_stats(endpoint)
        mine = st["sessions"][e._mdb._session]
        assert st["device"] == "cuda" and mine["cells"] == [["cuda:0"]]
        assert mine["launches"][0][0] >= 1
        assert e._mdb.grid[0][0].launches >= 1
        assert e.shard_health()["degraded_hosts"] == []
    finally:
        e.close()
