"""Port parity, bottleneck attribution: trivy_tpu_torch/obs/attrib.py
(the lane taxonomy, the streaming aggregator, the slow-scan flight
recorder), the server's `/debug/profile` and `/debug/flight` behind the
reference's token gate, the attribution the server holds for its
lifetime, and the `profile` command, each against the JAX package's.

The tolerance is exact equality of keys, lanes, gates and (with every
number and random id masked) command output; the critical-path
partition must sum to the wall within 1e-5 s (the records round each
value to the microsecond). Both packages' tracing
state is reset around every test (test_torch_obs.py `obs_state`).
"""

from __future__ import annotations

import json
import re
import time

import pytest
from test_torch_obs import (  # noqa: F401 — fixtures
    PKGS,
    TOKEN,
    _get,
    _one_thread,
    _scan_with,
    obs_state,
    pkg,
    port_witness,
    servers,
)

from trivy_tpu.cli import main as jax_main
from trivy_tpu_torch.cli.main import main

pytestmark = pytest.mark.obs


def _scan_once(tr):
    """One synthetic scan trace with one span per classified lane."""
    with tr.span("scan_artifact"):
        with tr.span("inspect"):
            with tr.span("analysis.fetch"):
                time.sleep(0.002)
            with tr.span("analysis.walk"):
                time.sleep(0.004)
        with tr.span("detect"):
            with tr.span("engine.dispatch"):
                time.sleep(0.001)
            with tr.span("sched.enqueue"):
                time.sleep(0.001)
        with tr.span("report"):
            time.sleep(0.001)


@pytest.fixture()
def agg(pkg):
    """A private Aggregator of `pkg` fed by its tracer's sink."""
    a = pkg["attrib"].Aggregator()
    pkg["tracing"].set_sink(a.observe_root)
    return a


def test_taxonomy_is_closed(pkg):
    at = pkg["attrib"]
    for name, lane in at.SPAN_LANES.items():
        assert lane in at.LANES, (name, lane)
    assert set(at.PRIORITY) == set(at.LANES)
    assert not set(at.SPAN_LANES) & at.SPAN_STRUCTURAL
    assert at.classify("analysis.fetch") == "fetch_io"
    assert at.classify("rpc.Scan") == "fetch_io"
    assert at.classify("scan_artifact") is None
    assert at.classify("no.such.span") is None


def test_critical_partition_sums_to_the_wall(pkg, agg):
    _scan_once(pkg["tracing"])
    rec = agg.snapshot()["recent"][0]
    # each value is rounded to the microsecond in the record
    assert abs(sum(rec["crit"].values()) + rec["other_s"]
               - rec["wall_s"]) < 1e-5
    for lane, busy in rec["busy"].items():
        assert busy <= rec["wall_s"] + 1e-5, lane
    assert rec["busy"]["device_dispatch"] > 0


def test_nested_same_lane_spans_count_once(pkg, agg):
    tr = pkg["tracing"]
    with tr.span("scan_artifact"):
        with tr.span("analysis.walk"):
            with tr.span("analysis.walk"):
                time.sleep(0.005)
    rec = agg.snapshot()["recent"][0]
    assert rec["busy"]["host_crunch"] <= rec["wall_s"] + 1e-5


def test_work_lane_outranks_a_wait_lane(pkg, agg):
    tr = pkg["tracing"]
    with tr.span("scan_artifact"):
        with tr.span("sched.enqueue"):
            with tr.span("engine.dispatch"):
                time.sleep(0.005)
    rec = agg.snapshot()["recent"][0]
    assert rec["crit"]["device_dispatch"] > rec["crit"].get(
        "queue_wait", 0.0)


def test_flight_recorder_keeps_the_slowest(pkg, agg, monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_FLIGHT_RECORDER_N", "2")
    agg.reset()
    tr = pkg["tracing"]
    for s in (0.001, 0.006, 0.003):
        with tr.span("scan_artifact", want=s):
            time.sleep(s)
    walls = [r["wall_s"] for r in agg.flight.records()]
    assert len(walls) == 2 and walls == sorted(walls, reverse=True)
    doc = agg.flight.chrome_doc()
    assert doc["traceEvents"] and doc["flightRecorder"]["traces"] == 2


def test_snapshot_keys_equal_the_reference():
    docs = {}
    for name, p in PKGS.items():
        a = p["attrib"].Aggregator()
        p["tracing"].set_sink(a.observe_root)
        _scan_once(p["tracing"])
        p["tracing"].set_sink(None)
        docs[name] = a.snapshot()
    assert _shape(docs["port"]) == _shape(docs["ref"])


def _shape(doc):
    """Keys of a JSON document, recursively (list items by their first
    element), values dropped."""
    if isinstance(doc, dict):
        return {k: _shape(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_shape(doc[0])] if doc else []
    return type(doc).__name__ if isinstance(doc, (bool, str)) else "num"


# -------------------------------------------------------------- server

@pytest.mark.parametrize("path", ["/debug/profile", "/debug/flight",
                                  "/debug/usage", "/debug/nothing"])
def test_debug_gate_and_keys_equal_the_reference(servers, monkeypatch,
                                                 path):
    """Without a token 401, with the scan token or the dedicated
    TRIVY_TPU_PROFILE_TOKEN 200 (and that token opens no scan), the
    same status and document keys as the reference's after the same
    scans."""
    monkeypatch.setenv("TRIVY_TPU_PROFILE_TOKEN", "prof")
    got = {}
    for name in ("port", "ref"):
        addr = servers[name].address
        _scan_with(name, addr)
        anon = _get(addr, path, token=None)
        wrong = _get(addr, path, token="nope")
        prof = _get(addr, path, token="prof")
        scan = _get(addr, path)
        metrics = _get(addr, "/metrics", token=None)
        body = scan[2]
        got[name] = (anon[0], anon[2], wrong[0], prof[0], scan[0],
                     metrics[0],
                     _shape(json.loads(body)) if scan[0] == 200 else body)
    assert got["port"] == got["ref"]
    status = got["port"][4]
    assert got["port"][:2] == (401, b'{"error": "invalid token"}')
    assert status == (404 if path == "/debug/nothing" else 200)


def test_server_attribution_sees_the_device_dispatch(servers):
    """The server holds the attribution sink for its lifetime: after
    two scans its profile charges device_dispatch (engine.dispatch
    spans), and the critical seconds with `other` sum to the wall."""
    _scan_with("port", servers["port"].address)
    status, _h, body = _get(servers["port"].address, "/debug/profile")
    doc = json.loads(body)
    assert status == 200 and doc["enabled"] and doc["scans"] >= 2
    assert doc["lanes"]["device_dispatch"]["busy_s"] > 0
    crit = sum(row["crit_s"] for row in doc["lanes"].values())
    assert abs(crit + doc["other_s"] - doc["wall_s"]) < 1e-5
    flight = json.loads(_get(servers["port"].address, "/debug/flight")[2])
    names = {e["name"] for e in flight["traceEvents"]}
    assert {"server.scan", "detect", "engine.dispatch"} <= names


def test_kill_switch_and_release_on_shutdown(monkeypatch):
    """TRIVY_TPU_ATTRIB=0 keeps the sink off; a server releases the
    sink it holds when it shuts down."""
    from trivy_tpu_torch.cache.cache import MemoryCache
    from trivy_tpu_torch.detector.engine import MatchEngine
    from trivy_tpu_torch.obs import tracing
    from trivy_tpu_torch.rpc.server import Server
    from test_torch_obs import _db

    engine = MatchEngine(_db(), device="cpu")
    monkeypatch.setenv("TRIVY_TPU_ATTRIB", "0")
    s = Server(engine, MemoryCache(), host="127.0.0.1", port=0)
    s.start()
    assert tracing._sink is None and not s._attrib_held
    s.shutdown()
    monkeypatch.delenv("TRIVY_TPU_ATTRIB")
    s = Server(engine, MemoryCache(), host="127.0.0.1", port=0)
    s.start()
    assert tracing._sink is not None and s._attrib_held
    s.shutdown()
    assert tracing._sink is None


_NUM = re.compile(r"\d+(\.\d+)?%?")


def _mask(text: str) -> list[str]:
    """Command output with every number, trace id and timing-decided
    lane name masked, and each run of spaces made one (a right-aligned
    column's padding follows its number's width), lines sorted."""
    text = re.sub(r"[0-9a-f]{32}", "ID", text)
    text = re.sub(r"(verdict: |dominant=).*?(\s|$)", r"\1X\2", text)
    return sorted(re.sub(r" +", " ", _NUM.sub("N", ln))
                  for ln in text.splitlines())


@pytest.mark.parametrize("extra", [[], ["--json"]])
def test_profile_command_equals_the_reference(servers, capsys, tmp_path,
                                              extra):
    outs = {}
    for name, entry in (("port", main), ("ref", jax_main.main)):
        _scan_with(name, servers[name].address)
        flight = str(tmp_path / name / "flight.json")
        (tmp_path / name).mkdir()
        rc = entry(["profile", servers[name].address, "--token", TOKEN,
                    "--flight", flight, "--quiet", *extra])
        out = capsys.readouterr().out
        assert rc == 0, name
        if extra:
            doc = json.loads(out[out.index("{"):])
            outs[name] = (_shape(doc), sorted(doc["lanes"]))
        else:
            outs[name] = _mask(out.replace(f"/{name}/", "/PKG/"))
        assert json.load(open(flight))["traceEvents"]
    assert outs["port"] == outs["ref"]


def test_profile_refuses_a_replica_set(capsys):
    """A replica set none of whose replicas answers fails with one
    line, as the reference's federation does."""
    from trivy_tpu.cli.main import main as jax_main

    argv = ["profile", "http://127.0.0.1:9,http://127.0.0.1:10"]
    rc = main(argv)
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == 1 and len(err) == 1
    assert "profile fetch failed" in err[0]
    assert jax_main(argv) == 1
    want = capsys.readouterr().err.strip().splitlines()
    assert err[0].split("\t")[-1] == want[0].split("\t")[-1]


def test_profile_of_an_unreachable_server_is_one_line(capsys):
    rc = main(["profile", "http://127.0.0.1:9"])
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == 1 and len(err) == 1 and "profile fetch failed" in err[0]
