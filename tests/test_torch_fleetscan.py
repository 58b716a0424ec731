"""Port parity, the fleet scan mode (`--targets`, `--journal`, `--resume`,
`--fleet-parallel`: trivy_tpu_torch/cli/fleet.py over utils/pipeline.py
and the layer pipeline's journal hook) against the JAX package's, in the
shapes of tests/test_durability.py's and tests/test_analysis_pipeline.py's
fleet tests: the merged report and the journal byte for byte under the
fake clock and uuids, a no-op resume, changed options refused with the
reference's message, a failed target journaled and retried, a subprocess
SIGKILL mid-fleet and its resume, layer records written once across
lanes and journaled layers replayed on a resume, the `--monitor-index`
backfill of a resume, a port journal rebuilding the same index in both
packages' `watch --journal`, and the `fleet.scan` and `report.write`
fault sites.

The port scans with `--device cpu` (the match kernel's plain version) or
`--no-tpu`, the reference with `--no-tpu`: both paths write the same
report (the zero-diff rule), so the reference's host run is the oracle.
Each package keeps a cache directory of its own.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from test_analysis_pipeline import PACKAGE_LOCK, _fixture_db, _mk_registry

from trivy_tpu.cli import main as jax_main
from trivy_tpu.cli import run as jax_run
from trivy_tpu.durability import ScanJournal as JaxJournal
from trivy_tpu.monitor.index import MonitorIndex as JaxIndex
from trivy_tpu.resilience import faults as jax_faults
from trivy_tpu.utils import uuid as jax_uuid
from trivy_tpu_torch.cli import run
from trivy_tpu_torch.cli.main import main
from trivy_tpu_torch.durability import ScanJournal
from trivy_tpu_torch.monitor.index import MonitorIndex
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.resilience import faults
from trivy_tpu_torch.utils import uuid as port_uuid

ROOT = Path(__file__).resolve().parents[1]
FAKE_TIME = "2024-01-01T00:00:00+00:00"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and idle OpenMP workers spin on cores their neighbours' timing
    tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fresh() -> None:
    """Both packages as a new process finds them: no cached engine, the
    deterministic uuid counters at 0."""
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()
    port_uuid.reset()
    jax_uuid.reset()


def no_faults() -> None:
    """No fault plan installed, kills real again, in both packages."""
    faults.reset()
    jax_faults.reset()


@pytest.fixture()
def fleet(tmp_path, monkeypatch):
    """Three docker-save images sharing a gzipped base layer, one unique
    app layer each, a targets file naming all three, and the fixture
    DB (saved by the reference; the port loads it as it is)."""
    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", FAKE_TIME)
    monkeypatch.setenv("TRIVY_TPU_DETERMINISTIC_UUID", "1")
    for knob in ("TRIVY_TPU_ANALYSIS_PIPELINE", "TRIVY_TPU_ANALYSIS_WORKERS",
                 "TRIVY_TPU_FAULTS", "TRIVY_TPU_MONITOR"):
        monkeypatch.delenv(knob, raising=False)
    _fixture_db().save(str(tmp_path / "db"))
    imgs = _mk_registry(tmp_path, 3)
    (tmp_path / "targets.txt").write_text("".join(f"{p}\n" for p in imgs))
    fresh()
    no_faults()
    yield tmp_path, imgs
    no_faults()
    fresh()


def argv(env: Path, imgs: list[str], pkg: str, *extra: str,
         mode: str = "device") -> list[str]:
    """The fleet's command line for `pkg` ("port" or "ref"): the port on
    `--device cpu` or `--no-tpu` (`mode`), the reference on `--no-tpu`."""
    out = ["image", imgs[0], "--targets", str(env / "targets.txt"),
           "--format", "json", "--db-path", str(env / "db"),
           "--cache-dir", str(env / f"cache-{pkg}"), "--quiet",
           "--scanners", "vuln"]
    if pkg == "ref" or mode == "no-tpu":
        out.append("--no-tpu")
    else:
        out += ["--device", "cpu"]
    return out + list(extra)


def both(env: Path, imgs: list[str], *extra: str, mode: str = "device",
         name: str = "out") -> tuple[bytes, bytes]:
    """The fleet through each package's CLI, `extra` with `{pkg}` filled
    in -> (port's merged report, reference's)."""
    got = {}
    for pkg, entry in (("port", main), ("ref", jax_main.main)):
        fresh()
        out = env / f"{name}-{pkg}.json"
        args = [a.format(pkg=pkg) for a in extra]
        assert entry(argv(env, imgs, pkg, *args, "--output", str(out),
                          mode=mode)) == 0
        got[pkg] = out.read_bytes()
    return got["port"], got["ref"]


def records(path: Path) -> list[dict]:
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def counters() -> tuple[float, float, float]:
    return (obs_metrics.LAYERS_ANALYZED.value(),
            obs_metrics.LAYER_DEDUPE_HITS.value(),
            obs_metrics.LAYER_DEDUPE_INFLIGHT_WAITS.value())


def delta(base) -> tuple[float, float, float]:
    return tuple(n - b for n, b in zip(counters(), base))


def index_state(idx) -> dict:
    return {"artifacts": {
        a: (idx.packages_of(a),
            None if idx.findings_of(a) is None
            else sorted(repr(k) for k in idx.findings_of(a)))
        for a in idx.artifacts()},
        "db": idx.db_digest, "window": idx.window}


def error_message(err: str) -> str:
    lines = [ln for ln in err.splitlines() if "ERROR" in ln]
    assert len(lines) == 1, err
    return lines[0].split("\t")[-1]


# ========================================================= parity


@pytest.mark.parametrize("mode,lanes", [("device", 1), ("no-tpu", 1),
                                        ("device", 3)])
def test_fleet_report_and_journal_equal_the_reference(fleet, mode, lanes):
    env, imgs = fleet
    port, ref = both(env, imgs, "--fleet-parallel", str(lanes),
                     "--journal", str(env / "j-{pkg}.jsonl"), mode=mode)
    assert port == ref
    doc = json.loads(port)
    assert doc["ArtifactType"] == "fleet" and doc["Targets"] == 3
    assert [r["ArtifactName"] for r in doc["Reports"]] == \
        [f"demo{k}:latest" for k in range(3)]
    for rep in doc["Reports"]:
        ids = {v["VulnerabilityID"] for r in rep.get("Results") or []
               for v in r.get("Vulnerabilities") or []}
        assert "CVE-2019-10744" in ids
    pj = (env / "j-port.jsonl").read_bytes()
    rj = (env / "j-ref.jsonl").read_bytes()
    if lanes == 1:
        assert pj == rj
    else:
        # lanes interleave their records; the records are the same
        assert sorted(pj.splitlines()) == sorted(rj.splitlines())


def test_fleet_with_the_secret_scan_equals_the_reference(fleet):
    env, imgs = fleet
    port, ref = both(env, imgs, "--scanners", "vuln,secret")
    assert port == ref


def test_fleet_summary_line_counts_the_shared_base_once(fleet, capsys):
    env, imgs = fleet
    base = counters()
    args = argv(env, imgs, "port", "--fleet-parallel", "3", "--output",
                str(env / "out.json"))
    args.remove("--quiet")
    assert main(args) == 0
    analyzed, hits, _waits = delta(base)
    # 6 layer slots, 4 unique: the base analyzed once, deduped twice
    assert (analyzed, hits) == (4, 2)
    summary = [ln for ln in capsys.readouterr().err.splitlines()
               if "fleet analysis summary" in ln]
    assert len(summary) == 1
    assert "layers_analyzed=4" in summary[0]
    assert "layers_deduped=2" in summary[0]


def test_noop_resume_is_byte_identical(fleet):
    env, imgs = fleet
    j = env / "j.jsonl"
    assert main(argv(env, imgs, "port", "--journal", str(j), "--output",
                     str(env / "out.json"))) == 0
    fresh()
    base = counters()
    assert main(argv(env, imgs, "port", "--resume", str(j), "--output",
                     str(env / "out2.json"))) == 0
    assert (env / "out.json").read_bytes() == \
        (env / "out2.json").read_bytes()
    assert delta(base)[0] == 0  # nothing re-analyzed
    dones = [r["target"] for r in records(j) if r["kind"] == "done"]
    assert sorted(dones) == sorted(imgs)


@pytest.mark.parametrize("change", ["severity", "format", "grow", "command"])
def test_resume_refuses_with_the_reference_message(fleet, capsys, change):
    env, imgs = fleet
    messages = []
    for pkg, entry in (("port", main), ("ref", jax_main.main)):
        fresh()
        j = env / f"j-{pkg}.jsonl"
        assert entry(argv(env, imgs, pkg, "--journal", str(j), "--output",
                          str(env / f"out-{pkg}.json"))) == 0
        capsys.readouterr()
        args = argv(env, imgs, pkg, "--resume", str(j), "--output",
                    str(env / f"out2-{pkg}.json"))
        args.remove("--quiet")
        if change == "severity":
            args += ["--severity", "LOW"]
        elif change == "format":
            args += ["--format", "table"]
        elif change == "grow":
            extra = env / "extra.tar"
            extra.write_bytes(Path(imgs[0]).read_bytes())
            args[1] = str(extra)
        else:
            args[0] = "sbom"
        assert entry(args) == 1
        messages.append(error_message(capsys.readouterr().err)
                        .replace(f"-{pkg}", "-PKG"))
    assert messages[0] == messages[1]


def test_failed_target_is_journaled_and_retried(fleet):
    env, _imgs = fleet
    bom = {
        "bomFormat": "CycloneDX", "specVersion": "1.5", "version": 1,
        "metadata": {"component": {"bom-ref": "root", "type": "container",
                                   "name": "fleet-bom"}},
        "components": [{
            "bom-ref": "p1", "type": "library", "name": "lodash",
            "version": "4.17.4", "purl": "pkg:npm/lodash@4.17.4",
        }],
    }
    (env / "bom1.json").write_text(json.dumps(bom))
    (env / "targets.txt").write_text(
        f"{env / 'bom1.json'}\n{env / 'missing.json'}\n")

    def sbom_args(pkg, *extra):
        return (["sbom", str(env / "bom1.json"),
                 "--targets", str(env / "targets.txt"),
                 "--format", "json", "--db-path", str(env / "db"),
                 "--cache-dir", str(env / f"cache-{pkg}"), "--quiet",
                 "--scanners", "vuln"]
                + (["--no-tpu"] if pkg == "ref" else ["--device", "cpu"])
                + list(extra))

    for pkg, entry, journal in (("port", main, ScanJournal),
                                ("ref", jax_main.main, JaxJournal)):
        fresh()
        (env / "missing.json").unlink(missing_ok=True)
        j = env / f"j-{pkg}.jsonl"
        assert entry(sbom_args(pkg, "--journal", str(j), "--output",
                               str(env / f"out-{pkg}.json"))) == 1
        state = journal.resume(str(j))
        assert str(env / "bom1.json") in state.done
        assert str(env / "missing.json") in state.failed
        state.close()
        (env / "missing.json").write_text(json.dumps(bom))
        fresh()
        assert entry(sbom_args(pkg, "--resume", str(j), "--output",
                               str(env / f"out-{pkg}.json"))) == 0
    assert (env / "out-port.json").read_bytes() == \
        (env / "out-ref.json").read_bytes()
    assert len(json.loads((env / "out-port.json").read_text())
               ["Reports"]) == 2
    assert records(env / "j-port.jsonl") == records(env / "j-ref.jsonl")


def test_sigkill_mid_fleet_then_resume_equals_the_reference(fleet):
    """A `python -m trivy_tpu_torch` fleet SIGKILLed by the fleet.scan
    kill between its first and second artifact resumes to the merged
    report of the reference's uninterrupted run."""
    env, imgs = fleet
    j = env / "j.jsonl"
    sub_env = dict(
        os.environ, TRIVY_TPU_FAULTS="fleet.scan:kill@2",
        PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + [p for p in (os.environ.get("PYTHONPATH") or "")
                           .split(os.pathsep) if p]))
    proc = subprocess.run(
        [sys.executable, "-m", "trivy_tpu_torch"]
        + argv(env, imgs, "port", "--journal", str(j), "--output",
               str(env / "out-port.json")),
        env=sub_env, capture_output=True, timeout=180)
    assert proc.returncode == -9, proc.stderr.decode()
    kinds = [r["kind"] for r in records(j)]
    assert kinds == ["header", "pending", "pending", "pending", "running",
                     "layer", "layer", "done", "running"]
    assert not (env / "out-port.json").exists()
    fresh()
    assert main(argv(env, imgs, "port", "--resume", str(j), "--output",
                     str(env / "out-port.json"))) == 0
    dones = [r["target"] for r in records(j) if r["kind"] == "done"]
    assert dones.count(imgs[0]) == 1  # never re-scanned
    fresh()
    assert jax_main.main(argv(env, imgs, "ref", "--output",
                              str(env / "out-ref.json"))) == 0
    assert (env / "out-port.json").read_bytes() == \
        (env / "out-ref.json").read_bytes()


def test_layers_journaled_once_across_lanes(fleet):
    env, imgs = fleet
    j = env / "j.jsonl"
    base = counters()
    assert main(argv(env, imgs, "port", "--fleet-parallel", "3",
                     "--journal", str(j), "--output",
                     str(env / "out.json"))) == 0
    assert delta(base)[:2] == (4, 2)
    layers = [r["blob"] for r in records(j) if r["kind"] == "layer"]
    assert len(layers) == 4 and len(set(layers)) == 4
    state = ScanJournal.resume(str(j))
    assert len(state.layers) == 4
    state.close()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_a_killed_fleet_resumes_skipping_its_journaled_layers(fleet, pkg):
    """The fleet.scan kill (raise mode: an in-process InjectedKill) ends
    the fleet before its third artifact; the resume scans only that
    one, its base layer a journal-replayed dedupe, and writes the bytes
    of an uninterrupted run."""
    env, imgs = fleet
    f, entry = (faults, main) if pkg == "port" else \
        (jax_faults, jax_main.main)
    j = env / "j.jsonl"
    f.set_kill_mode("raise")
    f.install_spec("fleet.scan:kill@3")
    with pytest.raises(f.InjectedKill):
        entry(argv(env, imgs, pkg, "--journal", str(j), "--output",
                   str(env / "out.json")))
    no_faults()
    kinds = [r["kind"] for r in records(j)]
    assert kinds.count("done") == 2 and kinds.count("layer") == 3
    fresh()
    base = counters()
    assert entry(argv(env, imgs, pkg, "--resume", str(j), "--output",
                      str(env / "out.json"))) == 0
    if pkg == "port":
        assert delta(base)[:2] == (1, 1)
        assert run.STATS["analysis"]["journal_replayed"] == 1
        assert run.STATS["analysis"]["analyzed"] == 1
    fresh()
    assert jax_main.main(argv(env, imgs, "ref", "--output",
                              str(env / "golden.json"),
                              "--cache-dir", str(env / "cache-golden"))
                         ) == 0
    assert (env / "out.json").read_bytes() == \
        (env / "golden.json").read_bytes()


def test_fs_fleet_uuid_lanes_make_a_resume_byte_identical(tmp_path,
                                                         monkeypatch):
    """fs blob ids are uuids: each artifact draws from the lane of its
    fleet index, so a killed and resumed fs fleet writes the reference's
    uninterrupted bytes."""
    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", FAKE_TIME)
    monkeypatch.setenv("TRIVY_TPU_DETERMINISTIC_UUID", "1")
    p1, p2 = tmp_path / "p1", tmp_path / "p2"
    p1.mkdir()
    p2.mkdir()
    (p1 / "package-lock.json").write_text(PACKAGE_LOCK)
    (p2 / "requirements.txt").write_text("requests==2.19.0\n")
    _fixture_db().save(str(tmp_path / "db"))
    (tmp_path / "targets.txt").write_text(f"{p1}\n{p2}\n")

    def fs_args(pkg, *extra):
        return (["fs", str(p1), "--targets", str(tmp_path / "targets.txt"),
                 "--format", "json", "--db-path", str(tmp_path / "db"),
                 "--cache-dir", str(tmp_path / f"cache-{pkg}"), "--quiet",
                 "--scanners", "vuln"]
                + (["--no-tpu"] if pkg == "ref" else ["--device", "cpu"])
                + list(extra))

    try:
        fresh()
        faults.set_kill_mode("raise")
        faults.install_spec("fleet.scan:kill@2")
        j = tmp_path / "j.jsonl"
        with pytest.raises(faults.InjectedKill):
            main(fs_args("port", "--journal", str(j), "--output",
                         str(tmp_path / "out-port.json")))
        no_faults()
        fresh()
        assert main(fs_args("port", "--resume", str(j), "--output",
                            str(tmp_path / "out-port.json"))) == 0
        fresh()
        assert jax_main.main(fs_args("ref", "--output",
                                     str(tmp_path / "out-ref.json"))) == 0
    finally:
        no_faults()
        fresh()
    assert (tmp_path / "out-port.json").read_bytes() == \
        (tmp_path / "out-ref.json").read_bytes()


# ============================================== the monitor's part


def test_monitor_index_backfill_equals_the_reference(fleet):
    """A fleet killed after two artifacts without --monitor-index, then
    resumed with it: the two journal-completed artifacts are backfilled
    from their embedded reports (null baselines) and the third recorded
    by its scan, in both packages alike."""
    env, imgs = fleet
    states = {}
    for pkg, f, entry, index in (("port", faults, main, MonitorIndex),
                                 ("ref", jax_faults, jax_main.main,
                                  JaxIndex)):
        fresh()
        j = env / f"j-{pkg}.jsonl"
        idx = env / f"idx-{pkg}.jsonl"
        f.set_kill_mode("raise")
        f.install_spec("fleet.scan:kill@3")
        # the embedded reports keep their packages (the backfill's
        # inventory) with --list-all-pkgs
        with pytest.raises(f.InjectedKill):
            entry(argv(env, imgs, pkg, "--journal", str(j), "--output",
                       str(env / f"out-{pkg}.json"), "--list-all-pkgs"))
        no_faults()
        fresh()
        assert entry(argv(env, imgs, pkg, "--resume", str(j),
                          "--monitor-index", str(idx), "--output",
                          str(env / f"out-{pkg}.json"),
                          "--list-all-pkgs")) == 0
        opened = index.open(str(idx))
        try:
            states[pkg] = index_state(opened)
        finally:
            opened.close()
    assert states["port"] == states["ref"]
    arts = states["port"]["artifacts"]
    assert sorted(arts) == sorted(imgs)
    assert arts[imgs[0]][1] is None and arts[imgs[1]][1] is None
    assert arts[imgs[2]][1]  # scanned: a finding baseline


def test_port_journal_rebuilds_the_same_index_in_both_watch_commands(
        fleet, capsys):
    env, imgs = fleet
    j = env / "j.jsonl"
    assert main(argv(env, imgs, "port", "--journal", str(j), "--output",
                     str(env / "out.json"), "--list-all-pkgs")) == 0
    states, events = {}, {}
    for pkg, entry, index in (("port", main, MonitorIndex),
                              ("ref", jax_main.main, JaxIndex)):
        fresh()
        idx = env / f"idx-{pkg}.jsonl"
        idx.write_text("garbage\n")  # unusable: rebuilt from the journal
        capsys.readouterr()
        assert entry(["watch", "--db-path", str(env / "db"), "--index",
                      str(idx), "--journal", str(j), "--once", "--no-tpu",
                      "--quiet", "--cache-dir", str(env / f"c-{pkg}")]) == 0
        events[pkg] = [{k: v for k, v in json.loads(ln).items()
                        if k != "duration_s"}
                       for ln in capsys.readouterr().out.splitlines()]
        opened = index.open(str(idx))
        try:
            states[pkg] = index_state(opened)
        finally:
            opened.close()
    assert states["port"] == states["ref"]
    assert sorted(states["port"]["artifacts"]) == sorted(imgs)
    assert events["port"] == events["ref"]


# ================================================== fault sites


@pytest.mark.parametrize("action", ["torn-write", "bitflip", "kill"])
def test_report_write_faults_act_like_the_reference(fleet, action):
    """report.write on the merged report: a torn or flipped write lands
    the same mangled bytes in both packages; a kill between the tmp
    write and the rename leaves no report."""
    env, imgs = fleet
    assert main(argv(env, imgs, "port", "--output",
                     str(env / "clean.json"))) == 0
    clean = (env / "clean.json").read_bytes()
    out = {}
    for pkg, f, entry in (("port", faults, main),
                          ("ref", jax_faults, jax_main.main)):
        fresh()
        path = env / f"out-{pkg}.json"
        f.set_kill_mode("raise")
        f.install_spec(f"report.write:{action}")
        try:
            if action == "kill":
                with pytest.raises(f.InjectedKill):
                    entry(argv(env, imgs, pkg, "--output", str(path)))
                assert not path.exists()
                assert [n for n in os.listdir(env)
                        if n.startswith(f".out-{pkg}.json.tmp-")]
            else:
                assert entry(argv(env, imgs, pkg, "--output",
                                  str(path))) == 0
                out[pkg] = path.read_bytes()
            assert [(r.site, r.action) for r in f.active().rules
                    if r.fired] == [("report.write", action)]
        finally:
            no_faults()
    if action == "torn-write":
        assert out["port"] == out["ref"] == clean[:len(clean) // 2]
    elif action == "bitflip":
        assert out["port"] == out["ref"] != clean
        assert len(out["port"]) == len(clean)
