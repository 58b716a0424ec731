"""Port parity, the chaos campaign (trivy_tpu_torch/chaos/ and the `chaos
run|replay` command) against the JAX package's, in the shapes of
tests/test_chaos.py: the fault registry (`faults.SITES`) and the scenario
manifest equal the reference's and partition each other; the seeded
schedules, the coverage sweep and the delta-debugging shrinker give the
reference's specs; `Rule.token` / `FaultPlan.to_spec` round-trip; every
scenario's fault-free oracle bytes equal the reference scenario's; a
smoke campaign, every scenario's campaign on the CPU with no failing
episode, full coverage and no excluded scenario (the same episodes and
fired pairs as the reference's); the replay of every non-slow frozen
repro (tests/golden/chaos_repros.json); the pinned compositions; the
seeded strict violation's shrink; and the CLI.

The port's scenarios take their device paths on ``device="cpu"`` here
(the kernels' plain versions): its `mesh` and `dcn` scenarios repeat
that one device over their grid cells, so neither is excluded, where
the reference places them on the 8 virtual XLA host devices
tests/conftest.py forces.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from trivy_tpu.chaos import campaign as jax_campaign
from trivy_tpu.chaos import scenarios as jax_scenarios
from trivy_tpu.chaos import schedule as jax_schedule
from trivy_tpu.cli import run as jax_run
from trivy_tpu.resilience import faults as jax_faults
from trivy_tpu_torch.chaos import campaign, schedule
from trivy_tpu_torch.chaos.scenarios import (MANIFEST, SCENARIOS,
                                             EpisodeContext, declared_pairs,
                                             registry_pairs)
from trivy_tpu_torch.cli import run
from trivy_tpu_torch.cli.main import main
from trivy_tpu_torch.resilience import faults

pytestmark = pytest.mark.chaos

BUDGET_S = 30.0
CPU = "cpu"
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden", "chaos_repros.json")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and idle OpenMP workers spin on cores their neighbours' timing
    tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()


def _golden_repros() -> list[dict]:
    with open(GOLDEN, encoding="utf-8") as fh:
        return json.load(fh)["repros"]


def _pairs() -> dict:
    return {n: sorted({(s, a) for s, acts in rows for a in acts})
            for n, rows in MANIFEST.items()}


# =============================================== coverage coherence


def test_sites_and_manifest_equal_the_reference():
    assert dict(faults.SITES) == dict(jax_faults.SITES)
    assert sorted(faults.SITES) == sorted(jax_faults.SITES)
    assert MANIFEST == jax_scenarios.MANIFEST
    assert faults.ACTIONS == jax_faults.ACTIONS


def test_manifest_matches_sites_registry():
    assert campaign.full_coverage_check() == []
    assert declared_pairs() == registry_pairs()


def test_every_manifest_scenario_is_registered():
    assert set(MANIFEST) == set(SCENARIOS) == set(jax_scenarios.SCENARIOS)
    for name, cls in SCENARIOS.items():
        assert cls.name == name
        assert cls.smoke == jax_scenarios.SCENARIOS[name].smoke
        obj = cls(CPU)
        try:
            assert set(obj.pairs()) == {
                (s, a) for s, acts in MANIFEST[name] for a in acts}
        finally:
            obj.close()


def test_manifest_claims_are_disjoint():
    seen: dict[tuple[str, str], str] = {}
    for name, rows in MANIFEST.items():
        for site, actions in rows:
            for action in actions:
                assert (site, action) not in seen, (
                    f"{site}:{action} claimed by both "
                    f"{seen[(site, action)]} and {name}")
                seen[(site, action)] = name


@pytest.mark.parametrize("name", ["mesh", "dcn"])
def test_grid_scenarios_are_available_on_one_device(name, monkeypatch):
    """A standing departure: the port's mesh and dcn scenarios repeat
    one device over their cells, so a machine with one card (or none,
    on `device="cpu"`) excludes neither."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for device in (CPU, None):
        obj = SCENARIOS[name](device)
        try:
            assert obj.available() is None
        finally:
            obj.close()


# ============================================ schedule determinism


@pytest.mark.parametrize("seed", [0, 7, 20261021])
def test_generate_episode_gives_the_reference_specs(seed):
    pairs = _pairs()
    for uncovered in (set(declared_pairs()), set(),
                      {("fleet.scan", "kill"), ("db.save", "bitflip")}):
        for i in range(40):
            a = schedule.generate_episode(i, seed, pairs, set(uncovered))
            b = jax_schedule.generate_episode(i, seed, pairs,
                                              set(uncovered))
            assert (a.scenario, a.spec, a.index, a.sweep) == \
                (b.scenario, b.spec, b.index, b.sweep)
            assert a.pairs() == b.pairs()


def test_generated_specs_compile_and_stay_in_scenario():
    pairs = _pairs()
    uncovered = set(declared_pairs())
    for i in range(40):
        ep = schedule.generate_episode(i, 0, pairs, uncovered)
        plan = faults.FaultPlan.from_spec(ep.spec)
        assert plan.rules, ep.spec
        assert {(r.site, r.action) for r in plan.rules} <= \
            set(pairs[ep.scenario]), ep.spec
        r0 = plan.rules[0]
        assert (r0.site, r0.action) in uncovered
        assert r0.prob is None and r0.start <= 2


def test_sweep_episode_gives_the_reference_specs():
    for name, pairs in _pairs().items():
        for k, pair in enumerate(pairs):
            a = schedule.sweep_episode(k, name, pair)
            b = jax_schedule.sweep_episode(k, name, pair)
            assert (a.scenario, a.spec, a.index, a.sweep) == \
                (b.scenario, b.spec, b.index, b.sweep)
            assert faults.FaultPlan.from_spec(a.spec).rules


# ======================================== spec round trip, shrinker


ROUND_TRIP = [
    "seed=5;monitor.index:error@p0.5", "rpc:error=503@1-2",
    "rpc.scan:delay=0.2@3+", "engine:device-lost@1",
    "cache.write.commit:kill@1", "db.save.metadata:bitflip=7",
    "fleet.scan:kill@5", "report.write:torn-write=0.25@2-4",
    "compile_cache.save:kill", "seed=9;analysis.lane:drop@p0.33",
    "fleet.endpoint.0:timeout@2+", "engine.shard:delay=0.002@1",
]


@pytest.mark.parametrize("spec", ROUND_TRIP)
def test_to_spec_round_trips_like_the_reference(spec):
    port = faults.FaultPlan.from_spec(spec)
    ref = jax_faults.FaultPlan.from_spec(spec)
    assert port.to_spec() == ref.to_spec() == spec
    assert [r.token() for r in port.rules] == [r.token() for r in ref.rules]
    again = faults.FaultPlan.from_spec(port.to_spec())
    assert again.to_spec() == spec and again.rules == port.rules


def test_every_generated_spec_round_trips():
    pairs = _pairs()
    for seed in (0, 3):
        for i in range(40):
            spec = schedule.generate_episode(i, seed, pairs, set()).spec
            plan = faults.FaultPlan.from_spec(spec)
            assert plan.to_spec() == \
                jax_faults.FaultPlan.from_spec(spec).to_spec()
            assert faults.FaultPlan.from_spec(plan.to_spec()).rules == \
                plan.rules


SHRINK_CASES = [
    ("seed=3;journal.append:kill@2;rpc:drop@p0.5;engine:device-lost@1",
     lambda plan: any(r.site == "journal.append" for r in plan.rules)),
    ("seed=5;rpc:drop@p0.5;rpc:timeout@1",
     lambda plan: any(r.prob is not None for r in plan.rules)),
    ("seed=1;rpc:drop@1;rpc.scan:error=503@2;fleet.endpoint:timeout@3",
     lambda plan: {"rpc", "fleet.endpoint"} <= {r.site for r in plan.rules}),
    ("seed=4;fleet.scan:kill@2;report.write:bitflip@1-2;"
     "cache.write:torn-write@p0.4",
     lambda plan: any(r.site.startswith("report") for r in plan.rules)),
]


@pytest.mark.parametrize("case", range(len(SHRINK_CASES)))
def test_shrink_gives_the_reference_spec(case):
    spec, pred = SHRINK_CASES[case]
    port = schedule.shrink(
        spec, lambda s: pred(faults.FaultPlan.from_spec(s)))
    ref = jax_schedule.shrink(
        spec, lambda s: pred(jax_faults.FaultPlan.from_spec(s)))
    assert port == ref
    # 1-minimal: dropping any surviving rule flips the predicate
    plan = faults.FaultPlan.from_spec(port)
    tokens = [r.token() for r in plan.rules]
    for i in range(len(tokens)):
        smaller = faults.FaultPlan.from_spec(
            ";".join(tokens[:i] + tokens[i + 1:]))
        assert not pred(smaller) or len(tokens) == 1


def test_shrink_drops_irrelevant_rules_and_selectors():
    spec, pred = SHRINK_CASES[0]
    assert schedule.shrink(
        spec, lambda s: pred(faults.FaultPlan.from_spec(s))) == \
        "journal.append:kill@1"


def test_context_fired_prefix_matching():
    faults.install_spec("db.save.metadata:bitflip@1")
    faults.fire("db.save.metadata")
    ctx = EpisodeContext("/tmp")
    assert ctx.fired("db.save", ("torn-write", "bitflip"))
    assert ctx.fired("db.save.metadata")
    assert not ctx.fired("db.save", ("kill",))
    assert not ctx.fired("rpc")


# =========================================== scenario oracle bytes


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_oracle_bytes_equal_the_reference(name):
    """Each scenario's fault-free workload gives the reference's bytes.
    All ten are package-neutral: `fleetscan` writes its episode's tmp
    directory as <TMP>, `monitor` compares state transitions rather
    than the saved DB's gzip-mtime digest, and the others canonicalize
    results, hit lists or response hashes (the wire codecs are byte
    equal)."""
    port_obj = SCENARIOS[name](CPU)
    ref_obj = jax_scenarios.SCENARIOS[name]()
    try:
        assert ref_obj.available() is None
        port = campaign.compute_oracle(port_obj, BUDGET_S)
        ref = jax_campaign.compute_oracle(ref_obj, BUDGET_S)
    finally:
        port_obj.close()
        ref_obj.close()
    assert port == ref
    assert port  # a workload, not an empty answer


# ============================================== live campaigns


def test_smoke_campaign_controller():
    rep = campaign.run_campaign(seed=2, n_episodes=4,
                                scenario_names=["controller"],
                                budget_s=BUDGET_S, device=CPU)
    assert rep.ok, json.dumps(rep.to_dict(), indent=2)
    assert rep.coverage == 1.0 and not rep.uncovered
    assert not rep.excluded
    assert any(r.killed for r in rep.results)
    d = rep.to_dict()
    for key in ("seed", "episodes", "failed_episodes", "coverage",
                "uncovered", "excluded_scenarios", "repros",
                "results", "ok"):
        assert key in d
    assert d["ok"] is True and d["failed_episodes"] == 0


def test_campaign_over_every_scenario_holds_and_covers():
    """The default campaign (seed 0, 50 seeded episodes, then the
    sweep) over all ten scenarios: no failing episode, every (site,
    action) pair fired, none excluded."""
    rep = campaign.run_campaign(seed=0, n_episodes=50, budget_s=BUDGET_S,
                                device=CPU)
    d = rep.to_dict()
    assert rep.ok, json.dumps([r for r in d["results"] if not r["ok"]],
                              indent=2)
    assert d["failed_episodes"] == 0 and d["coverage"] == 1.0
    assert d["excluded_scenarios"] == {} and d["uncovered"] == []
    assert {r.scenario for r in rep.results} == set(SCENARIOS)
    fired = {p for r in rep.results for p in r.fired}
    assert fired == registry_pairs()


# the scenarios whose paths differ most between the packages (the
# device paths, the fleet scan, the durable writes); `serve` and
# `rollout` spend seconds in the reference's retry waits
COMPARED = ["controller", "dcn", "durable", "fleetscan", "mesh", "monitor",
            "sched", "secret"]


def test_campaign_runs_the_reference_episodes():
    """A short campaign in both packages: the same episodes, in order,
    each firing the same pairs to the same verdict, so both sweeps probe
    the same leftovers."""
    port = campaign.run_campaign(seed=5, n_episodes=6, budget_s=BUDGET_S,
                                 scenario_names=COMPARED, device=CPU)
    ref = jax_campaign.run_campaign(seed=5, n_episodes=6,
                                    scenario_names=COMPARED,
                                    budget_s=BUDGET_S)
    assert not port.excluded and not ref.excluded
    assert [(r.scenario, r.spec, r.sweep, r.fired, r.killed, r.ok)
            for r in port.results] == \
        [(r.scenario, r.spec, r.sweep, r.fired, r.killed, r.ok)
         for r in ref.results]
    assert port.coverage == ref.coverage == 1.0


def test_campaign_rejects_unknown_scenario():
    with pytest.raises(campaign.ChaosError):
        campaign.run_campaign(seed=0, n_episodes=1,
                              scenario_names=["nonesuch"], device=CPU)


# ==================================================== replay surface


def test_replay_holds_invariants_and_reports_fired():
    res = campaign.replay("fleet.controller:error@1", "controller",
                          budget_s=BUDGET_S, device=CPU)
    assert res.ok, res.failures
    assert ("fleet.controller", "error") in res.fired


def test_replay_validates_before_booting():
    with pytest.raises(faults.FaultSpecError):
        campaign.replay("fleet.controller:frobnicate@1", "controller",
                        device=CPU)
    with pytest.raises(campaign.ChaosError):
        campaign.replay("rpc:drop@1", "nonesuch", device=CPU)


def test_repro_env_line_round_trips():
    r = campaign.Repro(scenario="monitor",
                       spec="seed=5;monitor.index:error@p0.5",
                       failures=["zero-diff: ..."])
    assert r.env_line() == \
        "TRIVY_TPU_FAULTS='seed=5;monitor.index:error@p0.5'"
    assert faults.FaultPlan.from_spec(r.spec).to_spec() == r.spec
    assert r.to_dict() == jax_campaign.Repro(
        scenario=r.scenario, spec=r.spec, failures=r.failures).to_dict()


def test_frozen_repros_replay_clean():
    ran = 0
    for entry in _golden_repros():
        if entry.get("slow"):
            continue
        res = campaign.replay(entry["spec"], entry["scenario"],
                              budget_s=BUDGET_S, device=CPU)
        assert res.ok, (entry["spec"], res.failures)
        assert res.fired, entry["spec"]
        ran += 1
    assert ran >= 3


@pytest.mark.parametrize("spec,name,pair,killed", [
    ("fleet.controller:kill@1;journal.append:torn-write@1", "controller",
     ("fleet.controller", "kill"), True),
    ("fleet.rollout:error@1;engine.host:device-lost@1", "rollout",
     ("fleet.rollout", "error"), False),
    ("fleet.scan:kill@2;report.write:bitflip@1", "fleetscan",
     ("fleet.scan", "kill"), True),
    ("db.save:torn-write@1;compile_cache.save:kill", "durable",
     ("db.save", "torn-write"), False),
])
def test_composed_faults_hold(spec, name, pair, killed):
    res = campaign.replay(spec, name, budget_s=BUDGET_S, device=CPU)
    assert res.ok, res.failures
    assert res.killed is killed
    assert pair in res.fired


def test_seeded_violation_shrinks_to_minimal_spec():
    seeded = ("seed=9;monitor.index:error@1+;"
              "monitor.rematch:delay=0.001@1;fleet.endpoint:timeout@1")
    objs, _ = campaign._build_scenarios(["monitor"], CPU)
    obj = objs["monitor"]
    try:
        oracle = campaign.compute_oracle(obj, BUDGET_S)

        def failing(spec: str) -> bool:
            probe = schedule.EpisodeSpec(scenario="monitor", spec=spec,
                                         index=-1)
            return not campaign.run_episode(obj, probe, oracle,
                                            BUDGET_S, strict=True).ok

        assert failing(seeded)
        shrunk = schedule.shrink(seeded, failing)
    finally:
        obj.close()
    assert shrunk == "monitor.index:error"
    res = campaign.replay(shrunk, "monitor", budget_s=BUDGET_S, device=CPU)
    assert res.ok and res.degraded


# ================================================== CLI chaos surface


def test_cli_chaos_replay(capsys):
    rc = main(["chaos", "replay", "fleet.controller:error@1",
               "--scenario", "controller", "--device", "cpu"])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is True and doc["scenario"] == "controller"


def test_cli_chaos_run_writes_report(tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = main(["chaos", "run", "--seed", "3", "--episodes", "1",
               "--scenarios", "controller,secret", "--json", str(out),
               "--device", "cpu"])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert doc["ok"] is True and doc["coverage"] == 1.0
    assert doc["episodes"] >= 1
    assert capsys.readouterr().out.strip().startswith("chaos: ")


def test_cli_chaos_unknown_scenario_is_one_line(capsys):
    rc = main(["chaos", "run", "--scenarios", "nonesuch", "--device",
               "cpu"])
    assert rc == 1
    errors = [ln for ln in capsys.readouterr().err.splitlines()
              if "ERROR" in ln]
    assert len(errors) == 1 and "unknown scenario" in errors[0]


@pytest.mark.parametrize("sub", [["run", "--episodes", "1"],
                                 ["replay", "rpc:drop@1", "--scenario",
                                  "serve"]])
def test_cli_chaos_without_a_card_fails_and_names_cuda(monkeypatch, capsys,
                                                       sub):
    """No silent CPU fallback: without --device cpu the scenarios want
    cuda:0, and without a card the command refuses in one line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["chaos"] + sub) == 1
    captured = capsys.readouterr()
    errors = [ln for ln in captured.err.splitlines() if "ERROR" in ln]
    assert len(errors) == 1 and "CUDA" in errors[0]
    assert captured.out == ""


def test_cli_chaos_report_write_fault_fires(tmp_path, monkeypatch):
    """`chaos run --json` writes its report through the report.write
    site: a torn write lands half the report. The campaign's episodes
    install and reset their own plans; the env plan applies after."""
    out = tmp_path / "report.json"
    rc = main(["chaos", "run", "--seed", "3", "--episodes", "1",
               "--scenarios", "controller", "--json", str(out),
               "--device", "cpu"])
    assert rc == 0
    clean = out.read_bytes()
    out.unlink()
    monkeypatch.setenv("TRIVY_TPU_FAULTS", "report.write:torn-write")
    faults.reset()
    rc = main(["chaos", "run", "--seed", "3", "--episodes", "1",
               "--scenarios", "controller", "--json", str(out),
               "--device", "cpu"])
    assert rc == 0
    torn = out.read_bytes()
    # half of a report as long as the clean one, give or take the
    # digits of its episodes' durations
    assert abs(len(torn) - len(clean) // 2) < 16
    with pytest.raises(ValueError):
        json.loads(torn)
