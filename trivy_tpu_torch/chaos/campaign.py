"""Chaos campaign engine: episodes, invariant oracles, shrinking.

An *episode* is one scenario workload run under one generated fault
schedule, with the process-wide fault injector armed in ``raise`` kill
mode so even ``kill`` rules stay in-process.  After every episode five
invariant oracles run:

1. **zero-diff-or-stamped** — output bytes equal the fault-free
   oracle run, or the scenario stamped a documented degraded ladder;
2. **exactly-once** — no duplicate side effects (double-applied
   controller intents, duplicate spawns, re-journaled layers): the
   scenario records breaches via ``EpisodeContext.violate``;
3. **durable convergence** — an episode interrupted by an injected
   kill recovers (restart/replay on the surviving state) to the
   uninterrupted oracle's bytes;
4. **liveness** — both the run and its recovery finish inside the
   watchdog budget, and the armed lock witness found no lock cycle;
5. **telemetry hygiene** — Prometheus counters never go backwards and
   (for episodes that were not killed mid-span) no collected trace
   root names a parent that was never collected.

A failing episode's schedule is delta-debugged down to a minimal
still-failing spec (rules first, then selectors) and emitted as a
ready-to-paste ``TRIVY_TPU_FAULTS`` repro.  Campaign coverage is
machine-checked: every (site, action) pair the scenario manifest
claims must actually *fire* during the campaign — a deterministic
``@1`` sweep episode probes each pair the seeded phase missed, and a
pair that still never fires fails the campaign.

Copy of trivy_tpu/chaos/campaign.py. `run_campaign` and `replay` take
the torch device every scenario builds its device paths on (None is
``cuda:0``); the counters come from the port's `obs.metrics` registry,
the lock witness from its `analysis/witness.py`.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field

from trivy_tpu_torch.chaos import schedule
from trivy_tpu_torch.chaos.scenarios import (SCENARIOS, EpisodeContext,
                                             Scenario, declared_pairs,
                                             registry_pairs)
from trivy_tpu_torch.resilience import faults


class ChaosError(Exception):
    """Campaign-level failure (oracle run broken, unknown scenario)."""


def default_seed() -> int:
    return int(os.environ.get("TRIVY_TPU_CHAOS_SEED", "0"))


def default_episodes() -> int:
    return int(os.environ.get("TRIVY_TPU_CHAOS_EPISODES", "50"))


def default_budget_s() -> float:
    return float(os.environ.get("TRIVY_TPU_CHAOS_BUDGET_S", "30"))


# ------------------------------------------------------------ plumbing


def _watchdog(fn, ctx: EpisodeContext, budget_s: float):
    """Run fn(ctx) on a watched thread -> (out, err, timed_out)."""
    box: dict = {}

    def work():
        try:
            box["out"] = fn(ctx)
        # surfaced as data: the judge turns InjectedKill into the
        # durable-convergence oracle
        # lint: allow[bare-except] surfaced as data: the judge turns InjectedKill into the durable-convergence oracle
        except BaseException as exc:
            box["err"] = exc

    # the episode thread IS the trace root: no submitting scan to
    # stitch to
    # lint: allow[tracing-capture] the episode thread IS the trace root — there is no submitting scan to stitch to
    t = threading.Thread(target=work, daemon=True,
                         name="chaos-episode")
    t.start()
    t.join(budget_s)
    if t.is_alive():
        return None, None, True
    return box.get("out"), box.get("err"), False


def _counter_values() -> dict[str, float]:
    """Prometheus counter samples (name+labels -> value) from the
    process registry; `# TYPE ... counter` lines pick the counters."""
    from trivy_tpu_torch.obs import metrics as obs_metrics
    text = obs_metrics.REGISTRY.render()
    if isinstance(text, bytes):
        text = text.decode("utf-8", "replace")
    counters: set[str] = set()
    out: dict[str, float] = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) >= 4 and parts[3] == "counter":
                counters.add(parts[2])
        elif line and not line.startswith("#"):
            series, _, val = line.rpartition(" ")
            if series.split("{", 1)[0] in counters:
                try:
                    out[series] = float(val)
                except ValueError:
                    pass
    return out


def _fired_pairs() -> set[tuple[str, str]]:
    plan = faults.active()
    if plan is None:
        return set()
    return {(r.site, r.action) for r in plan.rules if r.fired}


# ------------------------------------------------------------- results


@dataclass
class EpisodeResult:
    scenario: str
    spec: str
    index: int
    failures: list[str] = field(default_factory=list)
    degraded: list[str] = field(default_factory=list)
    fired: list[tuple[str, str]] = field(default_factory=list)
    killed: bool = False
    sweep: bool = False
    duration_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.failures

    def to_dict(self) -> dict:
        return {"scenario": self.scenario, "spec": self.spec,
                "index": self.index, "ok": self.ok,
                "failures": self.failures, "degraded": self.degraded,
                "fired": sorted(f"{s}:{a}" for s, a in self.fired),
                "killed": self.killed, "sweep": self.sweep,
                "duration_s": round(self.duration_s, 3)}


@dataclass
class Repro:
    """A shrunk, replayable failure: paste the env line and run
    ``trivy-tpu chaos replay SPEC --scenario NAME``."""
    scenario: str
    spec: str
    failures: list[str]

    def env_line(self) -> str:
        return f"TRIVY_TPU_FAULTS='{self.spec}'"

    def to_dict(self) -> dict:
        return {"scenario": self.scenario, "spec": self.spec,
                "failures": self.failures, "env": self.env_line()}


@dataclass
class CampaignReport:
    seed: int
    results: list[EpisodeResult]
    coverage: float
    uncovered: list[tuple[str, str]]
    excluded: dict[str, str]
    repros: list[Repro]

    @property
    def failures(self) -> list[EpisodeResult]:
        return [r for r in self.results if not r.ok]

    @property
    def ok(self) -> bool:
        return not self.failures and not self.uncovered

    def to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "episodes": len(self.results),
            "failed_episodes": len(self.failures),
            "coverage": round(self.coverage, 4),
            "uncovered": sorted(f"{s}:{a}"
                                for s, a in self.uncovered),
            "excluded_scenarios": dict(self.excluded),
            "repros": [r.to_dict() for r in self.repros],
            "results": [r.to_dict() for r in self.results],
            "ok": self.ok,
        }


# ------------------------------------------------------------ episodes


def run_episode(scenario: Scenario, ep: schedule.EpisodeSpec,
                oracle: bytes, budget_s: float,
                strict: bool = False) -> EpisodeResult:
    """One episode + the five oracles.  `strict` disables the degraded
    escape hatch (used to seed shrinkable failures deliberately)."""
    from trivy_tpu_torch.analysis import witness
    from trivy_tpu_torch.obs import tracing

    tmp = tempfile.mkdtemp(prefix=f"chaos-{ep.scenario}-")
    ctx = EpisodeContext(tmp)
    res = EpisodeResult(scenario=ep.scenario, spec=ep.spec,
                        index=ep.index, sweep=ep.sweep)
    tracing_prior = tracing.enabled()
    tracing.reset()
    tracing.enable(True)
    before = _counter_values()
    if witness.enabled():
        witness.WITNESS.reset()
    faults.reset()
    faults.install_spec(ep.spec)
    faults.set_kill_mode("raise")
    t0 = time.monotonic()
    try:
        out, err, timed_out = _watchdog(scenario.run, ctx, budget_s)
        res.fired = sorted(_fired_pairs())
        if isinstance(err, faults.InjectedKill):
            res.killed = True
            err = None
            faults.reset()  # the fault plan dies with the "process"
            out, err, timed_out2 = _watchdog(scenario.recover, ctx,
                                             budget_s)
            timed_out = timed_out or timed_out2
    finally:
        res.fired = sorted(set(res.fired) | _fired_pairs())
        faults.reset()
    res.duration_s = time.monotonic() - t0
    res.degraded = list(ctx.degraded)

    # oracle 4: liveness (watchdog)
    if timed_out:
        res.failures.append(
            f"liveness: episode exceeded {budget_s}s budget")
    elif err is not None:
        res.failures.append(
            f"crash: {type(err).__name__}: {err}")
    else:
        stamped = bool(ctx.degraded) and not strict
        if out != oracle and not stamped:
            # oracle 1 / oracle 3, depending on how the episode died
            if res.killed:
                res.failures.append(
                    "durable-convergence: recovered bytes diverge "
                    "from the uninterrupted oracle")
            else:
                res.failures.append(
                    "zero-diff: output diverges from oracle with no "
                    "degraded stamp")
    # oracle 2: exactly-once, from scenario-side witnesses
    for v in ctx.violations:
        res.failures.append(f"exactly-once: {v}")
    # oracle 4b: lock-witness cycle
    if witness.enabled():
        cycle = witness.WITNESS.find_cycle()
        if cycle:
            res.failures.append(f"liveness: lock cycle {cycle}")
    # oracle 5: telemetry hygiene
    after = _counter_values()
    for series, val in before.items():
        if after.get(series, val) < val:
            res.failures.append(
                f"telemetry: counter {series} went backwards")
    if not res.killed and not timed_out:
        sp = tracing.spans()
        ids = {s.span_id for s in sp}
        orphans = [s for s in sp
                   if s.parent_id and s.parent_id not in ids]
        if orphans:
            names = sorted({s.name for s in orphans})
            res.failures.append(
                f"telemetry: {len(orphans)} orphan trace root(s): "
                f"{names}")
    tracing.reset()
    tracing.enable(tracing_prior)
    shutil.rmtree(tmp, ignore_errors=True)
    return res


def compute_oracle(scenario: Scenario, budget_s: float) -> bytes:
    """Fault-free reference bytes for a scenario's workload."""
    tmp = tempfile.mkdtemp(prefix=f"chaos-oracle-{scenario.name}-")
    try:
        faults.reset()
        out, err, timed_out = _watchdog(
            scenario.run, EpisodeContext(tmp), budget_s)
        if timed_out:
            raise ChaosError(
                f"oracle run for {scenario.name!r} exceeded "
                f"{budget_s}s")
        if err is not None:
            raise ChaosError(
                f"oracle run for {scenario.name!r} failed: "
                f"{type(err).__name__}: {err}") from err
        return out
    finally:
        faults.reset()
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ campaign


def _build_scenarios(names, device=None) -> tuple[dict, dict]:
    objs: dict[str, Scenario] = {}
    excluded: dict[str, str] = {}
    for n in names:
        if n not in SCENARIOS:
            raise ChaosError(
                f"unknown scenario {n!r} (have: "
                f"{', '.join(sorted(SCENARIOS))})")
        obj = SCENARIOS[n](device)
        why = obj.available()
        if why:
            excluded[n] = why
            obj.close()
        else:
            objs[n] = obj
    return objs, excluded


def run_campaign(seed: int, n_episodes: int, scenario_names=None,
                 budget_s: float = 30.0, strict: bool = False,
                 shrink_failures: bool = True,
                 log=None, device=None) -> CampaignReport:
    """The campaign loop: seeded episodes, then the coverage sweep,
    then shrinking for whatever failed. Every scenario runs its device
    paths on `device` (None is ``cuda:0``)."""
    def say(msg):
        if log:
            log(msg)

    names = sorted(scenario_names or SCENARIOS)
    objs, excluded = _build_scenarios(names, device)
    if not objs:
        raise ChaosError(f"no runnable scenarios in {names!r}: "
                         f"{excluded}")
    for n, why in sorted(excluded.items()):
        say(f"scenario {n} excluded: {why}")
    scenario_pairs = {n: sorted(o.pairs()) for n, o in objs.items()}
    declared = {p for pairs in scenario_pairs.values() for p in pairs}
    uncovered = set(declared)
    oracles: dict[str, bytes] = {}
    results: list[EpisodeResult] = []

    def oracle_of(name: str) -> bytes:
        if name not in oracles:
            oracles[name] = compute_oracle(objs[name], budget_s)
        return oracles[name]

    try:
        for i in range(n_episodes):
            ep = schedule.generate_episode(i, seed, scenario_pairs,
                                           uncovered)
            res = run_episode(objs[ep.scenario], ep,
                              oracle_of(ep.scenario), budget_s,
                              strict=strict)
            uncovered -= set(res.fired)
            results.append(res)
            say(f"episode {i} {ep.scenario} "
                f"{'ok' if res.ok else 'FAIL'} spec={ep.spec!r} "
                f"fired={len(res.fired)} "
                f"uncovered={len(uncovered)}")
        # deterministic sweep: probe every pair the seeded phase
        # never fired with a single @1 rule
        j = n_episodes
        for pair in sorted(uncovered):
            owner = next(n for n in sorted(scenario_pairs)
                         if pair in scenario_pairs[n])
            ep = schedule.sweep_episode(j, owner, pair)
            j += 1
            res = run_episode(objs[owner], ep, oracle_of(owner),
                              budget_s, strict=strict)
            uncovered -= set(res.fired)
            results.append(res)
            say(f"sweep {pair[0]}:{pair[1]} on {owner} "
                f"{'ok' if res.ok else 'FAIL'} "
                f"fired={'yes' if pair not in uncovered else 'NO'}")

        repros: list[Repro] = []
        if shrink_failures:
            for res in [r for r in results if not r.ok]:
                say(f"shrinking failing spec {res.spec!r} "
                    f"({res.scenario})")
                obj = objs[res.scenario]
                oracle = oracle_of(res.scenario)

                def failing(spec2: str) -> bool:
                    probe = schedule.EpisodeSpec(
                        scenario=res.scenario, spec=spec2, index=-1)
                    return not run_episode(obj, probe, oracle,
                                           budget_s,
                                           strict=strict).ok

                spec = schedule.shrink(res.spec, failing)
                repros.append(Repro(scenario=res.scenario, spec=spec,
                                    failures=list(res.failures)))
                say(f"shrunk to {spec!r}")
    finally:
        for obj in objs.values():
            obj.close()
        faults.reset()

    coverage = (1.0 if not declared
                else 1.0 - len(uncovered) / len(declared))
    return CampaignReport(seed=seed, results=results,
                          coverage=coverage,
                          uncovered=sorted(uncovered),
                          excluded=excluded, repros=repros)


def replay(spec: str, scenario_name: str, budget_s: float = 30.0,
           strict: bool = False, device=None) -> EpisodeResult:
    """Re-run one spec against one scenario (the `chaos replay`
    surface): fresh oracle, same five invariant checks, the scenario's
    device paths on `device` (None is ``cuda:0``)."""
    faults.FaultPlan.from_spec(spec)  # validate before booting
    objs, excluded = _build_scenarios([scenario_name], device)
    if scenario_name in excluded:
        raise ChaosError(f"scenario {scenario_name!r} unavailable "
                         f"here: {excluded[scenario_name]}")
    obj = objs[scenario_name]
    try:
        oracle = compute_oracle(obj, budget_s)
        ep = schedule.EpisodeSpec(scenario=scenario_name, spec=spec,
                                  index=0)
        return run_episode(obj, ep, oracle, budget_s, strict=strict)
    finally:
        obj.close()


def full_coverage_check() -> list[str]:
    """Manifest <-> faults.SITES coherence."""
    problems = []
    declared = declared_pairs()
    registry = registry_pairs()
    for site, action in sorted(registry - declared):
        problems.append(f"SITES pair {site}:{action} claimed by no "
                        "chaos scenario")
    for site, action in sorted(declared - registry):
        problems.append(f"chaos manifest claims unknown pair "
                        f"{site}:{action}")
    return problems
