"""Seed-derived fault schedules and the delta-debugging shrinker.

A *schedule* is just a ``TRIVY_TPU_FAULTS`` spec string (with its
``seed=`` token), so every artifact of the campaign — episodes,
shrunk repros, frozen regressions — is directly replayable with the
injector that already exists; the chaos engine adds no second fault
grammar.  Generation is coverage-guided: the first rule of each
episode aims at a still-unfired (site, action) pair with an
early-count selector, the rest compose more rules from the same
scenario's claimed sites with randomized selectors (``@N``, ``@N-M``,
``@N+``, ``@pF``).  Everything derives from
``random.Random(f"chaos:{seed}:{i}")`` — same campaign seed, same
schedules, byte for byte.

Copy of trivy_tpu/chaos/schedule.py: the same seed gives the same
specs in both packages.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from trivy_tpu_torch.resilience import faults


@dataclass
class EpisodeSpec:
    """One planned episode: a scenario name + a fault spec."""
    scenario: str
    spec: str
    index: int
    sweep: bool = False  # appended by the coverage sweep, not seeded

    def pairs(self) -> list[tuple[str, str]]:
        plan = faults.FaultPlan.from_spec(self.spec)
        return [(r.site, r.action) for r in plan.rules]


def _param_token(site: str, action: str, rng: random.Random) -> str:
    """`=param` fragment: delays stay tiny so episodes stay fast, rpc
    errors pick a realistic 5xx; everything else uses site defaults."""
    if action == "delay":
        return f"={round(rng.uniform(0.001, 0.004), 4)}"
    if action == "error" and site.split(".")[0] == "rpc":
        return f"={rng.choice([500, 502, 503])}"
    return ""


def _selector(rng: random.Random, eager: bool) -> str:
    """`@...` fragment. `eager` selectors are chosen to actually fire
    (early counts); the rest explore the full grammar."""
    if eager:
        return rng.choice(["@1", "@1-2", "@1-3", "@2"])
    roll = rng.random()
    if roll < 0.3:
        return f"@{rng.randrange(1, 5)}"
    if roll < 0.5:
        start = rng.randrange(1, 4)
        return f"@{start}-{start + rng.randrange(1, 4)}"
    if roll < 0.7:
        return f"@{rng.randrange(1, 4)}+"
    return f"@p{round(rng.uniform(0.3, 0.8), 2)}"


def rule_token(site: str, action: str, rng: random.Random,
               eager: bool) -> str:
    return (f"{site}:{action}{_param_token(site, action, rng)}"
            f"{_selector(rng, eager)}")


def episode_rng(seed: int, index: int) -> random.Random:
    # string seeding is stable across processes (unlike hash())
    return random.Random(f"chaos:{seed}:{index}")


def generate_episode(index: int, seed: int,
                     scenario_pairs: dict[str, list[tuple[str, str]]],
                     uncovered: set[tuple[str, str]]) -> EpisodeSpec:
    """Plan episode `index`: aim rule 0 at an uncovered pair when any
    remain (deterministic choice), then compose 0-2 extra rules from
    the same scenario so faults overlap in one run."""
    rng = episode_rng(seed, index)
    names = sorted(scenario_pairs)
    target = None
    todo = sorted(p for n in names for p in scenario_pairs[n]
                  if p in uncovered)
    if todo:
        target = todo[index % len(todo)]
        scenario = next(n for n in names
                        if target in scenario_pairs[n])
    else:
        scenario = names[index % len(names)]
    pool = scenario_pairs[scenario]
    tokens = []
    if target is not None:
        tokens.append(rule_token(target[0], target[1], rng,
                                 eager=True))
    for _ in range(rng.randrange(1, 3)):
        site, action = pool[rng.randrange(len(pool))]
        tokens.append(rule_token(site, action, rng, eager=False))
    spec = f"seed={rng.randrange(1 << 16)};" + ";".join(tokens)
    return EpisodeSpec(scenario=scenario, spec=spec, index=index)


def sweep_episode(index: int, scenario: str,
                  pair: tuple[str, str]) -> EpisodeSpec:
    """Deterministic single-rule episode for a pair the seeded phase
    never fired: `site:action@1` must fire on the first probe, or the
    pair is genuinely unreachable and the campaign fails coverage."""
    site, action = pair
    param = "=0.002" if action == "delay" else ""
    return EpisodeSpec(scenario=scenario,
                       spec=f"{site}:{action}{param}@1",
                       index=index, sweep=True)


# ------------------------------------------------------------ shrinking


def _plan_tokens(spec: str) -> tuple[int, list[str]]:
    plan = faults.FaultPlan.from_spec(spec)
    return plan.seed, [r.token() for r in plan.rules]


def _mk_spec(seed: int, tokens: list[str]) -> str:
    head = [f"seed={seed}"] if seed else []
    return ";".join(head + tokens)


def _simpler_selectors(token: str) -> list[str]:
    """Candidate simplifications of one rule token, simplest first."""
    base = token.split("@")[0]
    out = [f"{base}@1"]
    if "@" in token:
        out.append(base)  # no selector == fire from call 1 onward
    return [t for t in out if t != token]


def shrink(spec: str, failing) -> str:
    """Delta-debug `spec` against the `failing(spec) -> bool`
    predicate: greedily drop rules to a fixpoint, then simplify each
    survivor's selector, re-validating every step — the result is the
    minimal spec that still reproduces the failure."""
    seed, tokens = _plan_tokens(spec)
    # phase 1: rule removal to fixpoint
    changed = True
    while changed and len(tokens) > 1:
        changed = False
        for i in range(len(tokens)):
            cand = tokens[:i] + tokens[i + 1:]
            if failing(_mk_spec(seed, cand)):
                tokens = cand
                changed = True
                break
    # phase 2: selector simplification, one rule at a time
    for i, tok in enumerate(list(tokens)):
        for simpler in _simpler_selectors(tok):
            cand = tokens[:i] + [simpler] + tokens[i + 1:]
            if failing(_mk_spec(seed, cand)):
                tokens = cand
                break
    # a spec whose rules have no @pF selector no longer needs its seed
    final_seed = seed if any("@p" in t for t in tokens) else 0
    return _mk_spec(final_seed, tokens)
