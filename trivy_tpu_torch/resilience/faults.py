"""Deterministic, config-driven fault injector for the scan spine.

A fault plan is a list of rules compiled from a compact spec string —
either installed programmatically (tests) or read from the
`TRIVY_TPU_FAULTS` environment variable (operators / CI fault matrices).
Instrumented call sites ask `fire(site)` which rules apply to the current
call; the injector itself never touches the network or the device, it
only tells the call site what to simulate.

Spec grammar (rules joined by ";" or ","):

    rule     := site ":" action [ "=" param ] [ "@" selector ]
    site     := "rpc" | "rpc.scan" | "rpc.cache" | "rpc.cache.PutBlob"
                | "rpc.wire" | "sched.submit" | "engine" | "engine.device"
                | "engine.shard" | "engine.host" | "secret.device"
                | "journal.append" | "cache.write" | "db.save"
                | "compile_cache.save" | "report.write" | "fleet.scan"
                | "monitor.index" | "monitor.rematch"
                | "fleet.endpoint.N" | "fleet.rollout" | "fleet.controller"
                | ...  (dotted, prefix-matched)
    action   := "drop" | "timeout" | "delay" | "error" | "corrupt"
                | "device-lost" | "kill" | "torn-write" | "bitflip"
    selector := N        fire on the Nth matching call only (1-based)
              | N "+"    fire on the Nth and every later call
              | N "-" M  fire on calls N..M inclusive
              | "p" F    fire with probability F (seeded, deterministic)
              | (none)   fire on every matching call
    seed     := "seed=" INT   (plan-wide RNG seed for "p" selectors;
                               defaults to TRIVY_TPU_FAULT_SEED, then 0)

Examples:

    TRIVY_TPU_FAULTS="rpc.scan:drop"             # remote scans never land
    TRIVY_TPU_FAULTS="rpc:error=503@1-2"         # first two RPCs get a 503
    TRIVY_TPU_FAULTS="rpc.scan:delay=0.2@3+"     # slow from the 3rd scan on
    TRIVY_TPU_FAULTS="seed=7;rpc:drop@p0.3"      # 30% drop, deterministic
    TRIVY_TPU_FAULTS="sched.submit:error@1"      # first submission sheds
    TRIVY_TPU_FAULTS="engine:device-lost@1"      # the card dies on batch 1
    TRIVY_TPU_FAULTS="monitor.index:kill@5"      # SIGKILL on the 5th append
    TRIVY_TPU_FAULTS="fleet.endpoint.0:drop"     # replica 0 never answers
    TRIVY_TPU_FAULTS="fleet.scan:kill@2"         # SIGKILL on 2nd artifact
    TRIVY_TPU_FAULTS="cache.write:bitflip"       # every cache entry rots

Each rule keeps its own call counter, so selectors are deterministic per
rule regardless of how many rules share a site.

Durability fault kinds:

- ``kill``       the process dies (SIGKILL) when the rule fires: crash-
                 point testing for the append-log and atomic-write
                 paths. Tests may flip to raise-mode
                 (`set_kill_mode("raise")`) so the "death" is an
                 in-process `InjectedKill` that unwinds without running
                 recovery code.
- ``torn-write`` the payload handed to `mangle_write` is truncated
                 (param = fraction kept, default 0.5): a torn disk write.
- ``bitflip``    one bit of the payload is flipped (param = byte index,
                 default middle): silent corruption a checksum must
                 catch.

Copy of trivy_tpu/resilience/faults.py with the reference's every
site: the RPC client's (`rpc`, `rpc.scan`, `rpc.cache.*`, `rpc.wire`),
the match scheduler's (`sched.submit`), the match engine's device-loss
ladders (`engine`, `engine.device`, `engine.shard`, and the distributed
MeshDB's per-host `engine.host`), the secret scanner's
(`secret.device`), the layer pipeline's (`analysis.fetch`,
`analysis.lane`), the fleet scan's (`fleet.scan`, between artifacts),
`db download`'s (`db.download`, `db.install.extract`,
`db.install.promote`), the durable writes (`journal.append`,
`monitor.index`, `monitor.rematch`, `db.save`, `db.save.metadata`,
`cache.write`, `compile_cache.save`, `report.write`; an atomic write
also probes `<site>.commit` for a kill between the tmp write and the
rename), and the fleet control plane's (`fleet.endpoint.<index>` for
each replica of an endpoint set, `fleet.rollout`, `fleet.controller`).
One departure: a rule naming a site the reference does not fire, or an
action its site does not handle (`db.save:drop`, `fleet.scan:error`),
is refused with a FaultSpecError when the plan compiles, where the
reference accepts it and then leaves it to do nothing. Every firing
counts in `trivy_tpu_fault_injections_total`. `Rule.token` and
`FaultPlan.to_spec` turn a compiled plan back into its spec, which the
chaos campaign's shrinker (`chaos/schedule.py`) relies on.
"""

from __future__ import annotations

import os
import random
import re
from dataclasses import dataclass, field

from trivy_tpu_torch.analysis.witness import make_lock

ENV_VAR = "TRIVY_TPU_FAULTS"
SEED_ENV_VAR = "TRIVY_TPU_FAULT_SEED"

# the site grammar as structured data: each entry is (site, the actions
# its call site handles). Sites are prefix-matched at fire() time, so
# "rpc" covers every rpc.* child; the atomic-write sites (cache.write,
# db.save, ...) also fire a ``kill`` probe at "<site>.commit" between
# the tmp write and the rename.
SITES: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("rpc", ("drop", "timeout", "delay", "error", "corrupt")),
    ("rpc.scan", ("drop", "timeout", "delay", "error", "corrupt")),
    ("rpc.cache", ("drop", "timeout", "delay", "error", "corrupt")),
    ("rpc.wire", ("drop", "delay", "error", "corrupt")),
    ("engine", ("device-lost",)),
    ("engine.device", ("drop", "delay", "device-lost")),
    ("engine.shard", ("drop", "delay", "error", "device-lost")),
    ("engine.host", ("drop", "delay", "error", "device-lost")),
    ("sched.submit", ("drop", "delay", "error")),
    ("analysis.fetch", ("drop", "delay", "error", "kill")),
    ("analysis.lane", ("drop", "delay", "error", "kill")),
    ("secret.device", ("drop", "delay", "error", "device-lost")),
    ("journal.append", ("kill", "torn-write", "bitflip")),
    ("monitor.index", ("drop", "error", "kill", "torn-write", "bitflip")),
    ("monitor.rematch", ("drop", "delay", "error", "kill")),
    ("db.download", ("torn-write", "bitflip")),
    ("db.install.extract", ("kill",)),
    ("db.install.promote", ("kill",)),
    ("fleet.endpoint", ("drop", "timeout", "delay", "error")),
    ("fleet.rollout", ("delay", "error", "kill")),
    ("fleet.controller", ("drop", "delay", "error", "kill")),
    ("fleet.scan", ("kill",)),
    ("db.save", ("kill", "torn-write", "bitflip")),
    ("db.save.metadata", ("kill", "torn-write", "bitflip")),
    ("cache.write", ("kill", "torn-write", "bitflip")),
    ("compile_cache.save", ("kill", "torn-write", "bitflip")),
    ("report.write", ("kill", "torn-write", "bitflip")),
)

ACTIONS = {a for _site, acts in SITES for a in acts}

# the families whose call sites fire children of their own: rpc_site
# names each RPC's path (rpc.cache.PutBlob, rpc.Version), the fleet's
# endpoint set each replica's index (fleet.endpoint.0)
OPEN_SITES = ("rpc", "fleet.endpoint")


def site_actions(site: str) -> set[str] | None:
    """The actions a rule naming `site` may use: those of the site it
    names, or of the most specific RPC site it extends
    (``rpc.cache.PutBlob`` extends ``rpc.cache``), or of every site it
    prefixes (``sched`` prefixes ``sched.submit``, ``engine`` also
    ``engine.device``, ``engine.shard`` and ``engine.host``); ``kill``
    alone at an atomic write's ``<site>.commit`` probe. None when it
    reaches no site the package fires (``cache.read``)."""
    acts = dict(SITES)
    under = [name for name in acts
             if site == name or (site.startswith(name + ".")
                                 and name.startswith(OPEN_SITES))]
    if under:
        return set(acts[max(under, key=len)])
    parent, _, leaf = site.rpartition(".")
    if leaf == "commit" and "torn-write" in acts.get(parent, ()):
        return {"kill"}
    above = [a for name, a in SITES if name.startswith(site + ".")]
    if above:
        return set().union(*above)
    return None


class FaultError(Exception):
    """Base class for injected faults."""


class DeviceLost(FaultError):
    """Injected accelerator loss (site ``engine``)."""


class InjectedKill(BaseException):
    """Raise-mode stand-in for SIGKILL (site-level ``kill`` fault).

    Deliberately a BaseException: a crash does not run `except
    Exception` cleanup handlers, and neither should its simulation:
    state on disk must be exactly what a real kill would leave."""


class InjectedHTTPError(FaultError):
    """Injected HTTP error response (site ``rpc*``, action ``error``)."""

    def __init__(self, code: int):
        super().__init__(f"injected HTTP {code}")
        self.code = code


class FaultSpecError(ValueError):
    """The fault spec string does not parse."""


_RULE_RX = re.compile(
    r"(?P<site>[A-Za-z0-9_.]+):(?P<action>[a-z-]+)"
    r"(?:=(?P<param>[0-9.]+))?"
    r"(?:@(?P<sel>[0-9p.+-]+))?$"
)


@dataclass
class Rule:
    site: str
    action: str
    param: float | None = None
    start: int = 1
    stop: int | None = None  # inclusive; None = open-ended
    prob: float | None = None
    calls: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def fires(self, n: int, rng: random.Random) -> bool:
        if self.prob is not None:
            return rng.random() < self.prob
        if n < self.start:
            return False
        return self.stop is None or n <= self.stop

    def matches(self, site: str) -> bool:
        return site == self.site or site.startswith(self.site + ".")

    def token(self) -> str:
        """The rule back as a spec token: `from_spec(token())` rebuilds
        an equal rule, so shrunk schedules paste straight into
        TRIVY_TPU_FAULTS."""
        out = f"{self.site}:{self.action}"
        if self.param is not None:
            p = self.param
            out += f"={int(p)}" if p == int(p) else f"={p}"
        if self.prob is not None:
            out += f"@p{self.prob}"
        elif self.start == self.stop:
            out += f"@{self.start}"
        elif self.stop is not None:
            out += f"@{self.start}-{self.stop}"
        elif self.start != 1:
            out += f"@{self.start}+"
        return out


def _parse_selector(sel: str | None) -> tuple[int, int | None, float | None]:
    """-> (start, stop, prob)."""
    if sel is None:
        return 1, None, None
    if sel.startswith("p"):
        try:
            prob = float(sel[1:])
        except ValueError:
            raise FaultSpecError(f"bad probability selector {sel!r}")
        if not 0.0 <= prob <= 1.0:
            raise FaultSpecError(f"probability out of [0,1]: {sel!r}")
        return 1, None, prob
    if sel.endswith("+"):
        return int(sel[:-1]), None, None
    if "-" in sel:
        lo, _, hi = sel.partition("-")
        start, stop = int(lo), int(hi)
        if stop < start:
            raise FaultSpecError(f"empty selector range {sel!r}")
        return start, stop, None
    n = int(sel)
    return n, n, None


class FaultPlan:
    """A compiled fault spec; thread-safe (call counters live under one
    lock so concurrent RPC workers see a consistent ordinal per rule)."""

    def __init__(self, rules: list[Rule], seed: int = 0):
        self.rules = list(rules)
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = make_lock("resilience.faults._lock")

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Compile a spec string.  When the spec carries no `seed=` token,
        the plan-wide RNG seed for `@pF` selectors falls back to
        TRIVY_TPU_FAULT_SEED (default 0), so probabilistic specs replay
        deterministically without editing the spec itself."""
        rules: list[Rule] = []
        try:
            seed = int(os.environ.get(SEED_ENV_VAR, "0"))
        except ValueError:
            raise FaultSpecError(
                f"bad {SEED_ENV_VAR}={os.environ.get(SEED_ENV_VAR)!r}")
        for tok in re.split(r"[;,]", spec):
            tok = tok.strip()
            if not tok:
                continue
            if tok.startswith("seed="):
                try:
                    seed = int(tok[5:])
                except ValueError:
                    raise FaultSpecError(f"bad seed {tok!r}")
                continue
            m = _RULE_RX.match(tok)
            if not m:
                raise FaultSpecError(f"bad fault rule {tok!r}")
            action = m.group("action")
            site = m.group("site")
            acts = site_actions(site)
            if acts is None:
                raise FaultSpecError(
                    f"fault site {site!r} in {tok!r} is fired nowhere "
                    f"(sites: {', '.join(n for n, _a in SITES)})")
            if action not in acts:
                raise FaultSpecError(
                    f"fault action {action!r} is not handled at site "
                    f"{site!r} (valid: {', '.join(sorted(acts))})")
            try:
                start, stop, prob = _parse_selector(m.group("sel"))
            except ValueError as exc:
                raise FaultSpecError(f"bad selector in {tok!r}: {exc}")
            param = m.group("param")
            rules.append(Rule(
                site=site, action=action,
                param=float(param) if param is not None else None,
                start=start, stop=stop, prob=prob,
            ))
        return cls(rules, seed=seed)

    def to_spec(self) -> str:
        """Round-trip back to a TRIVY_TPU_FAULTS string (seed token first
        so a pasted repro replays the same `@pF` draws)."""
        toks = [f"seed={self.seed}"] if self.seed else []
        toks += [r.token() for r in self.rules]
        return ";".join(toks)

    def fire(self, site: str) -> list[Rule]:
        """Which rules apply to this call at `site`? Increments the call
        counter of every matching rule, firing or not. Every firing is
        counted in trivy_tpu_fault_injections_total{site,action} so a
        fault-matrix run's metrics show exactly what was injected."""
        out: list[Rule] = []
        with self._lock:
            for r in self.rules:
                if r.matches(site):
                    r.calls += 1
                    if r.fires(r.calls, self._rng):
                        r.fired += 1
                        out.append(r)
        if out:
            from trivy_tpu_torch.obs import metrics as obs_metrics

            for r in out:
                obs_metrics.FAULT_FIRES.inc(site=r.site, action=r.action)
        return out


# ------------------------------------------------------------ module state

_installed: FaultPlan | None = None
_env_cache: tuple[str, FaultPlan] | None = None
_kill_mode = "sigkill"  # "sigkill" (real death) | "raise" (InjectedKill)


def install(plan: FaultPlan) -> FaultPlan:
    """Activate a plan for the whole process (tests)."""
    global _installed
    _installed = plan
    return plan


def install_spec(spec: str) -> FaultPlan:
    return install(FaultPlan.from_spec(spec))


def reset() -> None:
    global _installed, _env_cache, _kill_mode
    _installed = None
    _env_cache = None
    _kill_mode = "sigkill"


def set_kill_mode(mode: str) -> None:
    """"sigkill" (default): a firing ``kill`` rule really SIGKILLs the
    process, for subprocess crash tests. "raise": it raises InjectedKill
    instead, so in-process tests can crash a write path at an exact
    point and then assert on the surviving on-disk state."""
    if mode not in ("sigkill", "raise"):
        raise ValueError(f"unknown kill mode {mode!r}")
    global _kill_mode
    _kill_mode = mode


def active() -> FaultPlan | None:
    """The installed plan, else one compiled from TRIVY_TPU_FAULTS."""
    if _installed is not None:
        return _installed
    spec = os.environ.get(ENV_VAR, "")
    if not spec:
        return None
    global _env_cache
    if _env_cache is None or _env_cache[0] != spec:
        _env_cache = (spec, FaultPlan.from_spec(spec))
    return _env_cache[1]


def fire(site: str) -> list[Rule]:
    plan = active()
    return plan.fire(site) if plan is not None else []


def validate_env() -> None:
    """Compile the TRIVY_TPU_FAULTS spec now so an operator typo fails
    at process startup with a clean FaultSpecError naming the bad rule,
    not mid-scan at the first instrumented call site."""
    spec = os.environ.get(ENV_VAR, "")
    if spec:
        FaultPlan.from_spec(spec)


# ------------------------------------------------------------ site helpers

def rpc_site(path: str) -> str:
    """Map an RPC URL path onto a dotted fault site."""
    tail = path.rsplit("/", 1)[-1]
    if "/trivy.cache." in path:
        return f"rpc.cache.{tail}"
    if tail == "Scan":
        return "rpc.scan"
    return f"rpc.{tail}"


def check_device(site: str = "engine") -> None:
    """Raise DeviceLost when a device-lost rule fires for `site`."""
    for r in fire(site):
        if r.action == "device-lost":
            raise DeviceLost(f"injected device loss at {site}")


def corrupt_bytes(raw: bytes) -> bytes:
    """Deterministically mangle a response body so decoding fails."""
    return b"\xff\x00corrupted\x00" + raw[: len(raw) // 2]


def check_kill(site: str, rules: list[Rule] | None = None) -> None:
    """Die (or raise InjectedKill in raise-mode) when a ``kill`` rule
    fires for `site`: the crash-point hook of the durability layer.
    Pass pre-fired `rules` to share one probe (one ordinal increment)
    with a mangle_write at the same site."""
    for r in (fire(site) if rules is None else rules):
        if r.action != "kill":
            continue
        if _kill_mode == "raise":
            raise InjectedKill(f"injected kill at {site}")
        import signal

        os.kill(os.getpid(), signal.SIGKILL)


def mangle_write(site: str, data: bytes,
                 rules: list[Rule] | None = None) -> bytes:
    """Apply firing ``torn-write`` / ``bitflip`` rules to a payload
    about to hit disk. Deterministic: torn-write keeps the first `param`
    fraction (default 0.5); bitflip flips bit 0 of the byte at `param`
    (default the middle byte)."""
    for r in (fire(site) if rules is None else rules):
        if r.action == "torn-write":
            keep = 0.5 if r.param is None else min(max(r.param, 0.0), 1.0)
            data = data[: int(len(data) * keep)]
        elif r.action == "bitflip" and data:
            idx = (len(data) // 2 if r.param is None
                   else int(r.param) % len(data))
            data = data[:idx] + bytes([data[idx] ^ 0x01]) + data[idx + 1:]
    return data
