"""Port parity, the self-driving fleet controller: trivy_tpu_torch's
fleet/controller.py (policy, the intent / applied action journal,
reconcile, dry run, the fleet.controller fault site, the local and HTTP
actuators) and `fleet control`, against the JAX package's.

Every shape of tests/test_controller.py runs in both packages over the
same scripted fleet; what each run observes (the tick reports, the
actuator's calls, the controller action journal, the controller_action
events) must be equal, times masked. The crash-safety shape SIGKILLs a
port controller in a subprocess and replays its journal, and the
reference's controller replays the same journal to the same state.
`fleet control` runs against a port replica and a reference replica and
journals the same decisions. A `mesh_reresolve` against a port replica
whose re-resolve meets a device error is a failed action that stays
pending (the port answers 500).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
from test_torch_fleet import PKGS, PORT, REF, close_pools, engine_of, mask
from test_torch_fleet import mk_db, same
from test_torch_fleet import _one_thread  # noqa: F401 — fixture


@pytest.fixture(autouse=True)
def _clean_state():
    for P in PKGS:
        P.faults.reset()
        P.slo.reset_bus()
    yield
    for P in PKGS:
        P.faults.reset()
        P.slo.reset_bus()
    close_pools()


class FakeActuator:
    """A scripted fleet: membership, health, mesh and probe latency
    are plain dicts the test mutates; every act is recorded."""

    def __init__(self, urls=("http://r0",), load=0.0):
        self._urls = list(urls)
        self.load = load
        self.ready = {u: True for u in urls}
        self.mesh: dict = {}
        self.probe = {u: 0.01 for u in urls}
        self.hedge = None
        self.calls: list = []
        self._n = 0

    @property
    def urls(self):
        return list(self._urls)

    def observe(self):
        statuses = [{"endpoint": u,
                     "ready": bool(self.ready.get(u)),
                     "generation": "g1",
                     "mesh": self.mesh.get(u),
                     "probe_s": self.probe.get(u, 0.01)}
                    for u in self._urls]
        return {"statuses": statuses,
                "offered_load": (float(self.load)
                                 if self.load is not None else None),
                "replicas": list(self._urls)}

    def spawn_replica(self):
        self._n += 1
        u = f"http://new{self._n}"
        self._urls.append(u)
        self.ready[u] = True
        self.probe[u] = 0.01
        self.calls.append(("spawn", u))
        return u

    def drain_replica(self, url):
        self.calls.append(("drain", url))
        return True

    def retire_replica(self, url):
        self.calls.append(("retire", url))
        self._urls = [u for u in self._urls if u != url]

    def reresolve_mesh(self, url):
        self.calls.append(("reresolve", url))
        self.mesh[url] = {"degraded_hosts": []}
        return {"reresolved": True}

    def set_hedge_budget(self, budget):
        self.hedge = budget
        self.calls.append(("hedge", budget))
        return True


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def mk_controller(P, act, tmp_path=None, clock=None, dry_run=False,
                  **pol):
    defaults = dict(min_replicas=1, max_replicas=3, scale_up_load=4.0,
                    scale_down_load=1.0, scale_down_holds=2,
                    cooldown_s=0.0, unhealthy_ticks=2,
                    degraded_ticks=2, hedge_skew=1e9)
    defaults.update(pol)
    policy = P.ctrl.ControllerPolicy(**defaults)
    journal = str(tmp_path / "actions.jsonl") if tmp_path else None
    return P.ctrl.FleetController(act, policy=policy,
                                  journal_path=journal,
                                  dry_run=dry_run,
                                  clock=clock or FakeClock())


def acted(act, kind):
    return [c for c in act.calls if c[0] == kind]


def ptmp(tmp_path, P):
    d = tmp_path / P.name
    d.mkdir(parents=True, exist_ok=True)
    return d


def actions_events(P) -> list:
    _nxt, ring = P.slo.events_since(0)
    return mask([e for e in ring if e["kind"] == "controller_action"])


def journal(c) -> list:
    return mask(c.journal.records()) if c.journal is not None else None


# ============================================================= policy


class TestPolicy:
    def test_env_defaults_clamps_and_malformed(self, monkeypatch):
        monkeypatch.setenv("TRIVY_TPU_CONTROLLER_MIN_REPLICAS", "0")
        monkeypatch.setenv("TRIVY_TPU_CONTROLLER_MAX_REPLICAS",
                           "not-a-number")
        monkeypatch.setenv("TRIVY_TPU_CONTROLLER_HOLDS", "5")

        def run(P):
            p = P.ctrl.ControllerPolicy()
            assert p.min_replicas == 1
            assert p.max_replicas == 4
            assert p.scale_down_holds == 5
            p2 = P.ctrl.ControllerPolicy(min_replicas=3, max_replicas=2)
            assert p2.max_replicas >= p2.min_replicas
            return p.doc(), p2.doc()
        same(run)

    def test_scale_up_is_eager(self):
        def run(P):
            act = FakeActuator(load=9.0)
            c = mk_controller(P, act)
            report = c.tick()
            assert [a["action"] for a in report["actions"]] == ["scale_up"]
            assert len(act.urls) == 2
            c.tick()
            assert len(act.urls) == 3
            last = c.tick()
            assert len(act.urls) == 3
            return mask([report, last]), act.calls
        same(run)

    def test_below_floor_scales_up_at_zero_load(self):
        def run(P):
            act = FakeActuator(load=0.0)
            c = mk_controller(P, act, min_replicas=2)
            report = c.tick()
            assert [a["action"] for a in report["actions"]] == ["scale_up"]
            assert report["actions"][0]["reason"] == "below_min_replicas"
            assert len(act.urls) == 2
            c.tick()
            assert len(act.urls) == 2
            return mask(report), act.calls
        same(run)

    def test_scale_down_hysteresis_and_cost_floor(self):
        def run(P):
            act = FakeActuator(urls=("http://r0", "http://r1",
                                     "http://r2"), load=0.5)
            c = mk_controller(P, act)
            r1 = c.tick()
            assert r1["actions"] == []
            r2 = c.tick()
            assert [a["action"] for a in r2["actions"]] == ["scale_down"]
            assert len(act.urls) == 2
            c.tick()
            c.tick()
            assert len(act.urls) == 1
            for _ in range(4):
                c.tick()
            assert len(act.urls) == 1
            return mask([r1, r2]), act.calls
        same(run)

    def test_load_spike_resets_calm_streak(self):
        def run(P):
            act = FakeActuator(urls=("http://r0", "http://r1"), load=0.5)
            c = mk_controller(P, act, scale_down_holds=2)
            c.tick()
            act.load = 9.0
            c.tick()
            act.load = 0.5
            n = len(act.urls)
            c.tick()
            assert len(act.urls) == n
            return act.calls
        same(run)

    def test_cooldown_blocks_consecutive_scale_ups(self):
        def run(P):
            clock = FakeClock()
            act = FakeActuator(load=20.0)
            c = mk_controller(P, act, clock=clock, cooldown_s=60.0)
            c.tick()
            assert len(act.urls) == 2
            c.tick()
            assert len(act.urls) == 2
            clock.now += 61.0
            c.tick()
            assert len(act.urls) == 3
            return act.calls
        same(run)

    def test_drain_replace_needs_a_streak(self):
        def run(P):
            act = FakeActuator(urls=("http://r0", "http://r1"), load=2.0)
            c = mk_controller(P, act, unhealthy_ticks=2)
            act.ready["http://r1"] = False
            c.tick()
            assert acted(act, "retire") == []
            act.ready["http://r1"] = True
            c.tick()
            act.ready["http://r1"] = False
            c.tick()
            assert acted(act, "retire") == []
            report = c.tick()
            assert [a["action"] for a in report["actions"]] \
                == ["drain_replace"]
            assert acted(act, "drain") == [("drain", "http://r1")]
            assert acted(act, "retire") == [("retire", "http://r1")]
            assert len(acted(act, "spawn")) == 1
            assert len(act.urls) == 2
            return mask(report), act.calls
        same(run)

    def test_drain_replace_suppresses_autoscale_same_tick(self):
        def run(P):
            act = FakeActuator(urls=("http://r0", "http://r1"), load=50.0)
            c = mk_controller(P, act, unhealthy_ticks=1, max_replicas=5)
            act.ready["http://r1"] = False
            report = c.tick()
            kinds = [a["action"] for a in report["actions"]]
            assert kinds == ["drain_replace"]
            return mask(report)
        same(run)

    def test_mesh_reresolve_on_sustained_degradation(self):
        def run(P):
            act = FakeActuator(urls=("http://r0",), load=2.0)
            c = mk_controller(P, act, degraded_ticks=2)
            act.mesh["http://r0"] = {"degraded_hosts": [2]}
            c.tick()
            assert acted(act, "reresolve") == []
            report = c.tick()
            assert [a["action"] for a in report["actions"]] \
                == ["mesh_reresolve"]
            assert acted(act, "reresolve") == [("reresolve", "http://r0")]
            c.tick()
            assert len(acted(act, "reresolve")) == 1
            return mask(report), act.calls
        same(run)

    def test_hedge_tune_follows_skew_and_returns_to_baseline(self):
        def run(P):
            act = FakeActuator(urls=("http://r0", "http://r1",
                                     "http://r2", "http://r3"), load=8.0)
            c = mk_controller(P, act, hedge_skew=4.0)
            act.probe["http://r3"] = 0.5
            report = c.tick()
            assert [a["action"] for a in report["actions"]] \
                == ["hedge_tune"]
            assert act.hedge == c.policy.hedge_budget_hi
            act.probe["http://r3"] = 0.01
            report2 = c.tick()
            assert [a["action"] for a in report2["actions"]] \
                == ["hedge_tune"]
            assert act.hedge == c._hedge_baseline
            return mask([report, report2]), act.calls
        same(run)

    def test_kill_switch_observes_and_decides_nothing(self, monkeypatch):
        monkeypatch.setenv("TRIVY_TPU_CONTROLLER", "0")

        def run(P):
            act = FakeActuator(load=50.0)
            c = mk_controller(P, act)
            report = c.tick()
            assert report["enabled"] is False and act.calls == []
            return report
        same(run)

    def test_every_action_emits_a_controller_action_event(self):
        def run(P):
            act = FakeActuator(load=9.0)
            c = mk_controller(P, act)
            c.tick()
            events = actions_events(P)
            assert [e["action"] for e in events] == ["scale_up"]
            assert events[0]["outcome"] == "applied"
            return events
        same(run)

    def test_action_vocabulary_equals_the_reference(self):
        same(lambda P: P.ctrl.ACTIONS)


# ======================================================== load signal


class TestLoadSignal:
    def test_http_observe_sums_replica_inflight(self, monkeypatch):
        docs = {"http://r0": {"ready": True, "inflight": 2},
                "http://r1": {"ready": True, "inflight": 3}}

        def run(P):
            monkeypatch.setattr(P.ctrl, "readyz_doc",
                                lambda url, token=None: docs[url])
            a = P.ctrl.HttpFleetActuator(["http://r0", "http://r1"])
            obs = a.observe()
            assert obs["offered_load"] == 5.0
            assert all(s["ready"] for s in obs["statuses"])
            return mask(obs)
        same(run)

    def test_http_observe_without_signal_is_none_not_zero(
            self, monkeypatch):
        def run(P):
            monkeypatch.setattr(P.ctrl, "readyz_doc",
                                lambda url, token=None: {"ready": True})
            a = P.ctrl.HttpFleetActuator(["http://r0", "http://r1"])
            first = a.observe()["offered_load"]
            monkeypatch.setattr(P.ctrl, "readyz_doc",
                                lambda url, token=None: None)
            second = a.observe()["offered_load"]
            assert first is None and second is None
            return first, second
        same(run)

    def test_http_load_cmd_wins_and_fails_to_none(self, monkeypatch):
        def run(P):
            monkeypatch.setattr(
                P.ctrl, "readyz_doc",
                lambda url, token=None: {"ready": True, "inflight": 9})
            a = P.ctrl.HttpFleetActuator(["http://r0"],
                                         load_cmd="echo 7.5")
            bad = P.ctrl.HttpFleetActuator(["http://r0"],
                                           load_cmd="exit 3")
            got = (a.observe()["offered_load"],
                   bad.observe()["offered_load"])
            assert got == (7.5, None)
            return got
        same(run)

    def test_no_load_signal_never_scales_down_a_healthy_fleet(self):
        def run(P):
            act = FakeActuator(urls=("http://r0", "http://r1",
                                     "http://r2"), load=None)
            c = mk_controller(P, act)
            for _ in range(8):
                report = c.tick()
                assert report["actions"] == []
            assert len(act.urls) == 3 and act.calls == []
            return mask(report)
        same(run)

    def test_no_load_signal_still_restores_the_floor(self):
        def run(P):
            act = FakeActuator(load=None)
            c = mk_controller(P, act, min_replicas=2)
            report = c.tick()
            assert [a["action"] for a in report["actions"]] == ["scale_up"]
            assert report["actions"][0]["reason"] == "below_min_replicas"
            assert len(act.urls) == 2
            return mask(report)
        same(run)

    def test_local_actuator_without_load_fn_reports_none(self):
        def run(P):
            a = P.ctrl.LocalFleetActuator(lambda: None)
            assert a.observe()["offered_load"] is None
            return a.observe()
        same(run)


# =========================================================== actuators


class _FakeServer:
    def __init__(self, url):
        self.address = url

    def drain(self, timeout_s):
        pass

    def shutdown(self):
        pass


class TestActuatorHardening:
    @pytest.mark.parametrize("error", ["timeout", "oserror"])
    def test_spawn_failure_is_an_actuator_error(self, monkeypatch, error):
        def run(P):
            def boom(*a, **k):
                if error == "timeout":
                    raise subprocess.TimeoutExpired(cmd="spawn",
                                                    timeout=300.0)
                raise OSError("exec failed")
            monkeypatch.setattr(P.ctrl.subprocess, "run", boom)
            a = P.ctrl.HttpFleetActuator(["http://r0"], spawn_cmd="spawn")
            with pytest.raises(P.ctrl.ActuatorError) as exc:
                a.spawn_replica()
            return str(exc.value)
        same(run)

    def test_retiring_the_last_replica_clears_the_endpoint_set(self):
        def run(P):
            es = P.endpoints.EndpointSet(["http://127.0.0.1:1"], hedge_s=0,
                                         health_interval_s=0)
            try:
                a = P.ctrl.LocalFleetActuator(
                    lambda: _FakeServer("http://127.0.0.1:2"),
                    endpoint_set=es)
                a.adopt(_FakeServer("http://127.0.0.1:1"))
                a.retire_replica("http://127.0.0.1:1")
                assert es._live() == []
                return es.urls, a.urls
            finally:
                es.close()
        same(run)

    def test_http_actuator_spawn_reads_the_last_stdout_line(self):
        """The operator's spawn command names the new replica on its
        last stdout line, in both packages alike."""
        def run(P):
            a = P.ctrl.HttpFleetActuator(
                ["http://r0"],
                spawn_cmd="echo starting; echo http://127.0.0.1:5/")
            url = a.spawn_replica()
            assert url == "http://127.0.0.1:5"
            return url, a.urls
        same(run)


# ====================================================== action journal


class TestActionJournal:
    def test_intent_applied_pending_roundtrip(self, tmp_path):
        def run(P):
            path = str(ptmp(tmp_path, P) / "a.jsonl")
            j = P.ctrl.ActionJournal.open(path)
            a1 = j.intent("scale_up", want=2)
            a2 = j.intent("scale_down", want=1, target="http://r1")
            j.applied(a1, "applied", spawned="http://new1")
            assert [r["id"] for r in j.pending()] == [a2]
            j.close()
            j2 = P.ctrl.ActionJournal.open(path)
            assert [r["id"] for r in j2.pending()] == [a2]
            a3 = j2.intent("scale_up", want=3)
            assert a3 > a2
            recs = mask(j2.records())
            j2.close()
            with open(path, encoding="utf-8") as f:
                header = json.loads(f.readline())
            return recs, header
        same(run)

    def test_open_rejects_a_foreign_log(self, tmp_path):
        def run(P):
            path = str(ptmp(tmp_path, P) / "ev.jsonl")
            P.slo.install_journal(path)
            P.slo.uninstall_journal()
            with pytest.raises(P.appendlog.AppendLogError) as exc:
                P.ctrl.ActionJournal.open(path)
            return str(exc.value).replace(path, "PATH")
        same(run)

    def test_open_salvages_a_torn_header(self, tmp_path):
        def run(P):
            path = str(ptmp(tmp_path, P) / "a.jsonl")
            j = P.ctrl.ActionJournal.open(path)
            a1 = j.intent("scale_up", want=2)
            j.applied(a1, "applied", spawned="http://new1")
            a2 = j.intent("scale_down", want=1)
            j.close()
            with open(path, "rb") as fh:
                lines = fh.read().split(b"\n")
            lines[0] = lines[0][: len(lines[0]) // 2]
            with open(path, "wb") as fh:
                fh.write(b"\n".join(lines))
            j2 = P.ctrl.ActionJournal.open(path)
            assert [r["id"] for r in j2.pending()] == [a2]
            assert j2.intent("scale_up", want=3) > a2
            j2.close()
            j3 = P.ctrl.ActionJournal.open(path)
            assert [r["id"] for r in j3.pending()] == [a2, a2 + 1]
            recs = mask(j3.records())
            j3.close()
            return recs
        same(run)

    def test_compact_keeps_pending_intents(self, tmp_path):
        def run(P):
            path = str(ptmp(tmp_path, P) / "a.jsonl")
            j = P.ctrl.ActionJournal.open(path)
            stale = j.intent("scale_up", want=2)
            for _ in range(20):
                aid = j.intent("hedge_tune", budget=0.1)
                j.applied(aid, "applied")
            j.compact(keep_last=4)
            assert [r["id"] for r in j.pending()] == [stale]
            j.close()
            j2 = P.ctrl.ActionJournal.open(path)
            assert [r["id"] for r in j2.pending()] == [stale]
            recs = mask(j2.records())
            j2.close()
            return recs
        same(run)


class TestReplay:
    def test_reconcile_seals_an_already_holding_intent(self, tmp_path):
        def run(P):
            d = ptmp(tmp_path, P)
            j = P.ctrl.ActionJournal.open(str(d / "actions.jsonl"))
            j.intent("scale_up", want=2)
            j.close()
            act = FakeActuator(urls=("http://r0", "http://r1"), load=2.0)
            c = mk_controller(P, act, tmp_path=d)
            report = c.tick()
            assert [r["outcome"] for r in report["reconciled"]] \
                == ["reconciled"]
            assert acted(act, "spawn") == []
            assert c.journal.pending() == []
            out = mask(report), journal(c)
            c.close()
            return out
        same(run)

    def test_reconcile_refires_once_under_the_same_id(self, tmp_path):
        def run(P):
            d = ptmp(tmp_path, P)
            j = P.ctrl.ActionJournal.open(str(d / "actions.jsonl"))
            aid = j.intent("scale_up", want=2)
            j.close()
            act = FakeActuator(load=0.5)
            c = mk_controller(P, act, tmp_path=d)
            c.tick()
            assert len(acted(act, "spawn")) == 1
            intents = [r for r in c.journal.records()
                       if r.get("phase") == "intent"]
            assert len(intents) == 1 and intents[0]["id"] == aid
            assert c.journal.pending() == []
            out = journal(c), act.calls
            c.close()
            return out
        same(run)

    def test_stale_intent_is_sealed_not_refired(self, tmp_path):
        def run(P):
            d = ptmp(tmp_path, P)
            j = P.ctrl.ActionJournal.open(str(d / "actions.jsonl"))
            j.intent("drain_replace")
            j.close()
            act = FakeActuator(load=2.0)
            c = mk_controller(P, act, tmp_path=d)
            c.tick()
            assert act.calls == [] and c.journal.pending() == []
            out = journal(c)
            c.close()
            return out
        same(run)

    def test_dry_run_changes_nothing_but_the_journal(self, tmp_path):
        def run(P):
            d = ptmp(tmp_path, P)
            act = FakeActuator(load=9.0)
            c = mk_controller(P, act, tmp_path=d, dry_run=True)
            for _ in range(3):
                report = c.tick()
            assert act.calls == [] and len(act.urls) == 1
            assert all(a["outcome"] == "dry_run"
                       for a in report["actions"])
            recs = c.journal.records()
            assert any(r.get("outcome") == "dry_run" for r in recs)
            assert c.journal.pending() == []
            events = actions_events(P)
            assert events and all(e["outcome"] == "dry_run"
                                  for e in events)
            out = mask(report), journal(c), events
            c.close()
            return out
        same(run)


# ========================================= fault site: observe only


class TestControllerFaultSite:
    def test_site_registered(self):
        def run(P):
            sites = dict(P.faults.SITES)
            assert sites["fleet.controller"] == ("drop", "delay", "error",
                                                 "kill")
            return sites["fleet.controller"], sites["fleet.rollout"], \
                sites["fleet.endpoint"]
        same(run)

    def test_drop_skips_the_act_and_journals_it(self, tmp_path):
        def run(P):
            P.faults.install_spec("fleet.controller:drop")
            act = FakeActuator(load=9.0)
            c = mk_controller(P, act, tmp_path=ptmp(tmp_path, P))
            report = c.tick()
            assert act.calls == []
            assert [a["outcome"] for a in report["actions"]] \
                == ["dropped"]
            assert c.journal.pending() == []
            out = mask(report), journal(c)
            c.close()
            return out
        same(run)

    def test_delay_stalls_but_still_applies(self, tmp_path):
        def run(P):
            P.faults.install_spec("fleet.controller:delay=0.01")
            act = FakeActuator(load=9.0)
            c = mk_controller(P, act, tmp_path=ptmp(tmp_path, P))
            report = c.tick()
            assert [a["outcome"] for a in report["actions"]] \
                == ["applied"]
            assert len(acted(act, "spawn")) == 1
            out = mask(report), journal(c)
            c.close()
            return out
        same(run)

    def test_error_aborts_then_reconciles_not_twice(self, tmp_path):
        def run(P):
            P.faults.install_spec("fleet.controller:error@1")
            act = FakeActuator(load=9.0)
            c = mk_controller(P, act, tmp_path=ptmp(tmp_path, P))
            report = c.tick()
            assert [a["outcome"] for a in report["actions"]] == ["failed"]
            assert act.calls == [] and len(c.journal.pending()) == 1
            P.faults.reset()
            report2 = c.tick()
            assert len(acted(act, "spawn")) == 1
            assert c.journal.pending() == [] and report2["actions"] == []
            intents = [r for r in c.journal.records()
                       if r.get("phase") == "intent"]
            assert len(intents) == 1
            out = mask([report, report2]), journal(c)
            c.close()
            return out
        same(run)

    def test_persistent_error_degrades_to_observe_only(self, tmp_path):
        def run(P):
            P.faults.install_spec("fleet.controller:error")
            act = FakeActuator(load=9.0)
            c = mk_controller(P, act, tmp_path=ptmp(tmp_path, P))
            for _ in range(4):
                c.tick()
            assert act.calls == []
            intents = [r for r in c.journal.records()
                       if r.get("phase") == "intent"]
            assert len(intents) == 1 and len(c.journal.pending()) == 1
            out = journal(c)
            c.close()
            return out
        same(run)

    def test_kill_crashes_with_the_intent_durable(self, tmp_path):
        def run(P):
            d = ptmp(tmp_path, P)
            P.faults.set_kill_mode("raise")
            P.faults.install_spec("fleet.controller:kill@1")
            act = FakeActuator(load=9.0)
            c = mk_controller(P, act, tmp_path=d)
            with pytest.raises(P.faults.InjectedKill):
                c.tick()
            assert act.calls == []
            c.journal.close()
            P.faults.reset()
            act.load = 2.0
            c2 = mk_controller(P, act, tmp_path=d)
            c2.tick()
            assert len(acted(act, "spawn")) == 1
            assert c2.journal.pending() == []
            intents = [r for r in c2.journal.records()
                       if r.get("phase") == "intent"
                       and r.get("action") == "scale_up"]
            assert len(intents) == 1
            out = journal(c2), act.calls
            c2.close()
            return out
        same(run)


# ==================================== crash safety (process boundary)


CRASH_CHILD = r"""
import importlib, json, os, sys

ctrl = importlib.import_module(sys.argv[4] + ".fleet.controller")
state_path, journal_path, ticks = sys.argv[1], sys.argv[2], int(sys.argv[3])


class FileActuator:
    def __init__(self, path):
        self.path = path
        if not os.path.exists(path):
            self._write({"replicas": ["r0"], "spawns": 0})

    def _read(self):
        with open(self.path, encoding="utf-8") as f:
            return json.load(f)

    def _write(self, doc):
        with open(self.path, "w", encoding="utf-8") as f:
            json.dump(doc, f)

    @property
    def urls(self):
        return list(self._read()["replicas"])

    def observe(self):
        doc = self._read()
        return {"statuses": [{"endpoint": u, "ready": True,
                              "generation": "g", "mesh": None,
                              "probe_s": 0.01}
                             for u in doc["replicas"]],
                "offered_load": 9.0,
                "replicas": list(doc["replicas"])}

    def spawn_replica(self):
        doc = self._read()
        doc["spawns"] += 1
        url = "r%d" % doc["spawns"]
        doc["replicas"].append(url)
        self._write(doc)
        return url

    def drain_replica(self, url):
        return True

    def retire_replica(self, url):
        doc = self._read()
        doc["replicas"] = [u for u in doc["replicas"] if u != url]
        self._write(doc)

    def reresolve_mesh(self, url):
        return {}

    def set_hedge_budget(self, budget):
        return False


policy = ctrl.ControllerPolicy(
    min_replicas=1, max_replicas=2, scale_up_load=4.0,
    scale_down_load=1.0, scale_down_holds=2, cooldown_s=0.0,
    unhealthy_ticks=2, degraded_ticks=2, hedge_skew=1e9)
c = ctrl.FleetController(FileActuator(state_path), policy=policy,
                         journal_path=journal_path)
for _ in range(ticks):
    c.tick()
c.close()
print("DONE")
"""


def _run_child(tmp_path, root, state, journal_path, ticks, fault=None):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    env.pop("TRIVY_TPU_FAULTS", None)
    if fault:
        env["TRIVY_TPU_FAULTS"] = fault
    script = tmp_path / "child.py"
    script.write_text(CRASH_CHILD)
    return subprocess.run(
        [sys.executable, str(script), str(state), str(journal_path),
         str(ticks), root],
        env=env, capture_output=True, timeout=120)


def _records(P, path) -> list:
    j = P.ctrl.ActionJournal.open(str(path))
    recs = j.records()
    j.close()
    return recs


def test_sigkill_mid_action_replay_converges(tmp_path):
    """SIGKILL a port controller subprocess between intent and act; a
    restart replays the journal, applies no duplicate action, and
    converges to the uninterrupted run's state. The reference's
    controller reads the crashed journal alike and, replaying a copy,
    converges to the same state and journal."""
    root = "trivy_tpu_torch"
    oracle_state = tmp_path / "oracle-state.json"
    proc = _run_child(tmp_path, root, oracle_state,
                      tmp_path / "oracle-actions.jsonl", ticks=2)
    assert proc.returncode == 0, proc.stderr.decode()
    oracle = json.loads(oracle_state.read_text())

    state = tmp_path / "state.json"
    journal_path = tmp_path / "actions.jsonl"
    proc = _run_child(tmp_path, root, state, journal_path, ticks=2,
                      fault="fleet.controller:kill@1")
    assert proc.returncode == -9, proc.stderr.decode()
    assert json.loads(state.read_text())["spawns"] == 0
    crashed = [_records(P, journal_path) for P in PKGS]
    assert crashed[0] == crashed[1]
    assert len([r for r in crashed[1] if r.get("phase") == "intent"]) == 1

    # the reference replays a copy of the crashed fleet and journal
    ref_state = tmp_path / "ref-state.json"
    ref_journal = tmp_path / "ref-actions.jsonl"
    ref_state.write_bytes(state.read_bytes())
    ref_journal.write_bytes(journal_path.read_bytes())
    for r, s, j in ((root, state, journal_path),
                    ("trivy_tpu", ref_state, ref_journal)):
        proc = _run_child(tmp_path, r, s, j, ticks=2)
        assert proc.returncode == 0, proc.stderr.decode()
        assert json.loads(s.read_text()) == oracle
    recs = [mask(_records(PORT, journal_path)),
            mask(_records(REF, ref_journal))]
    assert recs[0] == recs[1]
    intents = [r for r in recs[0] if r.get("phase") == "intent"
               and r.get("action") == "scale_up"]
    assert len(intents) == 1
    applied = {r["id"] for r in recs[0] if r.get("phase") == "applied"}
    assert all(r["id"] in applied for r in recs[0]
               if r.get("phase") == "intent")


# ================================================================ CLI


def _control_cli(P, tmp_path, capsys):
    d = ptmp(tmp_path, P)
    db = P.store.AdvisoryDB()
    db.put_advisory("npm::GitHub Security Advisory Npm", "pkg0",
                    P.model.Advisory(vulnerability_id="CVE-2026-0001",
                                     fixed_version="2.0.0",
                                     vulnerable_versions=["<2.0.0"]))
    db.meta = P.store.Metadata(updated_at="2026-01-01")
    srv = P.server.Server(engine_of(P, db), P.cache.MemoryCache(),
                          host="localhost", port=0)
    srv.start()
    actions = str(d / "actions.jsonl")
    ops = str(d / "ops.jsonl")
    try:
        rc = P.cli.main(["--quiet", "fleet", "control", srv.address,
                         "--actions", actions, "--journal", ops,
                         "--interval", "1ms", "--ticks", "2",
                         "--dry-run", "--min-replicas", "2"])
        assert rc == 0
    finally:
        close_pools()
        srv.shutdown()
        P.slo.uninstall_journal()
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 2 and all(r["enabled"] for r in lines)
    j = P.ctrl.ActionJournal.open(actions)
    assert j.pending() == []
    recs = mask(j.records())
    j.close()
    # one below-the-floor scale_up; the cooldown holds the second tick
    assert [(r["action"], r.get("reason")) for r in recs
            if r["phase"] == "intent"] == [("scale_up",
                                            "below_min_replicas")]
    assert [r["outcome"] for r in recs if r["phase"] == "applied"] \
        == ["dry_run"]
    events = mask(P.slo.OpsEventLog.read(ops))
    return (mask(lines, [srv.address]), recs,
            mask(events, [srv.address]))


def test_fleet_control_cli_dry_run_ticks(tmp_path, capsys):
    """`fleet control URL --dry-run --ticks 2` against a live replica
    journals without acting: one below-the-floor scale_up, the same
    tick reports, action journal and ops events in both packages."""
    same(_control_cli, tmp_path, capsys)


def test_mesh_reresolve_against_a_port_replica_with_a_device_error(
        tmp_path):
    """The controller's mesh_reresolve against a port replica whose
    re-resolve meets a device error: the HTTP 500 makes the action
    `failed`, its intent stays pending (re-fired next tick), and the
    event carries the device error."""
    from test_torch_fleet import _degrade_shard, _mesh_engine, _patched
    from test_torch_fleet import _raise

    engine = _mesh_engine(PORT, mk_db(PORT))
    srv = PORT.server.Server(engine, PORT.cache.MemoryCache(),
                             host="localhost", port=0)
    srv.start()
    try:
        _degrade_shard(PORT, engine)
        act = PORT.ctrl.HttpFleetActuator([srv.address])
        c = PORT.ctrl.FleetController(
            act, policy=PORT.ctrl.ControllerPolicy(
                min_replicas=1, max_replicas=1, degraded_ticks=1,
                cooldown_s=0.0, hedge_skew=1e9),
            journal_path=str(tmp_path / "a.jsonl"), clock=FakeClock())
        orig = act.observe

        def observe():
            obs = orig()
            for s in obs["statuses"]:
                s["mesh"] = dict(s["mesh"] or {}, degraded_hosts=[1])
            return obs

        act.observe = observe
        with _patched("trivy_tpu_torch.ops.match", "shard_device_db",
                      _raise(RuntimeError("CUDA error: launch failure"))):
            report = c.tick()
        (action,) = report["actions"]
        assert action["action"] == "mesh_reresolve"
        assert action["outcome"] == "failed"
        assert "HTTP 500" in action["error"]
        assert "device error" in action["error"]
        assert len(c.journal.pending()) == 1
        assert engine.shard_health()["degraded"] == [1]
        c.close()
    finally:
        close_pools()
        srv.shutdown()
