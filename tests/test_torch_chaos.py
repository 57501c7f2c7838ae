"""The port's chaos harness (``repro_torch.runtime.faults``) on the CPU vs
the JAX package's.

``generate_scenario`` must return the JAX package's event list field for
field, for every seed, configuration and topology tried. ``ChaosTwin``
steps a JAX and a port ``ChaosHarness``, each over its own package's
``Orchestrator`` (``test_torch_runtime.py``'s ``Twin``; the port's on
``EngineOptions(device="cpu")``), through the same events. After every
event it holds the records equal (every key), the harnesses' ledgers and
invariant counts equal, and both orchestrators' whole state equal
(``same_state``); an event that raises must raise the same exception with
the same message in both. At the end of a run the ``ChaosReport`` fields
are equal, except ``seconds``. Mirrors the chaos cases of
``tests/test_faults.py``. Tolerances: none.

``ChaosTwin.run`` runs each package's own ``ChaosHarness.run`` on its own
orchestrator, one after the other, with ``step`` wrapped to copy the
state after every event, and then compares the copies event by event.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import repro.runtime as JR
import repro_torch.runtime as TR
from repro.runtime.faults import _storm_limit as j_storm_limit
from repro.testing import given, settings, st
from repro_torch.collectives import build_program
from repro_torch.runtime.faults import CAP_FRACS, _storm_limit
from test_torch_runtime import Twin, build, same_state


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same_events(a, b):
    """A JAX and a port event list, field for field (types too)."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert isinstance(x, JR.FaultEvent) and isinstance(y, TR.FaultEvent)
        dx, dy = dataclasses.asdict(x), dataclasses.asdict(y)
        assert dx == dy, (dx, dy)
        assert ([type(v) for v in dx.values()]
                == [type(v) for v in dy.values()]), (dx, dy)


def scenario(jtopo, ttopo, cfg: dict, **kw):
    """``generate_scenario`` in both packages, held equal; the port's."""
    a = JR.generate_scenario(jtopo, cfg=JR.OrchestratorConfig(**cfg), **kw)
    b = TR.generate_scenario(ttopo, cfg=TR.OrchestratorConfig(**cfg), **kw)
    same_events(a, b)
    return b


def same_record(a, b):
    assert list(a) == list(b)
    for key, x in a.items():
        y = b[key]
        assert type(x) is type(y) and x == y, (key, x, y)


HARNESS_FIELDS = ("_capacity_total", "_extra_claims", "invariant_checks")


class ChaosTwin:
    """A JAX and a port ChaosHarness over a ``Twin``'s orchestrators."""

    def __init__(self, tw: Twin, verify_cache_hits: bool = True):
        self.tw = tw
        self.j = JR.ChaosHarness(tw.j, verify_cache_hits=verify_cache_hits)
        self.t = TR.ChaosHarness(tw.t, verify_cache_hits=verify_cache_hits)
        self.check()

    def check(self):
        for f in HARNESS_FIELDS:
            assert getattr(self.j, f) == getattr(self.t, f), f
        self.tw.check()

    def step(self, ev):
        """Apply the port event ``ev`` (and its JAX twin) to both."""
        a = self.j.step(JR.FaultEvent(**dataclasses.asdict(ev)))
        b = self.t.step(ev)
        same_record(a, b)
        self.check()
        return b

    def run(self, events):
        """Each harness's ``run`` over the same events, its ``step`` wrapped
        to snapshot the harness's ledgers and its orchestrator after every
        event; the snapshots are then held equal event by event (records,
        ledgers, ``same_state``), and the reports equal but for
        ``seconds``. Returns the port's report."""
        jevents = [JR.FaultEvent(**dataclasses.asdict(e)) for e in events]
        a, ja = self._recorded(self.j, jevents)
        b, ta = self._recorded(self.t, events)
        assert len(ja) == len(ta) == len(events)
        for i, ((ra, ha, oa), (rb, hb, ob)) in enumerate(zip(ja, ta)):
            same_record(ra, rb)
            assert ha == hb, (i, ha, hb)
            same_state(oa, ob)
        self.check()
        for f in dataclasses.fields(a):
            if f.name != "seconds":
                assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert b.seconds > 0 and b.events_per_sec == b.events / b.seconds
        return b

    @staticmethod
    def _recorded(h, events):
        """``h.run(events)`` and, after each event, (its record, the
        harness's ledgers, a copy of its orchestrator)."""
        snaps, real = [], h.step

        def step(ev):
            rec = real(ev)
            snaps.append((rec, {f: copy.deepcopy(getattr(h, f))
                                for f in HARNESS_FIELDS},
                          copy.deepcopy(h.orch)))
            return rec

        h.step = step
        try:
            return h.run(events), snaps
        finally:
            del h.step

    def raises(self, fn):
        """``fn(harness)`` raises the same violation in both packages."""
        with pytest.raises(JR.InvariantViolation) as a:
            fn(self.j)
        with pytest.raises(TR.InvariantViolation) as b:
            fn(self.t)
        assert str(a.value) == str(b.value)
        return str(b.value)


def fleet_twin(dims=(2, 4, 4), **cfg) -> tuple:
    """``tests/test_faults.py``'s ``mk``: both topologies and a Twin."""
    jtopo, ttopo = build("fleet_tree", *dims)
    return jtopo, ttopo, Twin(jtopo, ttopo, **cfg)


# ---------------------------------------------------------------------------
# generate_scenario
# ---------------------------------------------------------------------------

def test_module_constants_match_jax():
    from repro.runtime import faults as jf
    from repro_torch.runtime import faults as tf
    for name in ("KINDS", "POLICIES", "DEGRADE_FACTORS", "CAP_FRACS"):
        assert getattr(jf, name) == getattr(tf, name), name
    assert TR.FaultEvent("crash") == TR.FaultEvent("crash")
    assert dataclasses.asdict(JR.FaultEvent("x")) == dataclasses.asdict(
        TR.FaultEvent("x"))
    with pytest.raises(dataclasses.FrozenInstanceError):
        TR.FaultEvent("crash").kind = "x"
    for n in range(1, 40):
        for q in (0.5, 0.9, 0.95):
            assert _storm_limit(n, q) == j_storm_limit(n, q)


@pytest.mark.parametrize("dims,n_events,seed,cfg,kw", [
    ((2, 2, 4), 40, 11, dict(k=3, straggler_quantile=0.5), {}),
    ((2, 2, 4), 40, 12, dict(k=3, straggler_quantile=0.5), {}),
    ((2, 2, 4), 60, 3, dict(k=3), dict(admits=True)),
    ((2, 2, 4), 200, 21, dict(k=3, straggler_quantile=0.5),
     dict(train=True)),
    ((2, 4, 4), 80, 5, dict(k=4, straggler_patience=2),
     dict(admits=True, train=True, min_healthy=20)),
    ((2, 2, 2), 30, 0, dict(k=2), dict(min_healthy=2)),
])
def test_generate_scenario_equals_jax(dims, n_events, seed, cfg, kw):
    from repro.collectives import fleet_tree as j_fleet_tree
    from repro_torch.collectives import fleet_tree
    ev = scenario(j_fleet_tree(*dims), fleet_tree(*dims), cfg,
                  n_events=n_events, seed=seed, **kw)
    assert len(ev) == n_events


@pytest.mark.parametrize("seed", [0, 7, 19])
def test_generate_scenario_equals_jax_on_a_fleet_tree(seed):
    """A fleet's first tree at 128 devices (2 trees of 4 pods x 8 racks x
    4 chips), with admissions and crashes: the rack filter's set must
    keep the stream."""
    jf, tf = build("build_fleet", 2, 4, 8, 4)
    assert tf.topos[0].n_devices == 128
    ev = scenario(jf.topos[0], tf.topos[0], dict(k=8, capacity=2),
                  n_events=120, seed=seed, admits=True, train=True)
    assert "fail_rack" in {e.kind for e in ev}


def test_generate_scenario_deterministic_and_feasible():
    jtopo, ttopo = build("fleet_tree", 2, 2, 4)
    cfg = dict(k=3, straggler_quantile=0.5)
    a = scenario(jtopo, ttopo, cfg, n_events=40, seed=11)
    b = TR.generate_scenario(ttopo, n_events=40, seed=11,
                             cfg=TR.OrchestratorConfig(**cfg))
    assert a == b and len(a) == 40
    c = scenario(jtopo, ttopo, cfg, n_events=40, seed=12)
    assert a != c
    failed, quarantined, blocked = set(), set(), set()
    min_healthy = max(2, ttopo.n_devices // 4)
    for ev in a:
        if ev.kind == "fail_device":
            assert not (set(ev.devices) & (failed | quarantined))
            failed |= set(ev.devices)
        elif ev.kind == "recover_device":
            assert set(ev.devices) <= failed
            failed -= set(ev.devices)
        elif ev.kind == "fail_switch":
            assert not (set(ev.switches) & blocked)
            blocked |= set(ev.switches)
        elif ev.kind == "recover_switch":
            assert set(ev.switches) <= blocked
            blocked -= set(ev.switches)
        elif ev.kind == "straggler_storm":
            alive = ttopo.n_devices - len(failed) - len(quarantined)
            assert 1 <= len(ev.devices) <= _storm_limit(alive, 0.5)
            assert ev.steps == 3
            quarantined |= set(ev.devices)
        elif ev.kind == "recover_quarantined":
            quarantined = set()
        elif ev.kind == "fail_rack":
            assert not (set(ev.switches) & blocked)
            failed |= set(ev.devices)
            blocked |= set(ev.switches)
        assert ttopo.n_devices - len(failed) - len(quarantined) >= min_healthy
        assert len(blocked) <= ttopo.tree.n // 2


def test_generate_scenario_emits_capacity_degrades():
    jtopo, ttopo = build("fleet_tree", 2, 2, 4)
    cfg = dict(k=3, straggler_quantile=0.5)
    events = scenario(jtopo, ttopo, cfg, n_events=50, seed=21)
    kinds = {e.kind for e in events}
    assert "degrade_switch" in kinds and "crash" not in kinds
    cap_degraded, blocked = set(), set()
    for ev in events:
        if ev.kind == "degrade_switch":
            (s, f), = ev.rates
            assert s not in cap_degraded and s not in blocked
            assert f in CAP_FRACS
            cap_degraded.add(s)
        elif ev.kind == "recover_switch_capacity":
            (s, f), = ev.rates
            assert s in cap_degraded and f == 1.0
            cap_degraded.discard(s)
        elif ev.kind in ("fail_switch", "fail_rack"):
            blocked |= set(ev.switches)
        elif ev.kind == "recover_switch":
            blocked -= set(ev.switches)
    trained = scenario(jtopo, ttopo, cfg, n_events=200, seed=21, train=True)
    assert any(e.kind == "crash" for e in trained)


# ---------------------------------------------------------------------------
# ChaosHarness
# ---------------------------------------------------------------------------

def test_storm_quarantines_exactly_the_slow_set():
    _, ttopo, tw = fleet_twin(k=3)
    ev = TR.FaultEvent("straggler_storm", devices=(4, 9, 17),
                       steps=tw.t.cfg.straggler_patience, slow=8.0)
    ChaosTwin(tw).step(ev)
    assert set(np.nonzero(tw.t.quarantined)[0]) == {4, 9, 17}
    assert tw.t.n_alive == ttopo.n_devices - 3
    h = ChaosTwin(tw)
    h.step(TR.FaultEvent("recover_quarantined"))
    assert tw.t.n_alive == ttopo.n_devices
    h.step(TR.FaultEvent("recover_quarantined"))


def test_chaos_harness_detects_violations():
    from repro.collectives import build_program as j_build_program
    _, _, tw = fleet_twin(k=3)
    h = ChaosTwin(tw)
    h.j.check_invariants()
    h.t.check_invariants()
    tw.j.program = j_build_program(tw.j.topo,
                                   np.zeros(tw.j.topo.tree.n, bool))
    tw.t.program = build_program(tw.t.topo, np.zeros(tw.t.topo.tree.n, bool))
    msg = h.raises(lambda harness: harness.check_invariants())
    assert "utilization" in msg
    ev = TR.FaultEvent("recover_quarantined")
    msg = h.raises(lambda harness: harness.check_invariants(
        event=ev if harness is h.t else JR.FaultEvent("recover_quarantined")))
    assert msg.endswith(f" after recover_quarantined {ev!r}")


def test_chaos_harness_detects_blue_on_a_blocked_switch_and_overdraft():
    _, _, tw = fleet_twin(k=3, capacity=2)
    h = ChaosTwin(tw)
    for o in (tw.j, tw.t):
        o.switch_blocked[int(np.nonzero(o.blue)[0][0])] = True
    assert "blocked switch" in h.raises(lambda x: x.check_invariants())
    for o in (tw.j, tw.t):
        o.switch_blocked[:] = False
        o._residual[0] -= 3
    assert "negative capacity residual" in h.raises(
        lambda x: x.check_invariants())
    for o in (tw.j, tw.t):
        o._residual[0] += 4
    assert "claim ledger imbalance" in h.raises(
        lambda x: x.check_invariants())


def test_chaos_scenario_50_events_all_invariants():
    cfg = dict(k=3, capacity=2, straggler_quantile=0.5)
    jtopo, ttopo, tw = fleet_twin((2, 2, 4), **cfg)
    events = scenario(jtopo, ttopo, cfg, n_events=50, seed=7)
    assert len({e.kind for e in events}) >= 5
    tw("preplan_switch_failures")
    report = ChaosTwin(tw, verify_cache_hits=True).run(events)
    assert report.events == 50 and report.invariant_checks == 50
    assert report.cache_hits + report.replans >= 50 - sum(
        e.kind in ("recover_quarantined", "preplan_links") for e in events)
    assert report.cache_hits > 0
    assert (tw.t._residual >= 0).all()


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 10_000))
def test_chaos_invariants_hold_for_random_seeds(seed):
    cfg = dict(k=2, capacity=2, straggler_quantile=0.5, straggler_patience=2)
    jtopo, ttopo, tw = fleet_twin((2, 2, 2), **cfg)
    events = scenario(jtopo, ttopo, cfg, n_events=12, seed=seed, admits=True)
    report = ChaosTwin(tw, verify_cache_hits=True).run(events)
    assert report.invariant_checks == 12


def test_chaos_scenario_with_degrades_all_invariants():
    cfg = dict(k=3, capacity=2, straggler_quantile=0.5)
    jtopo, ttopo, tw = fleet_twin((2, 2, 4), **cfg)
    events = scenario(jtopo, ttopo, cfg, n_events=50, seed=21, admits=True)
    assert sum(e.kind == "degrade_switch" for e in events) >= 2
    report = ChaosTwin(tw, verify_cache_hits=True).run(events)
    assert report.events == 50 and report.invariant_checks == 50
    assert (tw.t._residual >= 0).all()


def test_chaos_over_fleet_topology():
    cfg = dict(k=2, capacity=2, straggler_quantile=0.5, straggler_patience=2)
    jf, tf = build("build_fleet", 2, 2, 2, 2)
    tw = Twin(jf, tf, **cfg)
    events = scenario(jf.topos[0], tf.topos[0], cfg, n_events=40, seed=5,
                      admits=True)
    report = ChaosTwin(tw, verify_cache_hits=True).run(events)
    assert report.invariant_checks == 40
    if sum(e.kind == "preplan_links" for e in events) and \
            report.cache_hits == 0:
        assert tw.t.preplan_cache_stats()["entries"] > 0


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 10_000))
def test_claim_ledger_conservation_under_admission_interleavings(seed):
    """``tests/test_faults.py``'s fuzz: the same seeded interleavings of
    admission waves, preemptive admissions, releases, switch failures and
    capacity degrades, on both harnesses, without cache verification."""
    cfg = dict(k=2, capacity=2, straggler_quantile=0.5)
    _, ttopo, tw = fleet_twin((2, 2, 2), **cfg)
    h = ChaosTwin(tw, verify_cache_hits=False)
    rng = np.random.default_rng(seed)
    n = ttopo.tree.n
    blocked: set[int] = set()
    degraded: set[int] = set()
    for _ in range(12):
        ops = ["admit", "preempt", "release"]
        if len(blocked) + 1 <= n // 2:
            ops.append("fail_switch")
        if blocked:
            ops.append("recover_switch")
        free = [v for v in range(n)
                if v not in degraded and v not in blocked]
        if free:
            ops.append("degrade_switch")
        if degraded:
            ops.append("recover_capacity")
        op = str(rng.choice(ops))
        if op == "admit":
            ev = TR.FaultEvent("admit_jobs", count=int(rng.integers(1, 3)))
        elif op == "preempt":
            ev = TR.FaultEvent(
                "preempt_admit", count=int(rng.integers(1, 3)),
                policy=str(rng.choice(TR.PreemptionPolicy.KINDS)))
        elif op == "release":
            ev = TR.FaultEvent("release_jobs",
                               count=int(rng.integers(1, 3)))
        elif op == "fail_switch":
            s = int(rng.choice([v for v in range(n) if v not in blocked]))
            blocked.add(s)
            ev = TR.FaultEvent("fail_switch", switches=(s,))
        elif op == "recover_switch":
            s = int(rng.choice(sorted(blocked)))
            blocked.discard(s)
            ev = TR.FaultEvent("recover_switch", switches=(s,))
        elif op == "degrade_switch":
            s = int(rng.choice(free))
            degraded.add(s)
            ev = TR.FaultEvent("degrade_switch", rates=((s, 0.5),))
        else:
            s = int(rng.choice(sorted(degraded)))
            degraded.discard(s)
            ev = TR.FaultEvent("recover_switch_capacity", rates=((s, 1.0),))
        h.step(ev)
        assert (tw.t._residual >= 0).all()
    assert h.t.invariant_checks == 12


def test_cache_hit_check_solves_on_the_orchestrator_device(monkeypatch):
    """The fresh solve after a cache hit gets the orchestrator's engine
    options (a CPU twin never touches CUDA), and none for a baseline."""
    from repro_torch.runtime import faults
    seen = []
    real = faults.plan

    def spy(*args, **kw):
        seen.append(kw.get("options"))
        return real(*args, **kw)

    monkeypatch.setattr(faults, "plan", spy)
    for strategy in ("soar", "top"):
        jtopo, ttopo = build("fleet_tree", 2, 2, 4)
        tw = Twin(jtopo, ttopo, k=3, strategy=strategy)
        tw("preplan_failures", [[0]])
        h = ChaosTwin(tw)
        rec = h.step(TR.FaultEvent("fail_device", devices=(0,)))
        assert rec["cache_hit"]
    assert seen == [tw.t.options, None]
