"""The port's runtime (``repro_torch.runtime``) on the CPU vs the JAX
package's ``repro.runtime``.

Every orchestrator case is a differential event script. The same topology,
built by each package's own constructors and held equal first, goes into a
JAX ``Orchestrator`` and a port ``Orchestrator`` (``options=EngineOptions(
device="cpu")``). Every event is applied to both, and after every event
their whole state is held equal bitwise: the blue mask, every op of the
program, the utilization history, the capacity ledgers, the health masks,
link rates and capacity scales, the effective topology, the job registry,
the degraded and preemption event records, the last admission, the
preplan and admission caches (keys and entries) with their counters, the
straggler profile and the last congestion result. What an event returns is
held equal too. An event that raises must raise the same exception with
the same message in both and leave both states equal. The port's host
state must stay numpy. Tolerances: none.

This file mirrors the orchestrator, straggler and elastic cases of
``tests/test_runtime.py`` and holds the helpers;
``test_torch_runtime_admission.py`` and ``test_torch_runtime_faults.py``
mirror the orchestrator cases of the other JAX test files.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.collectives as J
import repro.runtime as JR
import repro.runtime.elastic as JE
import repro_torch.collectives as T
import repro_torch.runtime as TR
import repro_torch.runtime.elastic as TE
from repro.collectives.schedule import ReduceProgram as JProgram
from repro_torch.core import Tree, phi, soar
from repro_torch.core.tree import DEST
from repro_torch.engine import EngineOptions
from test_torch_collectives import _same_program, _same_topo
from test_torch_congestion import assert_same_result

CPU = EngineOptions(device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the differential harness
# ---------------------------------------------------------------------------

def same_topology(j, t):
    """A JAX topology or Fleet and the port's, field by field."""
    if isinstance(j, J.Fleet):
        assert isinstance(t, T.Fleet)
        assert j.core_path == t.core_path
        assert j.core_rho.dtype == t.core_rho.dtype
        assert np.array_equal(j.core_rho, t.core_rho)
        for a, b in zip(j.topos, t.topos, strict=True):
            _same_topo(a, b)
    else:
        _same_topo(j, t)


def build(name, *args, **kw):
    """``collectives.<name>(*args, **kw)`` in both packages, held equal."""
    j, t = getattr(J, name)(*args, **kw), getattr(T, name)(*args, **kw)
    same_topology(j, t)
    return j, t


def same_value(a, b, what="value"):
    """What a JAX call returned against what the port's returned."""
    if isinstance(a, JProgram):
        _same_program(a, b)
    elif isinstance(a, JR.StragglerReport):
        assert isinstance(b, TR.StragglerReport), what
        for f in ("suspects", "quarantined"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (what, f)
        assert a.deadline == b.deadline, what
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, type(a)) and len(a) == len(b), what
        for x, y in zip(a, b):
            same_value(x, y, what)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and np.array_equal(a, b), what
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


def _same_array(x, y, what):
    assert (x is None) == (y is None), what
    if x is not None:
        assert isinstance(y, np.ndarray), f"{what}: host state left numpy"
        assert x.dtype == y.dtype, what
        assert np.array_equal(x, y), what


_ARRAYS = ("blue", "alive", "quarantined", "switch_blocked", "_link_rate",
           "_switch_scale")
_SCALARS = ("replans", "cache_recoveries", "utilization_history",
            "degraded_events", "preemption_events", "last_admission",
            "_job_seq", "_allred_util", "_topo_epoch", "_core_key",
            "n_alive", "grad_scale")


def same_state(j, t):
    """Every piece of state of a JAX and a port Orchestrator, bitwise."""
    for name in _ARRAYS:
        _same_array(getattr(j, name), getattr(t, name), name)
    for name in _SCALARS:
        assert getattr(j, name) == getattr(t, name), name
    assert dataclasses.asdict(j.cfg) == dataclasses.asdict(t.cfg)
    assert len(j._residuals) == len(t._residuals)
    assert t._residuals[0] is t._residual
    for g, (x, y) in enumerate(zip(j._residuals, t._residuals)):
        _same_array(x, y, f"ledger {g}")
    same_topology(j.fleet, t.fleet)
    _same_topo(j.topo, t.topo)
    _same_topo(j.topo0, t.topo0)
    assert (j.program is None) == (t.program is None)
    if j.program is not None:
        _same_program(j.program, t.program)
    assert sorted(j.jobs) == sorted(t.jobs)
    for jid, a in j.jobs.items():
        b = t.jobs[jid]
        assert isinstance(b, TR.JobRecord)
        _same_array(a.blue, b.blue, f"job {jid} blue")
        for f in ("job_id", "tree", "priority", "order", "utilization",
                  "benefit"):
            assert getattr(a, f) == getattr(b, f), (jid, f)
    assert j.preplan_cache_stats() == t.preplan_cache_stats()
    assert list(j._preplan) == list(t._preplan)
    for key, a in j._preplan.items():
        b = t._preplan[key]
        _same_array(a["blue"], b["blue"], "preplan blue")
        assert (a["util"], a["avail_key"]) == (b["util"], b["avail_key"])
    assert list(j._admission_cache) == list(t._admission_cache)
    for key, a in j._admission_cache.items():
        for x, y in zip(a["blues"], t._admission_cache[key]["blues"],
                        strict=True):
            _same_array(x, y, "admission cache blue")
    assert (j.last_congestion is None) == (t.last_congestion is None)
    if j.last_congestion is not None:
        assert_same_result(j.last_congestion, t.last_congestion)
    if isinstance(j.stragglers, JR.StragglerPolicy):
        same_stragglers(j.stragglers, t.stragglers)


def same_stragglers(a, b):
    for f in ("_profile", "_strikes", "_observed"):
        _same_array(getattr(a, f), getattr(b, f), f)
    for f in ("quantile", "slack", "patience", "ewma"):
        assert getattr(a, f) == getattr(b, f), f


def _to_jax(v):
    """An event argument as the JAX call takes it."""
    if isinstance(v, TR.PreemptionPolicy):
        return JR.PreemptionPolicy(v.kind, v.max_victims)
    return v


class Twin:
    """A JAX and a port Orchestrator on equal topologies, driven by the
    same events; their states are held equal after every event."""

    def __init__(self, jtopo, ttopo, **cfg):
        same_topology(jtopo, ttopo)
        self.j = JR.Orchestrator(jtopo, JR.OrchestratorConfig(**cfg))
        self.t = TR.Orchestrator(ttopo, TR.OrchestratorConfig(**cfg),
                                 options=CPU)
        self.events = 0
        self.check()

    def check(self):
        same_state(self.j, self.t)
        self.events += 1

    def __call__(self, method, *args, **kw):
        """Apply ``method(*args, **kw)`` to both; returns the port's
        result after holding it and both states equal."""
        a = getattr(self.j, method)(*map(_to_jax, args),
                                    **{k: _to_jax(v) for k, v in kw.items()})
        b = getattr(self.t, method)(*args, **kw)
        same_value(a, b, method)
        self.check()
        return b

    def raises(self, exc, match, method, *args, **kw):
        """Both raise ``exc`` with the same message; states stay equal."""
        with pytest.raises(exc, match=match) as a:
            getattr(self.j, method)(*map(_to_jax, args),
                                    **{k: _to_jax(v) for k, v in kw.items()})
        with pytest.raises(exc, match=match) as b:
            getattr(self.t, method)(*args, **kw)
        assert type(a.value) is type(b.value)
        assert str(a.value) == str(b.value)
        self.check()


def twin(build_name="fleet_tree", dims=(2, 4, 4), **cfg) -> Twin:
    """A Twin over ``collectives.<build_name>(*dims)`` of both packages."""
    return Twin(*build(build_name, *dims), **cfg)


def mk(k=4, capacity=None, **kw) -> Twin:
    """``tests/test_runtime.py``'s ``mk``: fleet_tree(2, 4, 4)."""
    return twin(k=k, capacity=capacity, **kw)


# ---------------------------------------------------------------------------
# tests/test_runtime.py
# ---------------------------------------------------------------------------

def test_initial_plan_is_soar_optimal():
    tw = mk(k=4)
    assert tw.t.program.utilization == pytest.approx(
        soar(tw.t.topo.tree, tw.t.topo.load, 4).cost)


def test_failure_triggers_replan_and_lowers_load():
    tw = mk(k=4)
    u0 = tw.t.program.utilization
    tw("on_failure", [0, 1, 2, 3])
    assert tw.t.n_alive == 28 and tw.t.replans == 2
    assert tw.t.program.utilization < u0
    assert tw.t.program.utilization == pytest.approx(
        soar(tw.t.topo.tree, tw.t.topo.load, 4).cost)


def test_failure_then_recover_restores_plan():
    tw = mk(k=4)
    u0 = tw.t.program.utilization
    tw("on_failure", [5])
    tw("on_recover", [5])
    assert tw.t.n_alive == tw.t.topo0.n_devices
    assert tw.t.program.utilization == u0


def test_all_devices_failing_raises():
    tw = mk(k=2)
    tw.raises(RuntimeError, "all devices failed", "on_failure",
              list(range(tw.t.topo0.n_devices)))


def test_double_failure_raises():
    tw = mk(k=2)
    tw("on_failure", [3])
    tw.raises(ValueError, "already dead", "on_failure", [3])


def test_grad_scale_renormalizes():
    tw = mk(k=2)
    assert tw.t.grad_scale == 1.0
    tw("on_failure", [0, 1])
    assert tw.t.grad_scale == 32 / 30


def test_straggler_quarantine_and_replan():
    tw = mk(k=4, straggler_patience=2)
    slow = np.full(tw.t.topo0.n_devices, 1.0)
    slow[7] = 10.0                        # device 7 is persistently slow
    r1 = tw("on_step_durations", slow)
    assert r1.suspects[7] and not r1.quarantined[7]
    r2 = tw("on_step_durations", slow)
    assert r2.quarantined[7] and tw.t.quarantined[7]
    assert tw.t.n_alive == tw.t.topo0.n_devices - 1
    assert tw.t.replans == 2              # init + quarantine replan
    tw("on_recover", [7])
    assert tw.t.n_alive == tw.t.topo0.n_devices


class StragglerTwin:
    """A JAX and a port StragglerPolicy fed the same steps."""

    def __init__(self, *args, **kw):
        self.j = JR.StragglerPolicy(*args, **kw)
        self.t = TR.StragglerPolicy(*args, **kw)

    def observe(self, durations, alive=None):
        a = self.j.observe(durations, alive=alive)
        b = self.t.observe(durations, alive=alive)
        same_value(a, b, "observe")
        same_stragglers(self.j, self.t)
        return b


def test_straggler_policy_no_false_positive_on_uniform():
    pol = StragglerTwin(16, patience=2)
    for _ in range(5):
        rep = pol.observe(np.random.default_rng(0).uniform(0.9, 1.1, 16))
        assert not rep.quarantined.any()


def test_capacity_respected_across_workloads():
    tw = mk(k=4, capacity=1)
    prog2 = tw("begin_workload")          # capacity 1 used up by the first
    assert prog2.utilization >= tw.t.utilization_history[0]
    assert (tw.t._residual >= 0).all()


def test_preplan_failures_matches_serial_replan():
    tw = mk(k=3)
    scenarios = [[0], [0, 1, 2, 3], [5, 9]]
    planned = tw("preplan_failures", scenarios)
    for devices, (blue, util) in zip(scenarios, planned, strict=True):
        probe = mk(k=3)
        probe("on_failure", list(devices))
        assert util == probe.t.program.utilization
        assert blue.sum() <= 3
    assert tw.t.replans == 1 and tw.t.n_alive == tw.t.topo0.n_devices


def test_preplan_failures_matches_serial_replan_with_capacity():
    tw = mk(k=3, capacity=1)
    planned = tw("preplan_failures", [[0], [4, 5]])
    residual_before = tw.t._residual.copy()
    for devices, (_, util) in zip([[0], [4, 5]], planned, strict=True):
        probe = mk(k=3, capacity=1)
        probe("on_failure", list(devices))
        assert util == probe.t.program.utilization
    assert np.array_equal(tw.t._residual, residual_before)
    assert tw.t.replans == 1


def test_begin_workloads_batched_respects_capacity():
    tw = mk(k=4, capacity=2)
    progs = tw("begin_workloads", 3)
    assert len(progs) == 3 and (tw.t._residual >= 0).all()
    assert len(tw.t.utilization_history) == 4


@pytest.mark.parametrize("k,old,new,policy", [
    (4, 32, 64, "proportional"), (4, 32, 64, "fixed"), (5, 2, 1,
                                                        "proportional"),
    (3, 2, 1, "proportional"), (1, 2, 1, "proportional"),
    (7, 0, 3, "proportional"), (4, 32, 64, "bogus")])
def test_elastic_rescale_and_budget(k, old, new, policy):
    """``rescale`` / ``shrink_by_failure`` topologies and the budget
    (half-way cases: Python's round, half to even), against JAX."""
    jt, tt = build("fleet_tree", 2, 4, 4)
    _same_topo(JE.rescale(jt, 4, 4, 4), TE.rescale(tt, 4, 4, 4))
    assert TE.rescale(tt, 4, 4, 4).n_devices == 64
    small = TE.shrink_by_failure(tt, [0, 1])
    _same_topo(JE.shrink_by_failure(jt, [0, 1]), small)
    assert small.load.sum() == tt.load.sum() - 2
    if policy == "bogus":
        for mod in (JE, TE):
            with pytest.raises(ValueError, match="unknown budget policy"):
                mod.scaling_budget(k, old, new, policy)
        return
    got = TE.scaling_budget(k, old, new, policy)
    assert type(got) is int and got == JE.scaling_budget(k, old, new, policy)


def test_replan_is_bounded_by_budget_always():
    tw = mk(k=3)
    rng = np.random.default_rng(1)
    alive = list(range(tw.t.topo0.n_devices))
    for _ in range(6):
        d = int(rng.choice(alive))
        alive.remove(d)
        tw("on_failure", [d])
        assert tw.t.blue.sum() <= 3
        assert tw.t.program.utilization == pytest.approx(
            phi(tw.t.topo.tree, tw.t.topo.load, tw.t.blue))


def test_on_recover_never_failed_device_raises():
    tw = mk(k=2)
    tw.raises(ValueError, "not failed or quarantined", "on_recover", [4])
    assert tw.t.replans == 1
    tw("on_failure", [4])
    tw("on_recover", [4])
    tw("on_failure", [5, 6])
    tw.raises(ValueError, "not failed", "on_recover", [5, 7])
    assert not tw.t.alive[5] and not tw.t.alive[6]
    tw("on_recover", [5, 6])
    assert tw.t.n_alive == tw.t.topo0.n_devices


def test_capacity_residual_never_negative_across_events():
    tw = mk(k=4, capacity=2)
    total = tw.t._residual.sum() + tw.t.blue.sum()
    tw("begin_workloads", 2)
    claimed_before = total - tw.t._residual.sum()
    tw("on_failure", [0, 1, 2, 3])
    tw("on_recover", [0, 1, 2, 3])
    assert total - tw.t._residual.sum() == claimed_before
    tw("begin_workloads", 1, congestion_aware=True)
    assert (tw.t._residual >= 0).all()
    assert total - tw.t._residual.sum() >= claimed_before


def test_preplan_snapshot_matches_real_replan_with_extra_workloads():
    tw = mk(k=3, capacity=2)
    tw("begin_workload")
    planned = tw("preplan_failures", [[0], [4, 5]])
    for devices, (blue, util) in zip([[0], [4, 5]], planned, strict=True):
        probe = mk(k=3, capacity=2)
        probe("begin_workload")
        probe("on_failure", list(devices))
        assert util == probe.t.program.utilization
        assert blue.sum() <= 3
    assert tw.t.replans == 1 and (tw.t._residual >= 0).all()


def test_on_failure_validates_before_mutating():
    tw = mk(k=2)
    n = tw.t.topo0.n_devices
    tw("on_failure", [9])
    tw.raises(ValueError, "already dead", "on_failure", [10, 9])
    assert tw.t.alive[10]
    tw.raises(ValueError, "out of range", "on_failure", [11, n])
    assert tw.t.alive[11]
    tw("on_failure", [12, 12])            # duplicates collapse
    assert tw.t.n_alive == n - 2


def test_all_devices_failing_leaves_state_untouched():
    tw = mk(k=2)
    tw.raises(RuntimeError, "all devices", "on_failure",
              list(range(tw.t.topo0.n_devices)))
    assert tw.t.n_alive == tw.t.topo0.n_devices and tw.t.replans == 1
    tw("on_failure", [0])


def test_begin_workloads_zero_count_returns_empty():
    tw = mk(k=2, capacity=2)
    assert tw("begin_workloads", 0) == []
    assert tw("begin_workloads", 0, congestion_aware=True) == []
    assert len(tw.t.utilization_history) == 1


def test_straggler_quantile_masks_dead_devices():
    pol = StragglerTwin(8, quantile=0.6, slack=1.5, patience=1)
    alive = np.ones(8, bool)
    warm = np.ones(8)
    warm[5:] = 50.0                        # three persistently slow devices
    pol.observe(warm, alive=alive)
    alive[5:] = False                      # ... then they die
    later = np.ones(8)
    later[0] = 4.0                         # a live straggler appears
    rep = pol.observe(later, alive=alive)
    assert rep.deadline < 4.0 and rep.suspects[0]
    assert not rep.suspects[5:].any()
    pol2 = StragglerTwin(8, quantile=0.6, slack=1.5, patience=1)
    pol2.observe(warm)
    assert not pol2.observe(later).suspects[0]


def test_straggler_observe_empty_alive_is_noop():
    pol = StragglerTwin(4, patience=1)
    rep = pol.observe(np.ones(4), alive=np.zeros(4, bool))
    assert not rep.suspects.any() and np.isinf(rep.deadline)


@pytest.mark.parametrize("kw,match", [
    (dict(quantile=1.0), "quantile"), (dict(quantile=0.0), "quantile"),
    (dict(slack=0.5), "slack")])
def test_straggler_policy_validation_messages(kw, match):
    """Every validation message of the JAX policy, word for word."""
    pol = StragglerTwin(4)
    calls = [lambda mod, p: mod.StragglerPolicy(4, **kw),
             lambda mod, p: p.observe(np.ones(5)),
             lambda mod, p: p.observe(np.ones(4), alive=np.ones(3, bool))]
    for call, want in zip(calls, (match, "expected", "alive mask")):
        msgs = []
        for mod, p in ((JR, pol.j), (TR, pol.t)):
            with pytest.raises(ValueError, match=want) as e:
                call(mod, p)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_on_step_durations_never_quarantines_last_devices():
    tw = mk(k=2, straggler_patience=1)

    def condemn_all(report_cls):
        class _CondemnAll:
            def observe(self, durations, alive=None):
                return report_cls(suspects=alive.copy(),
                                  quarantined=alive.copy(), deadline=0.0)
        return _CondemnAll()

    tw.j.stragglers = condemn_all(JR.StragglerReport)
    tw.t.stragglers = condemn_all(TR.StragglerReport)
    tw("on_step_durations", np.ones(tw.t.topo0.n_devices))
    assert tw.t.n_alive == tw.t.topo0.n_devices and tw.t.replans == 1


def test_rescale_derives_dims_from_topology():
    jt, tt = build("fleet_tree", 2, 4, 4)
    assert TE.fleet_dims(tt) == JE.fleet_dims(jt) == (2, 4, 4)
    for kw in (dict(n_pods=3), dict(chips_per_rack=8),
               dict(n_pods=4, racks_per_pod=4, chips_per_rack=4)):
        _same_topo(JE.rescale(jt, **kw), TE.rescale(tt, **kw))
        assert TE.fleet_dims(TE.rescale(tt, **kw)) == JE.fleet_dims(
            JE.rescale(jt, **kw))
    from repro.core.tree import Tree as JTree
    parent, rho = np.array([DEST, 0, 0, 1]), np.ones(4)
    leaf, load = np.array([3, 3]), np.array([0, 0, 0, 2])
    bad = [J.ClusterTopology(tree=JTree(parent, rho), device_leaf=leaf,
                             load=load),
           T.ClusterTopology(tree=Tree(parent, rho), device_leaf=leaf,
                             load=load)]
    msgs = []
    for mod, topo in zip((JE, TE), bad):
        with pytest.raises(ValueError, match="ragged pods") as e:
            mod.fleet_dims(topo)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_on_rescale_replans_with_scaled_budget():
    tw = mk(k=4, capacity=2)
    tw("on_failure", [0])
    tw("begin_workload")
    prog = tw("on_rescale", n_pods=4)
    assert tw.t.topo.n_devices == 64 and tw.t.cfg.k == 8
    assert tw.t.blue.sum() <= 8 and tw.t.n_alive == 64
    assert tw.t._residual.sum() + tw.t.blue.sum() == 2 * tw.t.topo.tree.n
    assert prog.utilization == pytest.approx(
        phi(tw.t.topo.tree, tw.t.topo.load, tw.t.blue))
    tw2 = mk(k=4, capacity=None)
    tw2("on_rescale", n_pods=4, budget_policy="fixed")
    assert tw2.t.cfg.k == 4

