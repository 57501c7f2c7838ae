"""The port's orchestrator admission on the CPU vs the JAX package's:
congestion-aware, capacity-priced, fleet and in-loop (device) admission,
preemption, releases and the admission cache, and link-degrade
preplanning on fleets.

Differential event scripts, as in ``test_torch_runtime.py`` (whose
``Twin`` holds the JAX and the port ``Orchestrator``'s whole state equal
bitwise after every event). Mirrors the orchestrator cases of
``tests/test_congestion.py``, ``tests/test_congestion_device.py``,
``tests/test_fleet.py`` and ``tests/test_admission_device.py``, and adds
seeded random interleavings of admission waves, preemptions, releases,
switch failures and capacity degrades. Tolerances: none.
"""
import numpy as np
import pytest
import torch

import repro.runtime as JR
import repro_torch.runtime as TR
from repro_torch.core.congestion import congestion_profile, messages_up_batch
from repro_torch.core.reduce import phi
from repro_torch.engine import solve_congestion
from test_torch_runtime import CPU, Twin, build, mk, twin


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def conservation(o, cap):
    """Every tree's residual plus its registered claims (and the
    orchestrator's own blue on tree 0) is the capacity."""
    for g, res_g in enumerate(o._residuals):
        claims = np.zeros(res_g.shape[0], np.int64)
        for j in o.jobs.values():
            if j.tree == g:
                claims += j.blue.astype(np.int64)
        if g == 0:
            claims += o.blue.astype(np.int64)
        assert np.array_equal(res_g + claims,
                              np.full(res_g.shape[0], cap, np.int64)), g


# ---------------------------------------------------------------------------
# tests/test_congestion.py, tests/test_congestion_device.py
# ---------------------------------------------------------------------------

def test_orchestrator_congestion_aware_admission():
    tw = twin(k=4, capacity=8)
    progs = tw("begin_workloads", 4, congestion_aware=True)
    assert len(progs) == 4 and (tw.t._residual >= 0).all()
    res = tw.t.last_congestion
    assert res is not None and res.max_congestion <= res.baseline_max
    tw.raises(ValueError, "only apply with congestion_aware=True",
              "begin_workloads", 2, max_rounds=4)
    top = twin(k=4, capacity=3, strategy="top")
    top.raises(ValueError, "strategy='soar'", "begin_workloads", 2,
               congestion_aware=True)


def test_congestion_admission_report_matches_admitted_placements():
    tw = twin(k=3, capacity=1)
    tw("begin_workloads", 3, congestion_aware=True)
    assert tw.t.last_admission["collisions"] >= 1   # the re-measured path
    topo, res = tw.t.topo, tw.t.last_congestion
    assert res.blue.shape[0] == 3
    prof = congestion_profile(messages_up_batch(
        [topo.tree] * 3, [topo.load] * 3, list(res.blue)))
    assert np.array_equal(prof, res.congestion)
    assert res.max_congestion == prof.max()
    for blue, cost in zip(res.blue, res.costs):
        assert cost == phi(topo.tree, topo.load, blue)


def test_orchestrator_capacity_priced_admission():
    tw = twin(k=4, capacity=2)
    progs = tw("begin_workloads", 3, congestion_aware=True,
               capacity_priced=True)
    assert len(progs) == 3 and (tw.t._residual >= 0).all()
    tw2 = twin(k=4, capacity=2)
    tw2.raises(ValueError, "congestion_aware", "begin_workloads", 2,
               capacity_priced=True)
    tw2.raises(ValueError, "residual-capacity snapshot", "begin_workloads",
               2, congestion_aware=True, capacity_priced=True,
               capacity=np.ones(tw2.t.topo.tree.n))


# ---------------------------------------------------------------------------
# tests/test_fleet.py: fleet admission, link-degrade preplanning
# ---------------------------------------------------------------------------

def test_orchestrator_fleet_admission_claims_per_tree():
    tw = Twin(*build("build_fleet", 2, 2, 2, 2), k=2, capacity=3)
    before = [r.copy() for r in tw.t._residuals]
    progs = tw("begin_workloads", congestion_aware=True, fleet=[2, 1])
    assert len(progs) == 3
    res = tw.t.last_congestion
    assert np.array_equal(np.asarray(res.tree_of), [0, 0, 1])
    for g in range(2):
        rows = [t for t in range(3) if res.tree_of[t] == g]
        n_g = tw.t.fleet.topos[g].tree.n
        claimed = sum(int(res.blue[t, :n_g].sum()) for t in rows)
        assert int((before[g] - tw.t._residuals[g]).sum()) == claimed
        assert (tw.t._residuals[g] >= 0).all()


def test_orchestrator_fleet_admission_validation_and_n1():
    tw = Twin(*build("build_fleet", 2, 2, 2, 2), k=2, capacity=3)
    tw.raises(ValueError, "congestion_aware=True", "begin_workloads",
              fleet=[1, 1])
    tw.raises(ValueError, "exactly one of count / fleet", "begin_workloads",
              congestion_aware=True)
    tw.raises(ValueError, "exactly one of count / fleet", "begin_workloads",
              2, congestion_aware=True, fleet=[1, 1])
    tw.raises(ValueError, ">=1 workloads", "begin_workloads",
              congestion_aware=True, fleet=[2])
    one = twin(dims=(2, 2, 2), k=2, capacity=3)
    progs = one("begin_workloads", congestion_aware=True, fleet=[2],
                capacity_priced=True)
    assert len(progs) == 2 and (one.t._residual >= 0).all()


def test_preplan_link_degrades_cache_hit_bit_identical():
    tw = twin(dims=(2, 2, 4), k=3, capacity=4)
    planned = tw("preplan_link_degrades", factor=0.5)
    assert len(planned) == tw.t.topo.tree.n
    replans0, rec0 = tw.t.replans, tw.t.cache_recoveries
    tw("on_link_degrade", {5: 0.5})
    assert tw.t.replans == replans0
    assert tw.t.cache_recoveries == rec0 + 1
    fresh = twin(dims=(2, 2, 4), k=3, capacity=4)
    fresh("on_link_degrade", {5: 0.5})
    assert np.array_equal(tw.t.blue, fresh.t.blue)
    assert tw.t.program.utilization == fresh.t.program.utilization


def test_preplan_link_degrades_staleness_evicts():
    tw = twin(dims=(2, 2, 2), k=2, capacity=1)
    tw("preplan_link_degrades", rate_sets=[{4: 0.5}])
    tw("begin_workload")
    rec0 = tw.t.cache_recoveries
    tw("on_link_degrade", {4: 0.5})
    assert tw.t.preplan_cache_stats()["stale"] == 1
    assert tw.t.cache_recoveries == rec0
    assert (tw.t._residual >= 0).all()


def test_preplan_link_degrades_validation():
    tw = twin(dims=(2, 2, 2), k=2)
    n = tw.t.topo.tree.n
    tw.raises(ValueError, "out of range", "preplan_link_degrades",
              rate_sets=[{n: 0.5}])
    tw.raises(ValueError, "positive finite", "preplan_link_degrades",
              rate_sets=[{0: 0.0}])
    tw.raises(ValueError, "positive finite", "preplan_link_degrades",
              factor=-1.0)
    tw("on_link_degrade", {3: 0.5})
    assert len(tw("preplan_link_degrades")) == n - 1


# ---------------------------------------------------------------------------
# tests/test_admission_device.py: in-loop admission, preemption, telemetry
# ---------------------------------------------------------------------------

def _orch(k=4, capacity=2):
    return twin(k=k, capacity=capacity)


def test_device_admission_one_solve_where_host_path_collides():
    host = _orch()
    host("begin_workloads", 16, congestion_aware=True, max_rounds=2)
    h = host.t.last_admission
    assert h["path"] == "host" and h["collisions"] >= 1
    assert h["round_trips"] == 1 + h["collisions"]
    dev = _orch()
    progs = dev("begin_workloads", 16, congestion_aware=True,
                device_admission=True, max_rounds=2)
    d = dev.t.last_admission
    assert len(progs) == 16 and d["path"] == "device"
    assert d["solves"] == 1 and d["collisions"] == 0 and d["preempted"] == ()
    assert h["round_trips"] >= 2 * d["round_trips"]
    conservation(dev.t, 2)


def test_device_admission_matches_engine_ledger_reference():
    tw = _orch()
    residual, avail = tw.t._residual.copy(), tw.t._avail()
    tw("begin_workloads", 6, congestion_aware=True, device_admission=True,
       max_rounds=2)
    ref = solve_congestion(tw.t.topo.tree, [tw.t.topo.load] * 6, tw.t.cfg.k,
                           avail=[avail] * 6, residual=residual,
                           device_loop=False, max_rounds=2, options=CPU)
    admitted = np.stack([j.blue for j in sorted(tw.t.jobs.values(),
                                                key=lambda j: j.order)])
    assert np.array_equal(admitted, ref.blue)


@pytest.mark.parametrize("kind,order", [
    ("priority", [2, 3, 1]), ("youngest-first", [3, 2, 1]),
    ("cheapest-regression", [2, 1, 3])])
def test_preemption_policies_order_victims(kind, order):
    records = {}
    for mod in (JR, TR):
        lo = dict(tree=0, blue=np.zeros(1, bool), utilization=0.0)
        jobs = [mod.JobRecord(job_id=1, priority=2, order=1, benefit=5.0,
                              **lo),
                mod.JobRecord(job_id=2, priority=0, order=2, benefit=1.0,
                              **lo),
                mod.JobRecord(job_id=3, priority=1, order=3, benefit=9.0,
                              **lo)]
        records[mod] = [j.job_id for j in
                        mod.PreemptionPolicy(kind).order_victims(jobs)]
    assert records[TR] == records[JR] == order
    for kw in (dict(kind="oldest"), dict(kind="priority", max_victims=0)):
        msgs = []
        for mod in (JR, TR):
            with pytest.raises(ValueError) as e:
                mod.PreemptionPolicy(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_preemptive_admission_evicts_then_fits():
    tw = _orch()
    for _ in range(3):
        tw("begin_workload", priority=1)
    before_jobs = set(tw.t.jobs)
    progs = tw("begin_workloads", 8, congestion_aware=True,
               device_admission=True,
               preemption=TR.PreemptionPolicy("priority"), priority=0,
               max_rounds=2)
    a = tw.t.last_admission
    assert len(progs) == 8 and a["solves"] == 2 and tuple(a["preempted"])
    assert set(a["preempted"]) <= before_jobs
    assert tw.t.preemption_events[-1]["policy"] == "priority"
    assert tw.t.preemption_events[-1]["freed"] > 0
    conservation(tw.t, 2)


def test_release_workloads_frees_ledger_exactly():
    tw = _orch()
    tw("begin_workloads", 4, congestion_aware=True, device_admission=True,
       max_rounds=2)
    ids = sorted(tw.t.jobs)
    res0 = tw.t._residual.copy()
    held = sum(int(tw.t.jobs[i].blue.sum()) for i in ids[:2])
    assert tw("release_workloads", ids[:2]) == held
    assert int((tw.t._residual - res0).sum()) == held
    tw.raises(KeyError, "unknown job id", "release_workloads", [ids[0]])


def test_admission_cache_serves_identical_wave():
    """The engine options are not driver options: a repeated identical
    device-admission wave of an orchestrator built with ``options=`` is a
    cache hit with no solve."""
    a, b = _orch(), _orch()
    a("begin_workloads", 4, congestion_aware=True, device_admission=True)
    blues_a = [j.blue.copy() for j in sorted(a.t.jobs.values(),
                                             key=lambda j: j.order)]
    b("begin_workloads", 4, congestion_aware=True, device_admission=True)
    b("release_workloads", sorted(b.t.jobs))
    b("begin_workloads", 4, congestion_aware=True, device_admission=True)
    t = b.t.last_admission
    assert t["cache_hit"] and t["solves"] == 0 and t["round_trips"] == 0
    blues_b = [j.blue.copy() for j in sorted(b.t.jobs.values(),
                                             key=lambda j: j.order)]
    for x, y in zip(blues_a, blues_b, strict=True):
        assert np.array_equal(x, y)


def test_device_admission_guardrails():
    tw = _orch()
    tw.raises(ValueError, "congestion_aware", "begin_workloads", 2,
              device_admission=True)
    tw.raises(ValueError, "device_admission", "begin_workloads", 2,
              congestion_aware=True, preemption=TR.PreemptionPolicy())
    tw.raises(ValueError, "residual", "begin_workloads", 2,
              congestion_aware=True, device_admission=True,
              residual=np.ones(tw.t.topo.tree.n, np.int64))


def test_fleet_device_admission_per_tree():
    tw = Twin(*build("build_fleet", 2, 2, 2, 4), k=3, capacity=2)
    progs = tw("begin_workloads", fleet=[3, 3], congestion_aware=True,
               device_admission=True, max_rounds=2)
    a = tw.t.last_admission
    assert len(progs) == 6 and a["path"] == "device"
    assert a["collisions"] == 0 and a["solves"] == 1
    conservation(tw.t, 2)


# ---------------------------------------------------------------------------
# seeded interleavings (the claim-ledger fuzz of tests/test_faults.py,
# driven on the orchestrator directly)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_admission_interleavings_match_jax(seed):
    tw = mk(k=2, capacity=2, build_name="fleet_tree", dims=(2, 2, 2))
    rng = np.random.default_rng(seed)
    n = tw.t.topo0.tree.n
    blocked: set[int] = set()
    degraded: set[int] = set()
    for _ in range(10):
        ops = ["admit", "preempt", "release", "host_admit"]
        if len(blocked) + 1 <= n // 2:
            ops.append("fail_switch")
        if blocked:
            ops.append("recover_switch")
        free = [v for v in range(n) if v not in degraded | blocked]
        if free:
            ops.append("degrade_switch")
        if degraded:
            ops.append("recover_capacity")
        op = str(rng.choice(ops))
        count = int(rng.integers(1, 3))
        if op == "admit":
            tw("begin_workloads", count, congestion_aware=True,
               device_admission=True, max_rounds=2)
        elif op == "host_admit":
            tw("begin_workloads", count, congestion_aware=True,
               capacity_priced=True, max_rounds=2)
        elif op == "preempt":
            kind = str(rng.choice(TR.PreemptionPolicy.KINDS))
            tw("begin_workloads", count, congestion_aware=True,
               device_admission=True, max_rounds=2,
               preemption=TR.PreemptionPolicy(kind, max_victims=2))
        elif op == "release":
            ids = sorted(tw.t.jobs)
            if ids:
                tw("release_workloads", ids[:count])
            else:
                tw("begin_workload", priority=count)
        elif op == "fail_switch":
            s = int(rng.choice([v for v in range(n) if v not in blocked]))
            blocked.add(s)
            tw("on_switch_failure", [s])
        elif op == "recover_switch":
            s = int(rng.choice(sorted(blocked)))
            blocked.discard(s)
            tw("on_switch_recover", [s])
        elif op == "degrade_switch":
            s = int(rng.choice(free))
            degraded.add(s)
            tw("on_switch_degrade", {s: 0.5})
        else:
            s = int(rng.choice(sorted(degraded)))
            degraded.discard(s)
            tw("on_switch_degrade", {s: 1.0})
        assert all((r >= 0).all() for r in tw.t._residuals)
    assert tw.events == 11
