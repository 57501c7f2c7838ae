"""The port's orchestrator under switch, link and capacity faults on the CPU
vs the JAX package's: the two-stage switch-failure and capacity-degrade
recoveries, the preplan cache (hits, misses, staleness) and the engine's
cache telemetry.

Differential event scripts, as in ``test_torch_runtime.py`` (whose
``Twin`` holds the JAX and the port ``Orchestrator``'s whole state equal
bitwise after every event). Mirrors the orchestrator cases of
``tests/test_degraded_capacity.py`` (chip-level trees) and
``tests/test_faults.py``. The cases of ``tests/test_faults.py`` that use
``ChaosHarness``, ``ChaosTrainer`` or ``generate_scenario`` are mirrored
in ``test_torch_chaos.py`` and ``test_torch_chaos_train.py``. Tolerances:
none.
"""
import numpy as np
import pytest
import torch

from repro_torch.collectives import degrade_links
from repro_torch.core import phi, soar
from repro_torch.engine import cache_stats
from test_torch_collectives import _same_program
from test_torch_runtime import mk, twin


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def chip(k=3, capacity=None):
    """``tests/test_degraded_capacity.py``'s ``mk``."""
    return twin("chip_level_tree", (2, 3, 2), k=k, capacity=capacity)


def first_blue(tw) -> int:
    return int(np.nonzero(tw.t.blue)[0][0])


# ---------------------------------------------------------------------------
# tests/test_degraded_capacity.py
# ---------------------------------------------------------------------------

def test_on_switch_degrade_two_stage_and_cached_restore():
    tw = chip(k=3)
    u0 = tw.t.program.utilization
    s = first_blue(tw)
    tw("on_switch_degrade", {s: 0.5})
    ev = tw.t.degraded_events[-1]
    assert ev["switches"] == (s,) and ev["scales"] == (0.5,)
    assert ev["degraded_utilization"] >= u0
    assert ev["utilization"] <= ev["degraded_utilization"]
    assert not ev["cache_hit"]
    tw("on_switch_degrade", {s: 1.0})
    assert tw.t.degraded_events[-1]["cache_hit"]
    assert tw.t.program.utilization == u0
    assert (tw.t._switch_scale == 1.0).all()


def test_on_switch_degrade_zero_forces_blue_off():
    tw = chip(k=3)
    s = first_blue(tw)
    tw("on_switch_degrade", {s: 0.0})
    assert not tw.t.blue[s]
    assert tw.t.degraded_events[-1]["was_blue"] == (s,)


def test_on_switch_degrade_validates_before_mutating():
    tw = chip(k=3)
    n = tw.t.topo0.tree.n
    for bad, match in (({n: 0.5}, "out of range"), ({-1: 0.5}, "out of "
                                                    "range"),
                       ({0: -0.1}, "finite fraction"),
                       ({0: 1.5}, "finite fraction"),
                       ({0: float("nan")}, "finite fraction"),
                       ({1.5: 0.5}, "not an integer")):
        tw.raises(ValueError, match, "on_switch_degrade", bad)


def test_on_switch_degrade_ledger_eviction():
    tw = chip(k=3, capacity=2)
    tw("begin_workloads", 2)                   # foreign claims on switches
    s = first_blue(tw)
    tw("on_switch_degrade", {s: 0.25})         # floor(2 * 0.25) = 0 units
    ev = tw.t.degraded_events[-1]
    assert ev["capacity_delta"] == -2
    assert s in ev["was_blue"] or ev["evicted_foreign"] > 0
    assert (tw.t._residual >= 0).all() and not tw.t.blue[s]


@pytest.mark.parametrize("capacity,scale,units", [
    (3, 0.3, 0), (3, 0.5, 1), (3, 0.7, 2), (3, 1 / 3, 1), (3, 2 / 3, 2),
    (10, 0.7 - 0.4, 3), (10, 0.3 - 0.2, 1)])
def test_effective_capacity_floors_like_jax(capacity, scale, units):
    """``floor(capacity * scale + 1e-9)`` in float64 (0.7 - 0.4 is just
    below 0.3: without the 1e-9 ten units would floor to 2), with the
    ledger eviction of foreign claims off the youngest jobs holding the
    switch."""
    tw = chip(k=3, capacity=capacity)
    assert tw.t._effective_capacity(scale) == tw.j._effective_capacity(
        scale) == units
    tw("begin_workloads", 2)
    tw("begin_workload", priority=1)
    held = [int(np.nonzero(tw.t._residual < capacity)[0][i])
            for i in range(2)]
    tw("on_switch_degrade", {held[0]: scale, held[1]: scale / 2})
    tw("on_switch_degrade", {held[0]: 1.0})


def test_fingerprint_distinguishes_capacity_states():
    tw = chip(k=3)
    s = first_blue(tw)
    fp0 = tw.t._fingerprint()
    assert fp0 == tw.j._fingerprint()
    tw("on_switch_degrade", {s: 0.5})
    assert tw.t._fingerprint() != fp0
    assert tw.t._fingerprint() == tw.j._fingerprint()
    tw("on_switch_degrade", {s: 1.0})
    assert tw.t._fingerprint() == fp0


def test_on_rescale_resets_switch_scale():
    tw = chip(k=3)
    tw("on_switch_degrade", {1: 0.5})
    tw("on_rescale", n_pods=2, racks_per_pod=2, chips_per_rack=2)
    assert (tw.t._switch_scale == 1.0).all()
    assert tw.t.topo.cap_scale is None or (tw.t.topo.cap_scale == 1.0).all()


def test_on_link_degrade_validates_rates():
    tw = chip(k=3)
    n = tw.t.topo0.tree.n
    for bad, match in (({n: 0.5}, "out of range"),
                       ({-1: 0.5}, "out of range"),
                       ({0: 0.0}, "positive finite"),
                       ({0: -1.0}, "positive finite"),
                       ({0: float("nan")}, "positive finite"),
                       ({0: float("inf")}, "positive finite"),
                       ({2.5: 0.5}, "not an integer")):
        tw.raises(ValueError, match, "on_link_degrade", bad)


# ---------------------------------------------------------------------------
# tests/test_faults.py: switch failures, degraded mode, the preplan cache
# ---------------------------------------------------------------------------

def test_switch_failure_degraded_then_replan():
    tw = mk(k=3)
    u0 = tw.t.program.utilization
    hit = first_blue(tw)
    tw("on_switch_failure", [hit])
    ev = tw.t.degraded_events[-1]
    assert ev["switches"] == (hit,) and ev["was_blue"] == (hit,)
    assert u0 < ev["degraded_utilization"] <= phi(
        tw.t.topo.tree, tw.t.topo.load, np.zeros(tw.t.topo.tree.n, bool))
    assert ev["utilization"] <= ev["degraded_utilization"]
    assert not tw.t.blue[hit]
    cold = int(np.nonzero(~tw.t.blue & ~tw.t.switch_blocked)[0][0])
    tw("on_switch_failure", [cold])
    assert tw.t.degraded_events[-1]["degraded_utilization"] is None
    tw.raises(ValueError, "already failed", "on_switch_failure", [hit])
    tw.raises(ValueError, "out of range", "on_switch_failure",
              [tw.t.topo0.tree.n])
    tw("on_switch_recover", [hit, cold])
    assert tw.t.program.utilization == u0
    tw.raises(ValueError, "is not failed", "on_switch_recover", [hit])


def test_preplan_switch_failures_cache_hit_bit_identical():
    tw = mk(k=3, capacity=2)
    planned = tw("preplan_switch_failures")
    assert len(planned) == int((~tw.t.switch_blocked).sum())
    replans0 = tw.t.replans
    for s in np.nonzero(~tw.t.switch_blocked)[0][:4]:
        s = int(s)
        tw("on_switch_failure", [s])
        assert tw.t.degraded_events[-1]["cache_hit"]
        fresh_blue, fresh_prog = tw.t._plan([tw.t.topo],
                                            [tw.t._replan_avail()])[0]
        assert np.array_equal(tw.t.blue, fresh_blue)
        _same_program(tw.j.program, fresh_prog)
        tw("on_switch_recover", [s])
    assert tw.t.replans == replans0
    stats = tw.t.preplan_cache_stats()
    assert stats["hits"] == 8 and stats["cache_recoveries"] == 8


def test_preplan_cache_staleness_evicts():
    tw = mk(k=3, capacity=1)
    tw("preplan_switch_failures", [[0]])
    tw("begin_workload")                       # capacity landscape shifts
    tw("on_switch_failure", [0])
    stats = tw.t.preplan_cache_stats()
    assert stats["stale"] == 1 and stats["hits"] == 0
    assert not tw.t.degraded_events[-1]["cache_hit"]
    assert (tw.t._residual >= 0).all()


def test_device_failure_recovery_is_cached():
    tw = mk(k=3)
    tw("preplan_failures", [[0], [1]])
    replans0 = tw.t.replans
    tw("on_failure", [0])                      # preplanned -> hit
    tw("on_recover", [0])                      # initial state memoized
    assert tw.t.replans == replans0
    assert tw.t.preplan_cache_stats()["hits"] == 2
    tw("on_failure", [5])                      # never preplanned -> miss
    assert tw.t.replans == replans0 + 1


def test_link_degrade_replans_with_updated_rho():
    tw = mk(k=3)
    u0 = tw.t.program.utilization
    topo = tw.t.topo0
    v = [v for v in range(topo.tree.n) if topo.tree.parent[v] == 0][0]
    tw("on_link_degrade", {v: 0.5})
    degraded = degrade_links(topo, {v: 0.5})
    assert tw.t.program.utilization == pytest.approx(
        soar(degraded.tree, degraded.load, 3).cost)
    assert tw.t.program.utilization >= u0
    tw.raises(ValueError, "positive finite", "on_link_degrade", {v: 0.0})
    replans0 = tw.t.replans
    tw("on_link_degrade", {v: 1.0})
    assert tw.t.program.utilization == u0 and tw.t.replans == replans0


def test_engine_cache_stats_includes_preplan():
    """The port's engine telemetry (no jit caches) plus the preplan
    sub-dict, which equals the JAX orchestrator's."""
    tw = mk(k=2)
    tw("preplan_failures", [[0]])
    tw("on_failure", [0])
    stats = tw.t.engine_cache_stats()
    assert stats["preplan"] == tw.t.preplan_cache_stats()
    assert stats["preplan"] == tw.j.engine_cache_stats()["preplan"]
    assert {k: v for k, v in stats.items() if k != "preplan"} == \
        cache_stats()
    assert sorted(stats) == ["distinct_layouts", "forests_built",
                             "kernels_built", "preplan"]
