"""The port's congestion measurement and penalty loop on the CPU vs the JAX
package, brute force and the serial solver.

Mirrors ``tests/test_congestion.py`` and ``tests/test_congestion_device.py``
(the ``Orchestrator`` cases wait for the runtime's port). The same
numpy-seeded instances go through ``repro`` (jitted, as ``solve_fleet``
runs it) and ``repro_torch`` with ``device="cpu"``. Tolerances: none.
Message counts are integers; on dyadic rates every round's effective rho,
masks, history, costs and congestion are bitwise equal to the JAX loop,
and the port's device loop bitwise equal to its host loop on any rates.
On the "linear" (non-dyadic) rates of
``test_device_loop_bit_identical_on_nondyadic_rates`` the port also equals
the JAX loop bitwise: both round the same float32 operations once each.

The bitwise comparison with JAX assumes an x86-64 host with FMA, where
XLA contracts the loop's ``1 + x * y`` updates into fused multiply-adds
(``repro_torch.engine.congestion._fma_rn`` spells that rounding exactly;
``tests/test_torch_fleet.py`` holds it against an exact oracle).
"""
from itertools import combinations, product

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.engine as jengine
from repro.collectives import fleet_tree as j_fleet_tree
from repro.collectives import plan_congestion as j_plan_congestion
from repro.core.congestion import messages_up_forest as j_messages_up_forest
from repro_torch import core as tcore
from repro_torch.collectives import (CongestionPlan, TenantPlan, fleet_tree,
                                     plan_congestion)
from repro_torch.core.congestion import (congestion_profile, max_congestion,
                                         messages_up_batch,
                                         messages_up_forest)
from repro_torch.engine import (EngineOptions, solve_batch,
                                solve_congestion)

CPU = EngineOptions(device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bt(n, scheme="constant"):
    return jcore.bt(n, scheme), tcore.bt(n, scheme)


def _fleet(n=64, T=8, scheme="constant"):
    jt, tt = _bt(n, scheme)
    loads = [tcore.sample_load(tt, "power-law", seed=100 + s)
             for s in range(T)]
    return jt, tt, loads


def _random_tree(rng, n_lo=5, n_hi=8):
    n = int(rng.integers(n_lo, n_hi))
    parent = np.full(n, tcore.DEST, np.int32)
    for v in range(1, n):
        parent[v] = int(rng.integers(0, v))
    return tcore.Tree(parent, rng.integers(1, 9, n) / 4.0)


def assert_same_result(a, b):
    """Two CongestionResults, every field but the transfer bill, bitwise."""
    assert a.history == b.history                       # f32 C_max, exact
    assert a.rounds == b.rounds
    assert a.best_round == b.best_round
    for name in ("blue", "costs", "msgs", "congestion", "tree_of",
                 "core_congestion", "admission_dropped"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        assert x is None or np.array_equal(x, y), name
    for name in ("max_congestion", "mean_congestion", "baseline_max",
                 "baseline_mean"):
        assert getattr(a, name) == getattr(b, name), name
    assert (a.rounds_log is None) == (b.rounds_log is None)
    for r, ((ae, ab), (be, bb)) in enumerate(
            zip(a.rounds_log or [], b.rounds_log or [], strict=True)):
        assert np.array_equal(ae, be), f"rho_eff differs at round {r}"
        assert np.array_equal(ab, bb), f"masks differ at round {r}"
    for name in ("residual_after", "admission_log"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        for r, (p, q) in enumerate(zip(x or [], y or [], strict=True)):
            assert np.array_equal(p, q), f"{name} differs at {r}"


# ---------------------------------------------------------------------------
# the messages sweep: equal to the host reference and to the JAX sweep
# ---------------------------------------------------------------------------

def test_messages_up_forest_bit_identical_to_host_and_jax():
    rng = np.random.default_rng(3)
    jt, tt, loads, blues = [], [], [], []
    for _ in range(12):
        n = int(rng.integers(1, 25))
        parent = np.full(n, tcore.DEST, np.int32)
        for v in range(1, n):
            parent[v] = int(rng.integers(0, v))
        rho = rng.integers(1, 32, n) / 8.0
        jt.append(jcore.Tree(parent, rho))
        tt.append(tcore.Tree(parent, rho))
        loads.append(rng.integers(0, 7, n))
        blues.append(rng.random(n) < 0.3)
    f = tcore.build_forest(tt, loads)
    B, n_max = f.mask.shape
    blue_pad = np.zeros((B, n_max), bool)
    for b, u in enumerate(blues):
        blue_pad[b, : len(u)] = u
    got = messages_up_forest(f, blue_pad, options=CPU)
    assert got.dtype == np.int64 and got.shape == (B, n_max)
    want = j_messages_up_forest(jcore.build_forest(jt, loads), blue_pad)
    assert np.array_equal(got, want)
    for b, (t, L, u) in enumerate(zip(tt, loads, blues)):
        host = messages_up_batch([t], [L], [u])[0]
        assert np.array_equal(got[b, : t.n], host)     # bit-identical
        assert got[b, t.n :].sum() == 0                # padding stays zero


def test_messages_up_forest_refuses_what_jax_refuses():
    t = tcore.bt(4)
    L = np.zeros(t.n, np.int64)
    L[-1] = 2 ** 31
    f = tcore.build_forest([t], [L])
    blue = np.zeros(f.mask.shape, bool)
    with pytest.raises(ValueError, match="overflows the device sweep"):
        messages_up_forest(f, blue, options=CPU)
    with pytest.raises(ValueError, match="blue shape"):
        messages_up_forest(f, blue[:, 1:], options=CPU)
    L[-1] = 2 ** 31 - 1                                # the largest accepted
    f = tcore.build_forest([t], [L])
    assert messages_up_forest(f, blue, options=CPU)[0, t.root] == L[-1]


def test_congestion_profile_shapes_and_weighting():
    jt, t = _bt(16)
    loads = [tcore.sample_load(t, "uniform", seed=s) for s in range(3)]
    blues = [np.zeros(t.n, bool)] * 3
    msgs = messages_up_batch([t] * 3, loads, blues)
    count = congestion_profile(msgs)
    timew = congestion_profile(msgs, t.rho)
    assert count.shape == timew.shape == (t.n,)
    assert np.array_equal(timew, count * t.rho)
    from repro.core.congestion import measure_fleet as j_measure_fleet
    for rw in (False, True):
        a = j_measure_fleet(jt, loads, blues, rw)
        b = tcore.measure_fleet(t, loads, blues, rw)
        for x, y in zip(a, b, strict=True):
            assert np.array_equal(x, y)


# ---------------------------------------------------------------------------
# the driver against brute-force min-max congestion (small trees)
# ---------------------------------------------------------------------------

def _brute_minmax(t, loads, k):
    """min over all per-tenant (<= k)-subsets of the max-link congestion."""
    subs = []
    for sz in range(k + 1):
        for c in combinations(range(t.n), sz):
            m = np.zeros(t.n, bool)
            m[list(c)] = True
            subs.append(m)
    best = None
    for combo in product(subs, repeat=len(loads)):
        prof = congestion_profile(
            messages_up_batch([t] * len(loads), loads, list(combo)))
        best = prof.max() if best is None else min(best, prof.max())
    return int(best)


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_driver_achieves_bruteforce_minmax(seed):
    rng = np.random.default_rng(seed)
    t = _random_tree(rng)
    loads = [rng.integers(0, 5, t.n) for _ in range(2)]
    res = solve_congestion(t, loads, 1, max_rounds=10, patience=3,
                           options=CPU)
    assert res.max_congestion == _brute_minmax(t, loads, 1)
    assert res.max_congestion < res.baseline_max       # strict improvement


@pytest.mark.parametrize("seed", range(8))
def test_driver_sandwiched_by_brute_and_baseline(seed):
    rng = np.random.default_rng(seed)
    t = _random_tree(rng)
    loads = [rng.integers(0, 5, t.n) for _ in range(2)]
    res = solve_congestion(t, loads, 1, max_rounds=10, patience=3,
                           options=CPU)
    assert _brute_minmax(t, loads, 1) <= res.max_congestion
    assert res.max_congestion <= res.baseline_max


# ---------------------------------------------------------------------------
# per-round placements equal the serial soar on the reweighted rho
# ---------------------------------------------------------------------------

def test_per_round_placements_bit_identical_to_serial_soar():
    t = tcore.bt(32, "constant")
    loads = [tcore.sample_load(t, "power-law", seed=s) for s in range(6)]
    res = solve_congestion(t, loads, 4, record_rounds=True, options=CPU)
    assert len(res.rounds_log) == res.rounds >= 2
    for r, (rho_eff, blue) in enumerate(res.rounds_log):
        for ti, L in enumerate(loads):
            ref = tcore.soar(tcore.Tree(t.parent, rho_eff[ti]), L, 4)
            assert np.array_equal(blue[ti], ref.blue), (r, ti)
    assert np.array_equal(res.rounds_log[0][0],
                          np.broadcast_to(t.rho, res.rounds_log[0][0].shape))


def test_fleet_scenario_reduction_and_convergence():
    """At T = 16 the loop cuts max-link congestion by at least 15% against
    the utilization-only solve, converges within the round bound, and
    returns the best round seen."""
    t = tcore.bt(128, "constant")
    T, k, max_rounds = 16, 8, 8
    loads = [tcore.sample_load(t, "power-law", seed=s) for s in range(T)]
    res = solve_congestion(t, loads, k, max_rounds=max_rounds, options=CPU)
    assert res.improvement >= 0.15
    assert res.best_round < res.rounds - 1 <= max_rounds - 1
    assert res.max_congestion == min(res.history)      # monotone best
    assert res.history[0] == res.baseline_max
    base = solve_batch([t] * T, loads, k, options=CPU)
    prof0 = congestion_profile(messages_up_batch(
        [t] * T, loads, [base.blue_of(b) for b in range(T)]))
    assert res.baseline_max == prof0.max()
    for ti, L in enumerate(loads):
        assert res.blue[ti].sum() <= k
        assert res.costs[ti] == tcore.phi(t, L, res.blue[ti])
    prof = congestion_profile(messages_up_batch([t] * T, loads,
                                                list(res.blue)))
    assert np.array_equal(prof, res.congestion)
    assert res.max_congestion == max_congestion(t, loads, list(res.blue))


# ---------------------------------------------------------------------------
# the loop against the jitted JAX loop, and device against host
# ---------------------------------------------------------------------------

def _config(t, loads, config):
    if config == "rho_weighted":
        return dict(rho_weighted=True)
    if config == "avail":
        av = np.ones(t.n, bool)
        av[5:9] = False
        return dict(avail=[av if i % 2 else None for i in range(len(loads))])
    if config == "priced":
        return dict(capacity=np.full(t.n, 3.0), cap_beta=1.5, cap_frac=0.5)
    return {}


@pytest.mark.parametrize("config", ["plain", "rho_weighted", "avail",
                                    "priced"])
def test_solve_congestion_equals_jitted_jax_round_for_round(config):
    jt, t, loads = _fleet()
    kw = _config(t, loads, config)
    want = jengine.solve_congestion(jt, loads, 4, record_rounds=True, **kw)
    got = solve_congestion(t, loads, 4, record_rounds=True, options=CPU,
                           **kw)
    assert got.rounds >= 2
    assert_same_result(got, want)


@pytest.mark.parametrize("config", ["plain", "rho_weighted", "avail",
                                    "priced"])
def test_device_loop_bit_identical_to_host_reference(config):
    _, t, loads = _fleet()
    kw = _config(t, loads, config)
    dev = solve_congestion(t, loads, 4, record_rounds=True,
                           device_loop=True, options=CPU, **kw)
    host = solve_congestion(t, loads, 4, record_rounds=True,
                            device_loop=False, options=CPU, **kw)
    assert_same_result(dev, host)


def test_device_loop_bit_identical_on_nondyadic_rates():
    # linear rates (1/(1+level)) are not exactly float32-representable, so
    # this checks that the paths share rounding, not that rounding is absent
    jt, t, loads = _fleet(scheme="linear")
    dev = solve_congestion(t, loads, 4, record_rounds=True,
                           rho_weighted=True, device_loop=True, options=CPU)
    host = solve_congestion(t, loads, 4, record_rounds=True,
                            rho_weighted=True, device_loop=False,
                            options=CPU)
    assert_same_result(dev, host)
    assert dev.history != [float(round(c)) for c in dev.history]
    want = jengine.solve_congestion(jt, loads, 4, record_rounds=True,
                                    rho_weighted=True)
    assert_same_result(dev, want)


def test_device_loop_transfer_accounting():
    """The device loop copies one flag a round and one buffer at the end:
    less than the host loop's per-round pulls, and not growing with the
    round count beyond the flags."""
    t = tcore.bt(128, "constant")
    loads = [tcore.sample_load(t, "power-law", seed=100 + s)
             for s in range(16)]
    dev = solve_congestion(t, loads, 8, device_loop=True, options=CPU)
    host = solve_congestion(t, loads, 8, device_loop=False, options=CPU)
    assert dev.history == host.history                 # same trajectory
    assert dev.rounds == host.rounds >= 2
    assert 0 < dev.bytes_to_host < host.bytes_to_host
    T, S = len(loads), dev.blue.shape[1]
    assert dev.bytes_to_host < 4 * T * S + 4 * len(dev.history) * T + 4096
    # best masks (bool), best round, history (float32), round-0 profile
    # (float32, one tree), dropped claims (int64), a flag a round
    f = tcore.build_forest([t] * T, loads)
    want = (T * f.n_slots + 8 + 4 * dev.rounds + 4 * f.n_slots + 8 * T
            + dev.rounds)
    assert dev.bytes_to_host == want


def test_capacity_pricing_steers_off_crowded_switches():
    _, t, loads = _fleet(n=64, T=12)
    base = solve_congestion(t, loads, 4, options=CPU)
    priced = solve_congestion(t, loads, 4, capacity=np.full(t.n, 2.0),
                              cap_beta=4.0, cap_frac=0.5, options=CPU)
    peak = lambda r: int(r.blue.sum(axis=0).max())
    assert peak(priced) <= peak(base)
    assert priced.max_congestion <= priced.baseline_max


def test_rho_weighted_congestion_mode():
    t = tcore.bt(32, "linear")
    loads = [tcore.sample_load(t, "power-law", seed=s) for s in range(4)]
    res = solve_congestion(t, loads, 3, rho_weighted=True, options=CPU)
    assert res.max_congestion == pytest.approx(
        max_congestion(t, loads, list(res.blue), rho_weighted=True))


# ---------------------------------------------------------------------------
# validation: the JAX package's messages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda S, t, L: S(t, [], 2),
    lambda S, t, L: S(t, [L], 2, max_rounds=0),
    lambda S, t, L: S(t, [L, L], 2, avail=[None]),
    lambda S, t, L: S(t, [L], 2, capacity=np.ones(3)),
    lambda S, t, L: S(t, [L], 2, residual=np.ones(3)),
    lambda S, t, L: S(t, [L], 2, capacity=np.full(t.n, 2.0), cap_frac=1.5),
    lambda S, t, L: S(t, [L], 2, capacity=np.full(t.n, 2.0), cap_beta=-1.0),
    lambda S, t, L: S(t, [L], 2, residual=np.full(t.n, 1.5)),
])
def test_driver_input_validation(call):
    jt, t = _bt(16)
    L = tcore.sample_load(t, "uniform", seed=0)
    with pytest.raises(ValueError) as je:
        call(jengine.solve_congestion, jt, L)
    with pytest.raises(ValueError) as te:
        call(lambda *a, **kw: solve_congestion(*a, options=CPU, **kw), t, L)
    assert str(te.value) == str(je.value)


def test_driver_rejects_engine_options_it_cannot_use():
    t = tcore.bt(16)
    L = tcore.sample_load(t, "uniform", seed=0)
    for opts, what in ((CPU.replace(color=False), "color=False"),
                       (CPU.replace(debug_tables=True), "debug_tables"),
                       (CPU.replace(dtype=torch.float64), "float32")):
        with pytest.raises(ValueError, match=what):
            solve_congestion(t, [L], 2, options=opts)
    with pytest.raises(TypeError, match="both options="):
        solve_congestion(t, [L], 2, options=CPU, cap=False)
    with pytest.raises(TypeError, match="did you mean 'dtype'"):
        solve_congestion(t, [L], 2, dtyp=torch.float32)
    with pytest.raises(TypeError, match="EngineOptions"):
        solve_congestion(t, [L], 2, cap=True, max_rounds=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solve_congestion(t, [L], 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            f = tcore.build_forest([t], [L])
            messages_up_forest(f, np.zeros(f.mask.shape, bool))


# ---------------------------------------------------------------------------
# planning over the loop
# ---------------------------------------------------------------------------

def test_plan_congestion_builds_the_jax_programs():
    jtopo, topo = j_fleet_tree(2, 4, 4), fleet_tree(2, 4, 4)
    rng = np.random.default_rng(5)
    loads = []
    for _ in range(6):
        L = topo.load.copy()
        L[rng.random(topo.tree.n) < 0.4] = 0           # a subset of racks
        loads.append(L)
    planned, res = plan_congestion(topo, 3, loads=loads, options=CPU)
    jplanned, jres = j_plan_congestion(jtopo, 3, loads=loads)
    assert_same_result(res, jres)
    assert len(planned) == 6
    for (blue, prog), (jblue, jprog), L, cost in zip(
            planned, jplanned, loads, res.costs, strict=True):
        assert np.array_equal(blue, jblue)
        assert prog.utilization == pytest.approx(tcore.phi(topo.tree, L,
                                                           blue))
        assert prog.utilization == pytest.approx(cost)
        assert blue.sum() <= 3
        assert (prog.n_dev, prog.n_slots, prog.root_home, prog.root_count,
                prog.utilization, prog.total_network_messages) == (
            jprog.n_dev, jprog.n_slots, jprog.root_home, jprog.root_count,
            jprog.utilization, jprog.total_network_messages)
        assert len(prog.ops) == len(jprog.ops)
        for op, jop in zip(prog.ops, jprog.ops, strict=True):
            assert type(op).__name__ == type(jop).__name__
            for name, v in vars(op).items():
                jv = getattr(jop, name)
                assert (np.array_equal(v, jv) if isinstance(v, np.ndarray)
                        else v == jv), name
    with pytest.raises(ValueError):
        plan_congestion(topo, 3)                       # loads xor count
    with pytest.raises(ValueError):
        plan_congestion(topo, 3, loads=loads, count=6)


def test_plan_congestion_returns_congestion_plan():
    topo = fleet_tree(2, 4, 4)
    cp = plan_congestion(topo, 3, count=4, max_rounds=4, options=CPU)
    assert isinstance(cp, CongestionPlan)
    planned, res = cp
    assert planned is cp.plans and res is cp.result
    assert len(cp.plans) == 4
    assert all(isinstance(p, TenantPlan) for p in cp.plans)
    assert cp.max_congestion == res.max_congestion
    assert cp.improvement == res.improvement
    for p in cp.plans:
        assert p.cost == p.program.utilization
