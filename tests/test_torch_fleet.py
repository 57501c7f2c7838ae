"""The port's fleet loop, in-loop admission and the loop's rounding on the
CPU vs the JAX package.

Mirrors ``tests/test_fleet.py`` and ``tests/test_admission_device.py``
(the ``Orchestrator``, preplan and preemption cases wait for the
runtime's port): the N = 1 fleet is ``solve_congestion`` bit for bit, the
fleet loop with a shared core and the admission ledgers equal the JAX
loop and the port's own host loop bitwise, round for round. Tolerances:
none (dyadic rates, integer ledgers).

The loop's updates ``1 + x * y`` round once, as XLA's jitted CPU code
computes them (a fused multiply-add; probed on this package's JAX loop).
``_fma_rn`` is held here to an exact rational oracle, and the port's
round against the jitted JAX round on inputs where one and two roundings
differ. That comparison assumes an x86-64 host with FMA, where XLA
contracts.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core as jcore
import repro.engine as jengine
from repro.collectives import build_fleet as j_build_fleet
from repro.collectives import plan_fleet as j_plan_fleet
from repro.engine.congestion import _penalty_step
from repro_torch import core as tcore
from repro_torch.collectives import (Fleet, FleetPlan, TenantPlan,
                                     build_fleet, fleet_tree,
                                     plan_congestion, plan_fleet)
from repro_torch.core.congestion import measure_fleet_multi
from repro_torch.engine import EngineOptions, solve_congestion, solve_fleet
from repro_torch.engine import congestion as tcong
from test_torch_congestion import assert_same_result

CPU = EngineOptions(device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jengine_tree(t):
    """The JAX package's copy of the port's tree ``t``."""
    return jcore.Tree(t.parent, t.rho)


def _assert_fleet_matches_single(fl, single):
    """FleetPlan(N=1) vs CongestionPlan: every observable, bitwise."""
    assert isinstance(fl, FleetPlan)
    assert_same_result(fl.result, single.result)
    for p, q in zip(fl.plans, single.plans, strict=True):
        assert isinstance(p, TenantPlan)
        assert np.array_equal(p.blue, q.blue)
        assert p.cost == q.cost


# ---------------------------------------------------------------------------
# N=1 degeneracy: plan_fleet IS plan_congestion, bit for bit


@pytest.mark.parametrize("seed,rho_weighted,dev", [
    (0, False, True), (1, True, False), (2, True, True), (3, False, False)])
def test_n1_fleet_round_trips_bit_identically(seed, rho_weighted, dev):
    rng = np.random.default_rng(seed)
    topo = fleet_tree(int(rng.integers(2, 4)), 2, int(rng.integers(2, 4)))
    T = int(rng.integers(2, 5))
    k = int(rng.integers(1, 4))
    kw = dict(max_rounds=3, rho_weighted=rho_weighted, device_loop=dev,
              record_rounds=True, options=CPU)
    single = plan_congestion(topo, k, count=T, **kw)
    fl = plan_fleet(Fleet.single(topo), k, counts=[T], **kw)
    _assert_fleet_matches_single(fl, single)


def test_n1_fleet_parity_with_avail_and_capacity():
    topo = fleet_tree(2, 2, 4)
    n = topo.tree.n
    av = np.ones(n, bool)
    av[3:6] = False
    cap = np.full(n, 2.0)
    kw = dict(max_rounds=4, record_rounds=True, cap_beta=2.0, cap_frac=0.5,
              options=CPU)
    single = plan_congestion(topo, 3, count=4, avails=[av] * 4,
                             capacity=cap, **kw)
    fl = plan_fleet(Fleet.single(topo), 3, counts=[4], avails=[av] * 4,
                    capacity=[cap], **kw)
    _assert_fleet_matches_single(fl, single)


# ---------------------------------------------------------------------------
# cross-tree coupling


def test_hot_shared_core_trades_placements_independent_solves_cannot():
    """Two trees contending on an expensive shared spine: the coupled
    solve sheds core traffic that per-tree solves cannot see, and equals
    the JAX package's plan."""
    fleet = build_fleet(2, 2, 2, 2, spine_rho=64.0)
    trees = [tp.tree for tp in fleet.topos]
    T_per, k = 4, 2
    tree_of = [0] * T_per + [1] * T_per
    loads = [fleet.topos[g].load for g in tree_of]

    coupled = plan_fleet(fleet, k, counts=[T_per, T_per],
                         rho_weighted=True, max_rounds=6, options=CPU)
    want = j_plan_fleet(j_build_fleet(2, 2, 2, 2, spine_rho=64.0), k,
                        counts=[T_per, T_per], rho_weighted=True,
                        max_rounds=6)
    assert_same_result(coupled.result, want.result)
    for p, q in zip(coupled.plans, want.plans, strict=True):
        assert np.array_equal(p.blue, q.blue) and p.cost == q.cost
        assert p.program.total_network_messages == \
            q.program.total_network_messages
    indep_blues = []
    for tp in fleet.topos:
        r = solve_congestion(tp.tree, [tp.load] * T_per, k,
                             rho_weighted=True, max_rounds=6, options=CPU)
        indep_blues.extend(np.asarray(r.blue[t]) for t in range(T_per))
    kw = dict(core_rho=fleet.core_rho, core_path=fleet.core_path,
              rho_weighted=True)
    m_cpl = measure_fleet_multi(trees, tree_of, loads,
                                [p.blue for p in coupled.plans], **kw)
    m_ind = measure_fleet_multi(trees, tree_of, loads, indep_blues, **kw)
    assert m_cpl.core_congestion.max() < m_ind.core_congestion.max()
    assert any(not np.array_equal(p.blue, b)
               for p, b in zip(coupled.plans, indep_blues, strict=True))


def _core_fleet():
    fleet = build_fleet(2, 2, 2, 2, spine_rho=8.0)
    trees = [tp.tree for tp in fleet.topos]
    tree_of = [0, 0, 0, 1, 1]
    loads = [tcore.sample_load(trees[g], "power-law", seed=10 + t)
             for t, g in enumerate(tree_of)]
    jtrees = [tp.tree for tp in j_build_fleet(2, 2, 2, 2,
                                              spine_rho=8.0).topos]
    return fleet, trees, jtrees, tree_of, loads


def test_fleet_device_host_bit_parity_with_core():
    """N = 2 trees and a shared core: the device loop, the host loop and
    the jitted JAX loop, bitwise, round for round."""
    fleet, trees, jtrees, tree_of, loads = _core_fleet()
    kw = dict(core_rho=fleet.core_rho, core_path=fleet.core_path,
              max_rounds=5, record_rounds=True, rho_weighted=True)
    dev = solve_fleet(trees, loads, tree_of, 2, device_loop=True,
                      options=CPU, **kw)
    host = solve_fleet(trees, loads, tree_of, 2, device_loop=False,
                       options=CPU, **kw)
    assert_same_result(dev, host)
    assert dev.core_congestion.shape == (fleet.n_core,)
    assert_same_result(dev, jengine.solve_fleet(jtrees, loads, tree_of, 2,
                                                **kw))


def test_global_link_id_space_layout():
    fleet = build_fleet(2, 2, 2, 2)
    n0, n1 = (tp.tree.n for tp in fleet.topos)
    assert fleet.link_offsets == (0, n0)
    assert fleet.core_offset == n0 + n1
    assert fleet.n_links == n0 + n1 + fleet.n_core
    fl = plan_fleet(fleet, 2, counts=[2, 2], max_rounds=2, options=CPU)
    assert fl.result.congestion.shape == (fleet.n_links,)
    assert fl.result.core_congestion.shape == (fleet.n_core,)
    assert np.array_equal(fl.result.congestion[fleet.core_offset:],
                          fl.result.core_congestion)
    assert np.array_equal(np.asarray(fl.tree_of), [0, 0, 1, 1])
    assert fl.core_congestion is fl.result.core_congestion
    for t, p in enumerate(fl.plans):
        assert p.blue.shape == (fleet.topos[fl.tree_of[t]].tree.n,)


# ---------------------------------------------------------------------------
# call-boundary validation: the JAX package's messages


def _both(call):
    """Run ``call`` on both packages; both raise the same error."""
    from repro import collectives as J
    from repro_torch import collectives as T
    errors = []
    for pkg in (J, T):
        with pytest.raises((TypeError, ValueError)) as e:
            call(pkg)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("call", [
    lambda m: m.plan_fleet(m.fleet_tree(2, 2, 2), 2, counts=[1]),
    lambda m: m.plan_fleet(m.Fleet.single(m.fleet_tree(2, 2, 2)), 2),
    lambda m: m.plan_fleet(m.Fleet.single(m.fleet_tree(2, 2, 2)), 2,
                           loads=[np.ones(7)], tree_of=[0], counts=[1]),
    lambda m: m.plan_fleet(m.Fleet.single(m.fleet_tree(2, 2, 2)), 2,
                           loads=[np.ones(7)]),
    lambda m: m.plan_fleet(m.Fleet.single(m.fleet_tree(2, 2, 2)), 2,
                           counts=[1], tree_of=[0]),
    lambda m: m.plan_fleet(m.build_fleet(2, 2, 2, 2), 2, counts=[2]),
    lambda m: m.plan_fleet(m.Fleet.single(m.fleet_tree(2, 2, 2)), 2,
                           loads=[np.ones(7)] * 2, tree_of=[0]),
    lambda m: m.plan_fleet(m.Fleet.single(m.fleet_tree(2, 2, 2)), 2,
                           loads=[np.ones(7)], tree_of=[1]),
    lambda m: m.plan_fleet(m.Fleet.single(m.fleet_tree(2, 2, 2)), 2,
                           counts=[2], avails=[None]),
    lambda m: m.plan_fleet(m.build_fleet(2, 2, 2, 2), 2, counts=[1, 1],
                           capacity=[np.ones(7)]),
    lambda m: m.plan_fleet(m.Fleet.single(m.fleet_tree(2, 2, 2)), 2,
                           counts=[1], capacity=[np.ones(3)]),
    lambda m: m.plan_fleet(m.build_fleet(2, 2, 2, 2), 2, counts=[1, 1],
                           residual=[np.ones(7)]),
    lambda m: m.plan_congestion(m.fleet_tree(2, 2, 2), 2, count=3,
                                avails=[None, None]),
    lambda m: m.plan_congestion(m.fleet_tree(2, 2, 2), 2, count=2,
                                capacity=np.ones(3)),
    lambda m: m.plan_congestion(m.fleet_tree(2, 2, 2), 2, count=2,
                                capacity=np.full(7, np.nan)),
    lambda m: m.plan_congestion(m.fleet_tree(2, 4, 4), 3, count=2,
                                residual=np.ones(12, np.int64)),
    lambda m: m.plan_congestion(m.fleet_tree(2, 4, 4), 3, count=2,
                                residual=np.full(11, 0.5)),
    lambda m: m.plan_congestion(m.fleet_tree(2, 4, 4), 3, count=2,
                                residual=np.full(11, -2)),
])
def test_planner_validation_matches_jax(call):
    _both(call)


def test_plan_congestion_residual_admits_within_the_ledger():
    topo = fleet_tree(2, 4, 4)
    n = topo.tree.n
    cp = plan_congestion(topo, 3, count=2, residual=np.full(n, 2),
                         options=CPU)
    claims = np.zeros(n, np.int64)
    for p in cp.plans:
        claims += p.blue
    assert (claims <= 2).all()


# ---------------------------------------------------------------------------
# in-loop admission: device loop vs host ledger vs JAX


def _adm_fleet(n=64, T=12):
    t = tcore.bt(n, "constant")
    loads = [tcore.sample_load(t, "power-law", seed=100 + s)
             for s in range(T)]
    return t, loads


def _adm_kw(t, loads, config):
    kw = dict(residual=np.full(t.n, 3, np.int64))
    if config == "rho_weighted":
        kw["rho_weighted"] = True
    elif config == "avail":
        av = np.ones(t.n, bool)
        av[5:9] = False
        kw["avail"] = [av if i % 2 else None for i in range(len(loads))]
    elif config == "priced":
        kw.update(capacity=np.full(t.n, 3.0), cap_beta=1.5, cap_frac=0.5)
    elif config == "tight":
        kw["residual"] = np.full(t.n, 1, np.int64)   # heavy truncation
    return kw


@pytest.mark.parametrize("config", ["plain", "rho_weighted", "avail",
                                    "priced", "tight"])
def test_admission_device_bit_identical_to_host_ledger(config):
    t, loads = _adm_fleet()
    kw = _adm_kw(t, loads, config)
    dev = solve_congestion(t, loads, 4, record_rounds=True,
                           device_loop=True, options=CPU, **kw)
    host = solve_congestion(t, loads, 4, record_rounds=True,
                            device_loop=False, options=CPU, **kw)
    assert_same_result(dev, host)
    assert dev.admission_log is not None and len(dev.admission_log) == \
        dev.rounds


def test_admission_equals_jitted_jax():
    """Heavy truncation (one claim a switch) under capacity pricing: the
    port's loop equals the jitted JAX loop, drops and ledgers included."""
    t, loads = _adm_fleet()
    kw = _adm_kw(t, loads, "priced")
    kw["residual"] = np.full(t.n, 1, np.int64)
    got = solve_congestion(t, loads, 4, record_rounds=True, options=CPU,
                           **kw)
    want = jengine.solve_congestion(jengine_tree(t), loads, 4,
                                    record_rounds=True, **kw)
    assert sum(int(d.sum()) for d in got.admission_log) > 0
    assert_same_result(got, want)


@pytest.mark.parametrize("device_loop", [True, False])
def test_admission_placements_feasible_wholesale(device_loop):
    t, loads = _adm_fleet()
    residual = np.full(t.n, 2, np.int64)
    res = solve_congestion(t, loads, 4, residual=residual,
                           device_loop=device_loop, options=CPU)
    claims = res.blue.sum(axis=0).astype(np.int64)
    assert (claims <= residual).all()
    after, = res.residual_after
    assert np.array_equal(after, residual - claims)
    assert (after >= 0).all()
    assert res.admission_dropped.shape == (len(loads),)
    assert (res.admission_dropped >= 0).all()


@pytest.mark.parametrize("device_loop", [True, False])
def test_admission_zero_residual_switches_are_hard_unavailable(device_loop):
    t, loads = _adm_fleet(T=4)
    residual = np.full(t.n, 2, np.int64)
    residual[3:10] = 0
    res = solve_congestion(t, loads, 4, residual=residual,
                           device_loop=device_loop, options=CPU)
    assert not res.blue[:, 3:10].any()


def test_admission_fleet_per_tree_ledgers_bit_identical():
    fleet = build_fleet(2, 2, 2, 4)
    trees = [tp.tree for tp in fleet.topos]
    tree_of = [0, 0, 0, 1, 1, 1]
    loads = [tcore.sample_load(trees[g], "power-law", seed=7 + i)
             for i, g in enumerate(tree_of)]
    residual = [np.full(tr.n, 2, np.int64) for tr in trees]
    kw = dict(core_rho=fleet.core_rho, core_path=fleet.core_path,
              residual=residual, record_rounds=True)
    dev = solve_fleet(trees, loads, tree_of, 3, device_loop=True,
                      options=CPU, **kw)
    host = solve_fleet(trees, loads, tree_of, 3, device_loop=False,
                       options=CPU, **kw)
    assert_same_result(dev, host)
    jtrees = [jengine_tree(tr) for tr in trees]
    assert_same_result(dev, jengine.solve_fleet(jtrees, loads, tree_of, 3,
                                                **kw))
    for g, tr in enumerate(trees):
        rows = [i for i, gg in enumerate(tree_of) if gg == g]
        claims = dev.blue[rows, : tr.n].sum(axis=0).astype(np.int64)
        assert (claims <= residual[g]).all()
        assert np.array_equal(dev.residual_after[g], residual[g] - claims)


@pytest.mark.parametrize("call", [
    lambda S, t, L: S(t, L, 2, capacity=np.full(t.n, 2.0), cap_frac=0.0),
    lambda S, t, L: S(t, L, 2, capacity=np.full(t.n, 2.0), cap_frac=1.5),
    lambda S, t, L: S(t, L, 2, capacity=np.full(t.n, 2.0),
                      cap_frac=float("nan")),
    lambda S, t, L: S(t, L, 2, capacity=np.full(t.n, 2.0),
                      cap_beta=float("inf")),
    lambda S, t, L: S(t, L, 2, capacity=np.where(np.arange(t.n) == 0, -1.0,
                                                 2.0)),
    lambda S, t, L: S(t, L, 2, residual=np.full(t.n - 1, 2, np.int64)),
    lambda S, t, L: S(t, L, 2, residual=np.full(t.n, 1.5)),
    lambda S, t, L: S(t, L, 2, residual=np.where(np.arange(t.n) == 2, -1,
                                                 2)),
])
def test_solve_boundary_rejects_malformed_knobs(call):
    t, loads = _adm_fleet(n=16, T=2)
    with pytest.raises(ValueError) as je:
        call(jengine.solve_congestion, jengine_tree(t), loads)
    with pytest.raises(ValueError) as te:
        call(lambda *a, **kw: solve_congestion(*a, options=CPU, **kw), t,
             loads)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# the loop's rounding: one rounding for 1 + x * y, as XLA contracts it


def _round_f32(x: Fraction) -> np.float32:
    """The float32 nearest the rational ``x``, ties to the even one."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.array(c).view(np.int32)) & 1))


def _oracle_fma(a, b, c):
    return np.asarray([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                  + Fraction(float(z)))
                       for x, y, z in zip(a, b, c, strict=True)], np.float32)


def _two_roundings(a, b, c):
    return (a * b).astype(np.float32) + c


def _midpoint_cases():
    """a * b + c on, or a float64 rounding away from, a float32 midpoint.

    Near-midpoints land on the midpoint in float64 and sit on the side of
    the odd neighbour, where rounding the float64 sum to even is wrong:
    (1 + j 2^-23) * 3 2^-24 (1 - j 2^-23) + 1 is 3 j^2 2^-70 under 1 +
    3 2^-24, and its negation plus 1 + 2^-22 as far over 1 + 2^-24 (j
    even keeps b a float32). Exact midpoints round to even.
    """
    a, b, c = [], [], []
    for j in range(2, 64, 2):
        for sign, z in ((1.0, 1.0), (-1.0, 1.0 + 2.0 ** -22)):
            a.append(sign * (1 + j * 2.0 ** -23))
            b.append(3 * 2.0 ** -24 * (1 - j * 2.0 ** -23))
            c.append(z)
    for m in range(1, 40):
        for scale, z in ((2.0 ** -24, 1.0), (2.0 ** -23, 2.0)):
            a.append(float(2 * m + 1))
            b.append(scale)
            c.append(z)
    return tuple(np.asarray(v, np.float32) for v in (a, b, c))


def _probe_cases(n=200_000, seed=0, cmax=4999):
    """The loop's own operands where two roundings and one differ: a ramp
    of alpha (``2 * (1 + t / 63)``), and a tenant's count over C_max."""
    rng = np.random.default_rng(seed)
    ramp = (1.0 + rng.integers(0, 64, n) / 63).astype(np.float32)
    a = (np.float32(2.0) * ramp).astype(np.float32)
    m = rng.integers(1, cmax, n)
    b = m.astype(np.float32) / np.float32(cmax)
    c = np.ones(n, np.float32)
    # selected apart from the code under test: the float64 sum rounded
    # once more is right off float32 midpoints, which these are not
    fused = (a.astype(np.float64) * b + c).astype(np.float32)
    differ = np.nonzero(fused != _two_roundings(a, b, c))[0][:2000]
    return a[differ], b[differ], c[differ], m[differ]


@pytest.mark.parametrize("cases", ["probe", "midpoints"])
def test_fma_rn_matches_exact_rational_oracle(cases):
    a, b, c = _probe_cases()[:3] if cases == "probe" else _midpoint_cases()
    assert a.size >= 20
    want = _oracle_fma(a, b, c)
    got = np.concatenate([
        tcong._fma_rn(torch.as_tensor(a[c == z]), torch.as_tensor(b[c == z]),
                      float(z)).numpy() for z in np.unique(c)])
    want = np.concatenate([want[c == z] for z in np.unique(c)])
    assert np.array_equal(got, want)
    # the cases discriminate: two roundings, and one float64 sum rounded
    # to float32 (no round-to-odd), each get some of them wrong
    assert (_two_roundings(a, b, c) != _oracle_fma(a, b, c)).any()
    if cases == "midpoints":
        naive = (a.astype(np.float64) * b + c).astype(np.float32)
        assert (naive != _oracle_fma(a, b, c)).any()


def _quantized(w, boost):
    q = np.round((w * boost).astype(np.float32) / np.float32(1 / 1024))
    return np.minimum(q * np.float32(1 / 1024), np.float32(8.0))


def test_reweight_rounds_once_where_two_roundings_differ(monkeypatch):
    """``_reweight`` on hot links whose boost rounds differently once and
    twice, each at a weight whose quantization tells the two apart: equal
    to the exact oracle and to JAX's ``_reweight`` jitted, and a
    two-rounding spelling fails every row."""
    import jax
    from repro.engine.congestion import _reweight as j_reweight
    cmax = 4999
    a, b, c, m = (x[:48] for x in _probe_cases(cmax=cmax))
    one, two = _oracle_fma(a, b, c), _two_roundings(a, b, c)
    grid = np.arange(1024, 8192, dtype=np.float32)[None, :] / 1024
    hit = _quantized(grid, one[:, None]) != _quantized(grid, two[:, None])
    keep = hit.any(axis=1)
    assert keep.sum() >= 20
    w = grid[0, hit[keep].argmax(axis=1)][:, None]
    a, m, one, two = a[keep, None], m[keep, None], one[keep, None], \
        two[keep, None]
    f32 = np.float32
    args = (w, m, np.full_like(w, cmax), f32(cmax), a, a / 2, f32(0.75),
            f32(8.0), np.ones_like(w), np.zeros_like(w), f32(1.0))
    want = _quantized(w, one)
    assert (want != _quantized(w, two)).all()
    jitted = jax.jit(j_reweight, static_argnames="priced")(
        *(jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
          for x in args), priced=False)
    assert np.array_equal(np.asarray(jitted), want)
    port = lambda: tcong._reweight(*(torch.as_tensor(x) for x in args),
                                   priced=False).numpy()
    assert np.array_equal(port(), want)
    monkeypatch.setattr(tcong, "_fma_rn",
                        lambda a, b, c: (a * b).float() + c)
    assert (port() != want).all()


def _penalty_inputs(seed, priced, T=64, S=5000):
    rng = np.random.default_rng(seed)
    w = (rng.integers(1024, 8 * 1024, (T, S)) / 1024).astype(np.float32)
    msgs = rng.integers(0, 40, (T, S))
    blue = rng.random((T, S)) < 0.3
    link_w = (rng.integers(1, 50, (1, S)) / 8.0).astype(np.float32)
    cap = rng.integers(1, 6, (1, S)).astype(np.float32)
    ramp = (1.0 + np.arange(T) / max(1, T - 1))[:, None].astype(np.float32)
    alpha_t = (np.float32(2.0) * ramp).astype(np.float32)
    scal = [np.float32(v) for v in (0.75, 8.0, 1.5, 0.5)]
    return (w, np.ones((T, 0), np.float32), msgs, blue, np.zeros(T, int),
            np.zeros(T, int), link_w, np.zeros(0, np.float32),
            np.zeros((T, 0), bool), cap, alpha_t, ramp, *scal)


@pytest.mark.parametrize("priced", [False, True])
def test_round_penalty_equals_jitted_jax_where_roundings_differ(priced,
                                                                monkeypatch):
    """The port's round update on rounds where a two-rounding spelling of
    ``_reweight`` parts from the jitted JAX update: equal to JAX, and the
    two-rounding spelling is not."""
    runs = [_penalty_inputs(seed, priced) for seed in range(8)]

    def port():
        out = []
        for args in runs:
            t = [torch.as_tensor(x) for x in args]
            out.append(tcong._round_penalty(*t, n_trees=1,
                                            priced=priced)[3].numpy())
        return out

    want = []
    for args in runs:
        j = [jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
             for x in args]
        want.append(np.asarray(_penalty_step(*j, n_trees=1,
                                             priced=priced)[3]))
    got = port()
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g, w)
    monkeypatch.setattr(tcong, "_fma_rn",
                        lambda a, b, c: (a * b).float() + c)
    two = port()
    assert sum(int((g != w).sum()) for g, w in zip(two, want)) > 0
