"""The port's topology, program builder and planners vs the JAX package.

Topologies, blue masks and budgets are made with numpy from a seed and go
through ``repro.collectives`` and ``repro_torch.collectives``; the port
plans on ``EngineOptions(device="cpu")``. Everything here is integer or
exactly computed, so every comparison is equality: topology arrays, every
field of every program op, utilization and message counts, blue masks.
"""
import numpy as np
import pytest

import repro.collectives as J
import repro.core.baselines as jbase
import repro.core.reduce as jred
import repro_torch.collectives as T
import repro_torch.core.baselines as tbase
import repro_torch.core.reduce as tred
from repro.collectives.schedule import (CompactOp as JCompact,
                                        CompressOp as JCompress,
                                        FoldOp as JFold,
                                        PermuteRound as JPermute)
from repro.core.tree import Tree as JTree
from repro_torch.collectives.schedule import (CompactOp, CompressOp, FoldOp,
                                              PermuteRound)
from repro_torch.engine import EngineOptions

CPU = EngineOptions(device="cpu")
DIMS = [(1, 2, 2), (2, 2, 2), (1, 4, 2), (2, 2, 4)]
_OPS = {JPermute: PermuteRound, JCompress: CompressOp, JFold: FoldOp,
        JCompact: CompactOp}


def _same_topo(a, b):
    assert np.array_equal(a.tree.parent, b.tree.parent)
    assert np.array_equal(a.tree.rho, b.tree.rho)
    assert a.tree.rho.dtype == b.tree.rho.dtype
    assert np.array_equal(a.load, b.load)
    assert np.array_equal(a.device_leaf, b.device_leaf)
    for name in ("blocked", "cap_scale"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert np.array_equal(x, y) and x.dtype == y.dtype, name


def _carried(jt):
    """The JAX topology carried into the port field by field."""
    return T.topology_from_arrays(jt.tree.parent, jt.tree.rho,
                                  jt.device_leaf, jt.load, jt.blocked,
                                  jt.cap_scale)


def _same_program(a, b):
    """Every field of every op, in order, and the program's scalars."""
    assert (a.n_dev, a.n_slots, a.root_home, a.root_count) == (
        b.n_dev, b.n_slots, b.root_home, b.root_count)
    assert a.utilization == b.utilization
    assert a.total_network_messages == b.total_network_messages
    assert len(a.ops) == len(b.ops)
    for x, y in zip(a.ops, b.ops):
        assert _OPS[type(x)] is type(y)
        for name, vx in vars(x).items():
            vy = getattr(y, name)
            if isinstance(vx, np.ndarray):
                assert vx.dtype == vy.dtype and np.array_equal(vx, vy), name
            else:
                assert vx == vy, name


# -- topology ----------------------------------------------------------------

@pytest.mark.parametrize("build", ["fleet_tree", "chip_level_tree"])
@pytest.mark.parametrize("dims", [(2, 4, 4), (1, 2, 2), (2, 4, 8),
                                  (4, 8, 8)])
def test_builders_match(build, dims):
    a, b = getattr(J, build)(*dims), getattr(T, build)(*dims)
    _same_topo(a, b)
    _same_topo(a, _carried(a))
    assert a.n_devices == b.n_devices


def test_fault_functions_match():
    rng = np.random.default_rng(0)
    for dims in [(2, 2, 4), (2, 4, 8)]:
        ja, ta = J.chip_level_tree(*dims), T.chip_level_tree(*dims)
        n, nd = ja.tree.n, ja.n_devices
        for _ in range(4):
            dead = [int(d) for d in rng.choice(nd, size=3, replace=False)]
            sw = [int(s) for s in rng.choice(n, size=2, replace=False)]
            rates = {int(s): float(rng.choice([0.25, 0.5, 2.0]))
                     for s in rng.choice(n, size=3, replace=False)}
            scales = {int(s): float(rng.choice([0.0, 0.3, 0.5, 0.75]))
                      for s in rng.choice(n, size=3, replace=False)}
            chain = [(J.fail_devices, T.fail_devices, (dead,), {}),
                     (J.fail_switches, T.fail_switches, (sw[:1],), {}),
                     (J.fail_switches, T.fail_switches, (sw[1:],),
                      {"isolate": True}),
                     (J.degrade_links, T.degrade_links, (rates,), {}),
                     (J.degrade_switches, T.degrade_switches, (scales,), {}),
                     (J.degrade_switches, T.degrade_switches, (scales,), {})]
            for jf, tf, args, kw in chain:
                try:
                    ja = jf(ja, *args, **kw)
                except ValueError as e:      # e.g. a switch already failed
                    with pytest.raises(ValueError, match=str(e)[:20]):
                        tf(ta, *args, **kw)
                    continue
                ta = tf(ta, *args, **kw)
                _same_topo(ja, ta)
                assert np.array_equal(ja.candidates(), ta.candidates())
            ja, ta = J.chip_level_tree(*dims), T.chip_level_tree(*dims)


@pytest.mark.parametrize("call", [
    lambda m, t: m.fail_devices(t, [99]),
    lambda m, t: m.fail_devices(m.fail_devices(t, [1]), [1]),
    lambda m, t: m.fail_switches(t, [-1]),
    lambda m, t: m.degrade_links(t, {0: 0.0}),
    lambda m, t: m.degrade_switches(t, {0: 1.5}),
    lambda m, t: m.degrade_switches(t, {0: float("nan")}),
])
def test_fault_validation_matches(call):
    with pytest.raises(ValueError) as je:
        call(J, J.fleet_tree(2, 2, 2))
    with pytest.raises(ValueError) as te:
        call(T, T.fleet_tree(2, 2, 2))
    assert str(je.value) == str(te.value)


def test_build_fleet_matches():
    for kw in ({}, {"uplink_rho": 4.0}):
        a, b = J.build_fleet(3, 2, 2, 2, **kw), T.build_fleet(3, 2, 2, 2,
                                                             **kw)
        assert a.core_path == b.core_path
        assert np.array_equal(a.core_rho, b.core_rho)
        assert (a.link_offsets, a.core_offset, a.n_links) == (
            b.link_offsets, b.core_offset, b.n_links)
        for x, y in zip(a.topos, b.topos, strict=True):
            _same_topo(x, y)


def test_topology_from_arrays_validates():
    t = J.chip_level_tree(1, 2, 2)
    with pytest.raises(ValueError, match="load shape"):
        T.topology_from_arrays(t.tree.parent, t.tree.rho, t.device_leaf,
                               t.load[:-1])
    with pytest.raises(ValueError, match="cap_scale shape"):
        T.topology_from_arrays(t.tree.parent, t.tree.rho, t.device_leaf,
                               t.load, cap_scale=np.ones(2))


# -- cost model and baselines --------------------------------------------------

def test_reduce_cost_model_matches():
    rng = np.random.default_rng(2)
    assert [tred.agg_width(w, f) for w in range(6) for f in (0.01, 0.5, 1)] \
        == [jred.agg_width(w, f) for w in range(6) for f in (0.01, 0.5, 1)]
    for dims in DIMS:
        topo = J.fleet_tree(*dims)
        t, tt = topo.tree, T.fleet_tree(*dims).tree
        for _ in range(5):
            blue = rng.random(t.n) < 0.4
            scale = np.where(rng.random(t.n) < 0.3, 0.5, 1.0)
            for f in ("messages_up", "phi", "phi_barrier"):
                assert np.array_equal(getattr(jred, f)(t, topo.load, blue),
                                      getattr(tred, f)(tt, topo.load, blue))
            for f in ("messages_up_degraded", "phi_degraded"):
                assert np.array_equal(
                    getattr(jred, f)(t, topo.load, blue, scale),
                    getattr(tred, f)(tt, topo.load, blue, scale))
        for f in ("all_red", "all_blue"):
            assert np.array_equal(getattr(jred, f)(t), getattr(tred, f)(tt))
        assert np.array_equal(jred.mask_from_set(t, [0, 2]),
                              tred.mask_from_set(tt, [0, 2]))


@pytest.mark.parametrize("strategy", sorted(jbase.STRATEGIES))
def test_baselines_match(strategy):
    assert sorted(tbase.STRATEGIES) == sorted(jbase.STRATEGIES)
    rng = np.random.default_rng(4)
    topo, tt = J.fleet_tree(2, 4, 4), T.fleet_tree(2, 4, 4).tree
    for k in (0, 1, 3, 7):
        avail = rng.random(topo.tree.n) < 0.7
        for av in (None, avail):
            a = jbase.STRATEGIES[strategy](topo.tree, topo.load, k, av,
                                           seed=k)
            b = tbase.STRATEGIES[strategy](tt, topo.load, k, av, seed=k)
            assert np.array_equal(a, b)


# -- programs ----------------------------------------------------------------

def test_build_program_matches_pristine_and_degraded():
    """The random blues and degradations of the JAX package's
    ``test_degraded_program_bitwise_identical_to_pristine``."""
    rng = np.random.default_rng(1)
    kinds = set()
    for dims in DIMS:
        jt, tt = J.chip_level_tree(*dims), T.chip_level_tree(*dims)
        t = jt.tree
        rng.standard_normal((jt.n_devices, 3))      # keep the JAX stream
        for _ in range(12):
            blue = rng.random(t.n) < 0.5
            _same_program(J.build_program(jt, blue),
                          T.build_program(tt, blue))
            ks = rng.choice(t.n, size=int(rng.integers(1, 4)),
                            replace=False)
            scales = {int(s): float(rng.choice(
                [0.9, 0.75, 0.5, 0.25, 0.1, 0.01])) for s in ks}
            jp = J.build_program(J.degrade_switches(jt, scales), blue)
            tp = T.build_program(T.degrade_switches(tt, scales), blue)
            _same_program(jp, tp)
            kinds |= {type(op).__name__ for op in tp.ops}
    assert kinds == {"PermuteRound", "CompressOp", "FoldOp", "CompactOp"}


def test_build_program_rejects_like_jax():
    jt = J.fail_switches(J.chip_level_tree(1, 2, 2), [1])
    tt = _carried(jt)
    blue = np.zeros(jt.tree.n, bool)
    blue[1] = True
    for m, topo in ((J, jt), (T, tt)):
        with pytest.raises(ValueError, match="failed switch"):
            m.build_program(topo, blue)
    jz = J.degrade_switches(J.chip_level_tree(1, 2, 2), {1: 0.0})
    with pytest.raises(ValueError, match="zero-capacity"):
        T.build_program(_carried(jz), blue)
    # a load on a switch with children: the executor has no home for it
    inner = (np.array([-1, 0]), np.ones(2), np.array([0, 1]),
             np.array([1, 1]))
    jl = J.ClusterTopology(JTree(inner[0], inner[1]), inner[2], inner[3])
    for m, topo in ((J, jl), (T, T.topology_from_arrays(*inner))):
        with pytest.raises(ValueError, match="leaf-only"):
            m.build_program(topo, np.zeros(2, bool))


# -- planning ----------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["soar", "top", "max", "random"])
def test_plan_and_plan_batch_match(strategy):
    opts = {"options": CPU} if strategy == "soar" else {}
    base = J.chip_level_tree(2, 2, 2)
    faulty = J.degrade_switches(J.fail_switches(base, [1]), {2: 0.5})
    avail = np.random.default_rng(5).random(base.tree.n) < 0.8
    for k in (0, 2, 5):
        a = J.plan(base, k, strategy=strategy)
        b = T.plan(_carried(base), k, strategy=strategy, **opts)
        assert np.array_equal(a.blue, b.blue) and a.cost == b.cost
        _same_program(a.program, b.program)
    jb = J.plan_batch([base, faulty, base], 3, [None, None, avail],
                      strategy=strategy)
    tb = T.plan_batch([_carried(t) for t in (base, faulty, base)], 3,
                      [None, None, avail], strategy=strategy, **opts)
    for a, b in zip(jb, tb, strict=True):
        assert np.array_equal(a.blue, b.blue) and a.cost == b.cost
        _same_program(a.program, b.program)
    assert not tb[1].blue[1]                 # the failed switch stays red


def test_plan_boundary_errors():
    topo = T.chip_level_tree(1, 2, 2)
    with pytest.raises(ValueError, match="pairs them positionally"):
        T.plan_batch([topo, topo], 1, [None])
    with pytest.raises(ValueError, match="only apply to"):
        T.plan(topo, 1, strategy="top", options=CPU)
    with pytest.raises(ValueError, match="costs-only"):
        T.plan(topo, 1, options=CPU.replace(color=False))
    with pytest.raises(TypeError, match="did you mean"):
        T.plan(topo, 1, devise="cpu")
    assert T.plan_batch([], 1) == []


def _outcome(check, value):
    try:
        out = check(value, 4, "here")
    except ValueError as e:
        return str(e)
    return out.dtype, out.tolist()


@pytest.mark.parametrize("fn", ["_check_capacity", "_check_residual"])
def test_boundary_checks_match(fn):
    """The validators the congestion planners will use (copied now)."""
    import repro.collectives.schedule as js
    import repro_torch.collectives.schedule as ts
    for value in (np.ones(3), np.full(4, -1.0), np.array([1, 2, np.nan, 4]),
                  np.array([0.5, 1, 2, 3]), np.array([0, 1, 2, 3])):
        assert _outcome(getattr(js, fn), value) == _outcome(getattr(ts, fn),
                                                            value)
