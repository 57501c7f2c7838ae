"""The port's batched solve on the CPU vs the JAX engine and the serial DP.

Same numpy-seeded instances through ``repro.engine`` (float32, fused jnp
path) and ``repro_torch.engine`` with ``device="cpu"`` (float32 unless
stated). Tolerances:

* dyadic rates (BT "constant"/"exponential", rpa, rates in 1/8 steps):
  masks and costs bitwise equal to the JAX engine and to the float64
  serial ``soar`` (every sum is exact in float32);
* "linear" and uniform random rates: costs to rtol 1e-6 against the
  serial solver (float32 rounding), masks optimal when re-measured by
  ``phi`` to the same rtol;
* float64 tables: costs to rtol 1e-12 against the serial solver.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.engine import EngineOptions as JOptions
from repro.engine import color_batch as j_color_batch
from repro.engine import gather_batch as j_gather_batch
from repro.engine import solve_batch as j_solve_batch
from repro.engine import solve_forest as j_solve_forest
from repro_torch import core as tcore
from repro_torch.core.forest import forest_from_arrays
from repro_torch.engine import (EngineOptions, cache_stats, color_batch,
                                gather_batch, solve_batch, solve_forest)

CPU = EngineOptions(device="cpu")


def _pair(parent, rho):
    """The same tree in both packages."""
    return jcore.Tree(parent, rho), tcore.Tree(parent, rho)


def _ragged(seed, B, n_hi=24, dyadic=True):
    """B ``random_tree`` instances of random size, loads and availability;
    ``dyadic`` rounds the rates to 1/8 steps (exact in float32)."""
    rng = np.random.default_rng(seed)
    jt, tt, loads, avails = [], [], [], []
    for _ in range(B):
        n = int(rng.integers(1, n_hi + 1))
        t = tcore.random_tree(n, seed=int(rng.integers(1 << 30)))
        rho = np.maximum(np.round(t.rho * 8), 1) / 8 if dyadic else t.rho
        a, b = _pair(t.parent, rho)
        jt.append(a)
        tt.append(b)
        loads.append(rng.integers(0, 7, size=n))
        avails.append(rng.random(n) < 0.7)
    return jt, tt, loads, avails


def _bitwise(got, want):
    assert np.array_equal(got.costs, want.costs)
    if want.blue is None:
        assert got.blue is None
    else:
        assert np.array_equal(got.blue, want.blue)


def _check_serial(trees, loads, avails, k, res, rtol=0.0):
    for b, t in enumerate(trees):
        av = None if avails is None else avails[b]
        ref = tcore.soar(t, loads[b], k, avail=av)
        blue = res.blue_of(b)
        np.testing.assert_allclose(res.costs[b], ref.cost, rtol=rtol, atol=0)
        np.testing.assert_allclose(tcore.phi(t, loads[b], blue), ref.cost,
                                   rtol=rtol, atol=0)
        assert blue.sum() <= k
        if av is not None:
            assert not np.any(blue & ~av)
        if rtol == 0.0:
            assert np.array_equal(blue, ref.blue)


@pytest.mark.parametrize("scheme,k", [("constant", 0), ("constant", 5),
                                      ("exponential", 3),
                                      ("exponential", 70)])
def test_bt_bitwise_vs_jax_and_serial(scheme, k):
    jt, tt = jcore.bt(64, scheme), tcore.bt(64, scheme)
    loads = [tcore.sample_load(tt, "power-law", seed=s) for s in range(6)]
    got = solve_batch([tt] * 6, loads, k, options=CPU)
    _bitwise(got, j_solve_batch([jt] * 6, loads, k))
    _check_serial([tt] * 6, loads, None, k, got)


@pytest.mark.parametrize("seed,k,cap", [(0, 0, True), (1, 2, True),
                                        (2, 5, False)])
def test_ragged_with_avail_bitwise(seed, k, cap):
    jt, tt, loads, avails = _ragged(seed, 10)
    got = solve_batch(tt, loads, k, avails,
                      options=CPU.replace(cap=cap))
    _bitwise(got, j_solve_batch(jt, loads, k, avails,
                                options=JOptions(cap=cap)))
    _check_serial(tt, loads, avails, k, got)


def test_rpa_bitwise():
    jt = [jcore.rpa(48, seed=s) for s in range(4)]
    tt = [tcore.rpa(48, seed=s) for s in range(4)]
    loads = [tcore.sample_load(t, "power-law", seed=s)
             for s, t in enumerate(tt)]
    rng = np.random.default_rng(1)
    avails = [rng.random(t.n) < 0.8 for t in tt]
    got = solve_batch(tt, loads, 6, avails, options=CPU)
    _bitwise(got, j_solve_batch(jt, loads, 6, avails))
    _check_serial(tt, loads, avails, 6, got)


def test_non_dyadic_rates_within_float32():
    """Linear BT rates and uniform random rates: float32 rounding, so the
    serial costs hold to rtol 1e-6 and the masks are optimal by phi."""
    tt = tcore.bt(32, "linear")
    loads = [tcore.sample_load(tt, "uniform", seed=s) for s in range(4)]
    got = solve_batch([tt] * 4, loads, 4, options=CPU)
    _check_serial([tt] * 4, loads, None, 4, got, rtol=1e-6)
    _, rt, rl, ra = _ragged(4, 6, dyadic=False)
    got = solve_batch(rt, rl, 3, ra, options=CPU)
    _check_serial(rt, rl, ra, 3, got, rtol=1e-6)


def test_float64_vs_serial():
    tt = tcore.bt(32, "linear")
    loads = [tcore.sample_load(tt, "power-law", seed=s) for s in range(3)]
    got = solve_batch([tt] * 3, loads, 5,
                      options=CPU.replace(dtype=torch.float64))
    _check_serial([tt] * 3, loads, None, 5, got, rtol=1e-12)


def test_costs_only_and_bytes_to_host():
    jt, tt = jcore.bt(32, "constant"), tcore.bt(32, "constant")
    loads = [tcore.sample_load(tt, "power-law", seed=s) for s in range(4)]
    f = tcore.build_forest([tt] * 4, loads)
    got = solve_forest(f, 4, options=CPU.replace(color=False))
    want = j_solve_forest(jcore.build_forest([jt] * 4, loads), 4,
                          options=JOptions(color=False))
    _bitwise(got, want)
    assert got.bytes_to_host == want.bytes_to_host == 4 * 4
    with pytest.raises(ValueError):
        got.blue_of(0)
    full = solve_forest(f, 4, options=CPU)
    assert full.tables is None
    assert full.bytes_to_host == full.blue.nbytes + 4 * 4  # masks + f32


def test_debug_tables_and_host_color_match_jax():
    jt, tt, loads, avails = _ragged(3, 5, n_hi=16)
    jf = jcore.build_forest(jt, loads, avails)
    tf = tcore.build_forest(tt, loads, avails)
    X = gather_batch(tf, 4, options=CPU)
    Xj = j_gather_batch(jf, 4)
    assert np.array_equal(X, Xj)
    assert np.array_equal(color_batch(tf, X, 4), j_color_batch(jf, Xj, 4))
    dbg = solve_forest(tf, 4, options=CPU.replace(debug_tables=True))
    _bitwise(dbg, solve_forest(tf, 4, options=CPU))
    assert np.array_equal(dbg.tables, X)


def test_rho_overrides_bitwise_vs_jax():
    jt, tt, loads, avails = _ragged(6, 6, n_hi=18)
    jf = jcore.build_forest(jt, loads, avails)
    tf = tcore.build_forest(tt, loads, avails)
    rng = np.random.default_rng(2)
    scale = rng.integers(1, 9, size=(tf.batch, tf.n_max)) / 4.0
    extra = rng.integers(0, 17, size=tf.batch) / 8.0
    _bitwise(solve_forest(tf, 3, options=CPU, rho_scale=scale),
             j_solve_forest(jf, 3, rho_scale=scale))
    _bitwise(solve_forest(tf, 3, options=CPU, rho_scale=scale,
                          rho_root_add=extra),
             j_solve_forest(jf, 3, rho_scale=scale, rho_root_add=extra))
    with pytest.raises(ValueError):
        solve_forest(tf, 3, options=CPU, rho_root_add=extra)
    with pytest.raises(ValueError):
        solve_forest(tf, 3, options=CPU.replace(debug_tables=True),
                     rho_scale=scale)


def _fields(f):
    return {fl.name: getattr(f, fl.name) for fl in dataclasses.fields(f)}


def test_build_forest_matches_jax_field_by_field():
    jt, tt, loads, avails = _ragged(8, 7)
    for bucket in (True, False):
        jf = jcore.build_forest(jt, loads, avails, bucket=bucket)
        tf = tcore.build_forest(tt, loads, avails, bucket=bucket)
        jfl, tfl = _fields(jf), _fields(tf)
        assert jfl.keys() == tfl.keys()
        for name in jfl:
            if name == "trees":
                continue
            a, b = jfl[name], tfl[name]
            if name == "levels":
                assert len(a) == len(b)
                assert all(np.array_equal(x, y) for x, y in zip(a, b))
            elif isinstance(a, tuple):
                assert a == b, name
            else:
                assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_forest_from_arrays_round_trip():
    jt, tt, loads, avails = _ragged(9, 5)
    jf = jcore.build_forest(jt, loads, avails)
    fields = _fields(jf)
    fields["trees"] = tuple((t.parent, t.rho) for t in jf.trees)
    f = forest_from_arrays(fields)
    ref = tcore.build_forest(tt, loads, avails)
    for name, val in _fields(ref).items():
        if name not in ("trees", "levels") and not isinstance(val, tuple):
            assert np.array_equal(getattr(f, name), val), name
    assert tcore.layout_key(f) == tcore.layout_key(ref)
    _bitwise(solve_forest(f, 3, options=CPU),
             solve_forest(ref, 3, options=CPU))
    with pytest.raises(ValueError, match="missing"):
        forest_from_arrays({k: v for k, v in fields.items() if k != "kid"})


def test_options_reject_unknown_and_removed():
    tt = tcore.bt(8, "constant")
    load = tcore.sample_load(tt, "uniform", seed=0)
    with pytest.raises(TypeError, match="did you mean 'cap'"):
        solve_batch([tt], [load], 2, cpa=False)
    for removed in ("use_pallas", "interpret"):
        with pytest.raises(TypeError, match="unknown engine option"):
            solve_batch([tt], [load], 2, **{removed: True})
        with pytest.raises(TypeError):
            EngineOptions(**{removed: True})
    with pytest.raises(TypeError, match="options=EngineOptions"):
        solve_batch([tt], [load], 2, device="cpu")
    with pytest.raises(TypeError, match="both"):
        solve_batch([tt], [load], 2, options=CPU, cap=False)
    with pytest.raises(ValueError):
        solve_batch([tt], [load], -1, options=CPU)
    assert {"kernels_built", "forests_built",
            "distinct_layouts"} <= set(cache_stats())
