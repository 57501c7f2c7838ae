"""The port's vectorised gather (``repro_torch.core.soar_fast``) and
brute-force oracle (``core.brute``) on the CPU vs the JAX package's.

Mirrors ``tests/test_soar_fast.py``: every tree is built by each
package's own constructor and held equal first; the port's DP tables
equal the JAX ``soar_gather_vectorized``'s bitwise (``inf`` included), its
masks equal bitwise and its costs equal with ``==``; then the JAX test's
own checks run on the port's results. Tolerances: none against JAX; the
JAX test's rtol 1e-12 where it compares two algorithms.
"""
import importlib

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as C
from repro.core import brute as j_brute
from repro_torch.core import brute

# the modules (the packages export functions of the same name)
j_fast = importlib.import_module("repro.core.soar_fast")
soar_fast = importlib.import_module("repro_torch.core.soar_fast")


def same_tree(a, b):
    assert np.array_equal(a.parent, b.parent)
    assert a.rho.dtype == b.rho.dtype and np.array_equal(a.rho, b.rho)


def trees(name, *args, **kw):
    """``core.<name>(*args, **kw)`` of both packages, held equal."""
    a, b = getattr(J, name)(*args, **kw), getattr(C, name)(*args, **kw)
    same_tree(a, b)
    return a, b


def loads(jt, t, *args, **kw):
    a, b = J.sample_load(jt, *args, **kw), C.sample_load(t, *args, **kw)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    return b


def same_fast(jt, t, load, k, avail=None):
    """``soar_fast`` and its tables in both packages, held equal; the
    port's result."""
    xa = j_fast.soar_gather_vectorized(jt, load, k, avail)
    xb = soar_fast.soar_gather_vectorized(t, load, k, avail)
    assert xa.dtype == xb.dtype and np.array_equal(xa, xb)
    a = j_fast.soar_fast(jt, load, k, avail=avail)
    b = soar_fast.soar_fast(t, load, k, avail=avail)
    assert np.array_equal(a.blue, b.blue) and a.blue.dtype == b.blue.dtype
    assert type(a.cost) is type(b.cost) and a.cost == b.cost
    assert a.tables is None and b.tables is None
    return b


def test_exports_match_jax():
    for name in ("soar_fast", "soar_gather_vectorized", "minplus_batch",
                 "brute_force"):
        assert getattr(C, name) is not None, name
    assert C.soar_fast is soar_fast.soar_fast
    assert C.brute_force is brute.brute_force


@pytest.mark.parametrize("seed", range(6))
def test_fast_equals_reference_random(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 24))
    jt, t = trees("random_tree", n, seed=seed)
    load = rng.integers(0, 7, size=n)
    k = int(rng.integers(0, 6))
    avail = rng.random(n) < 0.7
    ref = C.soar(t, load, k, avail=avail)
    fast = same_fast(jt, t, load, k, avail)
    np.testing.assert_allclose(fast.cost, ref.cost, rtol=1e-12)
    np.testing.assert_allclose(C.phi(t, load, fast.blue), ref.cost,
                               rtol=1e-12)


@pytest.mark.parametrize("scheme", ["constant", "linear", "exponential"])
def test_fast_bt64(scheme):
    jt, t = trees("bt", 64, scheme)
    load = loads(jt, t, "power-law", seed=3)
    for k in (0, 1, 4, 9):
        fast = same_fast(jt, t, load, k)
        np.testing.assert_allclose(fast.cost, C.soar(t, load, k).cost,
                                   rtol=1e-12)


def test_fast_scale_free():
    jt, t = trees("rpa", 128, seed=5)
    load = loads(jt, t, "ones", seed=0, leaves_only=False)
    for k in (1, 4, 8):
        fast = same_fast(jt, t, load, k)
        np.testing.assert_allclose(fast.cost, C.soar(t, load, k).cost,
                                   rtol=1e-12)


def test_vectorized_tables_match_reference():
    jt, t = trees("bt", 16)
    load = loads(jt, t, "power-law", seed=2)
    k = 3
    Xr = C.soar_gather(t, load, k, cap=False)
    Xv = soar_fast.soar_gather_vectorized(t, load, k)
    assert np.array_equal(Xv, j_fast.soar_gather_vectorized(jt, load, k))
    for v in range(t.n):
        nl = t.depth[v] + 2
        np.testing.assert_allclose(Xv[v][:nl], Xr[v], rtol=1e-12)


def test_levels_match_jax():
    jt, t = trees("rpa", 200, seed=9)
    a, b = j_fast._levels(jt), soar_fast._levels(t)
    assert len(a) == len(b)
    assert all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(a, b))


def test_fast_vs_brute_small():
    rng = np.random.default_rng(42)
    for seed in range(4):
        n = int(rng.integers(3, 9))
        jt, t = trees("random_tree", n, seed=100 + seed)
        load = rng.integers(0, 6, size=n)
        k = int(rng.integers(0, 3))
        mask, want = brute.brute_force(t, load, k)
        jmask, jwant = j_brute.brute_force(jt, load, k)
        assert np.array_equal(mask, jmask) and type(want) is type(jwant)
        assert want == jwant
        got = same_fast(jt, t, load, k)
        np.testing.assert_allclose(got.cost, want, rtol=1e-12)


@pytest.mark.parametrize("exactly", [False, True])
def test_brute_force_with_availability(exactly):
    jt, t = trees("random_tree", 9, seed=4)
    load = np.random.default_rng(4).integers(0, 5, size=9)
    avail = np.arange(9) % 3 != 1
    a = j_brute.brute_force(jt, load, 3, avail=avail, exactly=exactly)
    b = brute.brute_force(t, load, 3, avail=avail, exactly=exactly)
    assert np.array_equal(a[0], b[0]) and a[1] == b[1]
    assert not (b[0] & ~avail).any()
