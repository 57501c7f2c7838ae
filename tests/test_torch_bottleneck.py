"""The port's bottleneck solver (``repro_torch.core.bottleneck``) on the CPU
vs the JAX package's.

Mirrors ``tests/test_bottleneck.py``: ``solve_bottleneck``'s mask and
bottleneck, ``bottleneck_phi`` and ``_prune``'s frontier equal the JAX
functions' on the same inputs (masks bitwise, floats with ``==``); then
the JAX test's own checks (against brute force) run on the port's
results. Tolerances: none against JAX.
"""
import itertools

import numpy as np
import pytest

from repro.core import bottleneck as jb
from repro.testing import given, settings, st
from repro_torch.core import DEST, Tree, all_blue, all_red, mask_from_set
from repro_torch.core import bottleneck as tb
from repro_torch.core import soar_fast
from test_torch_soar_fast import loads, trees


def brute_lambda(t, load, k, avail=None):
    availm = np.ones(t.n, bool) if avail is None else np.asarray(avail, bool)
    cand = np.nonzero(availm)[0]
    best = np.inf
    for size in range(min(k, len(cand)) + 1):
        for combo in itertools.combinations(cand, size):
            best = min(best, tb.bottleneck_phi(t, load,
                                               mask_from_set(t, combo)))
    return best


def solve(jt, t, load, k, avail=None):
    """``solve_bottleneck`` in both packages, held equal; the port's."""
    ja, jl = jb.solve_bottleneck(jt, load, k, avail=avail)
    blue, lam = tb.solve_bottleneck(t, load, k, avail=avail)
    assert blue.dtype == ja.dtype and np.array_equal(blue, ja)
    assert type(lam) is type(jl) and lam == jl
    assert tb.bottleneck_phi(t, load, blue) == jb.bottleneck_phi(jt, load,
                                                                 ja)
    return blue, lam


def test_fig2_bottleneck():
    from repro.core import Tree as JTree
    parent = np.array([DEST, 0, 0, 1, 1, 2, 2])
    t, jt = Tree(parent, np.ones(7)), JTree(parent, np.ones(7))
    load = np.zeros(7, dtype=np.int64)
    load[[3, 4, 5, 6]] = [2, 6, 5, 4]
    assert tb.bottleneck_phi(t, load, all_red(t)) == 17
    assert tb.bottleneck_phi(t, load, all_blue(t)) == 1
    blue, lam = solve(jt, t, load, 2)
    assert lam == brute_lambda(t, load, 2)
    assert tb.bottleneck_phi(t, load, blue) == lam
    assert blue.sum() <= 2


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 10_000), st.integers(4, 10), st.integers(0, 4))
def test_matches_brute_force_random(seed, n, k):
    jt, t = trees("random_tree", n, seed=seed)
    load = np.random.default_rng(seed).integers(0, 6, size=n)
    blue, lam = solve(jt, t, load, k)
    assert blue.sum() <= k
    assert tb.bottleneck_phi(t, load, blue) == pytest.approx(lam)
    assert lam == pytest.approx(brute_lambda(t, load, k))


def test_availability_respected():
    jt, t = trees("bt", 16, "constant")
    load = loads(jt, t, "power-law", seed=1)
    avail = np.zeros(t.n, bool)
    avail[[3, 5]] = True
    blue, lam = solve(jt, t, load, 2, avail=avail)
    assert set(np.nonzero(blue)[0]) <= {3, 5}
    assert lam == pytest.approx(brute_lambda(t, load, 2, avail=avail))


def test_monotone_in_k():
    jt, t = trees("bt", 32, "exponential")
    load = loads(jt, t, "power-law", seed=2)
    prev = np.inf
    for k in range(0, 6):
        _, lam = solve(jt, t, load, k)
        assert lam <= prev + 1e-12
        prev = lam


def test_conjecture_direction_smallcase():
    jt, t = trees("bt", 64, "constant")
    load = loads(jt, t, "power-law", seed=3)
    k = 4
    blue_phi = soar_fast(t, load, k).blue
    _, lam_opt = solve(jt, t, load, k)
    assert tb.bottleneck_phi(t, load, blue_phi) <= 4 * lam_opt


def test_prune_keeps_the_jax_frontier():
    rng = np.random.default_rng(7)
    pairs = [(int(m), float(b)) for m, b in zip(rng.integers(0, 6, 40),
                                                rng.integers(0, 9, 40) / 2)]
    got = tb._prune([tb._Entry(m, b, False, (i,))
                     for i, (m, b) in enumerate(pairs)])
    want = jb._prune([jb._Entry(m, b, False, (i,))
                      for i, (m, b) in enumerate(pairs)])
    assert [(e.m, e.b, e.back) for e in got] == [(e.m, e.b, e.back)
                                                 for e in want]
    assert all(x.m < y.m and x.b > y.b for x, y in zip(got, got[1:]))
