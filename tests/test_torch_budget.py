"""The port's cross-workload budget split (``repro_torch.core.budget``) on
the CPU vs the JAX package's.

Mirrors ``tests/test_budget.py``: ``cost_curve``, the envelope gains,
``allocate_budget``'s, ``brute_allocate``'s and ``uniform_allocate``'s
allocation lists and totals equal the JAX functions' on the same inputs
(arrays bitwise, totals with ``==``); then the JAX test's own checks run
on the port's results. Tolerances: none against JAX.
"""
import numpy as np
import pytest

from repro.core import budget as jb
from repro_torch.core import budget as tb
from repro_torch.core import soar
from test_torch_soar_fast import trees


def _workloads(jt, t, n, seed=0):
    from repro.core import sample_load as j_sample
    from repro_torch.core import sample_load
    out = []
    for i in range(n):
        dist = "power-law" if i % 2 else "uniform"
        a, b = j_sample(jt, dist, seed=seed + i), sample_load(t, dist,
                                                               seed=seed + i)
        assert np.array_equal(a, b)
        out.append(b)
    return out


def same(fn, jt, t, *args, **kw):
    """``budget.<fn>`` of both packages, held equal; the port's."""
    a, b = getattr(jb, fn)(jt, *args, **kw), getattr(tb, fn)(t, *args, **kw)
    if isinstance(a, tuple):
        assert a[0].dtype == b[0].dtype and np.array_equal(a[0], b[0])
        assert type(a[1]) is type(b[1]) and a[1] == b[1]
    else:
        assert a.dtype == b.dtype and np.array_equal(a, b)
    return b


def test_cost_curve_matches_soar_pointwise():
    jt, t = trees("bt", 32, "linear")
    L = _workloads(jt, t, 2, seed=1)[1]
    c = same("cost_curve", jt, t, L, 6)
    for k in range(7):
        assert c[k] == pytest.approx(soar(t, L, k).cost)


def test_curve_monotone_and_envelope_gains():
    jt, t = trees("bt", 64, "constant")
    c = same("cost_curve", jt, t, _workloads(jt, t, 1, seed=2)[0], 12)
    assert (np.diff(c) <= 1e-9).all()
    g = tb._concave_envelope_gains(c)
    assert np.array_equal(g, jb._concave_envelope_gains(c))
    assert (np.diff(g[1:]) <= 1e-9).all()        # concave: gains fall


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_close_to_brute(seed):
    jt, t = trees("bt", 16, "constant")
    ws = _workloads(jt, t, 3, seed=10 * seed)
    K = 6
    b_g, c_g = same("allocate_budget", jt, t, ws, K)
    b_b, c_b = same("brute_allocate", jt, t, ws, K)
    assert b_g.sum() <= K
    assert c_g <= c_b * 1.02 + 1e-9
    assert c_b <= c_g + 1e-9


def test_greedy_beats_uniform():
    jt, t = trees("bt", 64, "exponential")
    ws = _workloads(jt, t, 4, seed=5)
    ws[0] = ws[0] * 20
    K = 12
    _, c_g = same("allocate_budget", jt, t, ws, K)
    _, c_u = same("uniform_allocate", jt, t, ws, K)
    assert c_g <= c_u + 1e-9


def test_budget_never_exceeded_and_zero_budget():
    jt, t = trees("bt", 32, "constant")
    ws = _workloads(jt, t, 5, seed=3)
    b, _ = same("allocate_budget", jt, t, ws, 0)
    assert b.sum() == 0
    b, _ = same("allocate_budget", jt, t, ws, 7)
    assert b.sum() <= 7


def test_allocation_ties_and_k_max_match_jax():
    """Equal workloads tie in the heap: the allocation follows JAX's
    (gain, workload) order; ``k_max`` caps every curve."""
    jt, t = trees("bt", 32, "constant")
    w = _workloads(jt, t, 1, seed=4)[0]
    b, _ = same("allocate_budget", jt, t, [w, w, w], 5)
    assert list(b) == sorted(b, reverse=True)
    b, _ = same("allocate_budget", jt, t, _workloads(jt, t, 3, seed=8), 9,
                k_max=2)
    assert (b <= 2).all()
    avail = np.arange(t.n) % 2 == 0
    same("allocate_budget", jt, t, _workloads(jt, t, 3, seed=9), 6,
         avail=avail)
