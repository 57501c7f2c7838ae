"""Cross-workload budget allocation (paper §8, second open problem).

"The main question there is how to distribute the overall aggregation
capacity available throughout the network to the various workloads being
served. Specifically, every workload might be serviced by a *distinct*
number of aggregation switches (i.e., there need not be a uniform k for
all workloads)."

Given workloads L_1..L_W and a TOTAL budget K, choose per-workload budgets
k_w with sum k_w <= K minimizing total utilization sum_w phi-BIC(T, L_w, k_w).

Approach: each workload's optimal-cost curve c_w(k) is produced by ONE
SOAR-Gather run (the root table row X_r(1, ·) gives the optimum for every
k <= K simultaneously — the DP is incremental in the budget). Greedy
marginal allocation on the savings curves is optimal when every curve is
convex in k (diminishing returns); SOAR curves are monotone but not always
convex, so we run greedy on the *concave envelope* of each savings curve —
this is exact for the relaxed (envelope) problem and, because envelope
break-points are always feasible pure allocations, yields an allocation
whose gap we can bound and test against brute force (tests/test_budget.py).
"""
from __future__ import annotations

import heapq

import numpy as np

from .soar_fast import soar_gather_vectorized
from .tree import Tree


def cost_curve(t: Tree, load, k_max: int, avail=None) -> np.ndarray:
    """c[k] = phi-BIC(T, L, k) for k = 0..k_max — one gather run."""
    X = soar_gather_vectorized(t, load, k_max, avail)
    return np.asarray(X[t.root, 1, : k_max + 1], dtype=np.float64)


def _concave_envelope_gains(c: np.ndarray) -> np.ndarray:
    """Per-unit marginal savings of the concave envelope of (red - c)."""
    s = c[0] - c                       # savings, monotone non-decreasing
    # upper concave envelope via monotone chain on (k, s)
    hull = [(0, s[0])]
    for k in range(1, len(s)):
        while len(hull) >= 2:
            (k1, s1), (k2, s2) = hull[-2], hull[-1]
            if (s2 - s1) * (k - k2) <= (s[k] - s2) * (k2 - k1):
                hull.pop()
            else:
                break
        hull.append((k, s[k]))
    gains = np.zeros(len(s))
    for (k1, s1), (k2, s2) in zip(hull, hull[1:]):
        gains[k1 + 1 : k2 + 1] = (s2 - s1) / (k2 - k1)
    return gains


def allocate_budget(t: Tree, workloads, K: int, avail=None,
                    k_max: int | None = None):
    """Greedy-on-envelopes allocation: returns (budgets, total_cost).

    budgets[w] sums to <= K; total_cost = sum_w c_w(budgets[w]).
    """
    W = len(workloads)
    k_cap = min(K, k_max) if k_max else K
    curves = [cost_curve(t, L, k_cap, avail) for L in workloads]
    gains = [_concave_envelope_gains(c) for c in curves]
    budgets = np.zeros(W, dtype=np.int64)
    heap = [(-gains[w][1], w) for w in range(W) if k_cap >= 1]
    heapq.heapify(heap)
    remaining = K
    while heap and remaining > 0:
        negg, w = heapq.heappop(heap)
        if negg == 0.0:
            break
        budgets[w] += 1
        remaining -= 1
        nxt = budgets[w] + 1
        if nxt <= k_cap:
            heapq.heappush(heap, (-gains[w][nxt], w))
    total = float(sum(c[b] for c, b in zip(curves, budgets)))
    return budgets, total


def brute_allocate(t: Tree, workloads, K: int, avail=None):
    """Exact allocator (enumerate compositions) — small instances only."""
    W = len(workloads)
    curves = [cost_curve(t, L, K, avail) for L in workloads]

    best = (np.inf, None)

    def rec(w, left, acc, picks):
        nonlocal best
        if w == W:
            if acc < best[0]:
                best = (acc, list(picks))
            return
        for k in range(left + 1):
            rec(w + 1, left - k, acc + curves[w][k], picks + [k])

    rec(0, K, 0.0, [])
    return np.asarray(best[1], dtype=np.int64), float(best[0])


def uniform_allocate(t: Tree, workloads, K: int, avail=None):
    """Baseline: the same k = K // W for every workload."""
    W = len(workloads)
    k = K // W
    curves = [cost_curve(t, L, k, avail) for L in workloads]
    budgets = np.full(W, k, dtype=np.int64)
    return budgets, float(sum(c[k] for c in curves))
