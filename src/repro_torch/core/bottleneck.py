"""Bottleneck-BIC: minimize the maximum per-link utilization (paper §8).

The paper leaves "minimizing the load on bottleneck links" as future work
and conjectures it correlates with the utilization objective. We solve it
exactly with a Pareto-frontier dynamic program and use it to TEST the
conjecture (benchmarks/beyond_bottleneck.py).

Objective:   lambda(T, L, U) = max_e  msg_e(T, L, U) * rho(e)

Why SOAR's table doesn't directly apply: phi is linear in per-edge message
counts, so the closest-blue-ancestor trick collapses the state to a
distance l. The bottleneck couples edges through the *message count*
crossing them, so the DP state must carry it: each subtree reports the
Pareto frontier of

    (m, b) = (messages leaving the subtree upward,
              bottleneck among edges inside + the root's up-edge)

per budget i and color choice. Combining children sums m and maxes b;
frontiers are pruned to non-dominated pairs (sorted by m, strictly
decreasing b), which keeps them small in practice (distinct useful m
values are few). Exactness is property-tested against brute force.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .reduce import messages_up
from .tree import Tree


def bottleneck_phi(t: Tree, load, blue) -> float:
    """lambda(T, L, U): max over edges of msg_e * rho(e) (simulator)."""
    msgs = messages_up(t, np.asarray(load), np.asarray(blue, bool))
    return float(np.max(msgs * t.rho))


@dataclasses.dataclass
class _Entry:
    m: int                  # messages leaving the subtree
    b: float                # bottleneck so far (incl. root's up-edge)
    color: bool             # this node blue?
    back: tuple             # per-child (entry_index, budget) used


def _prune(entries: list[_Entry]) -> list[_Entry]:
    """Keep the Pareto frontier: increasing m => strictly decreasing b."""
    entries.sort(key=lambda e: (e.m, e.b))
    out: list[_Entry] = []
    best_b = np.inf
    for e in entries:
        if e.b < best_b - 1e-12:
            out.append(e)
            best_b = e.b
    return out


def solve_bottleneck(t: Tree, load, k: int, avail=None):
    """Exact lambda-BIC: returns (blue_mask, optimal_bottleneck).

    Exponential only in frontier size (pruned); fine for the evaluation
    scale (trees up to a few hundred nodes, k <= ~16).
    """
    load = np.asarray(load, dtype=np.int64)
    availm = np.ones(t.n, bool) if avail is None else np.asarray(avail, bool)
    sub = t.subtree_loads(load)
    K = k + 1
    # tables[v][i] = Pareto list of _Entry
    tables: list[list[list[_Entry]] | None] = [None] * t.n

    for v in t.topo[::-1]:
        rho = float(t.rho[v])
        send = 1 if sub[v] > 0 else 0
        rows: list[list[_Entry]] = [[] for _ in range(K)]
        kids = t.children[v]
        if not kids:
            for i in range(K):
                red = _Entry(int(load[v]), load[v] * rho, False, ())
                rows[i] = [red]
                if i >= 1 and availm[v]:
                    rows[i].append(_Entry(send, send * rho, True, ()))
                rows[i] = _prune(rows[i])
            tables[v] = rows
            continue
        # fold children one at a time: combo[i] = frontier of
        # (sum m, max b, back chain) using i blue among processed children
        combo: list[list[tuple[int, float, tuple]]] = [
            [(0, 0.0, ())] if i == 0 else [] for i in range(K)]
        for c in kids:
            nxt: list[list[tuple[int, float, tuple]]] = [[] for _ in range(K)]
            for i in range(K):
                for j in range(i + 1):
                    for (m0, b0, back0) in combo[i - j]:
                        for ei, e in enumerate(tables[c][j]):
                            nxt[i].append((m0 + e.m, max(b0, e.b),
                                           back0 + ((ei, j),)))
            # prune each budget row (reuse _Entry machinery)
            for i in range(K):
                es = [_Entry(m, b, False, back) for (m, b, back) in nxt[i]]
                nxt[i] = [(e.m, e.b, e.back) for e in _prune(es)]
            combo = nxt
        for i in range(K):
            out: list[_Entry] = []
            for (m0, b0, back) in combo[i]:
                mr = int(load[v]) + m0
                out.append(_Entry(mr, max(b0, mr * rho), False, back))
            if i >= 1 and availm[v]:
                for (m0, b0, back) in combo[i - 1]:
                    out.append(_Entry(send, max(b0, send * rho), True, back))
            rows[i] = _prune(out)
        tables[v] = rows

    r = t.root
    best = min(tables[r][k], key=lambda e: e.b)

    # traceback
    blue = np.zeros(t.n, bool)
    stack = [(r, best)]
    while stack:
        v, e = stack.pop()
        blue[v] = e.color
        for c, (ei, j) in zip(t.children[v], e.back):
            stack.append((c, tables[c][j][ei]))
    return blue, float(best.b)
