"""SOAR: optimal dynamic program for the phi-BIC problem (paper Sec. 4/6).

Faithful reference implementation of Algorithms 2-4 (SOAR = SOAR-Gather +
SOAR-Color), with the recurrences of Lemma 6.1/6.2:

  X_v(l, i)  = min cost contribution of subtree T_v — internal utilization plus
               the messages leaving v, charged along the l hops up to v's
               closest blue ancestor (or d) — using at most i blue nodes in T_v.

  v red :  X_v(l, i) = minplus_{children}(X_c(l+1, .))[i] + L(v) * rho(v, A_v^l)
  v blue:  X_v(l, i) = minplus_{children}(X_c(1,   .))[i-1] + send(v) * rho(v, A_v^l)

where ``minplus`` is the min-plus (tropical) convolution over the children's
budget split (the paper's mCost / procedure lines 30-34 of Alg. 3), and
``send(v) = 1`` iff T_v holds positive load (see DESIGN.md §8 for the two
at-most-k / zero-load deviations, both strictly-dominating refinements).

Semantics notes vs. the paper's pseudo-code:
  * "at most k" (Def. 2.1 prose) rather than "exactly k" (Eq. 2): tables are
    monotone non-increasing in i, which the traceback exploits.
  * l ranges over 0..D(v)+1 (the +1 reaching d) — fixes the paper's Sec. 4.2
    off-by-one (the root needs l = 1, Eq. 6).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .tree import DEST, Tree
from .tropical import minplus  # noqa: F401  (re-exported: the DP's primitive)


@dataclasses.dataclass
class SoarResult:
    blue: np.ndarray          # (n,) bool mask of aggregating switches
    cost: float               # optimal phi(T, L, U)
    tables: list | None       # per-node X_v tables (gather output), if kept


def _send(t: Tree, load: np.ndarray) -> np.ndarray:
    """send(v): messages a blue v emits = 1 iff subtree load positive."""
    return (t.subtree_loads(load) > 0).astype(np.int64)


# ---------------------------------------------------------------------------
# SOAR-Gather (Algorithm 3)
# ---------------------------------------------------------------------------

def soar_gather(
    t: Tree,
    load: np.ndarray,
    k: int,
    avail: np.ndarray | None = None,
    cap: bool = True,
) -> list[np.ndarray]:
    """Bottom-up DP table construction.

    Returns per-node tables ``X[v]`` of shape (D(v)+2, k+1): rows are the
    distance l to the closest blue ancestor (or d), columns the blue budget.

    ``cap=True`` enables the subtree-budget cap (beyond-paper): a subtree with
    s available switches is convolved only up to min(k, s) budget columns,
    then flat-padded (tables are monotone). ``cap=False`` is the paper's
    verbatim O(n h k^2) loop structure.
    """
    load = np.asarray(load, dtype=np.int64)
    avail = np.ones(t.n, bool) if avail is None else np.asarray(avail, bool)
    K = k + 1
    R = t.rho_up_table()              # R[v, l] = rho(v, A_v^l)
    send = _send(t, load)
    # number of available switches in each subtree -> max useful budget
    navail = avail.astype(np.int64).copy()
    for u in t.topo[::-1]:
        p = t.parent[u]
        if p != DEST:
            navail[p] += navail[u]
    W = np.minimum(navail, k) + 1 if cap else np.full(t.n, K, dtype=np.int64)
    X: list[np.ndarray | None] = [None] * t.n

    for v in t.topo[::-1]:            # leaves towards the root
        d_v = int(t.depth[v])
        nl = d_v + 2                  # valid l values: 0 .. D(v)+1
        rl = R[v, :nl][:, None]       # (nl, 1)
        kids = t.children[v]
        w = int(W[v])
        if not kids:
            Xv = load[v] * rl * np.ones((1, w))
            if avail[v] and w >= 2:
                Xv[:, 1:] = np.minimum(Xv[:, 1:], send[v] * rl)
        else:
            # red: children see their barrier l+1 hops up -> child rows 1..nl.
            # (child tables have nl+1 rows; rows l+1 align with our rows l)
            conv_r = X[kids[0]][1 : nl + 1, :w]
            for c in kids[1:]:
                conv_r = minplus(conv_r, X[c][1 : nl + 1, :w], out_w=w)
            Xv = np.full((nl, w), np.inf)
            cw = conv_r.shape[1]
            Xv[:, :cw] = conv_r + load[v] * rl
            if cw < w:
                Xv[:, cw:] = Xv[:, cw - 1 : cw]
            if avail[v] and w >= 2:
                # blue: children see the barrier at distance 1 (v itself).
                conv_b = X[kids[0]][1:2, : w - 1]
                for c in kids[1:]:
                    conv_b = minplus(conv_b, X[c][1:2, : w - 1], out_w=w - 1)
                blue = np.full((nl, w), np.inf)
                bw = conv_b.shape[1]
                blue[:, 1 : 1 + bw] = conv_b + send[v] * rl
                if 1 + bw < w:
                    blue[:, 1 + bw :] = blue[:, bw : bw + 1]
                Xv = np.minimum(Xv, blue)
        # at-most-k monotonicity (defensive; holds by induction)
        np.minimum.accumulate(Xv, axis=1, out=Xv)
        if w < K:  # flat-pad so downstream budget indexing is unconstrained
            Xv = np.concatenate([Xv, np.repeat(Xv[:, -1:], K - w, axis=1)], axis=1)
        X[v] = Xv
    return X  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# SOAR-Color (Algorithm 4)
# ---------------------------------------------------------------------------

def _partial_convs(X, kids, row) -> list[np.ndarray]:
    """Partial min-plus chain Y^m over children at a fixed l row (1D, K)."""
    out = [X[kids[0]][row]]
    for c in kids[1:]:
        out.append(minplus(out[-1], X[c][row])[0])
    return out


def soar_color(
    t: Tree,
    load: np.ndarray,
    k: int,
    X: list[np.ndarray],
    avail: np.ndarray | None = None,
) -> np.ndarray:
    """Top-down traceback of the optimal coloring along the DP tables."""
    load = np.asarray(load, dtype=np.int64)
    avail = np.ones(t.n, bool) if avail is None else np.asarray(avail, bool)
    R = t.rho_up_table()
    send = _send(t, load)
    blue = np.zeros(t.n, dtype=bool)
    # (node, budget i for T_v, l* = distance to closest blue ancestor / d)
    stack: list[tuple[int, int, int]] = [(t.root, k, 1)]
    while stack:
        v, i, ell = stack.pop()
        kids = t.children[v]
        rl = R[v, ell]
        if not kids:
            red_val = load[v] * rl
            blue_val = send[v] * rl if (avail[v] and i >= 1) else np.inf
            if blue_val < red_val:
                blue[v] = True
            continue
        conv_r = _partial_convs(X, kids, ell + 1)
        red_val = conv_r[-1][i] + load[v] * rl
        if avail[v] and i >= 1:
            conv_b = _partial_convs(X, kids, 1)
            blue_val = conv_b[-1][i - 1] + send[v] * rl
        else:
            conv_b, blue_val = None, np.inf
        if blue_val < red_val:
            blue[v] = True
            budget, lc, chain = i - 1, 1, conv_b
        else:
            budget, lc, chain = i, ell + 1, conv_r
        # split the budget among children, last child first (mSplit replay)
        for m in range(len(kids) - 1, 0, -1):
            c = kids[m]
            prev = chain[m - 1]
            best_j, best_val = 0, np.inf
            for j in range(budget + 1):
                val = prev[budget - j] + X[c][lc][j]
                if val < best_val:
                    best_val, best_j = val, j
            stack.append((c, best_j, lc))
            budget -= best_j
        stack.append((kids[0], budget, lc))
    return blue


# ---------------------------------------------------------------------------
# SOAR (Algorithm 2)
# ---------------------------------------------------------------------------

def soar(
    t: Tree,
    load: np.ndarray,
    k: int,
    avail: np.ndarray | None = None,
    keep_tables: bool = False,
    cap: bool = True,
) -> SoarResult:
    """Optimal phi-BIC solution with |U| <= k (Theorem 4.1)."""
    if k < 0:
        raise ValueError("budget k must be non-negative")
    X = soar_gather(t, load, k, avail, cap=cap)
    cost = float(X[t.root][1, k])
    blue = soar_color(t, load, k, X, avail)
    return SoarResult(blue=blue, cost=cost, tables=X if keep_tables else None)
