"""Contending placement strategies from the paper (Sec. 3, Appendix B).

Every strategy returns a boolean blue mask with at most k True entries,
restricted to the available set Lambda.
"""
from __future__ import annotations

import numpy as np

from .tree import Tree


def _avail_idx(t: Tree, avail) -> np.ndarray:
    avail = np.ones(t.n, bool) if avail is None else np.asarray(avail, bool)
    return np.nonzero(avail)[0]


def _mask(t: Tree, picks) -> np.ndarray:
    m = np.zeros(t.n, bool)
    m[np.asarray(list(picks), dtype=np.int64)] = True
    return m


def top(t: Tree, load, k: int, avail=None, seed: int = 0) -> np.ndarray:
    """Top: the k available switches closest to the root (Sec. 3 (i)).

    Equal-depth ties are broken towards the heavier subtree, which matches
    the paper's Fig. 2a (Top = {root, right mid} with cost 27).
    """
    cand = _avail_idx(t, avail)
    sload = t.subtree_loads(np.asarray(load))
    order = cand[np.lexsort((cand, -sload[cand], t.depth[cand]))]
    return _mask(t, order[:k])


def max_load(t: Tree, load, k: int, avail=None, seed: int = 0) -> np.ndarray:
    """Max: the k available switches with the largest load (Sec. 3 (ii))."""
    load = np.asarray(load)
    cand = _avail_idx(t, avail)
    order = cand[np.lexsort((cand, -load[cand]))]
    return _mask(t, order[:k])


def max_degree(t: Tree, load, k: int, avail=None, seed: int = 0) -> np.ndarray:
    """Max-degree variant used for scale-free networks (Appendix B)."""
    cand = _avail_idx(t, avail)
    deg = np.asarray([t.degree(int(v)) for v in cand])
    order = cand[np.lexsort((cand, -deg))]
    return _mask(t, order[:k])


def level(t: Tree, load, k: int, avail=None, seed: int = 0) -> np.ndarray:
    """Level: a whole level of a complete binary tree (Sec. 3 (iii)).

    Picks the deepest complete level whose size fits the budget:
    level j holds 2^j switches, so j = floor(log2(k)) (clipped to the height).
    Only switches in Lambda are taken (the paper assumes Lambda = S).
    """
    if k < 1:
        return np.zeros(t.n, bool)
    j = min(int(np.floor(np.log2(k))), t.height)
    availm = np.ones(t.n, bool) if avail is None else np.asarray(avail, bool)
    picks = [v for v in range(t.n) if t.depth[v] == j and availm[v]]
    return _mask(t, picks[:k]) if picks else np.zeros(t.n, bool)


def random_k(t: Tree, load, k: int, avail=None, seed: int = 0) -> np.ndarray:
    """Uniformly random placement (sanity baseline)."""
    rng = np.random.default_rng(seed)
    cand = _avail_idx(t, avail)
    picks = rng.choice(cand, size=min(k, len(cand)), replace=False)
    return _mask(t, picks)


STRATEGIES = {
    "top": top,
    "max": max_load,
    "max_degree": max_degree,
    "level": level,
    "random": random_k,
}
