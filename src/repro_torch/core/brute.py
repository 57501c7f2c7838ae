"""Brute-force phi-BIC oracle for tests and small-scale validation."""
from __future__ import annotations

import itertools

import numpy as np

from .reduce import mask_from_set, phi
from .tree import Tree


def brute_force(
    t: Tree,
    load: np.ndarray,
    k: int,
    avail: np.ndarray | None = None,
    exactly: bool = False,
) -> tuple[np.ndarray, float]:
    """Minimize phi over all subsets U of available switches with |U| <= k.

    Theta(n^k) — only for small instances (tests / motivating examples).
    """
    avail = np.ones(t.n, bool) if avail is None else np.asarray(avail, bool)
    cand = np.nonzero(avail)[0]
    sizes = [min(k, len(cand))] if exactly else range(min(k, len(cand)) + 1)
    best_mask, best_cost = None, np.inf
    for size in sizes:
        for combo in itertools.combinations(cand, size):
            m = mask_from_set(t, combo)
            c = phi(t, load, m)
            if c < best_cost:
                best_cost, best_mask = c, m
    assert best_mask is not None
    return best_mask, float(best_cost)
