"""Tree network topology for the phi-BIC problem (paper Sec. 2).

Nodes 0..n-1 are switches; the destination server ``d`` is implicit *above*
the root switch ``r``.  Every switch v has exactly one upward edge
``(v, p(v))``; the root's upward edge is ``(r, d)``.  ``rho[v]`` is the
reciprocal link rate of that edge (transmission time per message).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

DEST = -1  # parent id of the root switch (the destination server d)


@dataclasses.dataclass(frozen=True)
class Tree:
    """Immutable rooted tree of switches with per-edge reciprocal rates."""

    parent: np.ndarray  # (n,) int32; parent[root] == DEST
    rho: np.ndarray     # (n,) float64; rho[v] = 1/omega((v, p(v)))

    def __post_init__(self):
        parent = np.asarray(self.parent, dtype=np.int32)
        rho = np.asarray(self.rho, dtype=np.float64)
        object.__setattr__(self, "parent", parent)
        object.__setattr__(self, "rho", rho)
        n = parent.shape[0]
        if rho.shape != (n,):
            raise ValueError(f"rho shape {rho.shape} != ({n},)")
        roots = np.nonzero(parent == DEST)[0]
        if len(roots) != 1:
            raise ValueError(f"tree must have exactly one root, got {roots}")
        if np.any(rho <= 0):
            raise ValueError("rho (reciprocal rates) must be positive")
        object.__setattr__(self, "_root", int(roots[0]))
        # depth (distance from root r; D(r)=0) and validation of acyclicity.
        depth = np.full(n, -1, dtype=np.int32)
        depth[self._root] = 0
        # children adjacency
        order = [self._root]
        kids: list[list[int]] = [[] for _ in range(n)]
        for v in range(n):
            p = parent[v]
            if p != DEST:
                if not (0 <= p < n):
                    raise ValueError(f"bad parent {p} for node {v}")
                kids[p].append(v)
        head = 0
        while head < len(order):
            u = order[head]
            head += 1
            for c in kids[u]:
                depth[c] = depth[u] + 1
                order.append(c)
        if len(order) != n:
            raise ValueError("tree is disconnected or cyclic")
        object.__setattr__(self, "depth", depth)
        object.__setattr__(self, "children", tuple(tuple(k) for k in kids))
        # topological order: root first; reversed() gives leaves-first.
        object.__setattr__(self, "topo", np.asarray(order, dtype=np.int32))
        # pathrho[v]: sum of rho along the full path v -> d.
        pathrho = np.zeros(n, dtype=np.float64)
        for u in order:  # root first: parent already done
            p = parent[u]
            pathrho[u] = rho[u] + (pathrho[p] if p != DEST else 0.0)
        object.__setattr__(self, "pathrho", pathrho)

    # -- basic properties ---------------------------------------------------
    @property
    def n(self) -> int:
        return int(self.parent.shape[0])

    @property
    def root(self) -> int:
        return self._root

    @property
    def height(self) -> int:
        """h(T) = max_v D(v) (paper Sec. 2)."""
        return int(self.depth.max())

    def is_leaf(self, v: int) -> bool:
        return len(self.children[v]) == 0

    @property
    def leaves(self) -> np.ndarray:
        return np.asarray([v for v in range(self.n) if self.is_leaf(v)], np.int32)

    def degree(self, v: int) -> int:
        """Undirected degree in T (children + parent edge)."""
        return len(self.children[v]) + 1  # every switch has an up edge

    def ancestor(self, v: int, ell: int) -> int:
        """A_v^ell: the ancestor at distance ell above v (DEST if past root)."""
        u = v
        for _ in range(ell):
            if u == DEST:
                raise ValueError("walked past destination")
            u = int(self.parent[u])
        return u

    def rho_up(self, v: int, ell: int) -> float:
        """rho(v, A_v^ell): cumulative transmission time of ell hops above v.

        ell may range 0 .. depth[v]+1 (the +1 reaching the destination d).
        """
        if ell == 0:
            return 0.0
        a = self.ancestor(v, ell)
        return float(self.pathrho[v] - (self.pathrho[a] if a != DEST else 0.0))

    def rho_up_table(self, max_ell: int | None = None) -> np.ndarray:
        """Dense table R[v, ell] = rho(v, A_v^ell), inf where ell > depth[v]+1.

        Vectorized ancestor walk: hop ``ell`` adds the up-edge rho of every
        node's current ancestor, all nodes at once (same per-node addition
        order as the scalar walk, so results are bit-identical).
        """
        h = self.height
        m = (h + 2) if max_ell is None else (max_ell + 1)
        n = self.n
        out = np.full((n, m), np.inf, dtype=np.float64)
        out[:, 0] = 0.0
        cur = np.arange(n)              # A_v^{ell-1}
        acc = np.zeros(n, dtype=np.float64)
        for ell in range(1, m):
            alive = cur != DEST
            if not alive.any():
                break
            idx = np.where(alive, cur, 0)
            acc = acc + self.rho[idx]
            out[alive, ell] = acc[alive]
            cur = np.where(alive, self.parent[idx], DEST)
        return out

    def subtree_sizes(self) -> np.ndarray:
        sz = np.ones(self.n, dtype=np.int64)
        for u in self.topo[::-1]:
            p = self.parent[u]
            if p != DEST:
                sz[p] += sz[u]
        return sz

    def subtree_loads(self, load: np.ndarray) -> np.ndarray:
        tl = np.asarray(load, dtype=np.int64).copy()
        for u in self.topo[::-1]:
            p = self.parent[u]
            if p != DEST:
                tl[p] += tl[u]
        return tl


# ---------------------------------------------------------------------------
# Tree constructors
# ---------------------------------------------------------------------------

def bt(n_total: int, rate_scheme: str = "constant") -> Tree:
    """Complete binary tree BT(n_total) per paper Sec. 5.

    ``n_total`` counts *all* nodes including the destination server, so the
    switch tree has n_total - 1 nodes and must be a complete binary tree
    (n_total a power of two). BT(256) -> 255 switches, 128 leaves.
    """
    n = n_total - 1
    if n < 1 or (n & (n + 1)) != 0:
        raise ValueError(f"BT needs n_total a power of 2, got {n_total}")
    parent = np.empty(n, dtype=np.int32)
    parent[0] = DEST
    for v in range(1, n):
        parent[v] = (v - 1) // 2
    t = Tree(parent, np.ones(n))
    return with_rates(t, rate_scheme)


def with_rates(t: Tree, scheme: str) -> Tree:
    """Apply the paper's rate schemes (Sec. 5): constant / linear / exponential.

    Leaf edges have rate 1; rates increase towards the root either by +1 per
    level (linear) or doubling (exponential). Level is measured from the
    deepest leaves: edge (v, p(v)) at tree-depth D(v) has
    level_from_leaf = h - D(v).
    """
    h = t.height
    lvl = h - t.depth  # 0 at deepest leaves, h at root edge... root edge lvl=h
    if scheme == "constant":
        rate = np.ones(t.n)
    elif scheme == "linear":
        rate = 1.0 + lvl
    elif scheme == "exponential":
        rate = np.power(2.0, lvl)
    else:
        raise ValueError(f"unknown rate scheme {scheme!r}")
    return Tree(t.parent, 1.0 / rate)


def rpa(n_total: int, seed: int = 0) -> Tree:
    """Random preferential attachment (scale-free) tree, Appendix B.

    Node 0 is the root switch; each new node attaches to an existing switch
    with probability proportional to its current (undirected) degree.
    """
    n = n_total - 1
    rng = np.random.default_rng(seed)
    parent = np.full(n, DEST, dtype=np.int32)
    deg = np.zeros(n, dtype=np.float64)
    deg[0] = 1.0  # root's edge to d
    for v in range(1, n):
        w = deg[:v] / deg[:v].sum()
        p = int(rng.choice(v, p=w))
        parent[v] = p
        deg[p] += 1.0
        deg[v] = 1.0
    return Tree(parent, np.ones(n))


# ---------------------------------------------------------------------------
# Load distributions (paper Sec. 5: mean 5; uniform [4,6], power-law [1,63])
# ---------------------------------------------------------------------------

def _powerlaw_pmf(alpha: float, lo: int = 1, hi: int = 63) -> np.ndarray:
    x = np.arange(lo, hi + 1, dtype=np.float64)
    p = x ** (-alpha)
    return p / p.sum()


def _calibrate_powerlaw(target_mean: float = 5.0, lo: int = 1, hi: int = 63) -> float:
    """Find alpha such that the truncated power-law mean equals target_mean."""
    x = np.arange(lo, hi + 1, dtype=np.float64)

    def mean(alpha: float) -> float:
        p = _powerlaw_pmf(alpha, lo, hi)
        return float((x * p).sum())

    a_lo, a_hi = 0.0, 5.0  # mean decreases in alpha
    for _ in range(80):
        mid = 0.5 * (a_lo + a_hi)
        if mean(mid) > target_mean:
            a_lo = mid
        else:
            a_hi = mid
    return 0.5 * (a_lo + a_hi)


_POWERLAW_ALPHA = _calibrate_powerlaw()


def sample_load(
    t: Tree,
    dist: str = "uniform",
    seed: int = 0,
    leaves_only: bool = True,
) -> np.ndarray:
    """Sample the network load L (paper Sec. 5 distribution characteristics)."""
    rng = np.random.default_rng(seed)
    load = np.zeros(t.n, dtype=np.int64)
    where = t.leaves if leaves_only else np.arange(t.n)
    m = len(where)
    if dist == "uniform":
        vals = rng.integers(4, 7, size=m)  # {4,5,6}: mean 5
    elif dist == "power-law":
        pmf = _powerlaw_pmf(_POWERLAW_ALPHA)
        vals = rng.choice(np.arange(1, 64), size=m, p=pmf)
    elif dist == "ones":
        vals = np.ones(m, dtype=np.int64)  # Appendix B scale-free setting
    else:
        raise ValueError(f"unknown load distribution {dist!r}")
    load[where] = vals
    return load


def random_tree(n: int, seed: int = 0, max_children: int = 4) -> Tree:
    """Arbitrary random tree + random rates — used by property tests."""
    rng = np.random.default_rng(seed)
    parent = np.full(n, DEST, dtype=np.int32)
    for v in range(1, n):
        parent[v] = int(rng.integers(0, v)) if max_children <= 0 else int(
            rng.integers(max(0, v - 3 * max_children), v)
        )
    rho = rng.uniform(0.1, 3.0, size=n)
    return Tree(parent, rho)
