"""Cluster reduction-tree topology: the paper's T overlaid on a fleet.

A copy of the JAX package's ``collectives/topology.py`` (numpy over
:mod:`repro_torch.core.tree`), plus :func:`topology_from_arrays`.

Gradient reduction for one model-parallel column flows over the (pod, data)
mesh axes. Physically that is a tree: chips -> rack/host reducers -> pod
spines -> the cross-pod destination d. Link rates are heterogeneous (ICI >>
DCN), which is exactly the paper's arbitrary-omega setting; the bounded
budget k models how many rack/pod reduction points a tenant may claim
(Sec. 5.2 multi-workload capacity).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.tree import DEST, Tree

# Relative per-message transmission times (rho = 1/rate): a message crossing
# a DCN hop costs ~16x an ICI hop (50 GB/s/link ICI vs ~3 GB/s/link-share DCN).
RHO_ICI = 1.0
RHO_RACK = 2.0
RHO_DCN = 16.0


@dataclasses.dataclass(frozen=True)
class ClusterTopology:
    tree: Tree
    device_leaf: np.ndarray        # device id -> leaf switch id
    load: np.ndarray               # per-switch load (grad shards entering)
    blocked: np.ndarray | None = None  # switches whose aggregation plane is
                                       # down (forwarding still works); they
                                       # leave the candidate set Lambda
    cap_scale: np.ndarray | None = None  # per-switch remaining aggregation-
                                         # capacity fraction a(s) in [0, 1];
                                         # None = all pristine. 0 composes
                                         # with blocked (the frac->0 limit)

    @property
    def n_devices(self) -> int:
        return len(self.device_leaf)

    def candidates(self, avail: np.ndarray | None = None) -> np.ndarray | None:
        """Availability mask Lambda after removing blocked switches.

        ``avail`` is an optional extra mask (e.g. the orchestrator's
        residual-capacity snapshot); the result is its intersection with
        the non-blocked switches — and the switches whose aggregation
        capacity has degraded all the way to zero, which is the same
        fault expressed continuously — or ``None`` when neither
        constrains. A mask whose shape is not one flag per switch raises
        here, at the planner boundary, instead of broadcasting somewhere
        in the engine.
        """
        if avail is not None:
            avail = np.asarray(avail, bool)
            if avail.shape != (self.tree.n,):
                raise ValueError(f"avail shape {avail.shape} != "
                                 f"({self.tree.n},) — one flag per switch")
        cand = None
        if self.blocked is not None:
            cand = ~self.blocked
        if self.cap_scale is not None:
            dead = np.asarray(self.cap_scale, np.float64) <= 0.0
            if dead.any():
                cand = ~dead if cand is None else cand & ~dead
        if cand is None:
            return avail
        if avail is None:
            return cand
        return avail & cand


def topology_from_arrays(parent, rho, device_leaf, load, blocked=None,
                         cap_scale=None) -> ClusterTopology:
    """A :class:`ClusterTopology` from its fields given as plain numpy data.

    Carries a topology built elsewhere (for instance by the JAX package's
    builders and fault functions) into this package unchanged, so both
    packages plan and execute the identical cluster.
    """
    t = Tree(np.array(parent, np.int32), np.array(rho, np.float64))
    device_leaf = np.array(device_leaf, np.int64)
    load = np.array(load, np.int64)
    if load.shape != (t.n,):
        raise ValueError(f"load shape {load.shape} != ({t.n},)")
    if device_leaf.ndim != 1 or np.any(device_leaf >= t.n):
        raise ValueError("device_leaf must be a vector of switch ids "
                         "(-1 for a failed device)")
    for name, a in (("blocked", blocked), ("cap_scale", cap_scale)):
        if a is not None and np.shape(a) != (t.n,):
            raise ValueError(f"{name} shape {np.shape(a)} != ({t.n},)")
    return ClusterTopology(
        tree=t, device_leaf=device_leaf, load=load,
        blocked=None if blocked is None else np.array(blocked, bool),
        cap_scale=None if cap_scale is None else np.array(cap_scale,
                                                          np.float64))


def fleet_tree(n_pods: int = 2, racks_per_pod: int = 4,
               chips_per_rack: int = 4) -> ClusterTopology:
    """Reduction tree: root spine -> pods -> racks; chips attach to racks.

    Chips are *servers* in the paper's model (they produce the messages);
    racks/pods/spine are the switches, some of which may aggregate.
    """
    parent, rho = [], []
    root = 0
    parent.append(DEST)
    rho.append(RHO_DCN)            # spine -> destination (cross-cluster)
    pods = []
    for p in range(n_pods):
        pods.append(len(parent))
        parent.append(root)
        rho.append(RHO_DCN)        # pod -> spine crosses the DCN
    racks = []
    for p in pods:
        for r in range(racks_per_pod):
            racks.append(len(parent))
            parent.append(p)
            rho.append(RHO_RACK)   # rack -> pod aggregation link
    t = Tree(np.asarray(parent, np.int32), np.asarray(rho))
    load = np.zeros(t.n, np.int64)
    device_leaf = []
    for r in racks:
        for c in range(chips_per_rack):
            device_leaf.append(r)
            load[r] += 1           # each chip contributes one gradient shard
    return ClusterTopology(tree=t, device_leaf=np.asarray(device_leaf),
                           load=load)


def chip_level_tree(n_pods: int = 2, racks_per_pod: int = 4,
                    chips_per_rack: int = 4) -> ClusterTopology:
    """Variant where each chip is its own leaf switch (ToR-of-one); used by
    the reduce executor, whose message homes live on devices."""
    base = fleet_tree(n_pods, racks_per_pod, chips_per_rack)
    parent = list(base.tree.parent)
    rho = list(base.tree.rho)
    load = list(base.load)
    device_leaf = []
    for dev, rack in enumerate(base.device_leaf):
        leaf = len(parent)
        parent.append(int(rack))
        rho.append(RHO_ICI)        # chip -> rack ICI link
        load[int(rack)] = 0
        load.append(1)
        device_leaf.append(leaf)
    t = Tree(np.asarray(parent, np.int32), np.asarray(rho))
    return ClusterTopology(tree=t, device_leaf=np.asarray(device_leaf),
                           load=np.asarray(load, np.int64))


def fail_devices(topo: ClusterTopology, dead: list[int]) -> ClusterTopology:
    """Remove failed chips from the reduction tree (runtime FT path).

    Dead chips stop producing messages; switches whose whole subtree died
    still exist but carry zero load (SOAR then never wastes budget there —
    the zero-load refinement of DESIGN.md §8). Duplicate ids in ``dead``
    are collapsed to one failure; a device that is already failed in
    ``topo`` (``device_leaf[d] == -1``) raises — its leaf's load was
    already released, and ``load[-1]`` would silently drain the *last*
    switch's load instead.
    """
    load = topo.load.copy()
    device_leaf = topo.device_leaf.copy()
    for d in dict.fromkeys(int(d) for d in dead):     # dedupe, keep order
        if not 0 <= d < len(device_leaf):
            raise ValueError(f"device {d} out of range "
                             f"[0, {len(device_leaf)})")
        if device_leaf[d] < 0:
            raise ValueError(f"device {d} is already failed")
        load[device_leaf[d]] -= 1
        device_leaf[d] = -1
    return ClusterTopology(tree=topo.tree, device_leaf=device_leaf, load=load,
                           blocked=topo.blocked, cap_scale=topo.cap_scale)


def fail_switches(topo: ClusterTopology, dead: list[int],
                  isolate: bool = False) -> ClusterTopology:
    """A switch's aggregation plane fails (runtime fault-domain path).

    Default semantics are the in-network-computing fault model (P4COM's
    fallback transport): the switch keeps *forwarding* — the tree, its
    loads and all paths are unchanged — but it can never aggregate again,
    so it leaves the candidate set Lambda (``blocked`` mask; the planner
    paths intersect it into ``avail``).

    ``isolate=True`` models the switch dying outright: every device whose
    leaf lies in a dead switch's subtree is disconnected, so the subtree's
    load drains exactly like :func:`fail_devices` (the tree object stays —
    SOAR simply never spends budget on zero-load subtrees) and the subtree
    re-homes nothing upward.

    Duplicate ids collapse to one failure; a switch already blocked in
    ``topo`` raises — same validate-then-apply discipline as
    :func:`fail_devices`.
    """
    t = topo.tree
    blocked = (np.zeros(t.n, bool) if topo.blocked is None
               else topo.blocked.copy())
    dead = list(dict.fromkeys(int(s) for s in dead))   # dedupe, keep order
    for s in dead:
        if not 0 <= s < t.n:
            raise ValueError(f"switch {s} out of range [0, {t.n})")
        if blocked[s]:
            raise ValueError(f"switch {s} is already failed")
    for s in dead:
        blocked[s] = True
    load = topo.load
    device_leaf = topo.device_leaf
    if isolate:
        # descendants of any dead switch (including the switch itself)
        dead_sub = np.zeros(t.n, bool)
        dead_sub[dead] = True
        for v in t.topo:                       # root first: parent resolved
            p = t.parent[v]
            if p != DEST and dead_sub[p]:
                dead_sub[v] = True
        gone = [d for d, leaf in enumerate(device_leaf)
                if leaf >= 0 and dead_sub[leaf]]
        if gone:
            interim = fail_devices(
                dataclasses.replace(topo, blocked=None), gone)
            load, device_leaf = interim.load, interim.device_leaf
    return ClusterTopology(tree=t, device_leaf=device_leaf, load=load,
                           blocked=blocked, cap_scale=topo.cap_scale)


def degrade_links(topo: ClusterTopology,
                  rates: dict[int, float]) -> ClusterTopology:
    """Scale the up-link rate of the given switches (runtime fault path).

    ``rates[v]`` is the remaining *rate* fraction of edge ``(v, p(v))`` —
    0.5 means the link runs at half its bandwidth, so the reciprocal rate
    doubles (``rho[v] /= rates[v]``); values above 1 speed a link up
    (recovery relative to an already-degraded topology). The tree is
    rebuilt with the new rho — this is exactly the ``rho`` the placement
    DP optimizes over, so replanning through the engine picks it up with
    no special casing.
    """
    t = topo.tree
    rho = t.rho.copy()
    for v, f in rates.items():
        v, f = int(v), float(f)
        if not 0 <= v < t.n:
            raise ValueError(f"switch {v} out of range [0, {t.n})")
        if not np.isfinite(f) or f <= 0:
            raise ValueError(f"rate fraction for switch {v} must be a "
                             f"positive finite number, got {f}")
        rho[v] = rho[v] / f
    return dataclasses.replace(topo, tree=Tree(t.parent, rho))


def degrade_switches(topo: ClusterTopology,
                     scales: dict[int, float]) -> ClusterTopology:
    """Scale the aggregation capacity a(s) of the given switches.

    ``scales[s]`` in ``[0, 1]`` is the remaining fraction of switch
    ``s``'s nominal aggregation capacity — the P4COM/SwitchAgg model
    where a switch's in-network compute is a per-switch *resource* that
    degrades gradually (memory pressure, partial pipeline loss), not a
    boolean. Scales compose multiplicatively with an existing
    ``cap_scale`` (two half-capacity events leave a quarter), mirroring
    :func:`degrade_links`. The ``frac -> 0`` limit composes with
    ``blocked`` / :func:`fail_switches`: a zero-capacity switch leaves
    the candidate set Lambda (see :meth:`ClusterTopology.candidates`)
    while forwarding keeps working, exactly like a blocked switch.

    Validation is all-before-apply: a bad id or a non-finite / out-of-
    range fraction raises before any state is built.
    """
    t = topo.tree
    scale = (np.ones(t.n, np.float64) if topo.cap_scale is None
             else np.asarray(topo.cap_scale, np.float64).copy())
    items = [(int(s), float(f)) for s, f in scales.items()]
    for s, f in items:
        if not 0 <= s < t.n:
            raise ValueError(f"switch {s} out of range [0, {t.n})")
        if not np.isfinite(f) or f < 0 or f > 1:
            raise ValueError(f"capacity scale for switch {s} must be a "
                             f"finite fraction in [0, 1], got {f}")
    for s, f in items:
        scale[s] = scale[s] * f
    return dataclasses.replace(topo, cap_scale=scale)


@dataclasses.dataclass(frozen=True)
class Fleet:
    """N aggregation trees hanging off a shared core (multi-tree setting).

    Each tree is a full :class:`ClusterTopology`; the core is a flat set of
    C extra links with per-link reciprocal rates ``core_rho``. Every
    root-crossing message of a tenant on tree g additionally transits the
    core links in ``core_path[g]`` (its root -> destination path through
    the shared core), which is how tenants on *different* trees become
    congestion-coupled: they meet on shared core link ids.

    Link ids live in one **global link-id space** so per-link traffic from
    different trees lands in one congestion profile::

        [0, n_0)                      tree 0's switch up-links
        [off_g, off_g + n_g)          tree g's up-links, off_g = sum n_<g
        [core_offset, core_offset+C)  the shared-core links

    The single-tree case is the degenerate ``N=1, C=0`` fleet
    (:meth:`single`), not a parallel code path.
    """

    topos: tuple[ClusterTopology, ...]
    core_rho: np.ndarray                    # (C,) reciprocal rates; C may be 0
    core_path: tuple[tuple[int, ...], ...]  # per tree: core link ids crossed

    def __post_init__(self):
        if not self.topos:
            raise ValueError("empty fleet")
        core_rho = np.asarray(self.core_rho, np.float64)
        object.__setattr__(self, "core_rho", core_rho)
        if core_rho.ndim != 1:
            raise ValueError(f"core_rho must be 1-D, got shape "
                             f"{core_rho.shape}")
        if core_rho.size and not (np.isfinite(core_rho).all()
                                  and (core_rho > 0).all()):
            raise ValueError("core_rho entries must be positive and finite")
        if len(self.core_path) != len(self.topos):
            raise ValueError(f"{len(self.core_path)} core paths for "
                             f"{len(self.topos)} trees")
        C = core_rho.size
        path = tuple(tuple(int(c) for c in p) for p in self.core_path)
        object.__setattr__(self, "core_path", path)
        for g, p in enumerate(path):
            if len(set(p)) != len(p):
                raise ValueError(f"core path of tree {g} repeats a link: {p}")
            for c in p:
                if not 0 <= c < C:
                    raise ValueError(f"core link {c} on tree {g}'s path out "
                                     f"of range [0, {C})")

    @property
    def n_trees(self) -> int:
        return len(self.topos)

    @property
    def n_core(self) -> int:
        return int(self.core_rho.size)

    @property
    def link_offsets(self) -> tuple[int, ...]:
        """Global-link-id segment start of each tree's up-links."""
        offs, s = [], 0
        for tp in self.topos:
            offs.append(s)
            s += tp.tree.n
        return tuple(offs)

    @property
    def core_offset(self) -> int:
        """First global link id of the shared-core segment."""
        return sum(tp.tree.n for tp in self.topos)

    @property
    def n_links(self) -> int:
        return self.core_offset + self.n_core

    @classmethod
    def single(cls, topo: ClusterTopology) -> "Fleet":
        """The degenerate one-tree fleet (no shared core)."""
        return cls(topos=(topo,), core_rho=np.zeros(0, np.float64),
                   core_path=((),))


def build_fleet(n_trees: int = 2, n_pods: int = 2, racks_per_pod: int = 4,
                chips_per_rack: int = 4, *, spine_rho: float = RHO_DCN,
                uplink_rho: float | None = None) -> Fleet:
    """N :func:`fleet_tree` topologies sharing one core spine link.

    Every tree's root-crossing traffic transits a single shared DCN spine
    (core link with rate ``spine_rho``) — the minimal fleet in which trees
    contend. ``uplink_rho`` additionally gives each tree a dedicated core
    up-link (tree root -> spine) on its path, modelling per-tree core
    attachment capacity.
    """
    if n_trees < 1:
        raise ValueError(f"need at least one tree, got {n_trees}")
    topos = tuple(fleet_tree(n_pods, racks_per_pod, chips_per_rack)
                  for _ in range(n_trees))
    if uplink_rho is None:
        core_rho = np.asarray([spine_rho], np.float64)
        core_path = tuple((0,) for _ in range(n_trees))
    else:
        core_rho = np.asarray([uplink_rho] * n_trees + [spine_rho],
                              np.float64)
        core_path = tuple((g, n_trees) for g in range(n_trees))
    return Fleet(topos=topos, core_rho=core_rho, core_path=core_path)
