"""Padded batch representation of many phi-BIC instances (a *forest*).

The multi-tenant setting (paper Sec. 5.2) solves one placement instance per
workload; a production engine solves B of them at once. ``Forest`` stacks B
trees of varying shape into dense ``(B, n_max)`` node-indexed arrays with
validity masks, plus a **level-packed slot layout** that the batched
gather in ``repro_torch.engine`` consumes:

  * slots are grouped by depth — every level is one contiguous block, so
    the level-synchronous sweep writes its results with *static* slice
    updates instead of scatters (the difference between a fused memcpy and
    a general scatter op on CPU/TPU);
  * within a level block, internal nodes come first and leaves last: the
    expensive child-fold (the mCost tropical convolution) only runs over
    the internal sub-block, leaves are pure elementwise;
  * missing children point at an *identity* slot (index ``n_slots``) whose
    table is all zeros — for monotone (at-most-k) DP tables the all-zeros
    vector is a min-plus identity, so folding a missing child is a no-op;
  * padded slots inside a block fold only identities and carry zero
    load / BIG rho, so their garbage stays finite and is never read.

Everything here is host-side numpy. Per-tree structure (children matrix,
depth buckets, rho-up table) is cached on the tree object's identity, so a
fleet reusing one topology — the common serving pattern — pays the packing
cost once. Layout bucketing maps batches of *similar* shapes onto one
packed layout (:func:`layout_key`), so group instances by size when
throughput matters.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Sequence

import numpy as np

from .tree import DEST, Tree


@dataclasses.dataclass(frozen=True)
class _TreeStruct:
    """Load-independent per-tree arrays (cached by tree identity)."""

    max_c: int
    kid: np.ndarray                 # (n, max(max_c, 1)) int32; -1 sentinel
    rho_up: np.ndarray              # (n, height+2) float64; inf invalid
    internal: tuple[np.ndarray, ...]  # node ids with children, per depth
    leaf: tuple[np.ndarray, ...]      # leaf node ids, per depth
    sub: np.ndarray                 # (n,) int64 subtree sizes
    ni: tuple[int, ...]             # len(internal[d]) per depth
    nl: tuple[int, ...]             # len(leaf[d]) per depth
    submax: tuple[int, ...]         # max subtree size at depth d


_STRUCT_CACHE: dict[int, tuple] = {}


def _tree_struct(t: Tree) -> _TreeStruct:
    key = id(t)
    hit = _STRUCT_CACHE.get(key)
    if hit is not None and hit[0]() is t:
        return hit[1]
    n, h = t.n, t.height
    max_c = max((len(t.children[v]) for v in range(n)), default=0)
    kid = np.full((n, max(max_c, 1)), -1, np.int32)
    internal: list[list[int]] = [[] for _ in range(h + 1)]
    leaf: list[list[int]] = [[] for _ in range(h + 1)]
    for v in range(n):
        ch = t.children[v]
        if ch:
            kid[v, : len(ch)] = ch
            internal[t.depth[v]].append(v)
        else:
            leaf[t.depth[v]].append(v)
    sub = t.subtree_sizes()
    s = _TreeStruct(
        max_c=max_c, kid=kid, rho_up=t.rho_up_table(),
        internal=tuple(np.asarray(l, np.int32) for l in internal),
        leaf=tuple(np.asarray(l, np.int32) for l in leaf),
        sub=sub,
        ni=tuple(len(l) for l in internal),
        nl=tuple(len(l) for l in leaf),
        submax=tuple(
            int(sub[internal[d] + leaf[d]].max())
            if internal[d] or leaf[d] else 0
            for d in range(h + 1)))
    _STRUCT_CACHE[key] = (weakref.ref(t, lambda _, k=key:
                                      _STRUCT_CACHE.pop(k, None)), s)
    return s


@dataclasses.dataclass(frozen=True)
class Forest:
    """B phi-BIC instances padded into dense arrays (see module docstring)."""

    # -- node-indexed (original per-tree node ids, padded to n_max) ----------
    trees: tuple[Tree, ...]        # originals (for unpacking / debugging)
    parent: np.ndarray             # (B, n_max) int32; -1 root, -2 padding
    rho: np.ndarray                # (B, n_max) float64; 1.0 padding
    load: np.ndarray               # (B, n_max) int64; 0 padding
    avail: np.ndarray              # (B, n_max) bool; False padding
    mask: np.ndarray               # (B, n_max) bool; True at real nodes
    depth: np.ndarray              # (B, n_max) int32; -1 padding
    root: np.ndarray               # (B,) int32
    n: np.ndarray                  # (B,) int64 — real node counts
    height: np.ndarray             # (B,) int32
    kid: np.ndarray                # (B, n_max, max_c) int32; sentinel n_max
    rho_up: np.ndarray             # (B, n_max, h_max+2) float64; inf invalid
    send: np.ndarray               # (B, n_max) int64; 1 iff subtree load > 0
    sub_size: np.ndarray           # (B, n_max) int64 subtree sizes; 0 padding
    levels: tuple[np.ndarray, ...]  # levels[d]: (B, W_d) int32 node ids at
                                    # depth d, padded with n_max
    # -- level-packed (slot-indexed) layout for the batched gather ----------
    slot_of: np.ndarray            # (B, n_max) int32 node -> slot; n_slots pad
    slot_node: np.ndarray          # (B, n_slots) int32 slot -> node; -1 pad
    pk_kid: np.ndarray             # (B, n_slots, max_c) int32 child slots;
                                   #   sentinel n_slots (the identity slot)
    pk_par: np.ndarray             # (B, n_slots) int32: parent's index
                                   #   *within its own level block* (0 for
                                   #   roots/padding) — the on-device color
                                   #   gathers its budget from here
    pk_cidx: np.ndarray            # (B, n_slots) int32: this slot's index in
                                   #   its parent's child list (0 roots/pad)
    pk_load: np.ndarray            # (B, n_slots) int64
    pk_send: np.ndarray            # (B, n_slots) int64
    pk_avail: np.ndarray           # (B, n_slots) bool
    pk_rho_up: np.ndarray          # (B, n_slots, h_max+2) float64; inf pad
    lvl_off: tuple[int, ...]       # level d block = slots [lvl_off[d],
    lvl_width: tuple[int, ...]     #   lvl_off[d] + lvl_width[d])
    lvl_internal: tuple[int, ...]  # first lvl_internal[d] slots of the block
                                   #   are internal nodes, the rest leaves
    lvl_sub: tuple[int, ...]       # max subtree size of any node at level d
                                   #   (static knapsack bound: a level-d table
                                   #   never needs more than min(k, lvl_sub[d])
                                   #   + 1 budget columns)

    @property
    def batch(self) -> int:
        return len(self.trees)

    @property
    def n_max(self) -> int:
        return int(self.parent.shape[1])

    @property
    def n_slots(self) -> int:
        return int(self.slot_node.shape[1])

    @property
    def h_max(self) -> int:
        return int(self.rho_up.shape[2] - 2)

    @property
    def max_children(self) -> int:
        return int(self.kid.shape[2])


def _bucket_up(x: int) -> int:
    """Round up to the next power of two (0 and 1 are their own buckets)."""
    return x if x <= 1 else 1 << (x - 1).bit_length()


# packing telemetry: how many forests were packed, and how many *distinct*
# layouts those forests map to (see :func:`layout_key`).
_LAYOUTS_SEEN: set[tuple] = set()
_FORESTS_BUILT: int = 0


def layout_key(f: Forest) -> tuple:
    """The static shape of this forest's packed layout.

    Two forests with equal layout keys run the engine's level sweep with
    identical per-level kernel shapes.
    """
    return (f.batch, f.n_max, f.n_slots, f.h_max, f.max_children,
            f.lvl_off, f.lvl_width, f.lvl_internal, f.lvl_sub)


def layout_stats() -> dict:
    """Packing-side telemetry: forests built vs distinct layouts."""
    return {"forests_built": _FORESTS_BUILT,
            "distinct_layouts": len(_LAYOUTS_SEEN)}


def build_forest(
    trees: Sequence[Tree],
    loads: Sequence[np.ndarray],
    avail: Sequence[np.ndarray] | None = None,
    *,
    bucket: bool = True,
) -> Forest:
    """Stack B (tree, load[, avail]) instances into one padded Forest.

    ``bucket=True`` (default) rounds the layout dimensions (see
    :func:`layout_key`) — per-level internal/leaf widths,
    ``max_children``, the per-level subtree-size caps, and ``h_max`` (to
    the next even height) — up to bucket boundaries (powers of two).
    Ragged multi-tenant batches whose exact shapes differ then collapse
    onto a handful of layouts; the extra slots are ordinary padded slots
    (identity children, zero load) that the sweep already tolerates.
    ``bucket=False`` packs exact shapes. The packing is the JAX
    package's, field for field.
    """
    if len(trees) == 0:
        raise ValueError("empty forest")
    if len(loads) != len(trees):
        raise ValueError(f"{len(loads)} loads for {len(trees)} trees")
    if avail is not None and len(avail) != len(trees):
        raise ValueError(f"{len(avail)} avail masks for {len(trees)} trees")
    B = len(trees)
    structs = [_tree_struct(t) for t in trees]
    n_max = max(t.n for t in trees)
    h_max = max(t.height for t in trees)
    max_c = max(max(s.max_c for s in structs), 1)
    if bucket:
        n_max = _bucket_up(n_max)
        h_max += h_max & 1           # next even height
        max_c = _bucket_up(max_c)
    H2 = h_max + 2

    parent = np.full((B, n_max), -2, np.int32)
    rho = np.ones((B, n_max), np.float64)
    load_a = np.zeros((B, n_max), np.int64)
    avail_a = np.zeros((B, n_max), bool)
    mask = np.zeros((B, n_max), bool)
    depth = np.full((B, n_max), -1, np.int32)
    root = np.zeros(B, np.int32)
    nn = np.zeros(B, np.int64)
    height = np.zeros(B, np.int32)
    kid = np.full((B, n_max, max_c), n_max, np.int32)   # identity sentinel
    rho_up = np.full((B, n_max, H2), np.inf, np.float64)
    sub_size = np.zeros((B, n_max), np.int64)

    for b, (t, s) in enumerate(zip(trees, structs)):
        n = t.n
        L = np.asarray(loads[b], np.int64)
        if L.shape != (n,):
            raise ValueError(f"load {b} shape {L.shape} != ({n},)")
        parent[b, :n] = t.parent
        rho[b, :n] = t.rho
        load_a[b, :n] = L
        avail_a[b, :n] = (np.ones(n, bool) if avail is None or avail[b] is None
                          else np.asarray(avail[b], bool))
        mask[b, :n] = True
        depth[b, :n] = t.depth
        root[b] = t.root
        nn[b] = n
        height[b] = t.height
        mc = s.kid.shape[1]
        kid[b, :n, :mc] = np.where(s.kid >= 0, s.kid, n_max)
        rho_up[b, :n, : t.height + 2] = s.rho_up
        sub_size[b, :n] = s.sub

    heights = [int(h) for h in height]
    levels = []
    for d in range(h_max + 1):
        W = max(max((s.ni[d] + s.nl[d] if d <= h else 0
                     for h, s in zip(heights, structs)), default=0), 1)
        lvl = np.full((B, W), n_max, np.int32)
        for b, (h, s) in enumerate(zip(heights, structs)):
            if d > h:
                continue
            ni = s.ni[d]
            lvl[b, :ni] = s.internal[d]
            lvl[b, ni : ni + s.nl[d]] = s.leaf[d]
        levels.append(lvl)

    # send(v) = 1 iff subtree load positive: bottom-up level sweep, batched
    sub = load_a.copy()
    for d in range(h_max, 0, -1):
        nd = levels[d]
        bv, wv = np.nonzero(nd < n_max)
        vv = nd[bv, wv]
        np.add.at(sub, (bv, parent[bv, vv]), sub[bv, vv])
    send = (sub > 0).astype(np.int64)

    # ---- level-packed slot layout -----------------------------------------
    lvl_off, lvl_width, lvl_internal, lvl_sub = [], [], [], []
    S = 0
    for d in range(h_max + 1):
        wi = max((s.ni[d] for h, s in zip(heights, structs) if d <= h),
                 default=0)
        wl = max((s.nl[d] for h, s in zip(heights, structs) if d <= h),
                 default=0)
        sub_d = max((s.submax[d] for h, s in zip(heights, structs)
                     if d <= h), default=0)
        if bucket:
            wi, wl, sub_d = _bucket_up(wi), _bucket_up(wl), _bucket_up(sub_d)
        lvl_off.append(S)
        lvl_internal.append(wi)
        lvl_width.append(wi + wl)
        lvl_sub.append(sub_d)
        S += wi + wl
    slot_of = np.full((B, n_max), S, np.int32)
    slot_node = np.full((B, S), -1, np.int32)
    for b, (h, s) in enumerate(zip(heights, structs)):
        for d in range(h + 1):
            o, wi = lvl_off[d], lvl_internal[d]
            vi, vl = s.internal[d], s.leaf[d]
            slot_of[b, vi] = o + np.arange(len(vi), dtype=np.int32)
            slot_node[b, o : o + len(vi)] = vi
            slot_of[b, vl] = o + wi + np.arange(len(vl), dtype=np.int32)
            slot_node[b, o + wi : o + wi + len(vl)] = vl
    real = slot_node >= 0
    src = np.where(real, slot_node, 0)
    bix = np.arange(B)[:, None]
    pk_load = np.where(real, load_a[bix, src], 0)
    pk_send = np.where(real, send[bix, src], 0)
    pk_avail = np.where(real, avail_a[bix, src], False)
    pk_rho_up = np.where(real[:, :, None], rho_up[bix, src], np.inf)
    ch = kid[bix, src]                                  # (B, S, max_c)
    ch_slot = np.where(
        ch < n_max,
        slot_of[bix[:, :, None], np.minimum(ch, n_max - 1)], S)
    pk_kid = np.where(real[:, :, None], ch_slot, S).astype(np.int32)

    # inverse child pointers: each slot's parent position (local to the
    # parent's level block) and its own index in the parent's child list —
    # the top-down color sweep *gathers* its budget/distance through these
    # instead of scattering parent -> child (scatter-free jit graphs).
    off_of_slot = np.zeros(S, np.int64)
    for d in range(h_max + 1):
        off_of_slot[lvl_off[d] : lvl_off[d] + lvl_width[d]] = lvl_off[d]
    pk_par = np.zeros((B, S), np.int32)
    pk_cidx = np.zeros((B, S), np.int32)
    bs, ss, ms = np.nonzero(pk_kid < S)
    cs = pk_kid[bs, ss, ms]
    pk_par[bs, cs] = (ss - off_of_slot[ss]).astype(np.int32)
    pk_cidx[bs, cs] = ms.astype(np.int32)

    f = Forest(trees=tuple(trees), parent=parent, rho=rho, load=load_a,
               avail=avail_a, mask=mask, depth=depth, root=root, n=nn,
               height=height, kid=kid, rho_up=rho_up, send=send,
               sub_size=sub_size, levels=tuple(levels),
               slot_of=slot_of, slot_node=slot_node, pk_kid=pk_kid,
               pk_par=pk_par, pk_cidx=pk_cidx,
               pk_load=pk_load, pk_send=pk_send, pk_avail=pk_avail,
               pk_rho_up=pk_rho_up, lvl_off=tuple(lvl_off),
               lvl_width=tuple(lvl_width),
               lvl_internal=tuple(lvl_internal), lvl_sub=tuple(lvl_sub))
    global _FORESTS_BUILT
    _FORESTS_BUILT += 1
    _LAYOUTS_SEEN.add(layout_key(f))
    return f


@dataclasses.dataclass(frozen=True)
class FleetLayout:
    """Per-tree segment + shared-link index maps for a multi-tree forest.

    ``build_fleet_forest`` packs T tenant instances — tenant t living on
    tree ``tree_of[t]`` — through the ordinary :func:`build_forest` path
    (a single-tree fleet therefore produces a bit-identical ``Forest`` to
    today's ``build_forest``), and this side table records how the
    instances map back onto the fleet's **global link-id space**: tree g's
    switch up-links occupy ``[link_off[g], link_off[g] + tree_n[g])`` and
    the C shared-core links occupy ``[core_offset, core_offset + C)``.
    """

    tree_of: np.ndarray            # (T,) int32 tenant -> tree index
    n_trees: int
    rep: np.ndarray                # (N,) int64 first tenant on each tree —
                                   #   that batch row carries the tree's
                                   #   canonical layout (slot_of etc.)
    tree_n: np.ndarray             # (N,) int64 real node count per tree
    link_off: np.ndarray           # (N,) int64 global-link segment starts
    core_offset: int               # first global id of the core segment
    core_rho: np.ndarray           # (C,) float64; C may be 0
    core_path: tuple[tuple[int, ...], ...]  # per tree: core links crossed
    core_inc: np.ndarray           # (T, C) bool — tenant t crosses core c

    @property
    def n_core(self) -> int:
        return int(self.core_rho.size)

    @property
    def n_links(self) -> int:
        return self.core_offset + self.n_core


def build_fleet_forest(
    trees: Sequence[Tree],
    loads: Sequence[np.ndarray],
    tree_of: Sequence[int],
    avail: Sequence[np.ndarray] | None = None,
    *,
    core_rho: np.ndarray | None = None,
    core_path: Sequence[Sequence[int]] | None = None,
    bucket: bool = True,
) -> tuple[Forest, FleetLayout]:
    """Pack T tenants living on N distinct trees into one Forest + layout.

    ``trees`` holds the N *distinct* tree objects; ``tree_of[t]`` names
    tenant t's tree. The Forest itself is built by replicating each
    tenant's tree into the batch — exactly ``build_forest([trees[g] for g
    in tree_of], ...)`` — so for ``tree_of == [0]*T`` the packed layout is
    bit-identical to the single-tree call it refactors. Every tree must
    carry at least one tenant (the per-tree congestion profile needs a
    representative batch row for its layout).
    """
    N = len(trees)
    if N == 0:
        raise ValueError("empty fleet")
    tid = np.asarray(list(tree_of), np.int32)
    T = tid.size
    if T == 0:
        raise ValueError("no tenants")
    if len(loads) != T:
        raise ValueError(f"{len(loads)} loads for {T} tenants")
    if tid.min() < 0 or tid.max() >= N:
        raise ValueError(f"tree_of entries must lie in [0, {N})")
    rep = np.full(N, -1, np.int64)
    for t in range(T - 1, -1, -1):
        rep[tid[t]] = t
    if (rep < 0).any():
        empty = [int(g) for g in np.nonzero(rep < 0)[0]]
        raise ValueError(f"trees {empty} carry no tenant — every fleet "
                         f"tree needs at least one")
    tree_n = np.asarray([t.n for t in trees], np.int64)
    link_off = np.concatenate([[0], np.cumsum(tree_n)[:-1]])
    core_offset = int(tree_n.sum())
    crho = (np.zeros(0, np.float64) if core_rho is None
            else np.asarray(core_rho, np.float64))
    C = crho.size
    if crho.ndim != 1:
        raise ValueError(f"core_rho must be 1-D, got shape {crho.shape}")
    path = (tuple(() for _ in range(N)) if core_path is None
            else tuple(tuple(int(c) for c in p) for p in core_path))
    if len(path) != N:
        raise ValueError(f"{len(path)} core paths for {N} trees")
    core_inc = np.zeros((T, C), bool)
    for g, p in enumerate(path):
        for c in p:
            if not 0 <= c < C:
                raise ValueError(f"core link {c} on tree {g}'s path out of "
                                 f"range [0, {C})")
        core_inc[tid == g] = np.isin(np.arange(C), list(p))
    f = build_forest([trees[g] for g in tid], list(loads), avail,
                     bucket=bucket)
    lay = FleetLayout(tree_of=tid, n_trees=N, rep=rep, tree_n=tree_n,
                      link_off=link_off.astype(np.int64),
                      core_offset=core_offset, core_rho=crho,
                      core_path=path, core_inc=core_inc)
    return f, lay


_ARRAY_FIELDS = {
    "parent": np.int32, "rho": np.float64, "load": np.int64,
    "avail": bool, "mask": bool, "depth": np.int32, "root": np.int32,
    "n": np.int64, "height": np.int32, "kid": np.int32,
    "rho_up": np.float64, "send": np.int64, "sub_size": np.int64,
    "slot_of": np.int32, "slot_node": np.int32, "pk_kid": np.int32,
    "pk_par": np.int32, "pk_cidx": np.int32, "pk_load": np.int64,
    "pk_send": np.int64, "pk_avail": bool, "pk_rho_up": np.float64,
}
_TUPLE_FIELDS = ("lvl_off", "lvl_width", "lvl_internal", "lvl_sub")


def forest_from_arrays(fields: dict) -> Forest:
    """A :class:`Forest` from its fields given as plain numpy data.

    ``fields`` names every ``Forest`` field: arrays for the padded and
    packed tables, int tuples for ``lvl_*``, a sequence of ``(B, W_d)``
    arrays for ``levels``, and for ``trees`` a sequence of ``Tree`` or of
    ``(parent, rho)`` pairs. This carries a packing made elsewhere (for
    instance by the JAX package's ``build_forest``) into this package
    unchanged, so both engines can be fed the identical layout.
    """
    names = {f.name for f in dataclasses.fields(Forest)}
    missing = sorted(names - set(fields))
    extra = sorted(set(fields) - names)
    if missing or extra:
        raise ValueError(f"Forest fields: missing {missing}, unknown {extra}")
    trees = tuple(t if isinstance(t, Tree) else Tree(*t)
                  for t in fields["trees"])
    kw = {name: np.array(fields[name], dtype)
          for name, dtype in _ARRAY_FIELDS.items()}
    kw.update({name: tuple(int(x) for x in fields[name])
               for name in _TUPLE_FIELDS})
    kw["levels"] = tuple(np.array(lv, np.int32) for lv in fields["levels"])
    f = Forest(trees=trees, **kw)
    B, S = f.slot_node.shape
    if len(trees) != B or f.parent.shape[0] != B:
        raise ValueError(f"{len(trees)} trees for a batch of {B}")
    if f.pk_kid.shape[:2] != (B, S) or f.pk_rho_up.shape[:2] != (B, S):
        raise ValueError("packed arrays disagree on (batch, n_slots)")
    if sum(f.lvl_width) != S or len(f.lvl_off) != f.h_max + 1:
        raise ValueError("level blocks do not tile the slot layout")
    return f
