"""SOAR placement -> static reduction program (the collective schedule).

Builds, for a cluster tree + blue placement, the exact message-passing
program the executor (:mod:`repro_torch.collectives.tree_allreduce`) runs:
which device sends which buffer slots to whom in each round, and where
partial sums are materialized. All counts are static (topology, loads and
coloring are known), so the program is a plain Python object.

A copy of the JAX package's ``collectives/schedule.py``: ``plan`` and
``plan_batch`` run :func:`repro_torch.engine.solve_batch`,
``plan_congestion`` and ``plan_fleet`` the penalty loop
(:func:`repro_torch.engine.solve_congestion` / ``solve_fleet``), and every
tenant's program comes from :func:`build_program`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import baselines
from ..core.reduce import messages_up, messages_up_degraded, phi_degraded
from ..engine import solve_batch, solve_congestion, solve_fleet
from ..engine.options import EngineOptions, resolve_options
from .topology import ClusterTopology, Fleet


def _check_capacity(capacity, n: int, where: str):
    """Boundary validation of a per-switch capacity vector: shape (n,),
    finite, non-negative. Returns the float64 copy the engine consumes."""
    c = np.asarray(capacity, np.float64)
    if c.shape != (n,):
        raise ValueError(f"{where}: capacity shape {c.shape} != ({n},)")
    if not np.all(np.isfinite(c)) or np.any(c < 0):
        raise ValueError(f"{where}: capacity must be finite and "
                         "non-negative")
    return c


def _check_residual(residual, n: int, where: str):
    """Boundary validation of a per-switch residual-capacity ledger:
    shape (n,), finite, integer-valued, non-negative. Returns the int64
    copy the engine's hard-admission path consumes."""
    r = np.asarray(residual)
    if r.shape != (n,):
        raise ValueError(f"{where}: residual shape {r.shape} != ({n},)")
    rf = r.astype(np.float64)
    if not np.all(np.isfinite(rf)) or np.any(rf != np.floor(rf)):
        raise ValueError(f"{where}: residual must be integer-valued and "
                         "finite")
    if np.any(rf < 0):
        raise ValueError(f"{where}: residual must be non-negative")
    return r.astype(np.int64)


@dataclasses.dataclass
class PermuteRound:
    perm: list                      # [(src_dev, dst_dev)]
    slab: int                       # slots sent per pair
    recv_offset: np.ndarray         # (n_dev,) slot offset at receiver
    recv_count: np.ndarray          # (n_dev,) valid incoming slots


@dataclasses.dataclass
class CompressOp:
    flag: np.ndarray                # (n_dev,) bool: device compresses now
    width: np.ndarray               # (n_dev,) slots folded into slot 0
                                    # (strict left fold; slots [1, width)
                                    # are cleared, slots >= width kept —
                                    # a degraded switch's raw overflow)


@dataclasses.dataclass
class FoldOp:
    """Host completion of a degraded child's spilled aggregation.

    The child delivered ``[P', x_m, .., x_{w-1}]`` (its partial fold plus
    the raw overflow); the parent's home continues the *same* left fold —
    ``((P' + x_m) + ...) + x_{w-1}`` — writing the completed sum back at
    the span's first slot. Because P' is the prefix of the fault-free
    fold, the result is bit-identical to the pristine aggregation.
    """
    start: np.ndarray               # (n_dev,) first slot of the span
    count: np.ndarray               # (n_dev,) slots in the span (0 = idle)
    span: int                       # static loop bound (max count)


@dataclasses.dataclass
class CompactOp:
    """Static per-device slot gather: ``buf[i] = buf[src[dev, i]]``.

    ``src[dev, i] == -1`` zero-fills. Restores the *fault-free* slot
    layout after spilled deliveries were folded (and clears the stale
    overflow slots), so every op downstream of a degraded level is the
    byte-for-byte pristine program.
    """
    src: np.ndarray                 # (n_dev, n_slots) int32 gather map


@dataclasses.dataclass
class ReduceProgram:
    n_dev: int
    n_slots: int
    ops: list                       # PermuteRound | CompressOp | FoldOp
                                    # | CompactOp
    root_home: int
    root_count: int
    utilization: float              # phi of the underlying placement
                                    # (phi_degraded under reduced capacity)
    total_network_messages: int     # logical messages (== sum msgs_up,
                                    # incl. spilled overflow)


def build_program(topo: ClusterTopology, blue: np.ndarray) -> ReduceProgram:
    t = topo.tree
    load = topo.load
    blue = np.asarray(blue, bool)
    if topo.blocked is not None and np.any(blue & topo.blocked):
        raise ValueError("blue placement aggregates at a failed switch")
    scale = (None if topo.cap_scale is None
             else np.asarray(topo.cap_scale, np.float64))
    if scale is not None and np.any(blue & (scale <= 0.0)):
        raise ValueError("blue placement aggregates at a zero-capacity "
                         "switch")
    if any(load[v] > 0 and len(t.children[v]) > 0 for v in range(t.n)):
        raise ValueError("executor supports leaf-only loads")
    n_dev = topo.n_devices
    msgs = messages_up(t, load, blue)      # fault-free out-counts

    # degraded execution: a blue switch at capacity scale a < 1 folds only
    # the first m = agg_width(w, a) of its w inputs and spills the
    # o = w - m overflow raw one hop up, where the parent's *host*
    # completes the same left fold. out_dl is what each switch actually
    # sends (msgs + its own overflow); everything above a spill carries
    # the fault-free count again.
    out_dl = messages_up_degraded(t, load, blue, scale)
    over = out_dl - msgs

    # homes: leaf -> its device; internal -> home of first nonempty child
    home = np.full(t.n, -1, np.int64)
    for dev, leaf in enumerate(topo.device_leaf):
        if leaf >= 0:
            home[leaf] = dev
    for v in t.topo[::-1]:
        if home[v] < 0:
            for c in t.children[v]:
                if home[c] >= 0:
                    home[v] = home[c]
                    break

    ops: list = []
    compacts: list[tuple[CompactOp, dict]] = []   # pad rows at the end
    n_slots = 1
    # process internal switches level by level (deepest parents first)
    order = [v for v in t.topo[::-1] if t.children[v]]
    level_of = {v: int(t.depth[v]) for v in range(t.n)}
    for depth in sorted({level_of[v] for v in order}, reverse=True):
        parents = [v for v in order if level_of[v] == depth]
        maxc = max(len(t.children[v]) for v in parents)
        for ci in range(1, maxc):   # child 0 lives at the parent's home
            perm, roff, rcnt = [], np.zeros(n_dev, np.int64), np.zeros(n_dev, np.int64)
            slab = 0
            for p in parents:
                kids = [c for c in t.children[p] if home[c] >= 0]
                if ci >= len(kids):
                    continue
                c = kids[ci]
                cnt = int(out_dl[c])
                if cnt == 0 or home[c] == home[p]:
                    continue
                off = int(load[p]) + sum(int(out_dl[kids[j]])
                                         for j in range(ci))
                perm.append((int(home[c]), int(home[p])))
                roff[home[p]] = off
                rcnt[home[p]] = cnt
                slab = max(slab, cnt)
                n_slots = max(n_slots, off + cnt)
            if perm:
                ops.append(PermuteRound(perm, slab, roff, rcnt))
        # host completion of spilled children: fold each degraded child's
        # [P', overflow...] span in delivery order, then compact back to
        # the fault-free slot layout so every op above this level is the
        # byte-for-byte pristine program
        spans = {}                  # parent -> [(child, dl_off, dl_cnt)]
        spilled = {}                # parent -> [(dl_off, dl_cnt)]
        for p in parents:
            kids = [c for c in t.children[p] if home[c] >= 0]
            off, sp, spl = int(load[p]), [], []
            for c in kids:
                cnt = int(out_dl[c])
                sp.append((c, off, cnt))
                if over[c] > 0 and cnt > 0:
                    spl.append((off, cnt))
                    n_slots = max(n_slots, off + cnt)
                off += cnt
            spans[p] = sp
            if spl:
                spilled[p] = spl
        fold_round = 0
        while any(fold_round < len(spl) for spl in spilled.values()):
            start = np.zeros(n_dev, np.int64)
            count = np.zeros(n_dev, np.int64)
            for p, spl in spilled.items():
                if fold_round < len(spl):
                    off_c, cnt = spl[fold_round]
                    start[home[p]] = off_c
                    count[home[p]] = cnt
            ops.append(FoldOp(start, count, int(count.max())))
            fold_round += 1
        if spilled:
            rows = {}
            for p in spilled:
                row = []
                for i in range(int(load[p])):
                    row.append(i)
                for c, dl_off, _ in spans[p]:
                    # a spilled child collapsed to 1 message at dl_off;
                    # others map their whole fault-free span
                    for j in range(int(msgs[c])):
                        row.append(dl_off + j)
                rows[int(home[p])] = np.asarray(row, np.int32)
            op = CompactOp(src=None)
            compacts.append((op, rows))
            ops.append(op)
        # compress at blue parents of this level (fault-free widths; a
        # degraded parent folds only its first `total - over` inputs)
        flag = np.zeros(n_dev, bool)
        width = np.ones(n_dev, np.int64)
        any_comp = False
        self_rows = {}
        for p in parents:
            if blue[p] and home[p] >= 0:
                kids = [c for c in t.children[p] if home[c] >= 0]
                total = int(load[p]) + sum(int(msgs[c]) for c in kids)
                if total > 1:
                    m = total - int(over[p])
                    flag[home[p]] = True
                    width[home[p]] = m
                    n_slots = max(n_slots, total)
                    any_comp = True
                    if over[p] > 0:
                        # [P' at 0, raw x_m..x_{w-1}] -> contiguous
                        # [P', x_m, ..] for the delivery upward
                        row = [0] + [m + j for j in range(int(over[p]))]
                        self_rows[int(home[p])] = np.asarray(row, np.int32)
        if any_comp:
            ops.append(CompressOp(flag, width))
        if self_rows:
            op = CompactOp(src=None)
            compacts.append((op, self_rows))
            ops.append(op)

    # finalize compact gather maps now that n_slots is known: uninvolved
    # devices keep an identity row; involved rows zero-fill (-1) past the
    # mapped extent, clearing stale overflow slots
    for op, rows in compacts:
        src = np.tile(np.arange(n_slots, dtype=np.int32), (n_dev, 1))
        for dev, row in rows.items():
            src[dev, : len(row)] = row
            src[dev, len(row):] = -1
        op.src = src

    r = t.root
    return ReduceProgram(
        n_dev=n_dev,
        n_slots=n_slots,
        ops=ops,
        root_home=int(home[r]),
        root_count=int(out_dl[r]),
        utilization=phi_degraded(t, load, blue, scale),
        total_network_messages=int(out_dl.sum()),
    )


@dataclasses.dataclass(frozen=True)
class TenantPlan:
    """One planned tenant: the blue mask, its compiled program, its cost.

    ``cost`` is the placement's utilization (phi on the original rho, the
    same number :class:`ReduceProgram` carries). Iterable-unpacking keeps
    the historical ``blue, program = plan(...)`` spelling working."""

    blue: np.ndarray
    program: ReduceProgram
    cost: float

    def __iter__(self):
        return iter((self.blue, self.program))


@dataclasses.dataclass(frozen=True)
class CongestionPlan:
    """:func:`plan_congestion`'s result: per-tenant plans + diagnostics.

    ``plans`` is a list of :class:`TenantPlan` in tenant order; ``result``
    the driver's ``CongestionResult`` (baseline vs achieved congestion,
    rounds, history, transfer accounting). Unpacks as the historical
    ``planned, res = plan_congestion(...)`` pair."""

    plans: list
    result: object                 # repro_torch.engine.CongestionResult

    def __iter__(self):
        return iter((self.plans, self.result))

    @property
    def max_congestion(self) -> float:
        return self.result.max_congestion

    @property
    def improvement(self) -> float:
        return self.result.improvement


def plan(topo: ClusterTopology, k: int, avail: np.ndarray | None = None,
         strategy: str = "soar", *, options: EngineOptions | None = None,
         **engine_kw) -> TenantPlan:
    """Choose the blue set for a budget k and build the program.

    A single-topology :func:`plan_batch`: ``strategy="soar"`` runs the
    batched engine, on the card unless ``options=EngineOptions(
    device="cpu")``, and the mask is that of a batch of one. Returns a
    :class:`TenantPlan`; ``blue, program = plan(...)`` unpacks."""
    return plan_batch([topo], k, [avail], strategy=strategy,
                      options=options, **engine_kw)[0]


def plan_batch(topos: list[ClusterTopology], k: int,
               avails: list[np.ndarray | None] | None = None,
               strategy: str = "soar", *,
               options: EngineOptions | None = None, **engine_kw):
    """Batched planning: place B scenarios/workloads in one engine solve.

    For ``strategy="soar"`` all instances run through
    :func:`repro_torch.engine.solve_batch`, the device-resident solve
    (level-fold gather and color on the card), so only the blue masks and
    costs the program builder needs leave the device. Engine behavior
    comes from ``options=EngineOptions(...)``; stray keyword arguments
    raise ``TypeError`` at this boundary. Other strategies run the serial
    per-instance baselines of :mod:`repro_torch.core.baselines`.
    Returns ``[TenantPlan]`` in input order (each unpacks as the
    historical ``(blue, program)`` pair).
    """
    if not topos:
        return []
    avails = [None] * len(topos) if avails is None else list(avails)
    if len(avails) != len(topos):
        raise ValueError(f"{len(avails)} avail masks for {len(topos)} "
                         f"topologies — plan_batch pairs them positionally")
    # fault-domain plumbing: switches with a failed aggregation plane
    # (topo.blocked) leave the candidate set on every strategy path
    avails = [tp.candidates(av) for tp, av in zip(topos, avails, strict=True)]
    if strategy == "soar":
        opts = resolve_options(options, engine_kw, "plan_batch")
        if not opts.color:
            raise ValueError("plan_batch builds programs from blue masks; "
                             "the costs-only mode (color=False) is not "
                             "usable here — call repro_torch.engine."
                             "solve_batch "
                             "directly")
        res = solve_batch([tp.tree for tp in topos],
                          [tp.load for tp in topos], k, avails, options=opts)
        blues = [res.blue_of(b) for b in range(len(topos))]
    elif options is not None or engine_kw:
        named = sorted(engine_kw) if engine_kw else "options="
        raise ValueError(
            f"engine options {named} only apply to "
            f"strategy='soar', not {strategy!r}")
    else:
        fn = baselines.STRATEGIES[strategy]
        blues = [fn(tp.tree, tp.load, k, avail=av)
                 for tp, av in zip(topos, avails, strict=True)]
    out = []
    for tp, blue in zip(topos, blues, strict=True):
        prog = build_program(tp, blue)
        out.append(TenantPlan(blue, prog, prog.utilization))
    return out


def plan_congestion(topo: ClusterTopology, k: int,
                    loads: list[np.ndarray] | None = None,
                    count: int | None = None,
                    avails: list[np.ndarray | None] | np.ndarray | None = None,
                    **driver_kw):
    """Congestion-aware multi-tenant planning on one shared cluster tree.

    Runs the repeated-solve penalty driver
    (:func:`repro_torch.engine.solve_congestion`) for T tenants sharing
    ``topo.tree`` — minimizing the *max-link* congestion across tenants
    instead of each tenant's utilization in isolation — then compiles one
    :class:`ReduceProgram` per tenant from the final masks. ``loads`` is
    one per-tenant load vector (or pass ``count`` to admit that many
    copies of ``topo.load`` — the orchestrator's admission shape);
    ``avails`` is a shared mask or a per-tenant list. Driver keyword
    arguments (``max_rounds``, ``alpha``, ``capacity``, ``residual`` —
    the hard in-loop admission ledger, validated here — ``device_loop``,
    ``options=EngineOptions(...)``, …) pass through. Returns a
    :class:`CongestionPlan` — per-tenant :class:`TenantPlan`\\ s in tenant
    order plus the driver's congestion diagnostics (baseline vs achieved
    max/mean, rounds, history, device↔host traffic); unpacks as the
    historical ``(planned, result)`` pair.
    """
    if (loads is None) == (count is None):
        raise ValueError("pass exactly one of loads / count")
    if loads is None:
        loads = [topo.load] * count
    # boundary validation (parity with plan_batch): a per-tenant avail list
    # must pair positionally, and a malformed capacity vector fails here,
    # not deep inside the engine
    if avails is not None and not isinstance(avails, np.ndarray):
        avails = list(avails)
        if len(avails) != len(loads):
            raise ValueError(
                f"{len(avails)} avail masks for {len(loads)} tenants — "
                "plan_congestion pairs them positionally")
    if driver_kw.get("capacity") is not None:
        driver_kw["capacity"] = _check_capacity(
            driver_kw["capacity"], topo.tree.n, "plan_congestion")
        if topo.cap_scale is not None:
            # partial-capacity degradation shrinks the capacity snapshot
            # the engine's crowding term prices against: a switch at half
            # its aggregation plane crowds twice as fast
            driver_kw["capacity"] = (driver_kw["capacity"]
                                     * np.clip(topo.cap_scale, 0.0, 1.0))
    if driver_kw.get("residual") is not None:
        driver_kw["residual"] = _check_residual(
            driver_kw["residual"], topo.tree.n, "plan_congestion")
    if topo.blocked is not None or topo.cap_scale is not None:
        # blocked and zero-capacity switches leave Lambda for every tenant
        if avails is None or isinstance(avails, np.ndarray):
            avails = topo.candidates(avails)
        else:
            avails = [topo.candidates(a) for a in avails]
    res = solve_congestion(topo.tree, loads, k, avail=avails, **driver_kw)
    plans = []
    for L, blue in zip(loads, res.blue, strict=True):
        tenant_topo = dataclasses.replace(topo, load=np.asarray(L, np.int64))
        prog = build_program(tenant_topo, blue)
        plans.append(TenantPlan(blue, prog, prog.utilization))
    return CongestionPlan(plans, res)


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """:func:`plan_fleet`'s result: per-tenant plans + fleet diagnostics.

    ``plans`` is a list of :class:`TenantPlan` in tenant order (each
    tenant's blue mask and program live on its *own* tree — look up the
    tree with ``tree_of``); ``result`` is the driver's
    ``CongestionResult`` with per-link arrays in the fleet's global
    link-id space (tree segments first, shared-core links last).
    Unpacks as the ``(planned, result)`` pair like
    :class:`CongestionPlan`."""

    plans: list
    result: object                 # repro_torch.engine.CongestionResult
    tree_of: np.ndarray            # (T,) tenant -> tree index

    def __iter__(self):
        return iter((self.plans, self.result))

    @property
    def max_congestion(self) -> float:
        return self.result.max_congestion

    @property
    def improvement(self) -> float:
        return self.result.improvement

    @property
    def core_congestion(self):
        return self.result.core_congestion


def plan_fleet(fleet: Fleet, k: int,
               loads: list[np.ndarray] | None = None,
               tree_of: list[int] | None = None,
               counts: list[int] | None = None,
               avails: list[np.ndarray | None] | None = None,
               **driver_kw) -> FleetPlan:
    """Congestion-coupled planning across a multi-tree fleet.

    T tenants spread over the fleet's N aggregation trees, solved
    *jointly* by :func:`repro_torch.engine.solve_fleet`: every penalty round
    profiles the union of tree-local links and the fleet's shared-core
    links, so tenants on different trees trade placements through the
    links they share — two independent :func:`plan_congestion` calls
    cannot see that coupling. Tenant assignment comes either from
    ``counts`` (per-tree tenant counts; tenant loads default to each
    tree's ``topo.load`` — the admission shape) or from explicit
    ``loads`` + ``tree_of`` (one load vector per tenant, shaped for its
    own tree). ``avails`` is an optional per-tenant mask list; each
    tree's fault domains (``topo.blocked``) are subtracted for its own
    tenants. ``capacity`` / ``residual`` in ``driver_kw`` are per-*tree*
    lists of capacity vectors / hard-admission ledgers, validated here at
    the call boundary. Compiles one
    :class:`ReduceProgram` per tenant on its own tree and returns a
    :class:`FleetPlan`.

    For an N=1 fleet with no core links this is exactly
    :func:`plan_congestion` on the single topology — same masks, same
    costs, same round history (the engine path is shared, not parallel).
    """
    if not isinstance(fleet, Fleet):
        raise TypeError("plan_fleet needs a Fleet; wrap a single topology "
                        "with Fleet.single(topo)")
    N = fleet.n_trees
    if (loads is None) == (counts is None):
        raise ValueError("pass exactly one of loads / counts")
    if counts is not None:
        if tree_of is not None:
            raise ValueError("tree_of is derived from counts — pass it "
                             "only with explicit loads")
        counts = [int(c) for c in counts]
        if len(counts) != N or any(c < 1 for c in counts):
            raise ValueError(f"counts must give >=1 tenants for each of "
                             f"the {N} trees, got {counts}")
        tree_of = [g for g, c in enumerate(counts) for _ in range(c)]
        loads = [fleet.topos[g].load for g in tree_of]
    else:
        if tree_of is None:
            raise ValueError("explicit loads need tree_of (one tree index "
                             "per tenant)")
        tree_of = [int(g) for g in tree_of]
        loads = list(loads)
        if len(tree_of) != len(loads):
            raise ValueError(f"{len(tree_of)} tree indices for "
                             f"{len(loads)} loads")
    T = len(loads)
    tid = np.asarray(tree_of, np.int32)
    if T and (tid.min() < 0 or tid.max() >= N):
        raise ValueError(f"tree_of entries must be in [0, {N})")
    if avails is not None:
        avails = list(avails)
        if len(avails) != T:
            raise ValueError(f"{len(avails)} avail masks for {T} tenants — "
                             "plan_fleet pairs them positionally")
    else:
        avails = [None] * T
    # per-tree fault domains + mask validation at the boundary
    avails = [fleet.topos[g].candidates(av)
              for g, av in zip(tree_of, avails)]
    if driver_kw.get("capacity") is not None:
        caps = list(driver_kw["capacity"])
        if len(caps) != N:
            raise ValueError(f"{len(caps)} capacity vectors for {N} trees "
                             "— plan_fleet takes one per tree")
        driver_kw["capacity"] = [
            _check_capacity(c, fleet.topos[g].tree.n, "plan_fleet")
            * (np.clip(fleet.topos[g].cap_scale, 0.0, 1.0)
               if fleet.topos[g].cap_scale is not None else 1.0)
            for g, c in enumerate(caps)]
    if driver_kw.get("residual") is not None:
        resid = list(driver_kw["residual"])
        if len(resid) != N:
            raise ValueError(f"{len(resid)} residual ledgers for {N} trees "
                             "— plan_fleet takes one per tree")
        driver_kw["residual"] = [
            _check_residual(rg, fleet.topos[g].tree.n, "plan_fleet")
            for g, rg in enumerate(resid)]
    res = solve_fleet([tp.tree for tp in fleet.topos], loads, tid, k,
                      avails,
                      core_rho=fleet.core_rho if fleet.n_core else None,
                      core_path=fleet.core_path if fleet.n_core else None,
                      **driver_kw)
    plans = []
    for t, (L, g) in enumerate(zip(loads, tree_of, strict=True)):
        tp = fleet.topos[g]
        blue = res.blue[t, : tp.tree.n]
        tenant_topo = dataclasses.replace(tp, load=np.asarray(L, np.int64))
        prog = build_program(tenant_topo, blue)
        plans.append(TenantPlan(blue, prog, prog.utilization))
    return FleetPlan(plans, res, tid)
