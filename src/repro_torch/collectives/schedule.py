"""SOAR placement -> static reduction program (the collective schedule).

Builds, for a cluster tree + blue placement, the exact message-passing
program the executor (:mod:`repro_torch.collectives.tree_allreduce`) runs:
which device sends which buffer slots to whom in each round, and where
partial sums are materialized. All counts are static (topology, loads and
coloring are known), so the program is a plain Python object.

A copy of the JAX package's ``collectives/schedule.py`` with ``plan`` and
``plan_batch`` running :func:`repro_torch.engine.solve_batch`; the
congestion and fleet planners are not part of this package yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import baselines
from ..core.reduce import messages_up, messages_up_degraded, phi_degraded
from ..engine import solve_batch
from ..engine.options import EngineOptions, resolve_options
from .topology import ClusterTopology


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
