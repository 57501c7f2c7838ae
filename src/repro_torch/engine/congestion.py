"""Congestion-aware multi-tenant placement: a device-resident penalty loop.

SOAR (and :func:`repro_torch.engine.solve_batch`) minimizes each tenant's
*own* utilization; with T tenants sharing reduction trees the
independently optimal placements pile messages onto the same links.
Following the congestion objective of Segal et al. 2022 (*Constrained
In-network Computing with Low Congestion in Datacenter Networks*), this
driver minimizes the **max-link congestion**

    C_max = max_e sum_t msg_e^t        (optionally time-weighted by rho_e)

by iterated penalty reweighting of the engine's effective link rates:

  1. solve all T tenants batched against the current per-tenant effective
     rho: the packed rho-up table is rebuilt on the device from the
     scaled edge rates (:func:`~repro_torch.kernels.minplus.levelfold.
     rho_up_from_edges`), so every round reuses one prebuilt Forest;
  2. measure per-link traffic from the blue masks with the batched level
     sweep (``repro_torch.core.congestion``), still on the device;
  3. multiplicatively boost each tenant's effective rho on overloaded
     links, in proportion to that tenant's own contribution; a
     deterministic per-tenant ramp of the penalty breaks ties between
     look-alike tenants. With per-switch ``capacity`` given, links whose
     switch is near its capacity claim are priced up jointly with hot
     links (capacity pricing);
  4. keep the best (strictly lowest C_max) placement seen: the result is
     never worse than the utilization-only baseline (round 0).

**Fleet-native.** The driver is :func:`solve_fleet`: T tenants spread over
N aggregation trees that hang off a shared core of C extra links
(:class:`repro_torch.collectives.topology.Fleet`). Every round profiles
and reweights the union of tree-local and shared-core links; the core
penalty weights feed back as an *additive* extension of each tenant's
root up-edge (see :func:`~repro_torch.kernels.minplus.levelfold.
scaled_edges`). :func:`solve_congestion` is the degenerate ``N=1, C=0``
call of the same driver.

**Device-resident loop (default).** ``device_loop=True`` runs each round
on ``options.device`` (CUDA by default) as torch operations on tensors
that stay there: the level-fold gather and the color (one launch each of
the hand-written kernels per level with internal nodes on a CUDA device),
the messages sweep, the penalty update and the best-round tracking. The
only value read back during the loop is the stop flag, once a round;
everything else comes back in one copy at the end
(``CongestionResult.bytes_to_host`` counts both). ``device_loop=False`` is
the host-driven reference: each round goes through the public
:func:`~repro_torch.engine.solve_forest` ``rho_scale`` / ``rho_root_add``
API on a Forest packed again, with masks, counts and C_max pulled to the
host.

**In-loop hard admission.** ``residual=`` hands the driver per-tree
integer residual-capacity ledgers: every round each tenant's candidate
blue set is truncated to the claims the ledger covers (claims ranked per
switch in tenant order) and rejected (tenant, switch) pairs are banned
through the ``avail`` masks for the rest of the loop. The device loop
ranks claims with an integer one-hot ``cumsum``; the host reference
replays a sequential numpy ledger. Both are exact integers.

**Arithmetic.** Both loops call the same functions below, so they agree
bitwise round for round. They also equal the JAX package's loop, which
runs its update jitted: XLA on the CPU contracts ``1 + alpha_t * contrib``
and the priced factor ``1 + cap_beta * ramp_t * crowd`` into fused
multiply-adds (a single rounding each) and keeps the division
``msgs * link_w / C_max`` a true division. :func:`_fma_rn` spells the
single rounding exactly on any device. Weights are quantized to a dyadic
grid (multiples of ``1/1024``), so on dyadic-rho trees every round's
effective rho stays exactly representable in float32 and each round's
batched solve equals the serial :func:`repro_torch.core.soar.soar` on the
reweighted instance. Utilization and congestion are always reported
against the *original* rho.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..core.congestion import (_messages_body, measure_fleet_multi,
                               messages_up_forest)
from ..core.forest import build_fleet_forest, build_forest
from ..core.tree import Tree
from ..kernels.minplus.levelfold import rho_up_from_edges, scaled_edges
from .batched import (_color_body, _device, _device_inputs, _gather_packed,
                      _override_inputs, solve_forest)
from .options import EngineOptions, resolve_options

#: weights are rounded to this dyadic grid so effective rho stays exactly
#: float32-representable on dyadic-rho trees (bit-identical engine/serial)
W_QUANTUM = 1.0 / 1024.0


@dataclasses.dataclass
class CongestionResult:
    """Best placement found by :func:`solve_fleet` plus diagnostics.

    Per-link arrays use the fleet's **global link-id space**: tree g's
    up-links occupy ``[off_g, off_g + n_g)`` of ``congestion`` (offsets
    in tree order), the C shared-core links fill the final entries (also
    broken out as ``core_congestion``). For the single-tree
    :func:`solve_congestion` entry that is the ``(n,)`` per-link profile.
    """

    blue: np.ndarray          # (T, max_g n_g) bool: best per-tenant masks,
                              # each row valid on its own tree's prefix
    costs: np.ndarray         # (T,) float64: utilization on the ORIGINAL rho
    msgs: np.ndarray          # (T, max_g n_g) int64 tree-local messages
    congestion: np.ndarray    # (sum n_g + C,) global per-link profile of
                              # the best round
    max_congestion: float     # C_max of the best round (incl. core links)
    mean_congestion: float    # mean over links carrying traffic
    baseline_max: float       # round 0 = utilization-only solve_batch
    baseline_mean: float
    rounds: int               # solve rounds actually run (incl. round 0)
    best_round: int
    history: list             # per-round C_max
    rounds_log: list | None = None   # [(rho_eff (T,n), blue (T,n))] when
                                     # record_rounds=True (parity testing)
    bytes_to_host: int = 0    # device-to-host bytes the driver copied
    tree_of: np.ndarray | None = None    # (T,) tenant -> tree index
    core_congestion: np.ndarray | None = None  # (C,) shared-core profile
    # -- hard admission (residual=...) only --
    admission_dropped: np.ndarray | None = None  # (T,) int64 claims the
                                                 # best round could not admit
    residual_after: list | None = None   # per-tree int64 residual ledgers
                                         # after the best round's claims
    admission_log: list | None = None    # per-round (T,) dropped-claim
                                         # counts when record_rounds=True

    @property
    def improvement(self) -> float:
        """Relative max-congestion reduction vs the utilization-only plan."""
        if self.baseline_max <= 0:
            return 0.0
        return 1.0 - self.max_congestion / self.baseline_max


# ---------------------------------------------------------------------------
# shared round arithmetic: the one definition both loops run
# ---------------------------------------------------------------------------

def _fma_rn(a: torch.Tensor, b: torch.Tensor, c: float) -> torch.Tensor:
    """``a * b + c`` for float32 ``a``, ``b``, rounded once to float32.

    The float64 product of two float32 values is exact. Their sum with
    ``c`` is TwoSum'd in float64 (``s + err`` is the exact sum) and
    rounded to odd (``s`` moved one float64 ulp toward the exact sum when
    that is inexact and ``s``'s last bit is even); a value rounded to odd
    with 53 bits rounds to nearest-even at 24 bits exactly as the exact
    sum does. Every step is one IEEE operation of torch, separate kernels
    on a card, so nothing is contracted or reassociated on any device.
    """
    p = a.double() * b.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _profile(msgs: torch.Tensor, link_w: torch.Tensor, tree_id: torch.Tensor,
             *, n_trees: int) -> torch.Tensor:
    """Per-tree per-link congestion: integer counts added over each
    tree's tenants (exact in any order), then weighted (``link_w`` is
    (N, links): the original per-link rho when rho_weighted, else 1)."""
    counts = msgs.new_zeros((n_trees, msgs.shape[1])).index_add_(
        0, tree_id, msgs)
    return counts.to(link_w.dtype) * link_w


def _crowding(blue: torch.Tensor, tree_id: torch.Tensor,
              capacity: torch.Tensor, cap_frac: torch.Tensor, *,
              n_trees: int) -> torch.Tensor:
    """Capacity-pricing term: per-tenant (T, links) pressure on crowded
    switches of the tenant's own tree (zero elsewhere)."""
    counts = torch.zeros((n_trees, blue.shape[1]), dtype=torch.int64,
                         device=blue.device).index_add_(0, tree_id,
                                                        blue.long())
    usage = counts[tree_id].to(capacity.dtype)
    pressure = usage / torch.maximum(capacity[tree_id],
                                     capacity.new_tensor(1e-6))
    crowded = (pressure >= cap_frac) & blue
    return torch.where(crowded, pressure, 0.0)


def _reweight(w, msgs, prof_t, cmax, alpha_t, ramp_t, hot_frac, w_cap,
              link_w_t, crowd, cap_beta, *, priced: bool):
    """One penalty update of a (T, links) weight matrix.

    Hot links (``prof_t >= hot_frac * cmax``; C_max is the *global* max,
    over tree and core links jointly) boost each tenant's weight in
    proportion to that tenant's own traffic share; ``crowd`` carries the
    capacity-pricing pressure (:func:`_crowding`) when ``priced``. Both
    ``1 + x * y`` factors round once (:func:`_fma_rn`). One dyadic
    quantization after the joint boost keeps the effective rho exactly
    float32-representable on dyadic trees.
    """
    hot = prof_t >= hot_frac * cmax
    contrib = msgs.to(w.dtype) * link_w_t / cmax
    boost = _fma_rn(alpha_t, torch.where(hot, contrib, 0.0), 1.0)
    if priced:
        boost = boost * _fma_rn(cap_beta * ramp_t, crowd, 1.0)
    q = torch.round(w * boost / W_QUANTUM) * W_QUANTUM
    return torch.minimum(q, w_cap)


def _core_extra(core_base: torch.Tensor, wc: torch.Tensor,
                core_onf: torch.Tensor) -> torch.Tensor:
    """Per-tenant additive root-edge extension from shared-core transit:
    each core link on the tenant's path contributes its penalty-weighted
    rate, summed left to right over the C links (as XLA sums this small
    row). ``core_base``: (C,) core rho; ``wc``: (T, C) weights;
    ``core_onf``: (T, C) float incidence. Returns (T,)."""
    terms = core_base[None, :] * wc * core_onf
    acc = torch.zeros_like(terms[:, 0])
    for c in range(terms.shape[1]):
        acc = acc + terms[:, c]
    return acc


def _admit_ranked(blue, tree_id, residual, *, n_trees: int):
    """Hard-admission truncation of one round's candidate blue sets.

    A claim by tenant t on switch s is admitted iff fewer than
    ``residual[tree_of[t], s]`` lower-indexed tenants of the same tree
    also claim s this round: the set a sequential per-tree ledger replay
    in tenant order admits, computed in one shot as an integer one-hot
    cumsum. Returns ``(admitted, rejected)`` bool (T, links) masks.
    """
    oh = (tree_id[:, None] == torch.arange(n_trees, device=blue.device)
          [None, :]).long()
    cum = torch.cumsum(blue.long()[:, None, :] * oh[:, :, None], dim=0)
    rank = (cum * oh[:, :, None]).sum(dim=1)         # own-tree row, (T, L)
    admitted = blue & (rank <= residual[tree_id])
    return admitted, blue & ~admitted


def _round_penalty(w, wc, msgs, blue, root_idx, tree_id, link_w,
                   core_link_w, core_on, capacity, alpha_t, ramp_t,
                   hot_frac, w_cap, cap_beta, cap_frac, *,
                   n_trees: int, priced: bool):
    """Profile the union of tree-local and shared-core links, then apply
    one penalty update to both weight matrices.

    ``msgs``: (T, links) integer per-tenant counts on the tenant's own
    tree; ``root_idx``: (T,) column of each tenant's root link (its
    root-crossing count is the core transit); ``core_on``: (T, C) bool
    incidence. Returns ``(prof_tree (N, links), prof_core (C,), cmax, w',
    wc')``; C_max is the max over *all* links, tree and core jointly.
    """
    prof_tree = _profile(msgs, link_w, tree_id, n_trees=n_trees)
    cmax = prof_tree.max()
    C = wc.shape[1]
    if C:
        root_msgs = torch.gather(msgs, 1, root_idx[:, None])
        core_msgs = root_msgs * core_on.to(msgs.dtype)          # (T, C)
        prof_core = core_msgs.sum(dim=0).to(core_link_w.dtype) * core_link_w
        cmax = torch.maximum(cmax, prof_core.max())
    else:
        prof_core = w.new_zeros((0,))
    prof_t = prof_tree[tree_id]                                 # (T, links)
    link_w_t = link_w[tree_id]
    crowd = (_crowding(blue, tree_id, capacity, cap_frac, n_trees=n_trees)
             if priced else torch.zeros_like(w))
    w2 = _reweight(w, msgs, prof_t, cmax, alpha_t, ramp_t, hot_frac, w_cap,
                   link_w_t, crowd, cap_beta, priced=priced)
    if C:
        # the core links have no per-switch capacity claim (pricing is a
        # tree-link concept), so their reweight is never priced
        wc2 = _reweight(wc, core_msgs, prof_core[None, :].expand_as(wc),
                        cmax, alpha_t, ramp_t, hot_frac, w_cap,
                        core_link_w[None, :].expand_as(wc),
                        torch.zeros_like(wc), cap_beta, priced=False)
    else:
        wc2 = wc
    return prof_tree, prof_core, cmax, w2, wc2


def _edges(base_edge, w, wc, core_base, core_on, root_idx):
    """Effective per-edge rates of one round (what ``record_rounds``
    logs), with the shared-core root extension when there is a core."""
    if wc.shape[1] == 0:
        return scaled_edges(base_edge, w)
    extra = _core_extra(core_base, wc, core_on.to(base_edge.dtype))
    return scaled_edges(base_edge, w, extra, root_idx)


# ---------------------------------------------------------------------------
# the device-resident loop
# ---------------------------------------------------------------------------

def _pull(tensors) -> list[np.ndarray]:
    """Copy ``tensors`` to the host in one device-to-host transfer: their
    bytes are packed into one buffer on the device, then split again."""
    flat = [t.contiguous().reshape(-1) for t in tensors]
    buf = torch.cat([t.view(torch.uint8) if t.dtype != torch.bool
                     else t.to(torch.uint8) for t in flat]).cpu().numpy()
    out, at = [], 0
    for src, t in zip(tensors, flat, strict=True):
        n = t.numel() * t.element_size()
        dt = np.dtype(str(src.dtype).removeprefix("torch."))
        out.append(buf[at : at + n].view(dt).reshape(tuple(src.shape)))
        at += n
    return out


def _device_loop(
    kid, load, send, avail, par, cidx, root_slot,     # packed solve inputs
    base_edge, anc, valid,                            # rho-override inputs
    tree_id, link_w, capacity,                        # (T,), (N,S), (N,S)
    residual,                                         # (N,S) int64 ledgers
    core_base, core_on, core_link_w,                  # (C,), (T,C), (C,)
    alpha_t, ramp_t,                                  # (T, 1) tenant ramps
    hot_frac, w_cap, cap_beta, cap_frac, patience,    # scalars
    *,
    lvl_off, lvl_width, lvl_internal, lvl_sub, k, cap, max_rounds: int,
    record: bool, priced: bool, admit: bool, n_trees: int,
):
    """The penalty loop with its state on the inputs' device.

    Per round: shared-core root extension and rho-up recompute -> level
    fold gather -> color (slot-indexed masks) -> admission -> messages
    sweep -> profile and reweight over the union of tree and core links
    -> best-round tracking. The host reads one value a round, the stop
    flag; the best masks, the history, the round-0 profiles and the logs
    come back in one copy at the end. Returns ``(host arrays, rounds,
    bytes_to_host)``.

    With ``admit`` the loop also owns the availability masks: each
    round's candidate blues are truncated to what ``residual`` covers and
    rejected claims ban their (tenant, switch) pair from every later
    round. A round that banned something never triggers the patience
    stop: the search landscape changed under it.
    """
    T, S, _ = kid.shape
    dt = base_edge.dtype
    dev = base_edge.device
    C = core_base.shape[0]
    w = torch.ones((T, S), dtype=dt, device=dev)
    wc = torch.ones((T, C), dtype=dt, device=dev)
    stale = torch.zeros((), dtype=torch.int64, device=dev)
    best_cmax = torch.full((), float("inf"), dtype=dt, device=dev)
    best_blue = torch.zeros((T, S), dtype=torch.bool, device=dev)
    best_round = torch.zeros((), dtype=torch.int64, device=dev)
    best_drop = torch.zeros((T,), dtype=torch.int64, device=dev)
    history = []
    logs: list = []
    prof0 = prof0c = None
    bytes_to_host = 0
    r = 0
    while r < max_rounds:
        edges = _edges(base_edge, w, wc, core_base, core_on, root_slot)
        R = rho_up_from_edges(edges, anc, valid)
        blocks = _gather_packed(
            kid, load, send, avail, R, lvl_off=lvl_off, lvl_width=lvl_width,
            lvl_internal=lvl_internal, lvl_sub=lvl_sub, k=k, cap=cap)
        blue, _ = _color_body(
            blocks, kid, par, cidx, load, send, avail, R, root_slot,
            lvl_off=lvl_off, lvl_width=lvl_width,
            lvl_internal=lvl_internal, lvl_sub=lvl_sub, k=k, cap=cap)
        if admit:
            blue, rejected = _admit_ranked(blue, tree_id, residual,
                                           n_trees=n_trees)
            avail = avail & ~rejected              # persistent in-loop ban
            banned = rejected.any()
            drop = rejected.sum(dim=1)
        else:
            drop = torch.zeros((T,), dtype=torch.int64, device=dev)
        msgs = _messages_body(kid, load, send, blue, lvl_off=lvl_off,
                              lvl_width=lvl_width, lvl_internal=lvl_internal)
        prof_tree, prof_core, cmax, w, wc = _round_penalty(
            w, wc, msgs, blue, root_slot, tree_id, link_w, core_link_w,
            core_on, capacity, alpha_t, ramp_t, hot_frac, w_cap, cap_beta,
            cap_frac, n_trees=n_trees, priced=priced)
        history.append(cmax)
        if r == 0:
            prof0, prof0c = prof_tree, prof_core
        if record:
            logs.append((edges, blue, drop))
        better = cmax < best_cmax                    # strict: earliest wins
        best_blue = torch.where(better, blue, best_blue)
        best_round = torch.where(better, r, best_round)
        best_cmax = torch.where(better, cmax, best_cmax)
        best_drop = torch.where(better, drop, best_drop)
        stale = torch.where(better, 0, stale + 1)
        stop = stale >= patience
        if admit:
            stop = stop & ~banned
        stop = stop | (cmax == 0.0)
        r += 1
        bytes_to_host += stop.element_size()
        if bool(stop):                     # the one read-back of a round
            break
    pulled = [best_blue, best_round, torch.stack(history), prof0, prof0c,
              best_drop]
    if record:
        pulled += [torch.stack([x[i] for x in logs]) for i in range(3)]
    host = _pull(pulled)
    bytes_to_host += sum(int(x.nbytes) for x in host)
    return host, r, bytes_to_host


# ---------------------------------------------------------------------------
# the public drivers
# ---------------------------------------------------------------------------

def solve_fleet(
    trees: Sequence[Tree],
    loads: Sequence[np.ndarray],
    tree_of: Sequence[int],
    k: int,
    avail: Sequence[np.ndarray | None] | None = None,
    *,
    core_rho: np.ndarray | None = None,
    core_path: Sequence[Sequence[int]] | None = None,
    max_rounds: int = 8,
    patience: int = 2,
    alpha: float = 2.0,
    hot_frac: float = 0.75,
    w_cap: float = 8.0,
    rho_weighted: bool = False,
    capacity: Sequence[np.ndarray] | None = None,
    cap_beta: float = 1.0,
    cap_frac: float = 0.75,
    residual: Sequence[np.ndarray] | None = None,
    record_rounds: bool = False,
    device_loop: bool = True,
    options: EngineOptions | None = None,
    **engine_kw,
) -> CongestionResult:
    """Minimize max-link congestion for T tenants across a multi-tree fleet.

    ``trees``: the N distinct aggregation trees; ``tree_of[t]`` names
    tenant t's tree (every tree needs at least one tenant); ``loads``:
    one load vector per tenant, shaped for its own tree. ``core_rho`` /
    ``core_path`` describe the shared core (see
    :class:`repro_torch.collectives.topology.Fleet`): a tenant's
    root-crossing messages transit every core link on its tree's path,
    the per-link profile spans the union of tree-local and core links,
    and core penalties feed back as additive root-edge extensions.

    ``avail``: a per-tenant sequence of masks (or None). ``capacity``:
    per-*tree* capacity vectors (len N) switching on capacity pricing for
    tree links. ``residual``: per-*tree* integer residual-capacity
    ledgers (len N) switching on **hard in-loop admission** (see the
    module docstring); ``admission_dropped`` / ``residual_after`` on the
    result report the best round's shortfall and remaining capacity.
    Zero-residual and zero-capacity switches leave every affected
    tenant's candidate set up front. Runs on ``options.device``, CUDA by
    default; the penalty arithmetic is float32 (``options.dtype``), as
    in the JAX package. All other knobs as :func:`solve_congestion`,
    which is the degenerate ``N=1, C=0`` call of this driver.
    """
    T = len(loads)
    if T == 0:
        raise ValueError("solve_fleet needs at least one tenant")
    if max_rounds < 1:
        raise ValueError("max_rounds must be >= 1")
    opts = resolve_options(options, engine_kw, "solve_fleet")
    if not opts.color:
        raise ValueError("solve_fleet needs blue masks; color=False "
                         "(costs-only mode) is not usable here")
    if opts.debug_tables:
        raise ValueError("solve_fleet re-solves on device-side effective "
                         "rho; the debug_tables host replay is not usable "
                         "here")
    if opts.dtype != torch.float32:
        # the JAX loop runs float32 (it has no float64 without x64), and
        # _fma_rn rounds once only for float32 operands
        raise ValueError(f"solve_fleet's penalty arithmetic is float32; "
                         f"got dtype={opts.dtype}")
    # capacity-knob boundary validation: _crowding clamps capacity with
    # 1e-6 (a numerical guard, not a semantics), so malformed knobs must
    # die here, not price a zero-capacity switch as admittable
    if not (np.isfinite(cap_frac) and 0.0 < cap_frac <= 1.0):
        raise ValueError(f"cap_frac must be in (0, 1], got {cap_frac}")
    if not (np.isfinite(cap_beta) and cap_beta >= 0.0):
        raise ValueError(f"cap_beta must be finite and >= 0, "
                         f"got {cap_beta}")
    trees = list(trees)
    N = len(trees)
    tid_np = np.asarray(list(tree_of), np.int32)
    if tid_np.shape != (T,):
        raise ValueError(f"tree_of shape {tid_np.shape} != ({T},)")
    if avail is None:
        avails = [None] * T
    else:
        avails = list(avail)
        if len(avails) != T:
            raise ValueError(f"{len(avails)} avail masks for {T} tenants")
    priced = capacity is not None
    if priced:
        capacity = [np.asarray(c, np.float64) for c in capacity]
        if len(capacity) != N:
            raise ValueError(f"{len(capacity)} capacity vectors for "
                             f"{N} trees")
        for g, c in enumerate(capacity):
            if c.shape != (trees[g].n,):
                raise ValueError(f"capacity shape {c.shape} != "
                                 f"({trees[g].n},)")
            if not np.all(np.isfinite(c)) or np.any(c < 0):
                raise ValueError(f"capacity vector for tree {g} must be "
                                 "finite and non-negative")
    admit = residual is not None
    if admit:
        residual = [np.asarray(rg) for rg in residual]
        if len(residual) != N:
            raise ValueError(f"{len(residual)} residual ledgers for "
                             f"{N} trees")
        checked = []
        for g, rg in enumerate(residual):
            if rg.shape != (trees[g].n,):
                raise ValueError(f"residual shape {rg.shape} != "
                                 f"({trees[g].n},) for tree {g}")
            rf = rg.astype(np.float64)
            if not np.all(np.isfinite(rf)) or np.any(rf != np.floor(rf)):
                raise ValueError(f"residual ledger for tree {g} must be "
                                 "integer-valued")
            if np.any(rg.astype(np.int64) < 0):
                raise ValueError(f"residual ledger for tree {g} must be "
                                 "non-negative")
            checked.append(rg.astype(np.int64))
        residual = checked
    if admit or priced:
        # hard unavailability flows through the avail masks: switches with
        # no residual (or no capacity at all) leave their tree's tenants'
        # candidate sets before the first solve
        hard = [np.ones(tr.n, bool) for tr in trees]
        for g in range(N):
            if admit:
                hard[g] &= residual[g] > 0
            if priced:
                hard[g] &= capacity[g] > 0
        if not all(h.all() for h in hard):
            avails = [
                (hard[g].copy() if a is None
                 else np.asarray(a, bool) & hard[g])
                for a, g in zip(avails, tid_np)]
    if admit:
        # the host ledger replay bans into its per-tenant masks: every
        # tenant needs its own copy
        avails = [np.ones(trees[g].n, bool) if a is None
                  else np.array(a, dtype=bool, copy=True)
                  for a, g in zip(avails, tid_np)]
    dev = _device(opts.device)

    # one Forest and one packing for the whole device loop
    f, lay = build_fleet_forest(trees, list(loads), tid_np, avails,
                                core_rho=core_rho, core_path=core_path)
    C = lay.n_core
    dt = opts.dtype
    rep = lay.rep

    def up(a, dtype=dt):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    # per-tenant penalty ramp: deterministic symmetry breaker
    ramp_t = up((1.0 + np.arange(T) / max(1, T - 1))[:, None])
    alpha_t = up(alpha) * ramp_t
    scal = dict(hot_frac=up(hot_frac), w_cap=up(w_cap),
                cap_beta=up(cap_beta), cap_frac=up(cap_frac))
    # per-tree per-link constants, node-indexed for the host reference and
    # slot-indexed for the device loop: the same value on each real link
    link_w_node = np.ones((N, f.n_max))
    link_w_slot = np.ones((N, f.n_slots))
    core_link_w = np.ones(C)
    if rho_weighted:
        base_slot = np.where(np.isfinite(f.pk_rho_up[:, :, 1]),
                             f.pk_rho_up[:, :, 1], 0.0)
        link_w_node[:] = 0.0
        for g, tr in enumerate(trees):
            link_w_node[g, : tr.n] = tr.rho
        link_w_slot = base_slot[rep]
        core_link_w = lay.core_rho
    cap_node = np.ones((N, f.n_max))
    cap_slot = np.ones((N, f.n_slots))
    if priced:
        for g in range(N):
            cap_node[g, : trees[g].n] = capacity[g]
            sn_g = f.slot_node[rep[g]]
            cap_slot[g] = np.where(sn_g >= 0,
                                   cap_node[g][np.maximum(sn_g, 0)], 1.0)
    # residual ledgers: padding slots read T, so they never reject
    res_slot = np.full((N, f.n_slots), T, np.int64)
    if admit:
        for g in range(N):
            sn_g = f.slot_node[rep[g]]
            res_slot[g] = np.where(
                sn_g >= 0, residual[g][np.clip(sn_g, 0, trees[g].n - 1)], T)
    tree_id = up(lay.tree_of, torch.int64)
    core_base = up(lay.core_rho)                           # (C,)
    core_on = up(lay.core_inc, torch.bool)                 # (T, C)
    core_link_w = up(core_link_w)

    if device_loop:
        state = _run_device(f, lay, k, opts, dev, tree_id, up(link_w_slot),
                            up(cap_slot), up(res_slot, torch.int64),
                            core_base, core_on, core_link_w, alpha_t,
                            ramp_t, scal, patience, max_rounds,
                            record_rounds, priced, admit)
    else:
        state = _run_host(trees, loads, tid_np, avails, f, lay, k, opts,
                          dev, up(link_w_node), up(cap_node), residual,
                          core_base, core_on, core_link_w, alpha_t, ramp_t,
                          scal, patience, max_rounds, record_rounds, priced,
                          admit)
    (blue_node, best_round, rounds, history, prof0_node, prof0_core,
     rounds_log, bytes_to_host, best_drop, admission_log) = state

    n_big = int(lay.tree_n.max())
    blue = blue_node[:, :n_big]
    # the reported statistics come from the one shared measurement recipe;
    # its host sweep equals the device messages the loop tracked
    m = measure_fleet_multi(
        trees, tid_np, list(loads),
        [blue[t, : trees[int(tid_np[t])].n] for t in range(T)],
        core_rho=lay.core_rho if C else None,
        core_path=lay.core_path if C else None,
        rho_weighted=rho_weighted)
    parts = [prof0_node[g, : trees[g].n] for g in range(N)]
    if C:
        parts.append(prof0_core)
    base0 = np.concatenate(parts)
    base0 = base0[base0 > 0]
    admission_dropped = residual_after = None
    if admit:
        admission_dropped = np.asarray(best_drop, np.int64)
        residual_after = []
        for g in range(N):
            claims = np.zeros(trees[g].n, np.int64)
            for t in range(T):
                if int(tid_np[t]) == g:
                    claims += blue[t, : trees[g].n].astype(np.int64)
            residual_after.append(residual[g] - claims)
    return CongestionResult(
        blue=blue, costs=m.costs, msgs=m.msgs, congestion=m.congestion,
        max_congestion=m.max_congestion,
        mean_congestion=m.mean_congestion,
        baseline_max=float(history[0]),
        baseline_mean=float(base0.astype(np.float64).mean())
        if base0.size else 0.0,
        rounds=rounds, best_round=best_round, history=history,
        rounds_log=rounds_log, bytes_to_host=bytes_to_host,
        tree_of=tid_np.copy(), core_congestion=m.core_congestion,
        admission_dropped=admission_dropped, residual_after=residual_after,
        admission_log=admission_log)


def solve_congestion(
    tree: Tree,
    loads: Sequence[np.ndarray],
    k: int,
    avail: Sequence[np.ndarray | None] | np.ndarray | None = None,
    *,
    max_rounds: int = 8,
    patience: int = 2,
    alpha: float = 2.0,
    hot_frac: float = 0.75,
    w_cap: float = 8.0,
    rho_weighted: bool = False,
    capacity: np.ndarray | None = None,
    cap_beta: float = 1.0,
    cap_frac: float = 0.75,
    residual: np.ndarray | None = None,
    record_rounds: bool = False,
    device_loop: bool = True,
    options: EngineOptions | None = None,
    **engine_kw,
) -> CongestionResult:
    """Minimize max-link congestion for T tenants sharing ``tree``.

    ``loads``: one (n,) load vector per tenant. ``avail``: a single mask
    shared by all tenants, a per-tenant sequence, or None. ``alpha``
    scales the penalty (each tenant t uses a deterministic ramp
    ``alpha * (1 + t/(T-1))``, the symmetry breaker for identical
    tenants); links hotter than ``hot_frac * C_max`` are penalized;
    per-link weights are capped at ``w_cap`` and quantized to
    :data:`W_QUANTUM`. ``rho_weighted=True`` measures congestion in
    transmission time (``msg * rho``) instead of raw message counts.

    ``capacity`` (n,) switches on *capacity pricing*: links whose switch
    has blue claims from at least ``cap_frac`` of its per-switch capacity
    this round are priced up (factor ``1 + cap_beta * ramp_t *
    usage/capacity``) jointly with the hot-link boost, for the tenants
    sitting on them.

    ``residual`` (n,) switches on **hard in-loop admission**: an integer
    per-switch claim ledger the returned placements are feasible against
    (see :func:`solve_fleet`).

    ``device_loop=True`` (default) keeps the loop's state on
    ``options.device`` (CUDA unless ``EngineOptions(device="cpu")``) and
    reads back one flag a round; ``device_loop=False`` is the host-driven
    reference with the same arithmetic and per-round transfers.
    ``color=False`` and ``debug_tables=True`` are rejected. Runs at most
    ``max_rounds`` solves, stopping after ``patience`` rounds without
    improvement; the returned placement is the best round seen, never
    worse than the utilization-only baseline (round 0). This is the
    single-tree, no-core call of :func:`solve_fleet`.
    """
    T = len(loads)
    if T == 0:
        raise ValueError("solve_congestion needs at least one tenant")
    # resolve here so errors cite the entry point the caller actually used
    opts = resolve_options(options, engine_kw, "solve_congestion")
    n = tree.n
    if avail is None or isinstance(avail, np.ndarray):
        avails = [avail] * T
    else:
        avails = list(avail)
        if len(avails) != T:
            raise ValueError(f"{len(avails)} avail masks for {T} tenants")
    if capacity is not None:
        capacity = np.asarray(capacity, np.float64)
        if capacity.shape != (n,):
            raise ValueError(f"capacity shape {capacity.shape} != ({n},)")
        capacity = [capacity]
    if residual is not None:
        residual = np.asarray(residual)
        if residual.shape != (n,):
            raise ValueError(f"residual shape {residual.shape} != ({n},)")
        residual = [residual]
    return solve_fleet(
        [tree], loads, [0] * T, k, avails,
        max_rounds=max_rounds, patience=patience, alpha=alpha,
        hot_frac=hot_frac, w_cap=w_cap, rho_weighted=rho_weighted,
        capacity=capacity, cap_beta=cap_beta, cap_frac=cap_frac,
        residual=residual, record_rounds=record_rounds,
        device_loop=device_loop, options=opts)


def _slots_to_nodes_np(x_slot: np.ndarray, f, rows=None) -> np.ndarray:
    """Host twin of the engine's slot->node gather (padding reads 0).

    ``rows`` selects which batch rows' ``slot_of`` maps apply: the fleet
    driver maps its (N, S) per-tree profiles through each tree's
    representative tenant row.
    """
    slot_of = f.slot_of if rows is None else f.slot_of[rows]
    B = x_slot.shape[0]
    pad = np.concatenate(
        [x_slot, np.zeros((B, 1), x_slot.dtype)], axis=1)
    return np.take_along_axis(pad, slot_of, axis=1)


def _run_device(f, lay, k, opts, dev, tree_id, link_w_slot, cap_slot,
                res_slot, core_base, core_on, core_link_w, alpha_t, ramp_t,
                scal, patience, max_rounds, record_rounds, priced, admit):
    """Run the resident loop; map its one final pull back to nodes."""
    n_big = int(lay.tree_n.max())
    kid, load, send, avail_d, _, par, cidx, _, root_d = \
        _device_inputs(f, opts.dtype, dev)
    base_edge, anc, valid, _, _ = _override_inputs(f, opts.dtype, dev)
    host, rounds, bytes_to_host = _device_loop(
        kid, load, send, avail_d, par, cidx, root_d, base_edge, anc, valid,
        tree_id, link_w_slot, cap_slot, res_slot, core_base, core_on,
        core_link_w, alpha_t, ramp_t, scal["hot_frac"], scal["w_cap"],
        scal["cap_beta"], scal["cap_frac"], int(patience),
        lvl_off=f.lvl_off, lvl_width=f.lvl_width,
        lvl_internal=f.lvl_internal, lvl_sub=f.lvl_sub, k=k,
        cap=bool(opts.cap), max_rounds=int(max_rounds),
        record=bool(record_rounds), priced=priced, admit=admit,
        n_trees=int(lay.n_trees))
    best_blue_s, best_round, hist, prof0_s, prof0c, best_drop = host[:6]
    history = [float(c) for c in hist]
    blue_node = _slots_to_nodes_np(best_blue_s, f)
    prof0_node = _slots_to_nodes_np(prof0_s, f, rows=lay.rep)
    rounds_log = admission_log = None
    if record_rounds:
        log_rho, log_blue, log_drop = host[6:]
        rounds_log = [
            (_slots_to_nodes_np(log_rho[r], f).astype(np.float64)[:, :n_big],
             _slots_to_nodes_np(log_blue[r], f)[:, :n_big])
            for r in range(rounds)]
        if admit:
            admission_log = [log_drop[r].astype(np.int64)
                             for r in range(rounds)]
    return (blue_node, int(best_round), rounds, history, prof0_node, prof0c,
            rounds_log, bytes_to_host, best_drop.astype(np.int64),
            admission_log)


def _run_host(trees, loads, tid_np, avails, f, lay, k, opts, dev,
              link_w_node, cap_node, residual, core_base, core_on,
              core_link_w, alpha_t, ramp_t, scal, patience, max_rounds,
              record_rounds, priced, admit):
    """Host-driven reference: one round per step, everything pulled.

    Runs the same round arithmetic as the device loop, but the solve goes
    through the public :func:`~repro_torch.engine.solve_forest`
    ``rho_scale`` / ``rho_root_add`` overrides on a Forest packed and
    uploaded again each round (node-indexed weights plus the shared-core
    root extension), the masks, message counts and C_max come back to the
    host each round, and loop control and best tracking run on the host.

    With ``admit`` each round replays a literal sequential per-tree
    ledger in tenant order (the admission the device loop's one-hot
    cumsum rank computes in one shot) and persists rejections into
    ``avails`` so the next round's Forest excludes them.
    """
    T, n_max = f.mask.shape
    N = int(lay.n_trees)
    C = int(lay.n_core)
    n_big = int(lay.tree_n.max())
    dt = opts.dtype
    base_edge_node = torch.as_tensor(
        np.where(np.isfinite(f.rho_up[:, :, 1]), f.rho_up[:, :, 1], 0.0),
        dtype=dt, device=dev)
    root_idx = torch.as_tensor(f.root, dtype=torch.int64, device=dev)
    tree_id = torch.as_tensor(lay.tree_of, dtype=torch.int64, device=dev)
    w = torch.ones((T, n_max), dtype=dt, device=dev)
    wc = torch.ones((T, C), dtype=dt, device=dev)
    best = None                     # (cmax, round, blue, drop)
    history: list[float] = []
    rounds_log: list | None = [] if record_rounds else None
    admission_log: list | None = \
        [] if (admit and record_rounds) else None
    prof0_node = prof0_core = None
    bytes_to_host = 0
    stale = 0
    rounds = 0
    for r in range(max_rounds):
        fr = build_forest([trees[g] for g in tid_np], list(loads), avails)
        if C:
            extra = _core_extra(core_base, wc, core_on.to(dt))
            res = solve_forest(fr, k, options=opts, rho_scale=w,
                               rho_root_add=extra)
        else:
            res = solve_forest(fr, k, options=opts, rho_scale=w)
        blue = res.blue
        bytes_to_host += res.bytes_to_host
        drop = np.zeros(T, np.int64)
        banned = False
        if admit:
            # the sequential ledger the device one-hot cumsum reproduces:
            # claims replayed in tenant order against a fresh per-round
            # copy of the residual; rejections ban the (tenant, switch)
            # pair from every later round via the avail masks
            blue = blue.copy()
            ledger = [rg.copy() for rg in residual]
            for t in range(T):
                g = int(tid_np[t])
                led = ledger[g]
                for v in np.nonzero(blue[t, : trees[g].n])[0]:
                    if led[v] > 0:
                        led[v] -= 1
                    else:
                        blue[t, v] = False
                        avails[t][v] = False
                        drop[t] += 1
                        banned = True
        msgs64 = messages_up_forest(fr, blue, options=opts)
        bytes_to_host += msgs64.nbytes
        blue_d = torch.as_tensor(blue, device=dev)
        prof_tree, prof_core, cmax_d, w2, wc2 = _round_penalty(
            w, wc, torch.as_tensor(msgs64, device=dev), blue_d, root_idx,
            tree_id, link_w_node, core_link_w, core_on, cap_node, alpha_t,
            ramp_t, scal["hot_frac"], scal["w_cap"], scal["cap_beta"],
            scal["cap_frac"], n_trees=N, priced=priced)
        cmax = float(cmax_d)
        bytes_to_host += cmax_d.element_size()
        history.append(cmax)
        rounds = r + 1
        if r == 0:
            prof0_node = prof_tree.cpu().numpy()
            prof0_core = prof_core.cpu().numpy()
            bytes_to_host += prof0_node.nbytes + prof0_core.nbytes
        if record_rounds:
            rho_eff = _edges(base_edge_node, w, wc, core_base, core_on,
                             root_idx).cpu().numpy()
            bytes_to_host += rho_eff.nbytes
            rounds_log.append((rho_eff.astype(np.float64)[:, :n_big],
                               blue[:, :n_big].copy()))
        if admission_log is not None:
            admission_log.append(drop.copy())
        if best is None or cmax < best[0]:           # strict: earliest wins
            best = (cmax, r, blue, drop)
            stale = 0
        else:
            stale += 1
        # a round that banned something changed the search landscape under
        # the loop: it never counts toward the patience stop
        if cmax == 0 or (stale >= patience and not banned):
            break
        w, wc = w2, wc2
    _, best_round, blue_node, best_drop = best
    return (blue_node, best_round, rounds, history, prof0_node, prof0_core,
            rounds_log, bytes_to_host, best_drop, admission_log)
